"""Model families of the sample-gather path, by ``--model_name``.

Port of the JAX package's ``models/registry.py``.  Each family exposes
``init_params(cfg, generator, device) / forward(params, cfg, x, d) /
density(params, cfg, x)``: ``"ngp"`` (``models/ngp.py``) and ``"svox"``,
the dense SH voxel grid (``models/voxel_grid.py``).
"""

from __future__ import annotations

from types import SimpleNamespace

from . import ngp, voxel_grid

MODEL_DICT = {
    "ngp": SimpleNamespace(
        init_params=ngp.init_ngp_params,
        forward=ngp.forward,
        density=ngp.density,
    ),
    "svox": SimpleNamespace(
        init_params=voxel_grid.init_params,
        forward=voxel_grid.forward,
        density=voxel_grid.density,
    ),
}


def get_model(name: str):
    return MODEL_DICT[name]
