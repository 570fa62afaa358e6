"""Model families of the sample-gather path, by ``--model_name``.

Port of the JAX package's ``models/registry.py``.  Each family exposes
``init_params(cfg, generator, device) / forward(params, cfg, x, d) /
density(params, cfg, x)``.  Only ``"ngp"`` is ported; the dense SH voxel
grid (``"svox"``) is ROADMAP 'Modules to port' item 11.
"""

from __future__ import annotations

from types import SimpleNamespace

from . import ngp

MODEL_DICT = {
    "ngp": SimpleNamespace(
        init_params=ngp.init_ngp_params,
        forward=ngp.forward,
        density=ngp.density,
    ),
}


def get_model(name: str):
    if name == "svox":
        raise NotImplementedError(
            "the svox (voxel_grid) model is not ported yet; see ROADMAP "
            "'Modules to port' item 11"
        )
    return MODEL_DICT[name]
