"""Parameters from the JAX package into the port's layout.

The JAX package's pyramid params are a pytree ``{"levels": [...],
"rgb_mlp": {"w0": ..., ...}}`` (fetched to the host it is a tree of
numpy arrays); ``train.py`` saves them as ``model_pyramid.npz`` with keys
``level_{i}``, ``rgb_mlp_{name}`` and, for split configs, ``sigma_level``.
The port keeps the same layouts (grids ``[x, y, z]`` channels last, MLP
weights ``(in, out)``), so conversion is a dtype and device move.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def pyramid_params_from_numpy(tree: Dict[str, Any], device=None):
    """JAX pyramid params (numpy leaves) -> the port's dict of fp32 tensors."""
    params = {
        "levels": [_t(g, device) for g in tree["levels"]],
        "rgb_mlp": {k: _t(v, device) for k, v in tree["rgb_mlp"].items()},
    }
    if "sigma_level" in tree:
        params["sigma_level"] = _t(tree["sigma_level"], device)
    return params


def load_pyramid_npz(path: str, device=None):
    """Read a ``model_pyramid.npz`` written by the JAX package's train.py."""
    with np.load(path) as d:
        levels = []
        while f"level_{len(levels)}" in d:
            levels.append(d[f"level_{len(levels)}"])
        if not levels:
            raise ValueError(f"no pyramid levels in {path}")
        tree = {
            "levels": levels,
            "rgb_mlp": {
                k[len("rgb_mlp_"):]: d[k]
                for k in d.files
                if k.startswith("rgb_mlp_")
            },
        }
        if "sigma_level" in d:
            tree["sigma_level"] = d["sigma_level"]
        return pyramid_params_from_numpy(tree, device)
