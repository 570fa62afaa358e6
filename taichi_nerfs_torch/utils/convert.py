"""Pyramid parameters between the JAX package's layout and the port's.

The JAX package's pyramid params are a pytree ``{"levels": [...],
"rgb_mlp": {"w0": ..., ...}}`` (fetched to the host it is a tree of
numpy arrays); ``train.py`` saves them as ``model_pyramid.npz`` with keys
``level_{i}``, ``rgb_mlp_{name}`` and, for split configs, ``sigma_level``.
The port keeps the same layouts (grids ``[x, y, z]`` channels last, MLP
weights ``(in, out)``), so conversion is a dtype and device move, and a
``model_pyramid.npz`` written by :func:`save_pyramid_npz` is read by both
packages (the JAX ``SwrTrainer.load_npz`` and :func:`load_pyramid_npz`).
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


def pyramid_params_to_numpy(params) -> Dict[str, Any]:
    """The port's pyramid params -> the JAX package's tree of fp32 numpy
    arrays, as the JAX trainer holds its params on the host."""

    def _n(t):
        return t.detach().to("cpu", torch.float32).numpy()

    return {
        "levels": [_n(g) for g in params["levels"]],
        "rgb_mlp": {k: _n(v) for k, v in params["rgb_mlp"].items()},
    }


def save_pyramid_npz(path: str, params) -> None:
    """Write ``model_pyramid.npz`` with train.py's keys, ``level_{i}`` and
    ``rgb_mlp_{name}`` (the port trains no split ``sigma_level``)."""
    tree = pyramid_params_to_numpy(params)
    np.savez(
        path,
        **{f"level_{i}": g for i, g in enumerate(tree["levels"])},
        **{f"rgb_mlp_{k}": v for k, v in tree["rgb_mlp"].items()},
    )
