"""Model parameters between the JAX package's layouts and the port's:
the pyramid (below) and the NGP path (params and occupancy, at the end).

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


# ------------------------------------------------------------------ NGP
#
# The JAX package's NGP params are ``{"hash_table": (F, n)}`` or
# ``{"brick": {"corners", "bricks"}}`` plus ``"xyz_mlp"`` and ``"rgb_mlp"``
# weight dicts; the port keeps the same tree.  The occupancy bitfield is
# uint32 there and int32 with the same bits here.  ``model.npz`` uses the
# key names of the JAX ``utils/checkpoint.py`` (``params/...``,
# ``occ/...``, ``__step__``); the optimizer moments are not written (the
# JAX optimizer's layout is ROADMAP 'Modules to port' item 8).


def ngp_params_from_numpy(tree: Dict[str, Any], device=None):
    """JAX NGP params (numpy leaves) -> the port's dict of fp32 tensors."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _t(x, device)

    return conv(tree)


def ngp_params_to_numpy(params) -> Dict[str, Any]:
    """The port's NGP params -> a tree of fp32 numpy arrays."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return x.detach().to("cpu", torch.float32).numpy()

    return conv(params)


def occupancy_from_numpy(density_grid, count_grid, bitfield, device=None):
    """JAX occupancy arrays (the bitfield uint32) -> the port's
    ``OccupancyGrid`` (the bitfield int32, same bits)."""
    from ..models.occupancy import OccupancyGrid

    words = np.ascontiguousarray(np.asarray(bitfield, np.uint32))
    return OccupancyGrid(
        density_grid=_t(density_grid, device),
        count_grid=_t(count_grid, device),
        bitfield=torch.tensor(words.view(np.int32), device=device),
    )


def occupancy_to_numpy(occ) -> Dict[str, np.ndarray]:
    """The port's ``OccupancyGrid`` -> numpy, the bitfield as uint32."""
    return {
        "density_grid": occ.density_grid.cpu().numpy(),
        "count_grid": occ.count_grid.cpu().numpy(),
        "bitfield": occ.bitfield.cpu().numpy().view(np.uint32),
    }


def _flat(tree, prefix: str, out: dict):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], f"{prefix}/{k}", out)
    else:
        out[prefix] = tree


def save_ngp_npz(path: str, params, occupancy, step: int = 0) -> None:
    """Write ``model.npz``: ``params/...``, ``occ/...`` and ``__step__``."""
    out: dict = {"__step__": np.asarray(step)}
    _flat(ngp_params_to_numpy(params), "params", out)
    _flat(occupancy_to_numpy(occupancy), "occ", out)
    np.savez(path, **out)


def load_ngp_npz(path: str, device=None):
    """Read ``(params, occupancy, step)`` from a ``model.npz`` written by
    either package (the JAX one's optimizer state and key are skipped)."""
    with np.load(path) as d:
        params: Dict[str, Any] = {}
        for key in d.files:
            if not key.startswith("params/"):
                continue
            node = params
            *parents, leaf = key.split("/")[1:]
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = d[key]
        occ = occupancy_from_numpy(d["occ/density_grid"], d["occ/count_grid"],
                                   d["occ/bitfield"], device)
        step = int(d["__step__"])
    return ngp_params_from_numpy(params, device), occ, step
