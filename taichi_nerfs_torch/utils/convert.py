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

    tree = {
        "levels": [_n(g) for g in params["levels"]],
        "rgb_mlp": {k: _n(v) for k, v in params["rgb_mlp"].items()},
    }
    if "sigma_level" in params:
        tree["sigma_level"] = _n(params["sigma_level"])
    return tree


def save_pyramid_npz(path: str, params) -> None:
    """Write ``model_pyramid.npz`` with train.py's keys: ``level_{i}``,
    ``rgb_mlp_{name}`` and, for a split config, ``sigma_level``."""
    tree = pyramid_params_to_numpy(params)
    extra = {"sigma_level": tree["sigma_level"]} if "sigma_level" in tree \
        else {}
    np.savez(
        path,
        **{f"level_{i}": g for i, g in enumerate(tree["levels"])},
        **{f"rgb_mlp_{k}": v for k, v in tree["rgb_mlp"].items()},
        **extra,
    )


# ------------------------------------------------------------------ NGP
#
# The JAX package's NGP params are ``{"hash_table": (F, n)}`` or
# ``{"brick": {"corners", "bricks"}}`` plus ``"xyz_mlp"`` and ``"rgb_mlp"``
# weight dicts; the port keeps the same tree.  The occupancy bitfield is
# uint32 there and int32 with the same bits here.  ``model.npz`` is the JAX
# ``utils/checkpoint.py`` file: params, the state of its Adam on a cosine
# schedule, the occupancy grid, the random key and the step, under its key
# names.


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


def save_ngp_npz(path: str, state, step: int = 0, seed: int = 0) -> None:
    """Write ``model.npz`` with the keys of the JAX ``save_checkpoint``:

    * ``params/<path>``: the params;
    * ``opt/0/0``: Adam's count (int32); ``opt/0/1/<path>`` and
      ``opt/0/2/<path>``: its moments mu and nu; ``opt/1/0``: the
      schedule's count (int32), as the JAX optimizer (Adam chained with
      a schedule) keeps them;
    * ``occ/...``: the occupancy grid (the bitfield as uint32);
    * ``rng``: uint32 key data of shape (2,).  The port draws from torch
      generators, whose state JAX cannot continue, so it writes the key of
      ``jax.random.PRNGKey(seed)``, ``(0, seed)``: a JAX run resumed from
      the file draws a stream of its own from the run's seed;
    * ``__step__``.

    ``state`` is a ``train.state.TrainState``.
    """
    opt = state.opt_state
    out: dict = {
        "__step__": np.asarray(step),
        "opt/0/0": np.asarray(opt.count, np.int32),
        "opt/1/0": np.asarray(opt.sched_count, np.int32),
        "rng": np.asarray([0, seed], np.uint32),
    }
    _flat(ngp_params_to_numpy(state.params), "params", out)
    _flat(ngp_params_to_numpy(opt.mu), "opt/0/1", out)
    _flat(ngp_params_to_numpy(opt.nu), "opt/0/2", out)
    _flat(occupancy_to_numpy(state.occupancy), "occ", out)
    np.savez(path, **out)


def _tree(d, prefix: str) -> Dict[str, Any]:
    """The arrays of ``d`` under ``prefix/``, as a tree of dicts."""
    tree: Dict[str, Any] = {}
    for key in d.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *parents, leaf = key[len(prefix) + 1:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = d[key]
    return tree


def load_ngp_npz(path: str, device=None):
    """Read ``(params, occupancy, step, opt_state)`` from a ``model.npz``
    written by either package.  ``opt_state`` is a ``train.state.AdamState``
    with Adam's moments and both counts, or None when the file has no
    ``opt/`` keys; the random key is not read (the port's draws come from
    torch generators)."""
    from ..train.state import AdamState

    with np.load(path) as d:
        params = ngp_params_from_numpy(_tree(d, "params"), device)
        occ = occupancy_from_numpy(d["occ/density_grid"], d["occ/count_grid"],
                                   d["occ/bitfield"], device)
        step = int(d["__step__"])
        opt = None
        if "opt/0/0" in d.files:
            opt = AdamState(
                count=int(d["opt/0/0"]), sched_count=int(d["opt/1/0"]),
                mu=ngp_params_from_numpy(_tree(d, "opt/0/1"), device),
                nu=ngp_params_from_numpy(_tree(d, "opt/0/2"), device))
    return params, occ, step, opt
