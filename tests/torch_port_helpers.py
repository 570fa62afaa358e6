"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

Inputs are made with numpy from a seed and handed to both packages (the
JAX package as ``jnp`` arrays, the port as CPU tensors).  Importing this
module caps torch at 2 threads: the suite runs several pytest workers.
"""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(2)


def t32(a) -> torch.Tensor:
    """numpy (or jax) array -> fp32 CPU tensor (a copy)."""
    return torch.tensor(np.asarray(a, np.float32))


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def mlp_dims(input_dim, output_dim, depth, width, skip_layer=4):
    """(in, out) per layer, as ``MLPSpec.layer_dims`` lists them."""
    dims, fin = [], input_dim
    for i in range(depth):
        dims.append((fin, width))
        fin = width + input_dim if (skip_layer and i % skip_layer == 0
                                    and i > 0) else width
    dims.append((fin, output_dim))
    return dims


def numpy_pyramid_params(resolutions, level_features, rgb_width, rgb_depth,
                         seed=0, blob=0.0, radius=0.25):
    """Pyramid params as a numpy tree: levels ~ 1e-2 N(0, 1), Xavier-uniform
    rgb MLP (in, out), plus an optional gaussian density blob of amplitude
    ``blob`` and width ``radius`` on the finest level's channel 0."""
    rng = np.random.default_rng(seed)
    levels = [
        (1e-2 * rng.normal(size=(r, r, r, f))).astype(np.float32)
        for r, f in zip(resolutions, level_features)
    ]
    if blob:
        R = resolutions[-1]
        c = (np.arange(R) + 0.5) / R - 0.5
        xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
        r = np.sqrt(xx**2 + yy**2 + zz**2)
        levels[-1][..., 0] += (blob * np.exp(-((r / radius) ** 2))).astype(
            np.float32
        )
    mlp = {}
    for i, (fi, fo) in enumerate(
        mlp_dims(16 + level_features[0] - 1, 3, rgb_depth, rgb_width)
    ):
        a = np.sqrt(6.0 / (fi + fo))
        mlp[f"w{i}"] = rng.uniform(-a, a, (fi, fo)).astype(np.float32)
    return {"levels": levels, "rgb_mlp": mlp}


def jax_tree(tree):
    import jax.numpy as jnp

    return {
        "levels": [jnp.asarray(g) for g in tree["levels"]],
        "rgb_mlp": {k: jnp.asarray(v) for k, v in tree["rgb_mlp"].items()},
    }


def rand_sweep_inputs(seed=0, nc=2, dc=3, Rb=8, Rc=8, F=4, nq=8):
    """numpy copy of ``tests/test_swr_pallas.py:_rand_inputs``."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.3, 1.0, (nc, dc, F, Rb, Rc)).astype(np.float32)
    vol[np.abs(vol[:, :, 0:1].repeat(F, 2)) < 0.05] += 0.1
    rs = np.stack(
        [
            rng.uniform(-1.0, 1.0, (nc, dc)),
            rng.uniform(0.7, 1.3, (nc, dc)),
            rng.uniform(-1.0, 1.0, (nc, dc)),
            rng.uniform(0.7, 1.3, (nc, dc)),
        ],
        axis=-1,
    ).astype(np.float32)
    z_rel = np.linspace(1.0, 2.0, nc * dc, dtype=np.float32).reshape(nc, dc)
    ch = np.stack(
        [
            rng.uniform(-0.5, 0.0, nc),
            rng.uniform(0.01, 0.05, nc),
            rng.uniform(-0.5, 0.0, nc),
            rng.uniform(0.01, 0.05, nc),
            np.full(nc, 1.5),
            np.full(nc, 0.1),
        ],
        axis=-1,
    ).astype(np.float32)
    return vol, rs, z_rel, ch, nq
