"""Real spherical-harmonics direction encoding (degree 4, 16 components).

Port of the JAX package's ``ops/sh.py:sh_encode``.  The SH basis constants
derive from the PlenOctree codebase (BSD 2-Clause,
https://github.com/sxyu/plenoctree/blob/master/LICENSE), as in the JAX
module.
"""

from __future__ import annotations

import torch

SH_OUT_DIM = 16


def sh_encode(dirs: torch.Tensor) -> torch.Tensor:
    """(..., 3) inputs -> (..., 16) degree-4 SH basis.

    The caller remaps unit directions to ``(d + 1) / 2`` first
    (instant-ngp convention), as the JAX version's callers do.
    """
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z

    return torch.stack(
        [
            torch.full_like(x, 0.28209479177387814),
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * x2 - 0.54627421529603959 * y2,
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ],
        dim=-1,
    )
