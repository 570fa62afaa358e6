"""taichi_nerfs_torch — the PyTorch / CUDA (Hopper) port of the JAX package.

The port mirrors the JAX package's layout (``ops/``, ``models/``,
``render/``, ``train/``, ``utils/``, ``data/``): each ported function keeps
its counterpart's path and name, so a test can hold one against the other.
It imports ``torch`` and ``numpy`` only.  Hand-written CUDA kernels live in
``csrc/`` and are built on first use by :mod:`taichi_nerfs_torch.ops._build`.

Ported so far: the pyramid model's serving path (bake, shear-warp sweep,
fold, pixel warp, deferred shading) — see ``render/serve.py``.
"""
