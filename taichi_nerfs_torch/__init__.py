"""taichi_nerfs_torch — the PyTorch / CUDA (Hopper) port of the JAX package.

The port mirrors the JAX package's layout (``ops/``, ``models/``,
``render/``, ``train/``, ``utils/``, ``data/``): each ported function keeps
its counterpart's path and name, so a test can hold one against the other.
It imports ``torch`` and ``numpy`` only.  Hand-written CUDA kernels live in
``csrc/`` and are built on first use by :mod:`taichi_nerfs_torch.ops._build`.

Ported so far: the pyramid model on the shear-warp renderer, serving
(``render/serve.py``) and training (``train/swr_step.py``), and the
sample-gather Instant-NGP path (hash and brick encoders, occupancy grid,
marching, compositing, ``train/loop.py:Trainer`` and the test-time
renderer ``render/renderer.py``), both behind ``python -m
taichi_nerfs_torch.train``, on one device or data-parallel on several
(``parallel/``, ``--num_devices``); ``entry.py`` is the counterpart of the
repository's ``__graft_entry__.py``.
"""
