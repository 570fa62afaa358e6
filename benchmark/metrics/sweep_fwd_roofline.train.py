"""The sweep forward's share of its roofline: the least time of the
profiled steps' sweep calls at their inputs (`counts/sweep.py:sweep_needed`:
each slab's source window that its lattice's taps reach, read once; the
frames written once) over the device time of
every launch of the kernel `swr_sweep_fwd_kernel` (`csrc/swr_sweep_fwd.cu`).
Moves `train_rays_per_s`."""

from benchmark.harness.readers import roofline

KERNELS = (r"swr_sweep_fwd_kernel",)


def read(r):
    return roofline(r, "train", KERNELS, "sweep_fwd_bound_ms")
