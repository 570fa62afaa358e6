"""The sweep backward's share of its roofline: the least time of the
profiled steps' backward calls at their inputs (`counts/sweep.py:
sweep_needed(..., backward=True)`: each slab's reached source window read,
the whole gradient volume written, the frames' tau and the cotangent read
once) over the device time of every launch of `swr_sweep_bwd_kernel` and,
where it runs (a bf16 volume or operands), `swr_sweep_bwd_rows_kernel`
(`csrc/swr_sweep_bwd.cu`).  Moves `train_rays_per_s`."""

from benchmark.harness.readers import roofline

KERNELS = (r"swr_sweep_bwd_kernel", r"swr_sweep_bwd_rows_kernel")


def read(r):
    return roofline(r, "train", KERNELS, "sweep_bwd_bound_ms")
