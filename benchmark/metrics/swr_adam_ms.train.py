"""Device ms a step of the pyramid's Adam update of every weight: the
kernels launched inside the program's span `swr.adam`
(`train/swr_step.py:apply_swr_grads`).  Moves `train_rays_per_s`."""

from benchmark.harness.readers import span_ms

SPAN = "swr.adam"


def read(r):
    return span_ms(r, "train", SPAN)
