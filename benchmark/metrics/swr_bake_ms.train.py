"""Device ms a step of the pyramid's bake (the progressive upsample chain
to the R^3 x F grid): the kernels launched inside the program's span
`swr.bake` (`train/swr_step.py:make_swr_loss`; with the bake checkpointed,
its recomputation in the backward too).  Moves `train_rays_per_s`."""

from benchmark.harness.readers import span_ms

SPAN = "swr.bake"


def read(r):
    return span_ms(r, "train", SPAN)
