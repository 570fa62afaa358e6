"""Device ms a step of the NGP field at the step's packed samples (the
encoding, both MLPs, the SH): the kernels launched inside the program's span
`ngp.field` (`render/renderer.py:render_train`).  Moves `train_rays_per_s`."""

from benchmark.harness.readers import span_ms

SPAN = "ngp.field"


def read(r):
    return span_ms(r, "train", SPAN)
