"""Device ms a step of the NGP march (the box, the cell-interval probes
of the bitfield, the compaction to the sample cap): the kernels launched
inside the program's span `ngp.march` (`render/renderer.py:render_train`).
Moves `train_rays_per_s`."""

from benchmark.harness.readers import span_ms

SPAN = "ngp.march"


def read(r):
    return span_ms(r, "train", SPAN)
