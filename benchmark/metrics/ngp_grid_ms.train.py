"""Device ms a step of the NGP density-grid refresh (one step in 16:
about a million densities, the merge, the bitfield): the kernels launched
inside the program's span `ngp.grid` (`train/step.py:density_grid_step`).
Moves `train_rays_per_s`."""

from benchmark.harness.readers import span_ms

SPAN = "ngp.grid"


def read(r):
    return span_ms(r, "train", SPAN)
