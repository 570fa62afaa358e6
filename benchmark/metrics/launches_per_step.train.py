"""Kernel launches a training step: every kernel event of the profiled
sub-window over the units profiled.  Moves `train_rays_per_s`."""

from benchmark.harness.readers import launches


def read(r):
    return launches(r, "train")
