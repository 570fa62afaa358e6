"""Per cent of the profiled sub-window's wall time in which the card ran no
kernel, copy or set: 1 - the union of the device intervals over the
sub-window.  Moves `train_rays_per_s`."""

from benchmark.harness.readers import idle


def read(r):
    return idle(r, "train")
