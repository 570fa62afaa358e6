"""Kernel launches a frame: every kernel event of the profiled
sub-window over the units profiled.  Moves `frames_per_s`."""

from benchmark.harness.readers import launches


def read(r):
    return launches(r, "view")
