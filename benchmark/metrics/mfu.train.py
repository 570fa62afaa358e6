"""The whole step's share of the card's peak: the time the algorithm's
operations (`counts/flops.py`, each term at the published peak of the
precision it runs in) would take, over the profiled wall time.  Moves
`train_rays_per_s`."""

from benchmark.harness.readers import mfu


def read(r):
    return mfu(r, "train")
