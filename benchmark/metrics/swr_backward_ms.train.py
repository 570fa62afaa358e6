"""Device ms a step of the pyramid step's backward: the kernels launched
inside the program's span `swr.backward` (`train/swr_step.py:loss_and_grads`),
which opens and closes on the thread that runs the backward, autograd's
device thread on the card.  Moves `train_rays_per_s`."""

from benchmark.harness.readers import span_ms

SPAN = "swr.backward"


def read(r):
    return span_ms(r, "train", SPAN)
