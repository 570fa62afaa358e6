"""Device ms a step of the NGP step's backward: the kernels launched
inside the program's span `ngp.backward` (`train/step.py:loss_and_grads`),
which opens and closes on the thread that runs the backward, autograd's
device thread on the card.  Moves `train_rays_per_s`."""

from benchmark.harness.readers import span_ms

SPAN = "ngp.backward"


def read(r):
    return span_ms(r, "train", SPAN)
