"""The brick encoder's share of its roofline: its least time at the
profiled steps' own samples and refresh probes (`counts/ngp.py:
encode_bound`: the positions read, each distinct table row or corner entry
they touch read once and, in a training step, its gradient written once;
the 8-corner multiply-adds forward and backward) over the device time of
the kernels launched inside the program's span `ngp.encode` (the forward in
`models/ngp.py:_encode_position`, the backward in
`ops/brick_encoder.py:_BrickEncode.backward`, on autograd's thread).
Moves `train_rays_per_s`."""

from benchmark.harness.readers import span_ms

SPAN = "ngp.encode"


def read(r):
    ms = span_ms(r, "train", SPAN)
    if ms is None or "ngp_encode_bound_ms" not in r.context:
        return None
    return 100.0 * r.context["ngp_encode_bound_ms"] / (ms * r.units)
