"""Device ms a frame of the pyramid renderer's final warp: the kernels
launched inside the program's span `swr.warp` (`render/swr.py`).  Moves
`frames_per_s`."""

from benchmark.harness.readers import span_ms

SPAN = "swr.warp"


def read(r):
    return span_ms(r, "view", SPAN)
