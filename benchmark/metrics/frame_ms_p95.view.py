"""The 95th percentile of the window's frame times, in ms, the profiled
frames left out: the host's clock from the request to the rgb on the host.
Moves `frames_per_s`."""


def read(r):
    if r is None or r.kind != "view":
        return None
    return r.context.get("frame_ms_p95")
