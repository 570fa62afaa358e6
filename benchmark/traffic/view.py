"""Traffic kind ``view``: one interactive client of a served model.

Closed loop: the next frame is asked for once the last frame's rgb is on
the host; a frame's time runs from the request to that.  The poses are a
fixed set (the mix's orbit), visited in an order drawn from the seed, so
every seed renders the same frames.  ``frames_per_s`` is the frames of the
window over its wall time.  A traced run's reading also carries the 95th
percentile of the window's frame times, the profiled frames left out, for
the per-layer ``frame_ms_p95.view``.  One frame of each pose, its first or
second visit as the seed draws, is kept and, once the window has closed
and the program's state is freed, compared with the reference's frame of
that pose.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import device as dev
from benchmark.harness import trace as tr
from benchmark.harness.session import Outcome, Run, release


def run(r: Run) -> Outcome:
    system = r.spec.system(r.config["family"])
    build_s = dev.build_kernels(system.ViewSession.kernels, r.device)
    sess = system.ViewSession(r.config, r.traffic, r.seed, r.device)
    sess.warm_up()
    dev.sync(r.device)
    dev.collect()
    t0 = dev.now()
    setup_s = t0 - r.t_start
    sub = tr.SubWindow(r.trace, int(r.traffic["trace_units"]),
                       0.5 * r.seconds, r.device)
    times, kept = [], {}
    while dev.now() - t0 < r.seconds or sub.active:
        i = len(times)
        sub.before(dev.now() - t0, i)
        a = dev.now()
        rgb = sess.frame(i)
        times.append(dev.now() - a)
        sub.after()
        if sess.kept(i):
            kept[sess.pose_of(i)] = rgb
    t1 = dev.now()
    peak = dev.memory_peak(r.device)
    parsed = sub.finish()
    sess.release()
    release()
    gaps = sess.check(kept)
    limits = r.traffic["limits"]
    checks = {k: (max(v.values(), default=float("inf")), float(limits[k]))
              for k, v in gaps.items()}
    failed = sum(any(gaps[k][p] > float(limits[k]) for k in gaps)
                 for p in kept)
    out = Outcome(
        attempted=len(times), failed=failed,
        values={"frames_per_s": len(times) / (t1 - t0),
                "setup_s": setup_s},
        checks=checks, memory_peak=peak, build_s=build_s)
    if parsed is not None:
        flops, context = sess.profiled(sub.first_unit, sub.count)
        plain = times[:sub.first_unit] + times[sub.first_unit + sub.count:]
        context["frame_ms_p95"] = float(np.percentile(plain, 95)) * 1e3
        out.reading = tr.reading(parsed, "view", sub.count, flops, context)
        out.breakdown = parsed.breakdown()
    return out
