"""Traffic kind ``train``: a training job, step after step.

Set-up builds the configuration's trainer (``systems/<family>.py``) on the
benchmark's inputs, runs its first steps on checked draws (their losses,
first gradient and change are what the reference follows), warms up every
sweep case the views use, and settles where the mix asks.  The window then
runs steps until ``--seconds`` have passed and ends in a host read of the
last step's loss: ``train_rays_per_s`` is every ray trained in the window
over the window's wall time.  With ``--trace 1`` a fixed number of steps
from the middle of the window is profiled.  Once the window has closed and
the peak memory is read, the program's state is freed and the reference
follows the checked steps.
"""

from __future__ import annotations

import torch

from benchmark.harness import device as dev
from benchmark.harness import trace as tr
from benchmark.harness.session import Outcome, Run, release


def run(r: Run) -> Outcome:
    system = r.spec.system(r.config["family"])
    build_s = dev.build_kernels(system.TrainSession.kernels, r.device)
    sess = system.TrainSession(r.config, r.traffic, r.seed, r.device)
    sess.check_steps()
    sess.warm_up()
    dev.sync(r.device)
    dev.collect()
    t0 = dev.now()
    setup_s = t0 - r.t_start
    sub = tr.SubWindow(r.trace, int(r.traffic["trace_units"]),
                       0.5 * r.seconds, r.device)
    losses = []
    while dev.now() - t0 < r.seconds or sub.active:
        sub.before(dev.now() - t0, len(losses))
        losses.append(sess.step())
        sub.after()
    float(losses[-1])  # the window ends when the last step's loss is read
    t1 = dev.now()
    steps = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
    peak = dev.memory_peak(r.device)
    parsed = sub.finish()
    sess.release()
    release()
    checks = sess.check()
    limits = r.traffic["limits"]
    out = Outcome(
        attempted=steps, failed=failed,
        values={"train_rays_per_s": steps * sess.rays_per_step / (t1 - t0),
                "setup_s": setup_s},
        checks={k: (v, float(limits[k])) for k, v in checks.items()},
        memory_peak=peak, build_s=build_s)
    if parsed is not None:
        flops, context = sess.profiled(sub.first_unit, sub.count)
        out.reading = tr.reading(parsed, "train", sub.count, flops, context)
        out.breakdown = parsed.breakdown()
    return out
