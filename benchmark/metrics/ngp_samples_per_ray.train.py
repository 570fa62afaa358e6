"""Samples the march gives a ray in the profiled steps (the program's own
counter `rm_samples` of `render/renderer.py:render_train`: every one of
them is evaluated by the field and composited), over the steps' rays.  The
count that shows whether a later speed-up came from doing less work.
Moves `train_rays_per_s`."""


def read(r):
    if r is None or r.kind != "train" or r.units <= 0:
        return None
    return r.context.get("ngp_samples_per_ray")
