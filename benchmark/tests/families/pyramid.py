"""The dense pyramid on the CPU: its tiny sizes, the tiny limits of its
mixes and the faults its cells can have."""

from __future__ import annotations

import torch

from benchmark.tests.tiny import patched

TINY_MODEL = {"resolutions": [8, 16], "level_features": [8, 8]}
TINY_TRAIN = {"crop": 16, "n_chunks": 4}
TINY_SCENE = {"n_views": 4, "img_wh": [24, 24], "gt_steps": 24, "gt_ss": 1}
TINY_VIEW = {"img_wh": [24, 24],
             "orbit": {"views": 6, "radius": 1.2, "rig_seed": 1,
                       "elevation": [0.06, 1.15], "jitter": 0.3},
             "trace_units": 2}
# The CPU runs the plain sweep on both sides, so only rounding separates
# the program from the reference; the TF32 control and the faults read
# above each limit.
LIMITS = {
    # a step's loss: fp32 sums in another order
    "loss_gap": 1e-4,
    # the first gradient's worst leaf: the same sums, through one backward
    "grad_gap": 1e-4,
    # the change after the checked steps: Adam carries the rounding along
    "change_gap": 1e-4,
    # a frame's rgb: one forward, no gradient, so tighter than the steps'
    "rgb_rms_gap": 1e-5,
    # the median leaf's gradient difference: the number TF32 fails
    "grad_diff_median": 1e-4,
}


def shrink_config(cfg: dict) -> dict:
    cfg["model"].update(TINY_MODEL)
    cfg["train"].update(TINY_TRAIN)
    cfg["scene"].update(TINY_SCENE)
    return cfg


def shrink_traffic(t: dict) -> dict:
    if t["kind"] == "view":
        t.update(TINY_VIEW)
    return t


class _HalfMean:
    """``torch`` for one module, whose ``mean`` of a crop's rows takes the
    first half of them only."""

    def __init__(self, rows):
        self.rows = rows

    def __getattr__(self, name):
        return getattr(torch, name)

    def mean(self, x, *a, **k):
        if x.dim() >= 1 and x.shape[0] == self.rows:
            x = x[: self.rows // 2]
        return torch.mean(x, *a, **k)


def faults(spec, cell):
    """The faults this cell can have, each a context that plants it."""
    import taichi_nerfs_torch.render.serve as serve
    import taichi_nerfs_torch.train.swr_step as swr_step

    kind = spec.traffic(spec.cell(cell)["traffic"])["kind"]
    if kind == "train":
        crop = spec.config(spec.cell(cell)["config"])["train"]["crop"]

        def unchanged(self, draw=None):
            return {"loss": torch.tensor(0.5), "psnr": torch.tensor(3.0)}

        return {
            "state unchanged": patched(swr_step.SwrTrainer, "run_step",
                                       unchanged),
            "half the batch": patched(swr_step, "torch",
                                      _HalfMean(crop * crop)),
        }
    orig = serve.PyramidRenderer.render

    def altered(self, *a, **k):
        out = orig(self, *a, **k)
        out["rgb"] = out["rgb"].clone()
        out["rgb"][7] += 0.05
        return out

    def half(self, *a, **k):
        out = orig(self, *a, **k)
        n = out["rgb"].shape[0]
        out["rgb"] = out["rgb"].clone()
        out["rgb"][n // 2:] = 1.0
        return out

    return {"an answer altered": patched(serve.PyramidRenderer, "render",
                                         altered),
            "half the frame": patched(serve.PyramidRenderer, "render", half)}
