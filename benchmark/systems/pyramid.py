"""The dense pyramid on the shear-warp renderer: what the pyramid cells
drive of the program, the inputs they give it, and the comparison with
the plain reference (``benchmark/reference/pyramid.py``).

Inputs are the benchmark's own, made from the run's seed: the lego scene's
ground truth (``benchmark/scene/lego.py``), the weights (made on the device
in one call a leaf) and every draw of a step (view, crop, background, TV
window).  The program gets them through its public entries
(``SwrTrainer.run_step(draw)``, ``PyramidRenderer``); the reference gets
the same and works out everything the program derives (the bake, the
crops' geometry, the warps) again.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List

import numpy as np
import torch

from benchmark.counts import flops as fl
from benchmark.counts.sweep import sweep_needed
from benchmark.harness.device import seeds
from benchmark.reference.pyramid import (PyramidReference, fp32_matmuls,
                                         sweep_axis)
from benchmark.scene import lego

B1 = 0.9


def reference_cfg(config: dict) -> dict:
    m, t = config["model"], config["train"]
    return {**m, "n_chunks": t["n_chunks"],
            "resample_kind": t["resample_kind"]}


def make_params(config: dict, seed: int, device) -> Dict:
    """The pyramid's weights from ``seed``, on ``device``: every level
    ~ 1e-2 N(0, 1) and the rgb MLP Xavier-uniform (stored (in, out)), each
    leaf one call of a generator on the device."""
    m = config["model"]
    F = int(m["features"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    levels = [1e-2 * torch.randn((r, r, r, F), generator=gen, device=device)
              for r in m["resolutions"]]
    mlp = {}
    for i, (fi, fo) in enumerate(fl.pyramid_mlp_dims(m)):
        u = torch.rand((fi, fo), generator=gen, device=device)
        mlp[f"w{i}"] = (2.0 * u - 1.0) * float(np.sqrt(6.0 / (fi + fo)))
    return {"levels": levels, "rgb_mlp": mlp}


def leaves(params) -> Dict[str, torch.Tensor]:
    """Named leaves: ``levels.<i>`` and ``rgb_mlp.w<i>``."""
    out = {f"levels.{i}": g for i, g in enumerate(params["levels"])}
    out.update({f"rgb_mlp.{k}": v for k, v in sorted(params["rgb_mlp"].items())})
    return out


def worst_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> float:
    """The widest gap between a leaf's norm in the program and in the
    reference, over the larger of that leaf's reference norm and the
    median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


def program_configs(config: dict):
    from taichi_nerfs_torch.models.pyramid import PyramidConfig
    from taichi_nerfs_torch.train.swr_step import SwrTrainConfig

    m = dict(config["model"])
    for k in ("resolutions", "level_features"):
        m[k] = tuple(m[k])
    t = dict(config["train"])
    t["prog_steps"] = tuple(t["prog_steps"])
    return PyramidConfig(**m), SwrTrainConfig(**t)


@dataclasses.dataclass
class Draw:
    i: int
    crop_xy: tuple
    bg: torch.Tensor
    tv_starts: tuple


class Draws:
    """A stream of step draws: a view and a crop from a host generator, the
    (crop^2, 3) background from one on the device, the finest level's TV
    window start from the host one."""

    def __init__(self, n_views: int, img_wh, crop: int, r_fine: int,
                 seed: int, device):
        self.n, (self.w, self.h), self.c = n_views, img_wh, crop
        self.tv_hi = r_fine - max(r_fine // 4, 2) + 1
        ss = seeds(seed, 2)
        self.rng = np.random.RandomState(ss[0])
        self.gen = torch.Generator(device=device).manual_seed(ss[1])
        self.device = device

    def next(self, i: int | None = None) -> Draw:
        if i is None:
            i = int(self.rng.randint(self.n))
        x0 = int(self.rng.randint(max(self.w - self.c, 0) + 1))
        y0 = int(self.rng.randint(max(self.h - self.c, 0) + 1))
        tv = (int(self.rng.randint(self.tv_hi)),)
        bg = torch.rand((self.c * self.c, 3), generator=self.gen,
                        device=self.device)
        return Draw(i, (x0, y0), bg, tv)

    def distinct(self, k: int) -> List[Draw]:
        """``k`` draws on ``k`` different views."""
        views = self.rng.choice(self.n, size=k, replace=False)
        return [self.next(int(i)) for i in views]


class Cycle(Draws):
    """The window's draws: a fixed set of ``k`` (view, crop) pairs, each
    view as often (drawn once from ``RandomState(0)``, the same for every
    seed), visited over and over in an order drawn from the seed; the
    background and TV window of each step from the seed.  Every seed's
    window does the same work in another order."""

    def __init__(self, k: int, *args):
        super().__init__(*args)
        fixed = np.random.RandomState(0)
        views = np.arange(k) % self.n
        self.pairs = [(int(i), int(fixed.randint(max(self.w - self.c, 0) + 1)),
                       int(fixed.randint(max(self.h - self.c, 0) + 1)))
                      for i in views]
        self.order = self.rng.permutation(k)
        self.j = 0

    def next(self, i: int | None = None) -> Draw:
        if i is not None:
            return super().next(i)
        v, x0, y0 = self.pairs[self.order[self.j % len(self.order)]]
        self.j += 1
        tv = (int(self.rng.randint(self.tv_hi)),)
        bg = torch.rand((self.c * self.c, 3), generator=self.gen,
                        device=self.device)
        return Draw(v, (x0, y0), bg, tv)


class TrainSession:
    """``SwrTrainer`` at the record recipe (the configuration's ``train``),
    on the lego views, its weights and draws the benchmark's."""

    kernels = ("swr_sweep_fwd", "swr_sweep_bwd")

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from taichi_nerfs_torch.train.swr_step import SwrTrainer

        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.s_weights, self.s_check, s_window, s_trainer = seeds(seed, 4)
        sc = config["scene"]
        w, h = sc["img_wh"]
        self.img_wh = (w, h)
        self.K = lego.intrinsics(w, h)
        self.poses = lego.train_poses(sc["n_views"], sc["radius"])
        rgb, alpha = lego.render_gt(self.poses, self.K, w, h, sc["gt_steps"],
                                    sc["gt_ss"], device=self.device)
        rgba = torch.cat([rgb, alpha[..., None]], dim=-1)
        self.gt_u8 = torch.clamp(rgba * 255.0 + 0.5, 0, 255).to(
            torch.uint8).reshape(-1, h, w, 4)
        del rgb, alpha, rgba
        host = (self.gt_u8.float() / 255.0).cpu().numpy()
        mcfg, tcfg = program_configs(config)
        self.trainer = SwrTrainer(
            mcfg, tcfg, host[..., :3].reshape(len(host), h * w, 3),
            self.poses, self.K, (w, h), seed=s_trainer, device=self.device,
            alphas=host[..., 3].reshape(len(host), h * w))
        del host
        if not torch.equal(self.trainer.images, self.gt_u8):
            raise RuntimeError("the trainer's 8-bit images differ from the "
                               "benchmark's")
        with torch.no_grad():
            mine = leaves(make_params(config, self.s_weights, self.device))
            for k, p in leaves(self.trainer.state.params).items():
                p.copy_(mine[k])
        del mine
        self.crop = int(config["train"]["crop"])
        self.R = int(config["model"]["resolutions"][-1])
        self.rays_per_step = self.crop * self.crop
        self.window_draws = Cycle(int(traffic["cycle"]), len(self.poses),
                                  self.img_wh, self.crop, self.R, s_window,
                                  self.device)
        self.drawn = []  # (view, crop) of every step of the window
        self.prog = None

    def _checked_draws(self) -> List[Draw]:
        return Draws(len(self.poses), self.img_wh, self.crop, self.R,
                     self.s_check, self.device).distinct(
                         int(self.traffic["check_steps"]))

    def _run(self, d: Draw):
        from taichi_nerfs_torch.train.swr_step import SwrDraw

        return self.trainer.run_step(SwrDraw(d.i, d.crop_xy, d.bg,
                                             d.tv_starts, None))["loss"]

    def check_steps(self) -> None:
        """The first steps, through the window's call, on checked draws:
        each loss, the first gradient (from Adam's first moment after one
        step, kept on the host) and the change of every leaf after the
        last."""
        losses, g1 = [], None
        for k, d in enumerate(self._checked_draws()):
            losses.append(self._run(d))
            if k == 0:
                g1 = {n: (m.float() / (1.0 - B1)).cpu() for n, m in
                      leaves(self.trainer.state.opt_state.mu).items()}
        p0 = leaves(make_params(self.config, self.s_weights, self.device))
        with torch.no_grad():
            change = {k: float(torch.linalg.vector_norm(p - p0[k]))
                      for k, p in leaves(self.trainer.state.params).items()}
        del p0
        self.prog = ([float(x) for x in losses], g1, change)

    def warm_up(self) -> None:
        """One step on a view of every (axis, direction) the views sweep."""
        seen = set()
        for i, pose in enumerate(self.poses):
            case = sweep_axis(pose)
            if case not in seen:
                seen.add(case)
                self._run(self.window_draws.next(i))

    def step(self):
        d = self.window_draws.next()
        self.drawn.append((d.i, d.crop_xy))
        return self._run(d)

    def profiled(self, first: int, n: int):
        """The operations and the sweep calls' least times of window steps
        ``first`` .. ``first + n - 1``, from the reference's geometry of
        their crops: ``(flops, context)``."""
        ref = PyramidReference(reference_cfg(self.config))
        F, R, nq = int(self.config["model"]["features"]), self.R, 0
        kind = self.config["train"]["resample_kind"]
        totals = {}
        fwd_ms = bwd_ms = 0.0
        for i, xy in self.drawn[first:first + n]:
            g = ref.crop_geometry(self.poses[i], self.K, xy, self.crop,
                                  self.device)
            nq = g["nq"]
            f = sweep_needed(g["rs_par"], F, R, R, nq, kind)
            b = sweep_needed(g["rs_par"], F, R, R, nq, kind, backward=True)
            fwd_ms, bwd_ms = fwd_ms + f[0], bwd_ms + b[0]
            for name, fl_, prec in fl.pyramid_step(
                    self.config["model"], self.config["train"], f[3], b[3]):
                totals[(name, prec)] = totals.get((name, prec), 0.0) + fl_
        flops = [(name, f, prec) for (name, prec), f in totals.items()]
        return flops, {"sweep_fwd_bound_ms": fwd_ms,
                       "sweep_bwd_bound_ms": bwd_ms}

    def release(self) -> None:
        self.trainer = None

    def reference(self, tf32: bool = False):
        """The reference's readings: each step's loss, the first gradient
        (a leaf) and the change's norm a leaf."""
        fp32_matmuls()
        ref = PyramidReference(reference_cfg(self.config), tf32=tf32)
        tcfg = self.config["train"]
        params = make_params(self.config, self.s_weights, self.device)
        named = leaves(params)
        p0 = {k: v.clone() for k, v in named.items()}
        for v in named.values():
            v.requires_grad_(True)
        order = list(named)
        mu = [torch.zeros_like(v) for v in named.values()]
        nu = [torch.zeros_like(v) for v in named.values()]
        losses, g1 = [], None
        for k, d in enumerate(self._checked_draws()):
            loss, _ = ref.loss(params, self.gt_u8[d.i], self.poses[d.i],
                               self.K, d.crop_xy, d.bg, d.tv_starts, tcfg)
            grads = torch.autograd.grad(loss, [named[n] for n in order])
            losses.append(float(loss.detach()))
            if k == 0:
                g1 = {n: g.detach().clone() for n, g in zip(order, grads)}
            ref.adam([named[n] for n in order], grads, mu, nu, k + 1, tcfg)
            del grads, loss
        change = {n: float(torch.linalg.vector_norm(named[n].detach() - p0[n]))
                  for n in order}
        return losses, g1, change

    @staticmethod
    def compare(prog, ref) -> Dict[str, float]:
        """The numbers compared: the widest relative gap of a step's loss;
        the worst leaf's gap of the first gradient's norm and of the
        change's norm, each over the larger of the leaf's reference norm
        and the median leaf's; and the median leaf's norm of the first
        gradient's difference over its reference norm (the number that
        separates the control: the rgb MLP's bf16 operands put the same
        rounding noise into its own leaves on both sides, the fp32 path
        into the levels' does not).  Leaves whose reference gradient is
        under a thousandth of the median leaf's are left out of the change
        and of the difference."""
        (pl, pg, pc), (rl, rg, rc) = prog, ref
        rn = {k: float(torch.linalg.vector_norm(v)) for k, v in rg.items()}
        pn = {k: float(torch.linalg.vector_norm(v.float())) for k, v in
              pg.items()}
        med = statistics.median(rn.values())
        moved = [k for k, v in rn.items() if v >= 1e-3 * med]
        diff = [float(torch.linalg.vector_norm(
            pg[k].to(rg[k].device).float() - rg[k])) / rn[k] for k in moved]
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(pl, rl)),
            "grad_gap": worst_gap(pn, rn),
            "change_gap": worst_gap(pc, rc, set(moved)),
            "grad_diff_median": statistics.median(diff),
        }

    def check(self) -> Dict[str, float]:
        return self.compare(self.prog, self.reference())

    def control(self) -> Dict[str, float]:
        return self.compare(self.reference(tf32=True), self.reference())


def view_params(config: dict, seed: int, device) -> Dict:
    """The served model: :func:`make_params`, then the finest level's
    density logit set from the lego density field (so that the bake's
    sigma is the scene's: empty space empty, the early exit as on a trained
    model)."""
    params = make_params(config, seed, device)
    m = config["model"]
    R = int(m["resolutions"][-1])
    dens = lego.density_grid(R, device=device)
    params["levels"][-1][..., 0] = (torch.log(torch.clamp(dens, min=1e-8))
                                    - float(m["sigma_bias"]))
    return params


def orbit(traffic: dict) -> np.ndarray:
    """The viewer's poses: the mix's ``orbit`` of the lego rig (its
    ``views``, ``radius``, ``rig_seed``, ``elevation`` range and azimuth
    ``jitter``)."""
    o = traffic["orbit"]
    return lego.rig_poses(int(o["views"]), float(o["radius"]),
                          int(o["rig_seed"]),
                          tuple(float(e) for e in o["elevation"]),
                          float(o["jitter"]))


class ViewSession:
    """``PyramidRenderer`` serving a seeded model of the lego scene to one
    client, frame after frame, over a fixed set of orbit poses in an order
    drawn from the seed."""

    kernels = ("swr_sweep_fwd",)

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from taichi_nerfs_torch.render.serve import PyramidRenderer

        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        s_weights, s_order, s_keep = seeds(seed, 3)
        w, h = traffic["img_wh"]
        self.img_wh = (w, h)
        self.K = lego.intrinsics(w, h)
        self.poses = orbit(traffic)
        self.order = np.random.RandomState(s_order).permutation(len(self.poses))
        # each pose's frame that is kept for the check: its first or second
        self.keep_round = np.random.RandomState(s_keep).randint(
            0, 2, len(self.poses))
        self.params = view_params(config, s_weights, self.device)
        mcfg, tcfg = program_configs(config)
        self.lat_cap = traffic["lat_cap"]
        self.renderer = PyramidRenderer(
            self.params, mcfg, self.K, self.img_wh,
            resample_kind=tcfg.resample_kind)
        R = int(config["model"]["resolutions"][-1])
        self.nq = (int(1.25 * R) + 16 if self.lat_cap == "auto"
                   else max(w, h) + 16)
        self.geometry = {}

    def pose_of(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def frame(self, i: int) -> torch.Tensor:
        out = self.renderer.render(self.poses[self.pose_of(i)],
                                   lat_cap=self.lat_cap,
                                   early_exit=float(self.traffic["early_exit"]))
        return out["rgb"].cpu()

    def kept(self, i: int) -> bool:
        """Whether frame ``i`` is its pose's kept frame."""
        n = len(self.order)
        return i // n == self.keep_round[self.pose_of(i)]

    def warm_up(self) -> None:
        for i in range(len(self.order)):
            self.frame(i)

    def release(self) -> None:
        self.renderer = None

    def reference(self, pose_ids, tf32: bool = False) -> Dict[int, torch.Tensor]:
        """The reference's frame of each pose (rgb on the host); keeps each
        pose's sweep geometry and the chunks an early exit needs."""
        fp32_matmuls()
        ref = PyramidReference(reference_cfg(self.config), tf32=tf32)
        cap = self.nq if self.lat_cap == "auto" else None
        out = {}
        with torch.no_grad():
            grid = ref.bake(self.params)
            for p in pose_ids:
                r = ref.render(self.params, grid, self.poses[p], self.K,
                               self.img_wh, lat_cap=cap)
                out[p] = r["rgb"].cpu()
                if not tf32:
                    self.geometry[p] = (r["rs_par"], r["needed"])
        return out

    @staticmethod
    def compare(frames: Dict[int, torch.Tensor],
                ref: Dict[int, torch.Tensor]) -> Dict[str, Dict[int, float]]:
        """Per frame: the root mean square gap of the rgb values (a frame
        that is not finite reads infinity)."""
        out = {"rgb_rms_gap": {}}
        for p, rgb in frames.items():
            d = rgb.float() - ref[p]
            bad = not torch.isfinite(rgb).all()
            out["rgb_rms_gap"][p] = (float("inf") if bad
                                     else float(torch.sqrt((d * d).mean())))
        return out

    def check(self, frames: Dict[int, torch.Tensor]):
        return self.compare(frames, self.reference(list(frames)))

    def control(self):
        ids = list(range(len(self.poses)))
        return self.compare(self.reference(ids, tf32=True),
                            self.reference(ids))

    def profiled(self, first: int, n: int):
        """The operations and the sweep calls' least times of frames
        ``first`` .. ``first + n - 1``: each frame's needed chunks at their
        geometry (the reference's).  Returns ``(flops, context)``."""
        poses = [self.pose_of(i) for i in range(first, first + n)]
        missing = sorted(set(poses) - set(self.geometry))
        if missing:
            self.reference(missing)
        m = self.config["model"]
        F, R = int(m["features"]), int(m["resolutions"][-1])
        kind = self.config["train"]["resample_kind"]
        w, h = self.img_wh
        totals, fwd_ms = {}, 0.0
        for p in poses:
            rs_par, needed = self.geometry[p]
            ms = flops = 0.0
            for g in needed:
                b = sweep_needed(rs_par[g:g + 1], F, R, R, self.nq, kind)
                ms, flops = ms + b[0], flops + b[3]
            fwd_ms += ms
            for name, f, prec in fl.pyramid_frame(m, w, h, self.nq, kind,
                                                  len(needed), flops):
                totals[(name, prec)] = totals.get((name, prec), 0.0) + f
        return ([(name, f, prec) for (name, prec), f in totals.items()],
                {"sweep_fwd_bound_ms": fwd_ms})
