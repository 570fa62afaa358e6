"""Training on the shear-warp renderer: image-crop SGD on the dense pyramid.

Port of the JAX package's ``train/swr_step.py`` for cameras outside the
scene cube on one device.  Each step draws a training image and a square
crop (a crop of a pinhole image is a pinhole image with a shifted principal
point), renders the crop with :func:`render_swr_fixed_axis`, and takes the
MSE against the ground truth plus the opacity, distortion, sigma-L1 and
per-level TV terms.  Deferred shading on an unsplit grid with full-matrix
resamples (the defaults, linear or cubic) runs the hand-written sweep
kernels on the card (``ops/swr_sweep.py``); per-sample shading, a split
``sigma_res`` grid, the distortion loss and a windowed resample run the
renderer's slab scan.  Linear training picks its slab window per phase as
the JAX trainer does (:func:`slab_window_bound`).

Randomness.  Every random input of the loss is an argument of
:func:`make_swr_loss`: the crop offset, the random background ``(c^2, 3)``
and the TV window starts (one per windowed level: the finest level, and
the sigma level of a split grid).  :class:`SwrTrainer` draws the image and
the crop with ``np.random.RandomState(seed)`` in the JAX trainer's call
order (so both packages pick the same crops), the background from a
``torch.Generator`` on the training device and the TV windows from one on
the host.

Adam is ``train/state.py:Adam`` (one count for bias correction, one for
the cosine schedule, as the JAX optimizer keeps them), shared with the NGP
trainer.

bf16, as the JAX trainer: ``bake_dtype="bfloat16"`` bakes in bf16 inside
the loss (checkpointed at ``grid_res >= 384``, as JAX remats it) and for
:meth:`SwrTrainer.render`; ``resample_dtype`` sets the loss's resample
operands; ``adam_mu_bf16`` keeps Adam's first moment in bf16.

Out of scope (each raises ``NotImplementedError`` naming its ROADMAP item):
inside cameras and ``cam_carve`` (item 10.5) and a device mesh (item 12).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models import pyramid as pyr
from ..render.serve import _require_fp32_matmul
from ..render.swr import (
    _RS_DTYPES,
    _as_f32,
    pick_warp,
    render_swr,
    render_swr_fixed_axis,
    slab_window_bound,
)
from ..utils.convert import load_pyramid_npz
from ..utils.device import resolve_device
from .state import Adam, AdamState, tree_leaves, tree_map
from .state import trainable as _trainable

_MODULES_TODO = "not ported yet; see ROADMAP 'Modules to port' item {}"


@dataclasses.dataclass(frozen=True)
class SwrTrainConfig:
    """The JAX package's ``SwrTrainConfig``, field for field (the record
    manifests dump it).  ``sweep_impl`` takes the port's values: "auto"
    (the CUDA kernels on the card, the plain sweep on the CPU) or
    "reference" (the plain sweep on any device).  ``weight_decay`` is
    unused, as in the JAX optimizer; ``near`` only acts on inside cameras.
    """

    crop: int = 128
    lr: float = 1e-2
    lr_final_ratio: float = 1 / 30
    max_steps: int = 4000
    weight_decay: float = 0.0
    n_chunks: int = 16
    white_bg: bool = True
    sigma_l1: float = 1e-5
    tv_w: float = 3e-3
    distortion_w: float = 0.0
    resample_dtype: str = "float32"
    bake_dtype: str = "float32"
    adam_mu_bf16: bool = False
    prog_steps: Tuple[int, ...] = ()
    near: float = 0.0
    random_bg: bool = False
    alpha_w: float = 0.0
    cam_carve: float = 0.0
    sweep_impl: str = "auto"
    resample_kind: str = "linear"


def _check_scope(tcfg: SwrTrainConfig) -> None:
    """Raise for the options of the JAX trainer the port does not train."""
    if tcfg.cam_carve > 0:
        raise NotImplementedError(
            f"cam_carve is {_MODULES_TODO.format('10.5')}")
    for name in ("bake_dtype", "resample_dtype"):
        if getattr(tcfg, name) not in _RS_DTYPES:
            raise ValueError(f"unknown {name} {getattr(tcfg, name)!r}")
    if tcfg.resample_kind not in ("linear", "cubic"):
        raise ValueError(f"unknown resample kind {tcfg.resample_kind!r}")
    if tcfg.sweep_impl not in ("auto", "reference"):
        raise ValueError(f"unknown sweep_impl {tcfg.sweep_impl!r}")


# ---------------------------------------------------------------- params


def _grow_like_params(old, new):
    """Shared levels and every other entry (the rgb MLP) keep ``old``;
    newly added levels keep ``new``."""
    out = dict(new)
    out.update({k: v for k, v in old.items() if k != "levels"})
    out["levels"] = list(old["levels"]) + list(
        new["levels"][len(old["levels"]):])
    return out


def make_optimizer(cfg: SwrTrainConfig) -> Adam:
    mu_dtype = torch.bfloat16 if cfg.adam_mu_bf16 else torch.float32
    return Adam(cfg.lr, cfg.max_steps, cfg.lr_final_ratio, mu_dtype=mu_dtype)


class SwrTrainState(NamedTuple):
    params: Any
    opt_state: AdamState


def create_swr_state(
    mcfg: pyr.PyramidConfig,
    tcfg: SwrTrainConfig,
    generator: torch.Generator | None = None,
    device=None,
) -> SwrTrainState:
    params = _trainable(pyr.init_pyramid_params(mcfg, generator, device))
    return SwrTrainState(params, make_optimizer(tcfg).init(params))


def grow_swr_state(
    state: SwrTrainState,
    new_mcfg: pyr.PyramidConfig,
    tcfg: SwrTrainConfig,
    generator: torch.Generator | None = None,
) -> SwrTrainState:
    """Grow a training state to a deeper pyramid config.

    New fine levels get their standard init and zero moments (the first in
    bf16 with ``adam_mu_bf16``); shared levels and the rgb MLP keep params
    and moments; both counts carry (one cosine schedule spans all
    phases)."""
    dev = state.params["levels"][0].device
    fresh = _trainable(pyr.init_pyramid_params(new_mcfg, generator, dev))
    params = _grow_like_params(state.params, fresh)
    zero = make_optimizer(tcfg).init(params)
    opt = AdamState(
        state.opt_state.count,
        state.opt_state.sched_count,
        _grow_like_params(state.opt_state.mu, zero.mu),
        _grow_like_params(state.opt_state.nu, zero.nu),
    )
    return SwrTrainState(params, opt)


# ---------------------------------------------------------------- loss


def tv_window(rf: int) -> int:
    """Side of a windowed level's stochastic TV window."""
    return max(rf // 4, 2)


def tv_levels(params, mcfg: pyr.PyramidConfig):
    """The levels whose TV is taken over a random window of their first
    axis each step: the finest level and, for a split grid, the sigma
    level (as a one-channel grid)."""
    fines = [params["levels"][-1]]
    if mcfg.split:
        fines.append(params["sigma_level"][..., None])
    return fines


def make_swr_loss(
    gt_image: torch.Tensor,  # (H, W, 3 | 4) uint8 or float
    pose,  # (3, 4)
    K,  # (3, 3)
    crop_xy: Tuple[int, int],  # top-left (x, y)
    mcfg: pyr.PyramidConfig,
    tcfg: SwrTrainConfig,
    axis: int,
    flip: bool,
    bg: torch.Tensor | None = None,
    tv_starts: Sequence[int] = (),
    lat_size: int = 0,
    warp: str = "matmul",
    slab_window: int = 0,
):
    """Build ``loss_fn(params) -> (loss, mse)`` for one training crop.

    ``bg`` is the (c^2, 3) random background (needed with ``random_bg``);
    ``tv_starts[i]`` the start of the TV window of ``tv_levels``' level i
    along its first axis (needed with ``tv_w > 0``), in ``[0, r -
    tv_window(r)]``.  ``slab_window`` is the renderer's (0: full-matrix
    resamples).
    """
    c = tcfg.crop
    x0, y0 = int(crop_xy[0]), int(crop_xy[1])
    n_ch = gt_image.shape[-1]  # 3 = rgb, 4 = rgba (GT alpha channel)
    gt = gt_image[y0 : y0 + c, x0 : x0 + c].reshape(c * c, n_ch)
    gt = gt.float() / 255.0 if gt.dtype == torch.uint8 else gt.float()
    gt_alpha = gt[:, 3] if n_ch == 4 else None
    gt = gt[:, :3]
    K_crop = _as_f32(K, gt_image.device).clone()
    K_crop[0, 2] -= float(x0)
    K_crop[1, 2] -= float(y0)
    if tcfg.random_bg and bg is None:
        raise ValueError("random_bg needs the (crop^2, 3) background bg")
    if tcfg.alpha_w > 0 and gt_alpha is None:
        raise ValueError("alpha_w needs the GT alpha channel (alphas=)")

    bake_dtype = _RS_DTYPES[tcfg.bake_dtype]

    def loss_fn(params):
        # checkpoint the bake at large R: its forward intermediates (the
        # progressive upsample chain, ~R^3 F each) would otherwise stay live
        # across the render for the backward, as the JAX trainer remats it
        if mcfg.grid_res >= 384:
            grid = checkpoint(pyr.bake, params, mcfg, bake_dtype,
                              use_reentrant=False)
        else:
            grid = pyr.bake(params, mcfg, bake_dtype)
        out = render_swr_fixed_axis(
            params, grid, mcfg, pose, K_crop, (c, c), axis, flip,
            n_chunks=min(tcfg.n_chunks, mcfg.grid_res),
            white_bg=tcfg.white_bg and not tcfg.random_bg,
            slab_window=slab_window,
            lat_size=lat_size,
            warp=warp,
            want_distortion=tcfg.distortion_w > 0,
            resample_dtype=tcfg.resample_dtype,
            sweep_impl=tcfg.sweep_impl,
            resample_kind=tcfg.resample_kind,
        )
        rgb_pred = out["rgb"]
        gt_eff = gt
        if tcfg.random_bg:
            rgb_pred = rgb_pred + (1.0 - out["opacity"])[:, None] * bg
            if gt_alpha is not None:
                # GT was stored over bg0 (white or black): put it over bg
                bg0 = 1.0 if tcfg.white_bg else 0.0
                gt_eff = gt + (1.0 - gt_alpha)[:, None] * (bg - bg0)
        mse = torch.mean((rgb_pred - gt_eff) ** 2)
        loss = mse
        if tcfg.alpha_w > 0:
            loss = loss + tcfg.alpha_w * torch.mean(
                (out["opacity"] - gt_alpha) ** 2
            )
        if tcfg.distortion_w > 0:
            loss = loss + tcfg.distortion_w * torch.mean(out["distortion"])
        if tcfg.sigma_l1 > 0:
            sigma = grid[0] if mcfg.split else grid[..., 0]
            loss = loss + tcfg.sigma_l1 * torch.mean(sigma)
        if tcfg.tv_w > 0:
            tv = 0.0
            for g in params["levels"][:-1]:
                for ax in range(3):
                    d = torch.diff(g, dim=ax)
                    tv = tv + torch.mean(d * d)
            # the finest level(s): a random window of the first axis each
            # step (stochastic TV, ~1/4 of the traffic)
            for fine, s0 in zip(tv_levels(params, mcfg), tv_starts,
                                strict=True):
                s0 = int(s0)
                sl = fine[s0 : s0 + tv_window(fine.shape[0])]
                for ax in range(3):
                    d = torch.diff(sl, dim=ax)
                    tv = tv + torch.mean(d * d)
            loss = loss + tcfg.tv_w * tv
        return loss, mse

    return loss_fn


def swr_train_step(
    state: SwrTrainState,
    gt_image: torch.Tensor,
    pose,
    K,
    crop_xy: Tuple[int, int],
    mcfg: pyr.PyramidConfig,
    tcfg: SwrTrainConfig,
    axis: int,
    flip: bool,
    bg: torch.Tensor | None = None,
    tv_starts: Sequence[int] = (),
    lat_size: int = 0,
    warp: str = "matmul",
    slab_window: int = 0,
) -> Tuple[SwrTrainState, Dict[str, torch.Tensor]]:
    """One Adam step on one crop; returns the new state (its tensors
    updated in place) and device-scalar ``loss`` and ``psnr``."""
    loss_fn = make_swr_loss(gt_image, pose, K, crop_xy, mcfg, tcfg, axis,
                            flip, bg, tv_starts, lat_size, warp, slab_window)
    loss, mse = loss_fn(state.params)
    leaves = tree_leaves(state.params)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    grad_tree = tree_map(lambda _: next(it), state.params)
    opt = make_optimizer(tcfg).update(grad_tree, state.opt_state,
                                      state.params)
    metrics = {"loss": loss.detach(),
               "psnr": -10.0 * torch.log10(mse.detach())}
    return SwrTrainState(state.params, opt), metrics


# ---------------------------------------------------------------- trainer


def _host_rng_state(rng: np.random.RandomState):
    name, keys, pos, has_gauss, cached = rng.get_state()
    return [name, keys.tolist(), int(pos), int(has_gauss), float(cached)]


class SwrTrainer:
    """Host loop: image and crop draws, sweep axis per pose, phases."""

    def __init__(
        self,
        mcfg: pyr.PyramidConfig,
        tcfg: SwrTrainConfig,
        images: np.ndarray,  # (N, H*W, 3)
        poses: np.ndarray,  # (N, 3, 4)
        K: np.ndarray,
        img_wh: Tuple[int, int],
        seed: int = 23,
        mesh=None,
        alphas: np.ndarray | None = None,
        device=None,
    ):
        """``alphas``: optional (N, H*W) GT opacity, packed as a 4th uint8
        image channel (alpha-correct ``random_bg`` and ``alpha_w``).
        ``device``: where the model trains; ``None`` means ``"cuda"``,
        which raises when there is no card (pass ``"cpu"`` for the CPU)."""
        if mesh is not None:
            raise NotImplementedError(
                "crop-parallel training over a mesh is "
                + _MODULES_TODO.format(12)
            )
        _check_scope(tcfg)
        self.device = resolve_device(device, "device='cpu'")
        self.mcfg, self.tcfg = mcfg, tcfg
        self.seed = seed
        w, h = img_wh
        imgs = np.asarray(images, np.float32).reshape(-1, h, w, 3)
        if alphas is not None:
            imgs = np.concatenate(
                [imgs, np.asarray(alphas, np.float32).reshape(-1, h, w, 1)],
                axis=-1,
            )
        # 8-bit on the device, as the JAX trainer keeps them
        self.images = torch.as_tensor(
            np.clip(imgs * 255.0 + 0.5, 0, 255).astype(np.uint8),
            device=self.device,
        )
        del imgs
        self.poses_np = np.asarray(poses, np.float32).reshape(-1, 3, 4)
        self.K = np.asarray(K, np.float32)
        self.img_wh = (w, h)
        self._host_rng = np.random.RandomState(seed)
        self._gen_dev = torch.Generator(device=self.device).manual_seed(seed)
        self._gen_host = torch.Generator().manual_seed(seed)
        self._axis_flip = []
        for p in self.poses_np:
            a = int(np.argmax(np.abs(p[:, 2])))
            if abs(float(p[a, 3])) <= mcfg.scale * 1.05:
                raise NotImplementedError(
                    f"inside cameras are {_MODULES_TODO.format('10.5')}")
            self._axis_flip.append((a, bool(p[a, 3] > 0)))
        # coarse-to-fine phases: [(truncated mcfg, end_step), ...]; the last
        # phase is the full config and takes the remaining steps
        self._phases = []
        if tcfg.prog_steps:
            n_lvl, n_pro = len(mcfg.resolutions), len(tcfg.prog_steps)
            if not 0 < n_pro < n_lvl:
                raise ValueError("prog_steps longer than the pyramid")
            end = 0
            for i, st in enumerate(tcfg.prog_steps):
                end += st
                self._phases.append((pyr.truncate(mcfg, n_lvl - n_pro + i),
                                     end))
        self._phases.append((mcfg, tcfg.max_steps))
        self.step = 0
        self._activate_phase(0)

    def _init_generator(self, idx: int) -> torch.Generator:
        return torch.Generator().manual_seed(self.seed * 1000 + idx)

    def _activate_phase(self, idx: int):
        pm = self._phases[idx][0]
        self._phase_idx = idx
        self.cur_mcfg = pm
        # the train lattice only needs to resolve the active grid: cap it
        # near 1.25 R (as eval does) while the pyramid is coarse
        lat_pad = 16
        cap = int(1.25 * pm.grid_res) + lat_pad
        self.lat_size = cap if cap < self.tcfg.crop + lat_pad else 0
        # linear resamples read a source window when it is a quarter of R or
        # less; the full matrix otherwise, and always for cubic (every pose
        # is outside: inside cameras raise)
        self.slab_window = (
            slab_window_bound(self.poses_np, self.K, self.img_wh, pm,
                              crop=self.tcfg.crop, lat_size=self.lat_size)
            if self.tcfg.resample_kind == "linear" else 0
        )
        self._grid_cache = (None, None)
        gen = self._init_generator(idx)
        if idx == 0:
            self.state = create_swr_state(pm, self.tcfg, gen, self.device)
        else:
            self.state = grow_swr_state(self.state, pm, self.tcfg, gen)

    def _advance_phases(self, to_idx: int | None = None):
        while self._phase_idx + 1 < len(self._phases) and (
            self._phase_idx < to_idx if to_idx is not None
            else self.step >= self._phases[self._phase_idx][1]
        ):
            self._activate_phase(self._phase_idx + 1)

    def draw(self):
        """The next step's random inputs: image index, crop offset, random
        background (or None) and TV window starts."""
        w, h = self.img_wh
        c = self.tcfg.crop
        i = self._host_rng.randint(len(self.poses_np))
        x0 = self._host_rng.randint(max(w - c, 0) + 1)
        y0 = self._host_rng.randint(max(h - c, 0) + 1)
        bg = None
        if self.tcfg.random_bg:
            bg = torch.rand((c * c, 3), generator=self._gen_dev,
                            device=self.device)
        tv_starts = ()
        if self.tcfg.tv_w > 0:
            tv_starts = tuple(
                int(torch.randint(0, rf - tv_window(rf) + 1, (1,),
                                  generator=self._gen_host))
                for rf in (g.shape[0] for g in tv_levels(self.state.params,
                                                         self.cur_mcfg))
            )
        return i, (x0, y0), bg, tv_starts

    def run_step(self):
        _require_fp32_matmul()
        self._advance_phases()
        i, (x0, y0), bg, tv_starts = self.draw()
        axis, flip = self._axis_flip[i]
        c = self.tcfg.crop
        warp = pick_warp(self.poses_np[i], self.K, (c, c), axis,
                         crop_xy=(x0, y0))
        self.state, metrics = swr_train_step(
            self.state, self.images[i], self.poses_np[i], self.K, (x0, y0),
            self.cur_mcfg, self.tcfg, axis, flip, bg, tv_starts,
            self.lat_size, warp, self.slab_window,
        )
        self.step += 1
        return metrics

    def fit(self, max_steps=None, log_every: int = 500, log_fn=print):
        max_steps = max_steps or self.tcfg.max_steps
        tic = time.time()
        m = None
        for _ in range(max_steps):
            m = self.run_step()
            if (self.step - 1) % log_every == 0:
                log_fn(
                    f"elapsed_time={time.time() - tic:.2f}s | "
                    f"step={self.step - 1} | "
                    f"psnr={float(m['psnr']):.2f} | "
                    f"loss={float(m['loss']):.6f}"
                )
        return m

    def render(self, pose, K=None, img_wh=None, lat_cap="auto",
               early_exit=1e-4):
        """Eval-time render.  ``early_exit`` stops the sweep once every
        pixel's transmittance is below it; 0.0 sweeps every chunk.  The
        grid is baked in ``bake_dtype``; the resample operands are fp32,
        as the JAX trainer renders."""
        _require_fp32_matmul()
        if self._grid_cache[0] != self.step:
            with torch.no_grad():
                self._grid_cache = (self.step, pyr.bake(
                    self.state.params, self.cur_mcfg,
                    _RS_DTYPES[self.tcfg.bake_dtype]))
        grid = self._grid_cache[1]
        if lat_cap == "auto":
            lat_cap = int(1.25 * self.cur_mcfg.grid_res) + 16
        pose_np = np.asarray(pose, np.float32).reshape(3, 4)
        a = int(np.argmax(np.abs(pose_np[:, 2])))
        if abs(float(pose_np[a, 3])) <= self.cur_mcfg.scale * 1.05:
            raise NotImplementedError(
                f"inside cameras are {_MODULES_TODO.format('10.5')}")
        with torch.no_grad():
            return render_swr(
                self.state.params, grid, self.cur_mcfg, pose_np,
                self.K if K is None else K,
                tuple(img_wh or self.img_wh),
                lat_cap=lat_cap,
                n_chunks=min(self.tcfg.n_chunks, self.cur_mcfg.grid_res),
                white_bg=self.tcfg.white_bg,
                skip_empty=True,
                early_exit=float(early_exit),
                resample_kind=self.tcfg.resample_kind,
                sweep_impl=self.tcfg.sweep_impl,
            )

    def save_state(self, path: str, light: bool = True):
        """Checkpoint for resume (``torch.save``).

        ``light`` (default): bf16 params, step, phase and the random
        streams; on resume Adam restarts with zero moments and count 0 while
        the schedule resumes at the saved step.  Full mode adds the fp32
        params and the Adam state (each moment in its own dtype: a bf16 first
        moment stays bf16), for an exact resume.
        """

        def cpu(t, dtype):
            return t.detach().to("cpu", dtype)

        st = self.state
        payload = {
            "step": self.step,
            "phase": self._phase_idx,
            "host_rng": _host_rng_state(self._host_rng),
            "gen_dev": self._gen_dev.get_state(),
            "gen_host": self._gen_host.get_state(),
        }
        if light:
            payload["params_bf16"] = tree_map(
                lambda t: cpu(t, torch.bfloat16), st.params
            )
        else:
            f32 = torch.float32
            payload["params"] = tree_map(lambda t: cpu(t, f32), st.params)
            payload["adam"] = {
                "count": st.opt_state.count,
                "sched_count": st.opt_state.sched_count,
                "mu": tree_map(lambda t: cpu(t, t.dtype), st.opt_state.mu),
                "nu": tree_map(lambda t: cpu(t, f32), st.opt_state.nu),
            }
        torch.save(payload, path)

    def load_state(self, path: str):
        d = torch.load(path, map_location="cpu", weights_only=True)
        # replay the phase activations, then overwrite the state they made
        self._advance_phases(to_idx=d["phase"])

        def dev(t):
            return t.to(self.device, torch.float32)

        if "adam" in d:
            params = _trainable(tree_map(dev, d["params"]))
            a = d["adam"]
            mu_dtype = make_optimizer(self.tcfg).mu_dtype
            opt = AdamState(int(a["count"]), int(a["sched_count"]),
                            tree_map(lambda t: t.to(self.device, mu_dtype),
                                     a["mu"]),
                            tree_map(dev, a["nu"]))
        else:
            params = _trainable(tree_map(dev, d["params_bf16"]))
            # the schedule resumes at the saved step; Adam's count restarts
            # at 0, so bias correction ramps the fresh moments in gently
            opt = make_optimizer(self.tcfg).init(params,
                                                 sched_count=d["step"])
        self.state = SwrTrainState(params, opt)
        self.step = int(d["step"])
        name, keys, pos, has_gauss, cached = d["host_rng"]
        self._host_rng.set_state(
            (name, np.asarray(keys, np.uint32), pos, has_gauss, cached)
        )
        self._gen_dev.set_state(d["gen_dev"])
        self._gen_host.set_state(d["gen_host"])
        self._grid_cache = (None, None)

    def load_npz(self, path: str):
        """Load params from a ``model_pyramid.npz`` (written by either
        package) and jump to the final, full-depth phase; Adam starts
        fresh."""
        self._advance_phases(to_idx=len(self._phases) - 1)
        params = load_pyramid_npz(path, self.device)
        exp = [tuple(g.shape) for g in self.state.params["levels"]]
        got = [tuple(g.shape) for g in params["levels"]]
        if exp != got:
            raise ValueError(f"ckpt level shapes {got} != config {exp}")
        if ("sigma_level" in params) != self.mcfg.split:
            raise ValueError(f"{path}: a sigma_level exactly when the config "
                             f"is split (sigma_res={self.mcfg.sigma_res})")
        params = _trainable(params)
        self.state = SwrTrainState(params,
                                   make_optimizer(self.tcfg).init(params))
        self._grid_cache = (None, None)
