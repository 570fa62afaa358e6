"""Training on the shear-warp renderer: image-crop SGD on the dense pyramid.

Port of the JAX package's ``train/swr_step.py``.  Each step
draws a training image and a square crop (a crop of a pinhole image is a
pinhole image with a shifted principal point), renders the crop with
:func:`render_swr_fixed_axis`, and takes the MSE against the ground truth
plus the opacity, distortion, sigma-L1 and per-level TV terms.  A camera
inside the scene cube trains one cubemap face of its crop per step (drawn
with probability proportional to the face's share of the crop's pixels),
through the slab scan, with the MSE, opacity and distortion terms masked to
the face's pixels.  ``cam_carve`` zeroes the baked sigma within that radius
of every training camera (:func:`camera_keep_mask`), in the loss and in
:meth:`SwrTrainer.render`.  Deferred shading on an unsplit grid with full-matrix
resamples (the defaults, linear or cubic) runs the hand-written sweep
kernels on the card (``ops/swr_sweep.py``); per-sample shading, a split
``sigma_res`` grid, the distortion loss and a windowed resample run the
renderer's slab scan.  Linear training picks its slab window per phase as
the JAX trainer does (:func:`slab_window_bound`).

Randomness.  Every random input of the loss is an argument of
:func:`make_swr_loss`: the crop offset, the random background ``(c^2, 3)``
and the TV window starts (one per windowed level: the finest level, and
the sigma level of a split grid).  :class:`SwrTrainer` draws the image, the
crop and an inside crop's face with ``np.random.RandomState(seed)`` in the
JAX trainer's call order (so both packages pick the same crops and faces),
the background from a ``torch.Generator`` on the training device and the TV
windows from one on the host; :meth:`SwrTrainer.run_step` takes a draw
(:class:`SwrDraw`) from its caller as well.

Adam is ``train/state.py:Adam`` (one count for bias correction, one for
the cosine schedule, as the JAX optimizer keeps them), shared with the NGP
trainer.

bf16, as the JAX trainer: ``bake_dtype="bfloat16"`` bakes in bf16 inside
the loss (checkpointed at ``grid_res >= 384``, as JAX remats it) and for
:meth:`SwrTrainer.render`; ``resample_dtype`` sets the loss's resample
operands; ``adam_mu_bf16`` keeps Adam's first moment in bf16.

With a ``mesh`` (``parallel/mesh.py``) the trainer is one rank of a
crop-parallel run (``parallel/swr_shard.py``): the host stream, seeded
alike on every rank, draws one crop a rank from poses that share the
sweep's axis and direction (for an inside camera: one pose, one window a
rank and one cubemap face); each rank trains its own crop, with its own
background and TV windows from generators seeded from the seed and the
rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models import pyramid as pyr
from ..render.swr import (
    _RS_DTYPES,
    _as_f32,
    _dirs,
    _matmul_solve_choice,
    face_slope_bounds,
    pick_warp,
    pixel_faces,
    render_swr,
    render_swr_fixed_axis,
    render_swr_inside,
    slab_window_bound,
)
from ..utils import profiling
from ..utils.convert import load_pyramid_npz
from ..utils.device import require_fp32_matmul, resolve_device
from .state import Adam, AdamState, tree_leaves, tree_map
from .state import trainable as _trainable


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
    """Raise for unknown option values."""
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


# ---------------------------------------------------------------- carving


def apply_sigma_keep(grid, sigma_keep: torch.Tensor):
    """Zero the baked grid's sigma where ``sigma_keep`` is 0, in the grid's
    own dtype (a bf16 bake stays bf16); a split grid's sigma alone."""
    if isinstance(grid, tuple):
        sigma, feats = grid
        return sigma * sigma_keep.to(sigma.dtype), feats
    return torch.cat([grid[..., :1] * sigma_keep[..., None].to(grid.dtype),
                      grid[..., 1:]], dim=-1)


def camera_keep_mask(poses: np.ndarray, res: int, carve: float,
                     scale: float = 0.5) -> np.ndarray:
    """(res, res, res) float32: 0 within ``carve`` of any camera, else 1.

    The free-space prior behind ``SwrTrainConfig.cam_carve``: a voxel a
    training camera has been within ``carve`` of cannot be solid.
    """
    c = (np.arange(res, dtype=np.float32) + 0.5) / res * (2 * scale) - scale
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    pts = np.stack([xx, yy, zz], axis=-1)  # (R, R, R, 3)
    keep = np.ones((res, res, res), np.float32)
    for p in np.asarray(poses, np.float32).reshape(-1, 3, 4):
        d2 = ((pts - p[:, 3]) ** 2).sum(-1)
        keep *= (d2 > carve * carve).astype(np.float32)
    return keep


def is_inside(pose, scale: float) -> bool:
    """Whether the camera sits inside the grid along its dominant view
    axis (within 1.05 of the half-width), as both trainers classify it."""
    p = np.asarray(pose, np.float32).reshape(3, 4)
    a = int(np.argmax(np.abs(p[:, 2])))
    return abs(float(p[a, 3])) <= scale * 1.05


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
    inside: bool = False,
    sigma_keep: torch.Tensor | None = None,
    slope_bounds=None,
):
    """Build ``loss_fn(params) -> (loss, mse)`` for one training crop.

    ``bg`` is the (c^2, 3) random background (needed with ``random_bg``);
    ``tv_starts[i]`` the start of the TV window of ``tv_levels``' level i
    along its first axis (needed with ``tv_w > 0``), in ``[0, r -
    tv_window(r)]``.  ``slab_window`` is the renderer's (0: full-matrix
    resamples).  ``inside`` trains the cubemap face ``(axis, -1 if flip
    else +1)`` of a camera inside the grid (``slope_bounds`` as the
    renderer's): the MSE, opacity and distortion terms are masked to the
    crop pixels whose ray that face owns (the first axis of equal
    components).  ``sigma_keep`` ((R, R, R), or the sigma grid's side for a
    split config) multiplies the baked sigma (camera carving).
    """
    with profiling.span("swr.plan"):
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
        mask = face_mask(pose, K_crop, c, axis, flip) if inside else None
    bake_dtype = _RS_DTYPES[tcfg.bake_dtype]

    def masked_mean(x):
        if mask is None:
            return torch.mean(x)
        return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)

    def bake(params):
        with profiling.span("swr.bake"):
            return pyr.bake(params, mcfg, bake_dtype)

    def loss_fn(params):
        # checkpoint the bake at large R: its forward intermediates (the
        # progressive upsample chain, ~R^3 F each) would otherwise stay live
        # across the render for the backward, as the JAX trainer remats it
        # (the recomputation opens swr.bake again, inside the backward)
        if mcfg.grid_res >= 384:
            grid = checkpoint(bake, params, use_reentrant=False)
        else:
            grid = bake(params)
        if sigma_keep is not None:
            grid = apply_sigma_keep(grid, sigma_keep)
        out = render_swr_fixed_axis(
            params, grid, mcfg, pose, K_crop, (c, c), axis, flip,
            n_chunks=min(tcfg.n_chunks, mcfg.grid_res),
            white_bg=tcfg.white_bg and not tcfg.random_bg,
            slab_window=slab_window,
            lat_size=lat_size,
            warp=warp,
            want_distortion=tcfg.distortion_w > 0,
            resample_dtype=tcfg.resample_dtype,
            inside=inside,
            slope_bounds=slope_bounds,
            near=tcfg.near,
            sweep_impl=tcfg.sweep_impl,
            resample_kind=tcfg.resample_kind,
        )
        with profiling.span("swr.loss"):
            rgb_pred = out["rgb"]
            gt_eff = gt
            if tcfg.random_bg:
                rgb_pred = rgb_pred + (1.0 - out["opacity"])[:, None] * bg
                if gt_alpha is not None:
                    # GT was stored over bg0 (white or black): put it over bg
                    bg0 = 1.0 if tcfg.white_bg else 0.0
                    gt_eff = gt + (1.0 - gt_alpha)[:, None] * (bg - bg0)
            err = (rgb_pred - gt_eff) ** 2
            if inside:
                mse = torch.sum(err * mask[:, None]) / torch.clamp(
                    3.0 * torch.sum(mask), min=1.0)
            else:
                mse = torch.mean(err)
            loss = mse
            if tcfg.alpha_w > 0:
                loss = loss + tcfg.alpha_w * masked_mean(
                    (out["opacity"] - gt_alpha) ** 2)
            if tcfg.distortion_w > 0:
                loss = loss + tcfg.distortion_w * masked_mean(
                    out["distortion"])
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


def draw_bg_and_tv(tcfg: SwrTrainConfig, mcfg: pyr.PyramidConfig, params,
                   gen_dev: torch.Generator, gen_host: torch.Generator,
                   device) -> Tuple[torch.Tensor | None, Tuple[int, ...]]:
    """A crop's own random inputs: the ``(c^2, 3)`` random background on
    ``device`` from ``gen_dev`` (None without ``random_bg``) and the TV
    window starts of :func:`tv_levels` from ``gen_host`` (none without
    ``tv_w``)."""
    c = tcfg.crop
    bg = None
    if tcfg.random_bg:
        bg = torch.rand((c * c, 3), generator=gen_dev, device=device)
    tv_starts = ()
    if tcfg.tv_w > 0:
        tv_starts = tuple(
            int(torch.randint(0, rf - tv_window(rf) + 1, (1,),
                              generator=gen_host))
            for rf in (g.shape[0] for g in tv_levels(params, mcfg)))
    return bg, tv_starts


def face_mask(pose, K, c: int, axis: int, flip: bool) -> torch.Tensor:
    """(c^2,) float: 1 where the cubemap face ``(axis, -1 if flip else
    +1)`` owns the ray of a ``c`` x ``c`` image's pixel (intrinsics ``K``,
    a tensor), else 0.  The dominant axis is the first of equal
    components, as ``torch.argmax`` (and ``jnp.argmax``) take it."""
    dev = K.device
    pose = _as_f32(pose, dev)
    ui = torch.arange(c, dtype=torch.float32, device=dev)
    uu, vv = torch.meshgrid(ui, ui, indexing="xy")
    d_cam = torch.stack([(uu - K[0, 2] + 0.5) / K[0, 0],
                         (vv - K[1, 2] + 0.5) / K[1, 1],
                         torch.ones_like(uu)], dim=-1)
    d_w = _dirs(pose, d_cam)
    dom = torch.argmax(torch.abs(d_w), dim=-1)
    sign_ok = (d_w[..., axis] > 0) == (not flip)
    return ((dom == axis) & sign_ok).reshape(c * c).to(torch.float32)


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
    inside: bool = False,
    sigma_keep: torch.Tensor | None = None,
    slope_bounds=None,
) -> Tuple[SwrTrainState, Dict[str, torch.Tensor]]:
    """One Adam step on one crop; returns the new state (its tensors
    updated in place) and device-scalar ``loss`` and ``psnr``."""
    loss_fn = make_swr_loss(gt_image, pose, K, crop_xy, mcfg, tcfg, axis,
                            flip, bg, tv_starts, lat_size, warp, slab_window,
                            inside, sigma_keep, slope_bounds)
    return apply_swr_grads(state, tcfg, *loss_and_grads(loss_fn,
                                                        state.params))


def loss_and_grads(loss_fn, params):
    """``(loss, mse, gradients)`` of ``loss_fn(params)``: detached scalars
    and the gradients in :func:`tree_leaves` order."""
    with profiling.span("swr.forward"):
        loss, mse = loss_fn(params)
    leaves = tree_leaves(params)
    with profiling.backward_span("swr.backward", loss, leaves):
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), mse.detach(), list(grads)


def apply_swr_grads(state: SwrTrainState, tcfg: SwrTrainConfig, loss, mse,
                    grads) -> Tuple[SwrTrainState, Dict[str, torch.Tensor]]:
    """Adam on ``grads`` (:func:`tree_leaves` order), in place; returns the
    state and the metrics ``loss`` and ``psnr``."""
    it = iter(grads)
    grad_tree = tree_map(lambda _: next(it), state.params)
    with profiling.span("swr.adam"):
        opt = make_optimizer(tcfg).update(grad_tree, state.opt_state,
                                          state.params)
    metrics = {"loss": loss, "psnr": -10.0 * torch.log10(mse)}
    return SwrTrainState(state.params, opt), metrics


# ---------------------------------------------------------------- trainer


def _host_rng_state(rng: np.random.RandomState):
    name, keys, pos, has_gauss, cached = rng.get_state()
    return [name, keys.tolist(), int(pos), int(has_gauss), float(cached)]


class SwrDraw(NamedTuple):
    """One step's random inputs: the image index, the crop's top-left (x,
    y), the random background (or None), the TV window starts and, for an
    inside camera, the cubemap face (``2 * axis + positive``), else None."""

    i: int
    crop_xy: Tuple[int, int]
    bg: torch.Tensor | None
    tv_starts: Tuple[int, ...]
    face: int | None = None


class SwrShardedDraw(NamedTuple):
    """One crop-parallel step's random inputs: every rank's image index and
    crop offset (the shared host draws), the cubemap face of an inside
    step (else None), and this rank's background and TV window starts."""

    idxs: Tuple[int, ...]
    wins: Tuple[Tuple[int, int], ...]
    face: int | None
    bg: torch.Tensor | None
    tv_starts: Tuple[int, ...]


class SwrStepPlan(NamedTuple):
    """The renderer's static choices for one draw: the sweep axis and
    direction, whether the camera is inside, the face's slope bounds (or
    None), the final warp and the slab window."""

    axis: int
    flip: bool
    inside: bool
    slope_bounds: np.ndarray | None
    warp: str
    slab_window: int


class SwrTrainer:
    """Host loop: image, crop and face draws, sweep axis per pose,
    phases."""

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
        which raises when there is no card (pass ``"cpu"`` for the CPU).
        ``mesh``: train as one rank of it, on its device."""
        _check_scope(tcfg)
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's "
                                 f"{mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self._sharded_steps = {}
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
        # the host stream is the same on every rank; a rank's own draws
        # (background, TV windows) are its own (rank 0's are the seed's)
        self._host_rng = np.random.RandomState(seed)
        own = seed + ((mesh.rank if mesh is not None else 0) << 32)
        self._gen_dev = torch.Generator(device=self.device).manual_seed(own)
        self._gen_host = torch.Generator().manual_seed(own)
        # the sweep of each pose; an inside pose trains one cubemap face a
        # step, drawn from its crop's pixel shares on a face map subsampled
        # by _face_stride
        self._axis_flip, self._inside, self._face_map = [], [], []
        self._face_stride = max(1, min(img_wh) // 128)
        for p in self.poses_np:
            a = int(np.argmax(np.abs(p[:, 2])))
            self._axis_flip.append((a, bool(p[a, 3] > 0)))
            self._inside.append(is_inside(p, mcfg.scale))
            face_map = None
            if self._inside[-1]:
                dom, pos, _, _ = pixel_faces(p, self.K, self.img_wh)
                st = self._face_stride
                face_map = (dom[::st, ::st].astype(np.int8), pos[::st, ::st])
            self._face_map.append(face_map)
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
        # linear resamples of outside crops read a source window when it is
        # a quarter of R or less; the full matrix otherwise, always for
        # cubic and for inside crops
        outside = self.poses_np[~np.asarray(self._inside, bool)]
        self.slab_window = (
            slab_window_bound(outside, self.K, self.img_wh, pm,
                              crop=self.tcfg.crop, lat_size=self.lat_size)
            if len(outside) and self.tcfg.resample_kind == "linear" else 0
        )
        self.sigma_keep = None
        if self.tcfg.cam_carve > 0:
            res = pm.sigma_res if pm.split else pm.grid_res
            self.sigma_keep = torch.as_tensor(
                camera_keep_mask(self.poses_np, res, self.tcfg.cam_carve,
                                 pm.scale), device=self.device)
        self._grid_cache = (None, None)
        self._sharded_steps = {}  # a step is per phase (its mcfg)
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

    def face_shares(self, i: int, crop_xy: Tuple[int, int]) -> np.ndarray:
        """(6,) the share of inside pose ``i``'s crop pixels that each
        cubemap face (``2 * axis + positive``) owns, on the subsampled face
        map."""
        dom, pos = self._face_map[i]
        st, c = self._face_stride, self.tcfg.crop
        x0, y0 = crop_xy
        sd = dom[y0 // st:(y0 + c) // st + 1, x0 // st:(x0 + c) // st + 1]
        sp = pos[y0 // st:(y0 + c) // st + 1, x0 // st:(x0 + c) // st + 1]
        ids = (sd.astype(np.int64) * 2 + sp).ravel()
        counts = np.bincount(ids, minlength=6).astype(np.float64)
        return counts / counts.sum()

    def draw(self) -> SwrDraw:
        """The next step's random inputs (:class:`SwrDraw`).  The image, the
        crop and an inside crop's face come from the host stream in the JAX
        trainer's order (its face is ``RandomState.choice`` over the pixel
        shares)."""
        w, h = self.img_wh
        c = self.tcfg.crop
        i = self._host_rng.randint(len(self.poses_np))
        x0 = self._host_rng.randint(max(w - c, 0) + 1)
        y0 = self._host_rng.randint(max(h - c, 0) + 1)
        face = None
        if self._inside[i]:
            face = int(self._host_rng.choice(6, p=self.face_shares(i, (x0,
                                                                     y0))))
        return SwrDraw(i, (x0, y0), *self._own_draws(), face)

    def _own_draws(self):
        """:func:`draw_bg_and_tv` from this trainer's (this rank's)
        generators."""
        return draw_bg_and_tv(self.tcfg, self.cur_mcfg, self.state.params,
                              self._gen_dev, self._gen_host, self.device)

    def draw_sharded(self) -> SwrShardedDraw:
        """The next crop-parallel step's draws, in the JAX trainer's order
        on the shared host stream: the first pose, one window a rank, then
        either (inside) the face from window 0's face shares, every rank on
        that pose, or (outside) the other ranks' poses from those that
        share the first's axis and direction."""
        n = self.mesh.size
        w, h = self.img_wh
        c = self.tcfg.crop
        rng = self._host_rng
        i0 = rng.randint(len(self.poses_np))
        wins = tuple((rng.randint(max(w - c, 0) + 1),
                      rng.randint(max(h - c, 0) + 1)) for _ in range(n))
        face = None
        if self._inside[i0]:
            idxs = (i0,) * n
            face = int(rng.choice(6, p=self.face_shares(i0, wins[0])))
        else:
            pool = [j for j, (af, ins) in enumerate(zip(self._axis_flip,
                                                        self._inside))
                    if af == self._axis_flip[i0] and not ins]
            idxs = (i0,) + tuple(pool[rng.randint(len(pool))]
                                 for _ in range(n - 1))
        return SwrShardedDraw(idxs, wins, face, *self._own_draws())

    def plan_sharded(self, draw: SwrShardedDraw) -> SwrStepPlan:
        """The renderer's choices for a crop-parallel step, as the JAX
        trainer makes them: ``slope_bounds`` is every crop's (n, 2, 2) tight
        bounds of an inside face, or None (the cone's, for the whole step)
        when one crop has no pixel of it; the warp is crop 0's."""
        c, i0 = self.tcfg.crop, draw.idxs[0]
        inside = draw.face is not None
        slopes = None
        if inside:
            axis, flip = draw.face // 2, not bool(draw.face % 2)
            slopes = []
            for j, xy in zip(draw.idxs, draw.wins):
                b = face_slope_bounds(self.poses_np[j], self.K, (c, c), axis,
                                      -1.0 if flip else 1.0, crop_xy=xy)
                if b is None:
                    slopes = None
                    break
                slopes.append(np.asarray(b, np.float32))
        else:
            axis, flip = self._axis_flip[i0]
        if slopes:
            warp = _matmul_solve_choice(self.poses_np[i0], axis,
                                        float(slopes[0][1, 0]),
                                        float(slopes[0][1, 1]))
            slopes = np.stack(slopes)
        else:
            warp = pick_warp(self.poses_np[i0], self.K, (c, c), axis,
                             face_sign=((-1.0 if flip else 1.0) if inside
                                        else None),
                             crop_xy=draw.wins[0])
        return SwrStepPlan(axis, flip, inside, slopes, warp,
                           0 if inside else self.slab_window)

    def plan(self, draw: SwrDraw) -> SwrStepPlan:
        """The renderer's choices for a draw, as the JAX trainer makes
        them: an inside crop sweeps its drawn face over the face's tight
        slope bounds in the crop (the cone's when the sampled crop has no
        pixel of it), with the full matrix; an outside crop sweeps its
        pose's axis with the phase's slab window."""
        i, c = draw.i, self.tcfg.crop
        pose = self.poses_np[i]
        if not self._inside[i]:
            axis, flip = self._axis_flip[i]
            warp = pick_warp(pose, self.K, (c, c), axis,
                             crop_xy=draw.crop_xy)
            return SwrStepPlan(axis, flip, False, None, warp,
                               self.slab_window)
        if draw.face is None:
            raise ValueError(f"pose {i} is inside the grid: its draw needs a "
                             "face")
        axis, flip = draw.face // 2, not bool(draw.face % 2)
        sign = -1.0 if flip else 1.0
        b = face_slope_bounds(pose, self.K, (c, c), axis, sign,
                              crop_xy=draw.crop_xy)
        if b is not None:
            warp = _matmul_solve_choice(pose, axis, float(b[1, 0]),
                                        float(b[1, 1]))
        else:
            warp = pick_warp(pose, self.K, (c, c), axis, face_sign=sign,
                             crop_xy=draw.crop_xy)
        return SwrStepPlan(axis, flip, True, b, warp, 0)

    def loss_fn(self, draw: SwrDraw, tcfg: SwrTrainConfig | None = None):
        """:func:`make_swr_loss` of a draw at the current phase (``tcfg``
        overrides the trainer's config)."""
        pl = self.plan(draw)
        return make_swr_loss(
            self.images[draw.i], self.poses_np[draw.i], self.K, draw.crop_xy,
            self.cur_mcfg, tcfg or self.tcfg, pl.axis, pl.flip, draw.bg,
            draw.tv_starts, self.lat_size, pl.warp, pl.slab_window,
            pl.inside, self.sigma_keep, pl.slope_bounds)

    def run_step(self, draw: SwrDraw | SwrShardedDraw | None = None):
        """One training step on ``draw`` (the next :meth:`draw`, with a mesh
        :meth:`draw_sharded`, if None)."""
        with profiling.span("swr.step"):
            with profiling.span("swr.plan"):
                require_fp32_matmul()
                self._advance_phases()
                if self.mesh is not None:
                    draw = draw or self.draw_sharded()
                    pl = self.plan_sharded(draw)
                else:
                    draw = draw or self.draw()
                    pl = self.plan(draw)
            if self.mesh is not None:
                return self._run_step_sharded(draw, pl)
            self.state, metrics = swr_train_step(
                self.state, self.images[draw.i], self.poses_np[draw.i],
                self.K, draw.crop_xy, self.cur_mcfg, self.tcfg, pl.axis,
                pl.flip, draw.bg, draw.tv_starts, self.lat_size, pl.warp,
                pl.slab_window, pl.inside, self.sigma_keep, pl.slope_bounds,
            )
            self.step += 1
            return metrics

    def _run_step_sharded(self, draw: SwrShardedDraw, pl: SwrStepPlan):
        """One crop-parallel step on ``draw``'s plan ``pl``: this rank
        trains crop ``rank`` of the draw; the step of each sweep choice is
        made once a phase."""
        from ..parallel.swr_shard import make_swr_sharded_step

        with_sk = self.sigma_keep is not None
        with_sb = pl.slope_bounds is not None
        key = (self._phase_idx, pl.axis, pl.flip, pl.inside, pl.warp,
               pl.slab_window, self.lat_size, with_sk, with_sb)
        fn = self._sharded_steps.get(key)
        if fn is None:
            fn = make_swr_sharded_step(
                self.cur_mcfg, self.tcfg, self.mesh, pl.axis, pl.flip,
                slab_window=pl.slab_window, warp=pl.warp, inside=pl.inside,
                lat_size=self.lat_size, with_sigma_keep=with_sk,
                with_slope_bounds=with_sb)
            self._sharded_steps[key] = fn
        r = self.mesh.rank
        extras = (([self.sigma_keep] if with_sk else [])
                  + ([pl.slope_bounds[r]] if with_sb else []))
        self.state, metrics = fn(
            self.state, self.images[draw.idxs[r]],
            self.poses_np[draw.idxs[r]], self.K, draw.wins[r], *extras,
            bg=draw.bg, tv_starts=draw.tv_starts)
        self.step += 1
        return metrics

    def fit(self, max_steps=None, log_every: int = 500, log_fn=print):
        """``max_steps`` steps, logging every ``log_every`` (rank 0 alone,
        with a mesh)."""
        max_steps = max_steps or self.tcfg.max_steps
        tic = time.time()
        m = None
        rank0 = self.mesh is None or self.mesh.rank == 0
        for _ in range(max_steps):
            m = self.run_step()
            if rank0 and (self.step - 1) % log_every == 0:
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
        grid is baked in ``bake_dtype`` (and carved with ``cam_carve``); the
        resample operands are fp32, as the JAX trainer renders.  A camera
        inside the grid renders through :func:`render_swr_inside`, with no
        early exit."""
        require_fp32_matmul()
        if self._grid_cache[0] != self.step:
            with torch.no_grad():
                grid = pyr.bake(self.state.params, self.cur_mcfg,
                                _RS_DTYPES[self.tcfg.bake_dtype])
                if self.sigma_keep is not None:
                    grid = apply_sigma_keep(grid, self.sigma_keep)
                self._grid_cache = (self.step, grid)
        grid = self._grid_cache[1]
        if lat_cap == "auto":
            lat_cap = int(1.25 * self.cur_mcfg.grid_res) + 16
        pose_np = np.asarray(pose, np.float32).reshape(3, 4)
        inside = is_inside(pose_np, self.cur_mcfg.scale)
        kw = {} if inside else {"early_exit": float(early_exit)}
        with torch.no_grad():
            return (render_swr_inside if inside else render_swr)(
                self.state.params, grid, self.cur_mcfg, pose_np,
                self.K if K is None else K,
                tuple(img_wh or self.img_wh),
                lat_cap=lat_cap,
                n_chunks=min(self.tcfg.n_chunks, self.cur_mcfg.grid_res),
                white_bg=self.tcfg.white_bg,
                skip_empty=True,
                near=self.tcfg.near,
                resample_kind=self.tcfg.resample_kind,
                sweep_impl=self.tcfg.sweep_impl,
                **kw,
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
