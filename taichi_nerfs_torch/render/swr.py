"""Shear-warp frustum renderer: the dense pyramid's serving and training
path.

Port of the JAX package's ``render/swr.py`` for cameras outside the scene
cube.  One frame (see the JAX module's docstring for the geometry):

1. the baked grid is transposed so the dominant view axis leads and cut
   into ``n_chunks`` chunks of ``dc`` slabs;
2. per chunk, a lattice frame tightly covering the view frustum (and the
   cube's shadow) on the chunk's mean slab plane, and per slab the affine
   (start, step) of the resample onto it;
3. the slabs composite front to back into one frame per chunk, either
   - in the sweep (:func:`taichi_nerfs_torch.ops.swr_sweep.chunk_sweep`,
     the CUDA kernels on the card) when the call is in its scope: deferred
     shading, an unsplit grid, no distortion and full-matrix resamples
     (``slab_window=0``), as the JAX package takes its Pallas kernel; or
   - in the slab scan (the counterpart of the JAX ``chunk_body``): per
     slab a full-matrix or windowed resample, the split grid's two sigma
     sub-slabs, per-sample shading with the rgb MLP and the distortion
     loss's running sums, each slab checkpointed for the backward;
4. the chunk frames fold front to back into one global frame on the cube's
   centre plane (with the distortion loss's cross-chunk term);
5. a two-pass band-matrix warp (or a bilinear gather) takes that frame to
   pixels; deferred shading then runs the rgb MLP once per pixel.

Cameras inside the scene cube render one cubemap face per call
(``inside=True``): the frustum slopes are bounded by the face's dominance
cone (or tight caller bounds), slabs at or behind the camera's near margin
never composite, each chunk's reference plane is the mean of its valid
slabs, and the global frame sits between the camera and the face's wall.
:func:`render_swr_inside` splits an image into its faces and merges them
per pixel.  Inside calls always take the slab scan, as the JAX package
keeps them out of its Pallas kernel's scope; so does ``debug_frames``,
which also returns the global frame and each chunk's frames.

bf16: the grid may be a bf16 bake (``bake(..., dtype=torch.bfloat16)``);
it reaches the sweep kernels, or the scan's resamples, without an fp32
copy.  ``resample_dtype="bfloat16"`` rounds the operands where the JAX
renderer casts them to its ``rs_dtype``: the scan's slab resamples, the
first of the split sigma resamples, the sweep's operands and the final
warp's band matrices and frames; products accumulate in fp32.  The fold
stays fp32, as in the JAX package.

Precision: the two 3x3 contractions that the JAX renderer runs at
``Precision.HIGHEST`` (the corner directions and the per-pixel directions)
are explicit elementwise fp32 sums here, so no TF32 setting reaches them.
Every other fp32 matmul is a plain ``torch.matmul``/``bmm``, full fp32 on
CUDA while ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's
default; ``render/serve.py`` states and checks it).

There is no per-chunk VMEM-budget dispatch as on the TPU: the sweep runs
all chunks in one call, or one chunk per call in the early-exit loop.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models import pyramid as pyr
from ..ops.sh import sh_encode
from ..ops.swr_sweep import chunk_sweep, chunk_sweep_reference
from ..ops.warp import (
    resample_matmul,
    resample_matmul_batched,
    resample_matmul_windowed,
    resample_window,
)

# profiler spans of the frame's stages (cheap while no profiler runs)
_span = torch.profiler.record_function

_RS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_args(cfg, grid, *, debug_frames, slab_window, resample_dtype,
                want_distortion, resample_kind, early_exit):
    if resample_dtype not in _RS_DTYPES:
        raise ValueError(f"unknown resample_dtype {resample_dtype!r}")
    if resample_kind not in ("linear", "cubic"):
        raise ValueError(f"unknown resample kind {resample_kind!r}")
    if resample_kind != "linear" and slab_window:
        raise ValueError("cubic resampling needs the full-matrix path "
                         "(slab_window=0)")
    if early_exit and (want_distortion or debug_frames):
        raise ValueError("early_exit is eval-only: no distortion or debug "
                         "frames")
    if isinstance(grid, tuple) != cfg.split:
        raise ValueError("a split config (sigma_res) bakes to the pair "
                         "(sigma, feats), an unsplit one to one grid")


def _guard(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Sign-preserving division guard: |x| < eps becomes +-eps."""
    return torch.where(
        torch.abs(x) < eps,
        torch.where(x >= 0, eps, -eps).to(x.dtype),
        x,
    )


def _safe(x, eps: float = 1e-5):
    """Sign-preserving clamp away from 0 (the inside sweep's divisions):
    x >= 0 becomes at least eps, x < 0 at most -eps."""
    return torch.where(x >= 0, torch.clamp(x, min=eps),
                       torch.clamp(x, max=-eps))


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the operand ``dtype``, kept fp32 (a matmul of such
    operands is the JAX fp32-accumulated product)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _dirs(pose: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """World directions ``pose[:, :3] @ cam`` for (..., 3) camera dirs, as
    explicit fp32 sums (no matmul, so no TF32)."""
    return (
        cam[..., 0:1] * pose[:, 0]
        + cam[..., 1:2] * pose[:, 1]
        + cam[..., 2:3] * pose[:, 2]
    )


def render_swr_fixed_axis(
    params,
    grid,
    cfg: pyr.PyramidConfig,
    pose,  # (3, 4) camera-to-world
    K,  # (3, 3) pinhole intrinsics
    img_wh: Tuple[int, int],
    axis: int,
    flip: bool,
    n_chunks: int = 16,
    lat_pad: int = 16,
    white_bg: bool = True,
    debug_frames: bool = False,
    slab_window: int = 0,
    lat_size: int = 0,
    resample_dtype: str = "float32",
    skip_empty: bool = False,
    warp: str = "matmul",
    want_distortion: bool = False,
    inside: bool = False,
    slope_bounds=None,
    near: float = 0.0,
    sweep_impl: str = "auto",
    early_exit: float = 0.0,
    resample_kind: str = "linear",
) -> Dict[str, torch.Tensor]:
    """Render with a given sweep axis and direction.

    Args mirror the JAX function.  ``grid`` is the baked fp32 or bf16
    ``(R, R, R, F)`` grid on the render device, or for a split config the
    pair ``(sigma (Rs, Rs, Rs), feats (R, R, R, F-1))``; ``pose`` and ``K``
    may be numpy arrays or tensors.  ``resample_dtype`` ("float32" or
    "bfloat16") is the resample operand dtype.

    Dispatch, as in the JAX package: the sweep takes every call with
    deferred shading, an unsplit grid, no distortion and ``slab_window=0``;
    ``sweep_impl`` picks its implementation, "auto" (:func:`chunk_sweep`:
    the CUDA kernels for CUDA tensors, the plain version on the CPU) or
    "reference" (the plain PyTorch sweep on any device).  Every other call
    takes the slab scan on the grid's device, whatever ``sweep_impl``.

    ``slab_window`` > 0 resamples each slab from a source window of that
    width (:func:`slab_window_bound` gives one that covers the support;
    linear only).  ``skip_empty`` skips the scan's slabs whose max sigma is
    <= 1e-4 (one host read per frame); the sweep composites every slab, as
    the JAX package's kernel does.  ``early_exit`` > 0 stops once every
    pixel's transmittance is below it (one host read per chunk); the sweep
    then runs one chunk per call, skipping empty chunks and stopping once
    no occupied chunk remains.

    Returns ``rgb`` (H*W, 3), ``depth`` (H*W,) and ``opacity`` (H*W,), and
    with ``want_distortion`` the per-pixel ``distortion`` (H*W,).
    """
    _check_args(
        cfg, grid, debug_frames=debug_frames, slab_window=slab_window,
        resample_dtype=resample_dtype, want_distortion=want_distortion,
        resample_kind=resample_kind, early_exit=early_exit,
    )
    if sweep_impl == "auto":
        sweep = chunk_sweep
    elif sweep_impl == "reference":
        sweep = chunk_sweep_reference
    else:
        raise ValueError(f"unknown sweep_impl {sweep_impl!r}")
    if warp not in ("matmul", "matmul_x", "gather"):
        raise ValueError(f"unknown warp {warp!r}")
    split = isinstance(grid, tuple)
    dev = grid[0].device if split else grid.device
    f32 = torch.float32
    rs_dtype = _RS_DTYPES[resample_dtype]
    pose = _as_f32(pose, dev)
    K = _as_f32(K, dev)
    s = cfg.scale
    R = cfg.grid_res
    F = cfg.features
    h = 2.0 * s / R
    w_img, h_img = img_wh
    nq = lat_size if lat_size else max(w_img, h_img) + lat_pad
    # deferred shading composites the (F-1) feature channels, else rgb
    acc_ch = (F - 1) if cfg.deferred else 3
    if R % n_chunks:
        raise ValueError(f"n_chunks={n_chunks} must divide R={R}")
    in_sweep = (cfg.deferred and not split and not want_distortion
                and not inside and not debug_frames and slab_window == 0)
    # the inside face's sign along the axis and the near margin: at least
    # the camera's own slab (a near voxel covers a huge solid angle)
    sign_face = -1.0 if flip else 1.0
    margin = max(0.5 * h, near)
    safe = _safe if inside else (lambda x: x)

    with _span("swr.setup"):
        b_axis, c_axis = [d for d in range(3) if d != axis]
        zs = -s + (torch.arange(R, dtype=f32, device=dev) + 0.5) * h
        if split:
            # the sweep stays at feature granularity; each feature slab
            # composites its two sigma sub-slabs (h_s = h / 2)
            sigma_g, feat_g = grid
            Rs = cfg.sigma_res
            h_s = 2.0 * s / Rs
            vol = feat_g.permute(axis, 3, b_axis, c_axis)
            vol_s = sigma_g.permute(axis, b_axis, c_axis)
            zs_s = -s + (torch.arange(Rs, dtype=f32, device=dev) + 0.5) * h_s
            if flip:
                vol_s = torch.flip(vol_s, dims=(0,))
                zs_s = torch.flip(zs_s, dims=(0,))
            # after a flip, consecutive sub-slab pairs still belong to one
            # feature slab, near to far
            vol_s = vol_s.reshape(R, 2, Rs, Rs)
            zs_s2 = zs_s.reshape(R, 2)
        else:
            # vol: (D, F, Rb, Rc), the sweep axis leading, channels next
            vol = grid.permute(axis, 3, b_axis, c_axis)
        if flip:
            vol = torch.flip(vol, dims=(0,))
            zs = torch.flip(zs, dims=(0,))
        vol = vol.contiguous()

        o = pose[:, 3]
        o_a, o_b, o_c = o[axis], o[b_axis], o[c_axis]

        # frustum corner-ray slopes: q(z) = o_bc + (z - o_a) * slope
        cu = torch.tensor([0.0, w_img - 1.0], dtype=f32, device=dev)
        cv = torch.tensor([0.0, h_img - 1.0], dtype=f32, device=dev)
        uu, vv = torch.meshgrid(cu, cv, indexing="xy")
        corner_cam = torch.stack(
            [
                (uu - K[0, 2] + 0.5) / K[0, 0],
                (vv - K[1, 2] + 0.5) / K[1, 1],
                torch.ones_like(uu),
            ],
            dim=-1,
        ).reshape(-1, 3)
        corner_w = _dirs(pose, corner_cam)  # (4, 3)
        if inside:
            if slope_bounds is not None:
                (sb_lo, sb_hi), (sc_lo, sc_hi) = _as_f32(slope_bounds, dev)
            else:
                # every corner on the face's side: the slopes are monotone
                # along every line of the view, so the corners bound them
                # (clipped to the dominance cone); else the whole cone
                d_a_c = corner_w[:, axis]
                one_face = torch.all(sign_face * d_a_c > 1e-6)
                sb_c = torch.clamp(corner_w[:, b_axis] / _safe(d_a_c),
                                   -1.05, 1.05)
                sc_c = torch.clamp(corner_w[:, c_axis] / _safe(d_a_c),
                                   -1.05, 1.05)
                cone = torch.tensor(1.05, dtype=f32, device=dev)
                sb_lo = torch.where(one_face, sb_c.min(), -cone)
                sb_hi = torch.where(one_face, sb_c.max(), cone)
                sc_lo = torch.where(one_face, sc_c.min(), -cone)
                sc_hi = torch.where(one_face, sc_c.max(), cone)
        else:
            # division guard only: large slopes are legitimate geometry
            d_a_c = _guard(corner_w[:, axis], 1e-12)
            slope_b = corner_w[:, b_axis] / d_a_c
            slope_c = corner_w[:, c_axis] / d_a_c
            sb_lo, sb_hi = slope_b.min(), slope_b.max()
            sc_lo, sc_hi = slope_c.min(), slope_c.max()
            # the corner-slope frustum interval is valid only when the
            # sweep-axis direction component keeps one sign over the view
            d_ac = corner_w[:, axis]
            frustum_ok = (d_ac.min() > 0) | (d_ac.max() < 0)

        def frame_at(z_ref):
            """Lattice origin/spacing covering the frustum at plane z_ref
            (for an outside camera intersected with the cube's shadow).
            ``z_ref`` may be a vector (one frame per chunk)."""
            za = z_ref - o_a
            pos = za >= 0
            b0 = o_b + za * torch.where(pos, sb_lo, sb_hi)
            b1 = o_b + za * torch.where(pos, sb_hi, sb_lo)
            c0 = o_c + za * torch.where(pos, sc_lo, sc_hi)
            c1 = o_c + za * torch.where(pos, sc_hi, sc_lo)
            if not inside:
                b0, b1, c0, c1 = shadow(za, b0, b1, c0, c1)
            db = (b1 - b0) / (nq - 1 - lat_pad)
            dc = (c1 - c0) / (nq - 1 - lat_pad)
            # centre the margin
            return b0 - db * (lat_pad // 2), db, c0 - dc * (lat_pad // 2), dc

        def shadow(za, b0, b1, c0, c1):
            """The frustum frame intersected with the cube's
            central-projection shadow on the plane (outside cameras)."""
            # cube expanded by 2h: trilinear support + frame margin
            sE = s + 2.0 * h
            r_hi = za / _guard(sE - o_a, 1e-6)
            r_lo = za / _guard(-sE - o_a, 1e-6)
            qb = torch.stack(
                [
                    o_b + (sE - o_b) * r_hi,
                    o_b + (sE - o_b) * r_lo,
                    o_b + (-sE - o_b) * r_hi,
                    o_b + (-sE - o_b) * r_lo,
                ]
            )
            qc = torch.stack(
                [
                    o_c + (sE - o_c) * r_hi,
                    o_c + (sE - o_c) * r_lo,
                    o_c + (-sE - o_c) * r_hi,
                    o_c + (-sE - o_c) * r_lo,
                ]
            )
            # axis-0 reductions keep a vector z_ref per chunk
            qb_lo, qb_hi = qb.amin(dim=0), qb.amax(dim=0)
            qc_lo, qc_hi = qc.amin(dim=0), qc.amax(dim=0)
            nb0 = torch.where(frustum_ok, torch.maximum(b0, qb_lo), qb_lo)
            nb1 = torch.where(frustum_ok, torch.minimum(b1, qb_hi), qb_hi)
            nc0 = torch.where(frustum_ok, torch.maximum(c0, qc_lo), qc_lo)
            nc1 = torch.where(frustum_ok, torch.minimum(c1, qc_hi), qc_hi)
            # empty intersection: any non-degenerate frame renders it right
            return (nb0, torch.maximum(nb1, nb0 + 1e-5),
                    nc0, torch.maximum(nc1, nc0 + 1e-5))

        dc_slabs = R // n_chunks
        zs_c = zs.reshape(n_chunks, dc_slabs)

        # the global frame: on the cube-centre plane outside; inside between
        # the camera and the face's wall (the centre can be behind it)
        if inside:
            z_g = 0.5 * (torch.clamp(o_a, -s, s) + sign_face * s)
        else:
            z_g = torch.zeros((), dtype=f32, device=dev)
        g_b0, g_db, g_c0, g_dc = frame_at(z_g)

        # per-chunk reference planes + lattice frames, vectorised over chunks
        if inside:
            # the mean of the chunk's valid (camera-side) slabs; a chunk
            # with none parks on the face's wall, so every division stays
            # finite on both sides of the where
            v_ch = (sign_face * (zs_c - o_a) > margin).to(f32)
            n_v = v_ch.sum(dim=1)
            z_ref_c = torch.where(
                n_v > 0, (zs_c * v_ch).sum(dim=1) / torch.clamp(n_v, min=1.0),
                o_a + sign_face * s)
        else:
            z_ref_c = zs_c.mean(dim=1)  # (n_chunks,)
        fb0_c, fdb_c, fc0_c, fdc_c = frame_at(z_ref_c)

    # global carry, channel-leading: acc (acc_ch, nq, nq), depth, T[, dist]
    carry = (
        torch.zeros((acc_ch, nq, nq), dtype=f32, device=dev),
        torch.zeros((nq, nq), dtype=f32, device=dev),
        torch.ones((nq, nq), dtype=f32, device=dev),
    )
    if want_distortion:
        carry += (torch.zeros((nq, nq), dtype=f32, device=dev),)

    def fold(g, packed, carry):
        """Fold chunk g's frame ``packed`` (acc, depth, opacity[, the
        chunk's distortion]) into the global frame: the ray at global
        lattice q_g crosses the chunk plane at o + (q_g - o) * rho_cg."""
        acc_g, depth_g, t_g = carry[:3]
        rho_cg = (z_ref_c[g] - o_a) / safe(z_g - o_a)
        f_b0, f_db, f_c0, f_dc = fb0_c[g], fdb_c[g], fc0_c[g], fdc_c[g]
        start_b = (o_b * (1 - rho_cg) + g_b0 * rho_cg - f_b0) / f_db
        step_b = g_db * rho_cg / f_db
        start_c = (o_c * (1 - rho_cg) + g_c0 * rho_cg - f_c0) / f_dc
        step_c = g_dc * rho_cg / f_dc
        packed = resample_matmul(
            packed, start_b, step_b, nq, axis=1, kind=resample_kind
        )
        packed = resample_matmul(
            packed, start_c, step_c, nq, axis=2, kind=resample_kind
        )
        if debug_frames:
            chunk_dbg[2].append(packed)
        depth_w = packed[acc_ch]
        # Catmull-Rom can overshoot the resampled opacity outside [0, 1]
        # at hard silhouettes; clamp (a no-op for linear)
        op_w = torch.clamp(packed[acc_ch + 1], 0.0, 1.0)
        out = (
            acc_g + t_g[None] * packed[:acc_ch],
            depth_g + t_g * depth_w,
            t_g * (1.0 - op_w),
        )
        if want_distortion:
            # chunk-local pair terms scale by t_g^2 (a chunk sample's global
            # weight is t_g * w); cross-chunk pairs close over the global
            # prefix sums (S_W = 1 - t_g, S_Wt = depth_g)
            out += (
                carry[3]
                + t_g * t_g * packed[acc_ch + 2]
                + 2.0 * t_g * ((1.0 - t_g) * depth_w - depth_g * op_w),
            )
        return out

    chunk_dbg = ([], [], [])  # with debug_frames: acc_c, t_c, packed
    if in_sweep:
        carry = _sweep_chunks(
            sweep, fold, carry, vol, zs_c, z_ref_c, (fb0_c, fdb_c, fc0_c,
                                                     fdc_c),
            o, axis, s, h, nq, n_chunks, early_exit, resample_kind, rs_dtype,
        )
    else:
        with _span("swr.setup"):
            lat_i = torch.arange(nq, dtype=f32, device=dev)
            slabs = vol.unbind(0)
            sub = (vol_s.unbind(0), zs_s2) if split else None
            occ = None
            if skip_empty:  # one host read per frame
                occ_t = (vol_s.amax(dim=(1, 2, 3)) if split
                         else vol[:, 0].amax(dim=(1, 2)))
                occ = (occ_t > 1e-4).tolist()
        # the sigma sub-slab resample step is 2x the feature step in index
        # units, so its source window doubles
        sigma_window = 2 * slab_window if split and slab_window else 0
        geo = dict(o=o, axis=axis, s=s, h=h, nq=nq, lat_i=lat_i,
                   kind=resample_kind, rs_dtype=rs_dtype,
                   slab_window=slab_window,
                   sigma_window=sigma_window,
                   h_s=h_s if split else None,
                   inside=(sign_face, margin) if inside else None)
        for g in range(n_chunks):
            if early_exit > 0.0 and float(carry[2].max()) <= early_exit:
                break  # one host read per chunk
            with _span("swr.scan"):
                packed = _scan_chunk(
                    params, cfg, geo, z_ref_c[g],
                    (fb0_c[g], fdb_c[g], fc0_c[g], fdc_c[g]),
                    slabs[g * dc_slabs:(g + 1) * dc_slabs],
                    zs_c[g], sub, g * dc_slabs, occ, want_distortion,
                )
            if debug_frames:
                chunk_dbg[0].append(packed[:acc_ch].permute(1, 2, 0))
                chunk_dbg[1].append(1.0 - packed[acc_ch + 1])
            with _span("swr.fold"):
                carry = fold(g, packed, carry)
    acc_g, depth_g, t_g = carry[:3]

    with _span("swr.warp"):
        # final projective warp: pixel -> global-frame lattice coords
        u = torch.arange(w_img, dtype=f32, device=dev)
        v = torch.arange(h_img, dtype=f32, device=dev)
        uu, vv = torch.meshgrid(u, v, indexing="xy")  # (h, w)
        dir_cam = torch.stack(
            [
                (uu - K[0, 2] + 0.5) / K[0, 0],
                (vv - K[1, 2] + 0.5) / K[1, 1],
                torch.ones_like(uu),
            ],
            dim=-1,
        )  # (h, w, 3)
        dir_w = _dirs(pose, dir_cam)
        da = dir_w[..., axis]
        # grazing rays cross the slab stack near-parallel: guard the division
        # (sign-preserving) and mask them out
        grazing = torch.abs(da) < 1e-6
        t_hit = (z_g - o_a) / _guard(da, 1e-6)
        pb = o_b + t_hit * dir_w[..., b_axis]
        pc = o_c + t_hit * dir_w[..., c_axis]
        li = torch.clamp((pb - g_b0) / g_db, -1.0, float(nq))
        lj = torch.clamp((pc - g_c0) / g_dc, -1.0, float(nq))
        behind = (t_hit <= 0.0) | grazing

        # (C, nq, nq) global frame, C = acc_ch + 2 [+ 1]
        img = torch.cat(
            [acc_g, depth_g[None], (1.0 - t_g)[None]]
            + ([carry[3][None]] if want_distortion else []), dim=0)

        if warp == "gather":
            i0 = torch.clamp(torch.floor(li).long(), 0, nq - 2)
            j0 = torch.clamp(torch.floor(lj).long(), 0, nq - 2)
            fi = torch.clamp(li - i0, 0.0, 1.0)
            fj = torch.clamp(lj - j0, 0.0, 1.0)
            pix = (
                img[:, i0, j0] * ((1 - fi) * (1 - fj))
                + img[:, i0, j0 + 1] * ((1 - fi) * fj)
                + img[:, i0 + 1, j0] * (fi * (1 - fj))
                + img[:, i0 + 1, j0 + 1] * (fi * fj)
            )  # (C, h, w)
        else:
            # two-pass (Catmull-Smith) warp as batched band-matrix products;
            # pass A solves each lattice row j for one camera-plane coordinate
            # ("matmul": y, per column u; "matmul_x": x, per row v), pass B
            # resamples along j.  Both passes use linear tents.
            r = pose[:, :3]  # world = r @ cam
            ra, rb, rc = r[axis], r[b_axis], r[c_axis]
            xs_pix = (torch.arange(w_img, dtype=f32, device=dev) - K[0, 2]
                      + 0.5) / K[0, 0]
            ys_pix = (torch.arange(h_img, dtype=f32, device=dev) - K[1, 2]
                      + 0.5) / K[1, 1]
            j_ar = torch.arange(nq, dtype=f32, device=dev)
            oa_rel = o_a - z_g
            gam = o_c - g_c0 - j_ar * g_dc  # (J,)
            if warp == "matmul_x":
                fidx, sidx, free = 1, 0, ys_pix
            else:
                fidx, sidx, free = 0, 1, xs_pix
            num = (oa_rel * rc[fidx] - gam[:, None] * ra[fidx]) * free[
                None, :
            ] + (oa_rel * rc[2] - gam[:, None] * ra[2])  # (J, N)
            den = (
                gam[:, None] * ra[sidx] - oa_rel * rc[sidx]
                + torch.zeros_like(num)
            )
            sol = num / torch.where(torch.abs(den) < 1e-12, 1e-12, den)
            if warp == "matmul_x":
                x_p, y_p = sol, free[None, :] + torch.zeros_like(sol)
            else:
                x_p, y_p = free[None, :] + torch.zeros_like(sol), sol
            da_j = ra[0] * x_p + ra[1] * y_p + ra[2]  # (J, N)
            db_j = rb[0] * x_p + rb[1] * y_p + rb[2]
            posA = ((o_b - g_b0) * da_j - oa_rel * db_j) / (
                g_db * torch.where(torch.abs(da_j) < 1e-12, 1e-12, da_j)
            )  # (J, N): source-i position for (row j, output line n)
            posA = torch.where(torch.isfinite(posA), posA, -1e9)
            i_ar = torch.arange(nq, dtype=f32, device=dev)
            WA = _round_to(torch.clamp(
                1.0 - torch.abs(i_ar[None, :, None] - posA[:, None, :]), min=0.0
            ), rs_dtype)  # (J, I, N)
            # inter[j, c, n] = sum_i img[c, i, j] * WA[j, i, n]
            inter = torch.bmm(_round_to(img.permute(2, 0, 1), rs_dtype),
                              WA)  # (J, C, N)
            posB = lj if warp == "matmul_x" else lj.T  # (N', N)
            posB = torch.where(torch.isfinite(posB), posB, -1e9)
            WB = _round_to(torch.clamp(
                1.0 - torch.abs(j_ar[None, :, None] - posB[:, None, :]), min=0.0
            ), rs_dtype)  # (N, J, N')
            # pixT[n, c, n'] = sum_j inter[j, c, n] * WB[n, j, n']
            pixT = torch.bmm(_round_to(inter.permute(2, 1, 0), rs_dtype),
                             WB)  # (N, C, N')
            if warp == "matmul_x":
                pix = pixT.permute(1, 0, 2)  # (C, H, W)
            else:
                pix = pixT.permute(1, 2, 0)  # (C, H, W)
        pix = torch.where(behind[None], 0.0, pix)

    with _span("swr.shade"):
        depth = pix[acc_ch]
        opacity = pix[acc_ch + 1]
        if cfg.deferred:
            # shade the opacity-normalised features once per pixel and
            # re-premultiply, so transparent pixels stay black
            dirs_pix = dir_w / torch.linalg.norm(dir_w, dim=-1, keepdim=True)
            feat_avg = pix[:acc_ch].permute(1, 2, 0) / torch.clamp(
                opacity, min=1e-6
            )[..., None]
            rgb = pyr.rgb_from_features(params, cfg, feat_avg, dirs_pix)
            rgb = rgb * opacity[..., None]
        else:
            rgb = pix[:3].permute(1, 2, 0)
        if white_bg:
            rgb = rgb + (1.0 - opacity)[..., None]
    out = {
        "rgb": rgb.reshape(h_img * w_img, 3),
        "depth": depth.reshape(h_img * w_img),
        "opacity": opacity.reshape(h_img * w_img),
    }
    if want_distortion:
        out["distortion"] = pix[acc_ch + 2].reshape(h_img * w_img)
    if debug_frames:
        out["global_frame"] = img.permute(1, 2, 0)
        out["chunk_debug"] = tuple(torch.stack(x) for x in chunk_dbg)
    return out


def _sweep_chunks(sweep, fold, carry, vol, zs_c, z_ref_c, frames, o, axis,
                  s, h, nq, n_chunks, early_exit, kind, dtype):
    """The sweep's chunks, folded: every chunk in one call, or with
    ``early_exit`` one chunk per call front to back, skipping empty chunks
    (max sigma <= 1e-4) and stopping once no occupied chunk remains or every
    pixel's transmittance is below ``early_exit``."""
    b_axis, c_axis = [d for d in range(3) if d != axis]
    o_a, o_b, o_c = o[axis], o[b_axis], o[c_axis]
    fb0_c, fdb_c, fc0_c, fdc_c = frames
    dc_slabs = zs_c.shape[1]
    with _span("swr.setup"):
        vol_c = vol.reshape(n_chunks, dc_slabs, *vol.shape[1:])
        # per-slab resample params (start_b, step_b, start_c, step_c)
        rho = (z_ref_c[:, None] - o_a) / (zs_c - o_a)  # (n_chunks, dc)
        rs_par = torch.stack(
            [
                (o_b + (fb0_c[:, None] - o_b) / rho + s) / h - 0.5,
                fdb_c[:, None] / (rho * h),
                (o_c + (fc0_c[:, None] - o_c) / rho + s) / h - 0.5,
                fdc_c[:, None] / (rho * h),
            ],
            dim=-1,
        ).contiguous()  # (n_chunks, dc, 4)
        z_rel = (zs_c - o_a).contiguous()
        ch_par = torch.stack(
            [
                fb0_c - o_b,
                fdb_c,
                fc0_c - o_c,
                fdc_c,
                z_ref_c - o_a,
                torch.full_like(z_ref_c, h),
            ],
            dim=-1,
        ).contiguous()  # (n_chunks, 6)
    acc_ch = vol.shape[1] - 1
    if early_exit > 0.0:
        occ_chunk = vol_c[:, :, 0].amax(dim=(1, 2, 3)) > 1e-4
        occ = occ_chunk.tolist()  # one host read per frame
        rem_occ = [any(occ[g:]) for g in range(n_chunks)]
        for g in range(n_chunks):
            if not rem_occ[g]:
                break
            if not occ[g]:
                continue  # t_g is unchanged: no need to read it
            if carry[2].max().item() <= early_exit:  # one host read a chunk
                break
            with _span("swr.sweep"):
                fr = sweep(
                    vol_c[g : g + 1], rs_par[g : g + 1], z_rel[g : g + 1],
                    ch_par[g : g + 1], nq, kind, dtype=dtype,
                )[0]
            with _span("swr.fold"):
                carry = fold(g, fr[: acc_ch + 2], carry)
        return carry
    with _span("swr.sweep"):
        frames = sweep(vol_c, rs_par, z_rel, ch_par, nq, kind, dtype=dtype)
    for g in range(n_chunks):
        with _span("swr.fold"):
            carry = fold(g, frames[g, : acc_ch + 2], carry)
    return carry


def _scan_chunk(params, cfg, geo, z_ref, frame, slabs, zs, sub, first, occ,
                want_distortion):
    """One chunk of the slab scan: its ``dc`` slabs composited front to back
    onto the chunk lattice (the JAX ``chunk_body``).

    ``frame`` is the lattice's (b0, db, c0, dc); ``slabs`` the chunk's
    (F, Rb, Rc) feature slabs at planes ``zs``; ``sub`` for a split grid the
    (R,) list of (2, Rs, Rs) sigma sub-slab pairs and their (R, 2) planes;
    ``first`` the index of the chunk's first slab; ``occ`` None, or per slab
    whether its max sigma is above 1e-4 (empty slabs are skipped).  Each
    slab is checkpointed under autograd: the backward recomputes its
    resamples and MLP activations instead of storing them.

    Returns (acc_ch + 2 [+ 1], nq, nq): the weighted features (deferred) or
    rgb, the depth, the opacity and, with ``want_distortion``, the chunk's
    distortion.
    """
    o, axis, s, h, nq = geo["o"], geo["axis"], geo["s"], geo["h"], geo["nq"]
    kind, rs_dtype = geo["kind"], geo["rs_dtype"]
    safe = _safe if geo["inside"] else (lambda x: x)

    def near_masked(alpha, z):
        """``alpha`` of the slab at ``z``, zeroed where an inside camera
        has it at or behind its near margin."""
        if geo["inside"] is None:
            return alpha
        sign_face, margin = geo["inside"]
        return alpha * (sign_face * (z - o_a) > margin).to(f32)

    b_axis, c_axis = [d for d in range(3) if d != axis]
    o_a, o_b, o_c = o[axis], o[b_axis], o[c_axis]
    f_b0, f_db, f_c0, f_dc = frame
    f32, dev = torch.float32, z_ref.device
    qb = f_b0 + geo["lat_i"] * f_db  # world b coords on this frame
    qc = f_c0 + geo["lat_i"] * f_dc
    # rays through the chunk lattice: P = (z_ref at axis, qb, qc)
    vb = qb[:, None] - o_b  # (nq, 1)
    vc = qc[None, :] - o_c  # (1, nq)
    va = z_ref - o_a
    norm = torch.sqrt(va * va + vb * vb + vc * vc)  # (nq, nq)
    inv_da = norm / torch.abs(va)
    dt = h * inv_da  # per-lattice step length along the ray
    sgn = torch.sign(va)
    d_enc = None
    if not cfg.deferred:
        # world-order unit direction, SH-encoded once per chunk
        comps = [None, None, None]
        comps[axis] = (va / norm).expand(nq, nq)
        comps[b_axis] = (vb / norm).expand(nq, nq)
        comps[c_axis] = (vc / norm).expand(nq, nq)
        d_enc = sh_encode((torch.stack(comps, dim=-1) + 1.0) / 2.0)

    def affine(z_k, h_src):
        # source index of lattice i: m(i) = (p_b + s)/h_src - 1/2 with
        # p_b = o_b + (q_i - o_b)/rho
        rho = safe((z_ref - o_a) / safe(z_k - o_a))
        return ((o_b + (f_b0 - o_b) / rho + s) / h_src - 0.5,
                f_db / (rho * h_src),
                (o_c + (f_c0 - o_c) / rho + s) / h_src - 0.5,
                f_dc / (rho * h_src))

    def to_lattice(x, z_k, h_src, window):
        # each resample: operands in rs_dtype (the weights take x's),
        # fp32 accumulation, an fp32 result
        sb, stb, sc, stc = affine(z_k, h_src)
        if window:
            x = resample_matmul_windowed(x.to(rs_dtype), sb, stb, nq, 1,
                                         window)
            return resample_matmul_windowed(x.to(rs_dtype), sc, stc, nq, 2,
                                            window)
        x = resample_matmul(x.to(rs_dtype), sb, stb, nq, 1, kind=kind)
        return resample_matmul(x.to(rs_dtype), sc, stc, nq, 2, kind=kind)

    def slab_work(acc, depth_acc, t_acc, dist_acc, f, z, sp, zp):
        if sp is not None:
            # features at slab granularity; alpha from the two sigma
            # sub-slabs, each with its own affine map
            feats = to_lattice(f, z, h, geo["slab_window"])
            h_s, sw = geo["h_s"], geo["sigma_window"]
            if sw:
                s0 = to_lattice(sp[0:1], zp[0], h_s, sw)[0]
                s1 = to_lattice(sp[1:2], zp[1], h_s, sw)[0]
            else:
                sb, stb, sc, stc = affine(zp, h_s)  # (2,) each
                # as the JAX renderer: the first resample's operands in
                # rs_dtype, the second's in its fp32 result's dtype
                q = resample_matmul_batched(sp.to(rs_dtype), sb, stb, nq, 1,
                                            kind=kind)
                q = resample_matmul_batched(q, sc, stc, nq, 2, kind=kind)
                s0, s1 = q[0], q[1]
            dt_s = 0.5 * dt
            a0 = near_masked(
                1.0 - torch.exp(-torch.clamp(s0, min=0.0) * dt_s), zp[0])
            a1 = near_masked(
                1.0 - torch.exp(-torch.clamp(s1, min=0.0) * dt_s), zp[1])
            w0 = a0 * t_acc
            w1 = a1 * t_acc * (1.0 - a0)
            w = w0 + w1
            t0r = (zp[0] - o_a) * inv_da * sgn
            t1r = (zp[1] - o_a) * inv_da * sgn
            depth_contrib = w0 * t0r + w1 * t1r
            t_next = t_acc * (1.0 - a0) * (1.0 - a1)
            if dist_acc is not None:
                s_w = 1.0 - t_acc
                s_wt = depth_acc
                dcon = 2.0 * w0 * (t0r * s_w - s_wt) + w0 * w0 * dt_s / 3.0
                s_w = s_w + w0
                s_wt = s_wt + w0 * t0r
                dcon = dcon + (2.0 * w1 * (t1r * s_w - s_wt)
                               + w1 * w1 * dt_s / 3.0)
        else:
            sq = to_lattice(f, z, h, geo["slab_window"])  # (F, nq, nq)
            sigma = torch.clamp(sq[0], min=0.0)
            feats = sq[1:]
            alpha = near_masked(1.0 - torch.exp(-sigma * dt), z)
            w = alpha * t_acc
            t_ray = (z - o_a) * inv_da * sgn
            depth_contrib = w * t_ray
            t_next = t_acc * (1.0 - alpha)
            if dist_acc is not None:
                dcon = (2.0 * w * (t_ray * (1.0 - t_acc) - depth_acc)
                        + w * w * dt / 3.0)
        if cfg.deferred:
            contrib = feats
        else:
            contrib = pyr.rgb_from_features_enc(
                params, cfg, feats.permute(1, 2, 0), d_enc
            ).permute(2, 0, 1)
        out = (acc + w[None] * contrib, depth_acc + depth_contrib, t_next)
        if dist_acc is not None:
            out += (dist_acc + dcon,)
        return out

    acc_ch = (cfg.features - 1) if cfg.deferred else 3
    carry = [
        torch.zeros((acc_ch, nq, nq), dtype=f32, device=dev),
        torch.zeros((nq, nq), dtype=f32, device=dev),
        torch.ones((nq, nq), dtype=f32, device=dev),
        torch.zeros((nq, nq), dtype=f32, device=dev)
        if want_distortion else None,
    ]
    grad = torch.is_grad_enabled()
    for k, f in enumerate(slabs):
        if occ is not None and not occ[first + k]:
            continue
        args = (*carry, f, zs[k])
        args += (sub[0][first + k], sub[1][first + k]) if sub else (None,
                                                                   None)
        # remat: without it the backward keeps every slab's resampled frame
        # and MLP activations; recomputing them per slab keeps the live set
        # at the carry
        out = (checkpoint(slab_work, *args, use_reentrant=False) if grad
               else slab_work(*args))
        carry = [*out, None] if len(out) == 3 else list(out)
    acc, depth, t, dist = carry
    return torch.cat(
        [acc, depth[None], (1.0 - t)[None]]
        + ([dist[None]] if want_distortion else []), dim=0)


def _cam_dirs(pose, K, uu, vv) -> np.ndarray:
    """Host float64 world directions of the pixels (uu, vv)."""
    K = np.asarray(K, np.float64)
    cam = np.stack(
        [
            (uu - K[0, 2] + 0.5) / K[0, 0],
            (vv - K[1, 2] + 0.5) / K[1, 1],
            np.ones_like(uu),
        ],
        axis=-1,
    )
    return cam @ np.asarray(pose, np.float64).reshape(3, 4)[:, :3].T


def _grid_dirs(pose, K, img_wh, n_grid: int, crop_xy=(0, 0)) -> np.ndarray:
    """Host: the float64 directions of an ``n_grid`` x ``n_grid`` pixel
    grid spanning the (cropped) view."""
    w, h = img_wh
    u = crop_xy[0] + np.linspace(0.0, w - 1.0, n_grid)
    v = crop_xy[1] + np.linspace(0.0, h - 1.0, n_grid)
    return _cam_dirs(pose, K, *np.meshgrid(u, v, indexing="xy"))


def _pixel_slopes(pose, K, img_wh, axis, n_grid: int = 17):
    """Host helper: ray slopes (d_b/d_a, d_c/d_a) on a pixel grid."""
    world = _grid_dirs(pose, K, img_wh, n_grid)
    b_axis, c_axis = [d for d in range(3) if d != axis]
    sb = world[..., b_axis] / world[..., axis]
    sc = world[..., c_axis] / world[..., axis]
    return sb, sc


def _matmul_solve_choice(
    pose, axis: int, sc_lo: float, sc_hi: float, tol: float = 1e-3
) -> str:
    """Host: pick the matmul warp's pass-A solve coordinate.

    The pass-A denominator for solve coordinate ``s`` is proportional to
    ``rc[s] - slope_c * ra[s]`` over the lattice's slope_c range; a zero
    crossing inside the range sends that row's solve to infinity.  Returns
    "matmul" (solve for camera y) when its denominator stays away from zero
    over ``[sc_lo, sc_hi]``, else "matmul_x", else "gather".
    """
    r = np.asarray(pose, np.float64)[:, :3]
    c_axis = [d for d in range(3) if d != axis][1]
    ra, rc = r[axis], r[c_axis]
    pad = 0.05 * max(sc_hi - sc_lo, 0.1)
    lo, hi = sc_lo - pad, sc_hi + pad
    for s, name in ((1, "matmul"), (0, "matmul_x")):
        e0 = rc[s] - lo * ra[s]
        e1 = rc[s] - hi * ra[s]
        if e0 * e1 > 0 and min(abs(e0), abs(e1)) > tol:
            return name
    return "gather"


def pick_warp(
    pose,
    K,
    img_wh: Tuple[int, int],
    axis: int,
    face_sign: float | None = None,
    crop_xy: Tuple[int, int] = (0, 0),
    n_grid: int = 7,
) -> str:
    """Host: final-warp mode for one (pose, face[, crop]).

    Samples ray slopes on an ``n_grid`` x ``n_grid`` pixel grid of the
    (cropped) view; ``face_sign`` (+-1) restricts to the pixels a cubemap
    face owns, and delegates the conditioning test to
    :func:`_matmul_solve_choice`.
    """
    pose = np.asarray(pose, np.float64).reshape(3, 4)
    d = _grid_dirs(pose, K, img_wh, n_grid, crop_xy)
    c_axis = [x for x in range(3) if x != axis][1]
    da = d[..., axis]
    if face_sign is not None:
        dom = np.argmax(np.abs(d), axis=-1)
        m = (dom == axis) & (face_sign * da > 0)
        if not m.any():
            return "matmul"
        sc = d[..., c_axis][m] / da[m]
    else:
        sc = d[..., c_axis] / np.where(np.abs(da) < 1e-12, 1e-12, da)
    return _matmul_solve_choice(
        pose, axis, float(sc.min()), float(sc.max())
    )


def _max_window_span(arr, k: int) -> float:
    """Max (max - min) over any (k+1) x (k+1) sample window of a 2-D grid."""
    n = arr.shape[0]
    k = min(k, n - 1)
    best = 0.0
    for i in range(n - k):
        for j in range(arr.shape[1] - k):
            sub = arr[i : i + k + 1, j : j + k + 1]
            best = max(best, float(sub.max() - sub.min()))
    return best


def slab_window_bound(
    poses,
    K,
    img_wh: Tuple[int, int],
    cfg: pyr.PyramidConfig,
    crop: int | None = None,
    lat_pad: int = 16,
    safety: float = 1.1,
    lat_size: int = 0,
) -> int:
    """Host: a source-window width covering every slab resample, or 0 (the
    full matrix).

    The per-slab resample step is ``frustum_width(z_k) / (h * (nq - 1 -
    lat_pad))``; its max over the poses (and, with ``crop``, over every
    ``crop`` x ``crop`` sub-frustum, from a 17 x 17 grid of pixel slopes)
    bounds the source support (:func:`resample_window`).  Returns 0 when
    the window would exceed a quarter of R: the windowed product then saves
    too little over the full one.  ``lat_size`` overrides the lattice side
    (as the render call's); the frustum span still comes from ``crop``.
    """
    R, s = cfg.grid_res, cfg.scale
    h = 2.0 * s / R
    w_img, h_img = img_wh
    out_side = crop if crop else max(img_wh)
    nq = lat_size if lat_size else out_side + lat_pad
    denom = (nq - 1 - lat_pad) * h
    n_grid = 17
    if crop:
        ku = int(np.ceil((crop - 1) / max(w_img - 1, 1) * (n_grid - 1))) + 1
        kv = int(np.ceil((crop - 1) / max(h_img - 1, 1) * (n_grid - 1))) + 1
        k = max(ku, kv)
    else:
        k = n_grid - 1
    step_max = 0.0
    for p in np.asarray(poses, np.float32).reshape(-1, 3, 4):
        axis = int(np.argmax(np.abs(p[:, 2])))
        sb, sc = _pixel_slopes(p, K, img_wh, axis, n_grid)
        dist = abs(float(p[axis, 3])) + s
        for arr in (sb, sc):
            span = _max_window_span(arr, k)
            step_max = max(step_max, dist * span / denom)
    win = resample_window(step_max * safety, nq)
    return 0 if win * 4 > R else win


def sweep_axis(pose) -> Tuple[int, bool]:
    """Host: the dominant view axis of ``pose`` and whether the sweep runs
    descending (camera on the +axis side), as ``render_swr`` picks them."""
    pose = np.asarray(pose, np.float32).reshape(3, 4)
    axis = int(np.argmax(np.abs(pose[:, 2])))
    return axis, bool(pose[axis, 3] > 0)


def render_swr(
    params,
    grid: torch.Tensor,
    cfg: pyr.PyramidConfig,
    pose,
    K,
    img_wh: Tuple[int, int],
    lat_cap: int | None = None,
    **kw,
) -> Dict[str, torch.Tensor]:
    """Host wrapper: picks the dominant sweep axis from the concrete pose.

    ``lat_cap`` bounds the intermediate-lattice side (the final warp
    magnifies); e.g. ``int(1.25 * cfg.grid_res)`` for fast high-resolution
    renders.
    """
    pose = _host_f32(pose).reshape(3, 4)
    K = _host_f32(K)
    axis, flip = sweep_axis(pose)
    lat_pad = kw.get("lat_pad", 16)
    if lat_cap and max(img_wh) + lat_pad > lat_cap:
        kw["lat_size"] = lat_cap
    if "warp" not in kw:
        kw["warp"] = pick_warp(pose, K, tuple(img_wh), axis)
    return render_swr_fixed_axis(
        params, grid, cfg, pose, K, tuple(img_wh), axis, flip, **kw
    )


def face_slope_bounds(
    pose,
    K,
    img_wh: Tuple[int, int],
    axis: int,
    face_sign: float,
    crop_xy: Tuple[int, int] = (0, 0),
    n_grid: int = 17,
    pad: float = 0.02,
):
    """Host: tight (2, 2) slope bounds of a face's pixels in a crop.

    Samples the ray slopes (d_b/d_a, d_c/d_a) on an ``n_grid`` grid of the
    crop, restricted to the pixels the cubemap face ``(axis,
    sign(face_sign))`` owns.  Returns ``[[sb_lo, sb_hi], [sc_lo, sc_hi]]``
    (float32) for :func:`render_swr_fixed_axis`'s ``slope_bounds``, or None
    when the sampled grid has no pixel of the face.  An end past the
    dominance boundary (|slope| > 0.9, where the sampled extremum can
    undershoot the true one) widens to the cone's edge, 1.05; the others
    keep the measured value and ``pad``.
    """
    d = _grid_dirs(pose, K, img_wh, n_grid, crop_xy)
    b_axis, c_axis = [x for x in range(3) if x != axis]
    da = d[..., axis]
    m = (np.argmax(np.abs(d), axis=-1) == axis) & (face_sign * da > 0)
    if not m.any():
        return None
    out = np.empty((2, 2), np.float32)
    for row, ax in enumerate((b_axis, c_axis)):
        sl = d[..., ax][m] / da[m]
        lo, hi = float(sl.min()) - pad, float(sl.max()) + pad
        out[row, 0] = -1.05 if lo < -0.9 else lo
        out[row, 1] = 1.05 if hi > 0.9 else hi
    return out


def pixel_faces(pose, K, img_wh: Tuple[int, int]):
    """Host: the cubemap face of each pixel's ray.

    Returns ``(dom, pos, faces, dir_w)``: ``dom[h, w]`` the dominant world
    axis (the first of equal components), ``pos[h, w]`` whether its
    component is positive, ``faces`` the sorted distinct ``(axis,
    positive)`` pairs and ``dir_w`` the (h, w, 3) float64 directions.
    """
    w, h = img_wh
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64), indexing="xy")
    dir_w = _cam_dirs(pose, K, uu, vv)
    dom = np.argmax(np.abs(dir_w), axis=-1)
    d_dom = np.take_along_axis(dir_w, dom[..., None], axis=-1)[..., 0]
    pos = d_dom > 0
    faces = sorted({(int(a), bool(p)) for a, p in zip(dom.ravel(),
                                                     pos.ravel())})
    return dom, pos, faces, dir_w


def render_swr_inside(
    params,
    grid,
    cfg: pyr.PyramidConfig,
    pose,
    K,
    img_wh: Tuple[int, int],
    lat_cap: int | None = None,
    **kw,
) -> Dict[str, torch.Tensor]:
    """Render a camera inside the grid, one cubemap face at a time.

    The pixels are split by the signed axis that dominates their ray (one
    to six faces, one to three at a normal field of view); each face runs
    one ``inside=True`` sweep outward from the camera, over the tight slope
    bounds of its own pixels (padded by 0.02) and, unless ``warp`` is
    given, with its own pass-A solve (:func:`_matmul_solve_choice`).  Every
    pixel takes its own face's values.  ``lat_cap`` bounds the lattice as
    in :func:`render_swr`.
    """
    pose = _host_f32(pose).reshape(3, 4)
    K = _host_f32(K)
    dom, pos, faces, dir_w = pixel_faces(pose, K, img_wh)
    kw.pop("dist_min", None)
    lat_pad = kw.get("lat_pad", 16)
    if lat_cap and max(img_wh) + lat_pad > lat_cap:
        kw["lat_size"] = lat_cap
    pad = 0.02
    out = None
    for a, p in faces:
        b_ax, c_ax = [d for d in range(3) if d != a]
        m = (dom == a) & (pos == p)
        da = dir_w[..., a][m]
        sb = dir_w[..., b_ax][m] / da
        sc = dir_w[..., c_ax][m] / da
        bounds = np.asarray([[sb.min() - pad, sb.max() + pad],
                             [sc.min() - pad, sc.max() + pad]], np.float32)
        face_kw = kw
        if "warp" not in kw:
            # a sliver face's lattice c axis can align with image x, which
            # makes the default y-solve singular
            face_kw = dict(kw, warp=_matmul_solve_choice(
                pose, a, float(sc.min()) - pad, float(sc.max()) + pad))
        r = render_swr_fixed_axis(
            params, grid, cfg, pose, K, tuple(img_wh), a, not p,
            inside=True, slope_bounds=bounds, **face_kw,
        )
        mask = torch.as_tensor(m.reshape(-1), device=r["rgb"].device)
        out = {
            k: torch.where(mask[:, None] if v.ndim == 2 else mask, v,
                           0.0 if out is None else out[k])
            for k, v in r.items()
        }
    return out
