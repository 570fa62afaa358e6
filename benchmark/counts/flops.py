"""Operations the algorithm needs for one step or one frame, term by term,
each tagged with the precision the configuration runs it in.

These count the algorithm at the cell's inputs, not what an implementation
does: the resamples count their 2 (linear) or 4 (Catmull-Rom) taps a
separable pass, never a dense interpolation matrix; the bake counts the
separable trilinear upsample's 2 taps a pass; the warp its 2-tap tents; the
MLPs their multiply-adds (2 flops each).  A backward counts what the
gradient needs: a linear map of constant weights costs its transpose (the
forward's count again), a product of two trained operands twice that.
So a share of a peak built on these cannot pass 100 %, and moves only when
the time does.  Each term is ``(name, flops, precision)``; the precision
names a peak of ``counts/peaks.py``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


Term = Tuple[str, float, str]


def taps(kind: str) -> int:
    return 2 if kind == "linear" else 4


def mlp_macs(dims: Sequence[Tuple[int, int]]) -> int:
    """Multiply-adds of one row through layers of ``(in, out)``."""
    return sum(i * o for i, o in dims)


# ------------------------------------------------------------------ pyramid


def pyramid_mlp_dims(model: dict) -> List[Tuple[int, int]]:
    """The rgb MLP's layers: 16 SH terms and F - 1 features in, ``rgb_depth``
    hidden layers of ``rgb_width``, 3 out."""
    w, d = int(model["rgb_width"]), int(model["rgb_depth"])
    dims, fan_in = [], 16 + int(model["features"]) - 1
    for _ in range(d):
        dims.append((fan_in, w))
        fan_in = w
    return dims + [(fan_in, 3)]


def bake_flops(model: dict) -> float:
    """The bake: each running sum upsampled to the next level (three
    separable 2-tap passes), the level added, sigma's bias, cap and exp."""
    res = [int(r) for r in model["resolutions"]]
    F = int(model["features"])
    total = 0.0
    for r_in, r_out in zip(res, res[1:]):
        total += 2 * 2 * F * (r_out * r_in * r_in + r_out * r_out * r_in
                              + r_out ** 3)
        total += F * r_out ** 3
    return total + 3 * res[-1] ** 3


def param_count(model: dict) -> int:
    F = int(model["features"])
    levels = sum(int(r) ** 3 * F for r in model["resolutions"])
    return levels + sum(i * o for i, o in pyramid_mlp_dims(model))


def fold_flops(model: dict, nq: int, kind: str, n_chunks: int) -> float:
    """``n_chunks`` chunk frames (F - 1 features, depth, opacity) resampled
    onto the global lattice in two separable passes and composited (the
    features and depth a multiply-add each, the transmittance 3)."""
    C = int(model["features"]) + 1
    resample = 2 * 2 * taps(kind) * C * nq * nq
    composite = (2 * (C - 1) + 3) * nq * nq
    return n_chunks * (resample + composite)


def warp_flops(model: dict, nq: int, w: int, h: int) -> float:
    """The two-pass warp's 2-tap tents: the global frame's F + 1 channels
    along one lattice axis onto one pixel axis, then the other."""
    C = int(model["features"]) + 1
    return 2 * 2 * C * (nq * w + w * h)


def shade_terms(model: dict, pixels: int, backward: bool) -> List[Term]:
    """Deferred shading: the SH encoding and the normalisation (fp32) and
    the rgb MLP (bf16 operands) once a pixel."""
    macs = mlp_macs(pyramid_mlp_dims(model))
    mult = 3 if backward else 1  # the MLP's backward: inputs and weights
    fp32 = 60 + 2 * int(model["features"])
    return [("shade_mlp", mult * 2.0 * macs * pixels, "bf16"),
            ("shade_other", (2 if backward else 1) * fp32 * pixels, "fp32")]


def pyramid_step(model: dict, train: dict, sweep_fwd: float,
                 sweep_bwd: float) -> List[Term]:
    """One record-recipe step on a ``crop`` x ``crop`` crop: the bake, the
    sweep (``sweep_fwd`` and ``sweep_bwd``: the operations of the step's
    sweep calls, ``counts/sweep.py:sweep_needed``), the fold, the warp and
    the shading forward and backward, the loss and its terms, and Adam on
    every parameter."""
    R = int(model["resolutions"][-1])
    F = int(model["features"])
    c = int(train["crop"])
    kind = train["resample_kind"]
    nc = min(int(train["n_chunks"]), R)
    nq = c + 16
    bake = bake_flops(model)
    fold = fold_flops(model, nq, kind, nc)
    warp = warp_flops(model, nq, c, c)
    res = [int(r) for r in model["resolutions"]]
    tv = (sum(3 * 3 * r ** 3 * F for r in res[:-1])
          + 3 * 3 * (R // 4) * R * R * F)
    return [
        ("bake", 2 * bake, "fp32"),
        ("sweep_fwd", sweep_fwd, "fp32"),
        ("sweep_bwd", sweep_bwd, "fp32"),
        ("fold", 3 * fold, "fp32"),
        ("warp", 2 * warp, "fp32"),
        *shade_terms(model, c * c, backward=True),
        ("loss", 3 * (30 * c * c + tv + R ** 3), "fp32"),
        ("adam", 12 * param_count(model), "fp32"),
    ]


def pyramid_frame(model: dict, w: int, h: int, nq: int, kind: str,
                  chunks: int, sweep: float) -> List[Term]:
    """One served frame of a baked grid: the ``chunks`` chunks an early
    exit needs swept (``sweep``: their operations) and folded, the warp and
    the shading."""
    return [
        ("sweep_fwd", sweep, "fp32"),
        ("fold", fold_flops(model, nq, kind, chunks), "fp32"),
        ("warp", warp_flops(model, nq, w, h), "fp32"),
        *shade_terms(model, w * h, backward=False),
    ]

