"""Image reading and colour-space helpers, without an image library.

Port of the JAX package's ``data/color_utils.py``.  PNG files (8-bit grey,
grey + alpha, RGB, RGBA and palette; not interlaced) are
decoded here with ``zlib`` and numpy (:func:`read_png`), and
:func:`resize_bilinear` is OpenCV's default ``cv2.resize`` (bilinear,
half-pixel centres), so the loaders need neither OpenCV nor ``imageio``.
Any other file (a JPEG, an interlaced or 16-bit PNG) is read with
``imageio``, imported when such a file is met; where it is not installed,
the error names the file.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# channels per PNG colour type: grey, RGB, palette, grey + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    limit = 0.04045
    return np.where(img > limit, ((img + 0.055) / 1.055) ** 2.4, img / 12.92)


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    limit = 0.0031308
    return np.where(img > limit, 1.055 * img ** (1 / 2.4) - 0.055,
                    12.92 * img)


class UnsupportedPNG(ValueError):
    """A PNG variant :func:`read_png` does not decode."""


def _unfilter(data: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters of (h, w * bpp) bytes ``data``, whose
    rows carry the filter types ``ftype``, with ``bpp`` bytes a pixel."""
    h, stride = data.shape
    w = stride // bpp
    if ftype.max() > 4:
        raise UnsupportedPNG(f"unknown PNG filter type {int(ftype.max())}")
    if ftype.max() <= 2:
        # none, sub and up: each row vectorised
        out = np.empty_like(data)
        prev = np.zeros(stride, np.uint8)
        for r in range(h):
            x = data[r]
            if ftype[r] == 1:
                x = (np.cumsum(x.reshape(w, bpp), axis=0, dtype=np.uint64)
                     & 0xFF).astype(np.uint8).reshape(stride)
            elif ftype[r] == 2:
                x = x + prev  # wraps mod 256
            out[r] = prev = x
        return out
    # average and Paeth read the reconstructed left neighbour: run the
    # anti-diagonals of the (h, w) pixel grid, each in one vector step
    x3 = data.reshape(h, w, bpp).astype(np.int32)
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)  # zero row and column
    ft = ftype.astype(np.int32)
    for k in range(h + w - 1):
        r = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        i = k - r
        x = x3[r, i]
        a = rec[r + 1, i]  # left
        b = rec[r, i + 1]  # up
        c = rec[r, i]  # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        f = ft[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, i + 1] = (x + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8).reshape(h, stride)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file as ``imageio.v2.imread`` returns it: (h, w) for
    grey, (h, w, 2 | 3 | 4) otherwise (a palette image as RGB), uint8.
    Raises :class:`UnsupportedPNG` for an interlaced image or a bit depth
    other than 8."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_SIG:
        raise UnsupportedPNG(f"{path}: not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos + 8 <= len(buf):
        n, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise UnsupportedPNG(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace or depth != 8 or ctype not in _PNG_CHANNELS:
        raise UnsupportedPNG(
            f"{path}: colour type {ctype} at {depth} bits, interlace "
            f"{interlace}")
    ch = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw[: h * (w * ch + 1)].reshape(h, w * ch + 1)
    img = _unfilter(rows[:, 1:], rows[:, 0], ch).reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise UnsupportedPNG(f"{path}: a palette image with no PLTE")
        img = palette[img[..., 0]]
    return img[..., 0] if ch == 1 and ctype != 3 else img


def imread(path: str) -> np.ndarray:
    """An image file as ``imageio.v2.imread`` returns it: PNG decoded here,
    any other file through ``imageio`` (imported on use)."""
    try:
        return read_png(path)
    except UnsupportedPNG:
        pass
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise RuntimeError(
            f"{path}: only PNG files are decoded without imageio, which is "
            "not installed") from e
    return np.asarray(imageio.imread(path))


def resize_bilinear(img: np.ndarray, img_wh) -> np.ndarray:
    """Resize (h, w[, c]) to ``img_wh`` as ``cv2.resize``'s default
    (``INTER_LINEAR``): the source position of output pixel x is ``(x +
    0.5) * w / w_out - 0.5``, clamped to the first and last pixel; each
    output is the linear blend of its two neighbours along x, then along
    y.  Float input gives float32 output."""
    img = np.asarray(img, np.float32)
    w_out, h_out = int(img_wh[0]), int(img_wh[1])
    h, w = img.shape[:2]
    if (w_out, h_out) == (w, h):
        return img.copy()

    def taps(n_in, n_out):
        f = ((np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out)
             - 0.5).astype(np.float32)
        i0 = np.floor(f).astype(np.int64)
        frac = f - i0
        low = i0 < 0
        frac[low], i0[low] = 0.0, 0
        high = i0 >= n_in - 1
        frac[high], i0[high] = 0.0, n_in - 1
        i1 = np.minimum(i0 + 1, n_in - 1)
        return i0, i1, frac.astype(np.float32)

    x0, x1, fx = taps(w, w_out)
    y0, y1, fy = taps(h, h_out)
    extra = (None,) * (img.ndim - 2)
    fx = fx[(None, slice(None)) + extra]
    fy = fy[(slice(None), None) + extra]
    rows = img[:, x0] * (1.0 - fx) + img[:, x1] * fx
    return (rows[y0] * (1.0 - fy) + rows[y1] * fy).astype(np.float32)


def read_image(img_path: str, img_wh, blend_a: bool = True) -> np.ndarray:
    """Load an image, alpha-blend it onto white (``blend_a``, else onto
    black), resize it to ``img_wh`` and flatten it to (h * w, 3)."""
    img = imread(img_path).astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[2] == 4:  # alpha channel
        if blend_a:
            img = img[..., :3] * img[..., -1:] + (1 - img[..., -1:])
        else:
            img = img[..., :3] * img[..., -1:]
    img = resize_bilinear(img, img_wh)
    return img.reshape(-1, 3)
