"""Port parity: the file datasets, their readers and their writers.

* the PNG reader against ``imageio`` for every colour type the encoders
  write (8-bit grey, grey + alpha, RGB, RGBA, palette), with every
  scanline filter, and the fallback to ``imageio`` (and its error where
  ``imageio`` is missing) for other files, 16-bit PNGs among them;
* the bilinear resize against ``cv2.resize`` at factors 0.5, 0.37 and 1.6
  (1e-5), and ``read_image`` against the JAX package's;
* each loader (``nerf``, ``nsvf``, ``ngp``, ``colmap``) against the JAX
  package's on scenes that the JAX exporters write, and the JAX loaders on
  scenes that the port's exporters write: poses and K within 1e-6, images
  within 1e-5;
* the COLMAP parsers (binary and text), ``colmap_to_transforms`` and
  ``ColmapDataset`` on a model the test writes;
* CPU runs of ``python -m taichi_nerfs_torch.train --dataset_name nerf``
  for both models.
"""

import dataclasses
import json
import os
import struct
import sys

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from taichi_nerfs_torch.data import color_utils as tcu
from taichi_nerfs_torch.data import colmap2nerf as t2n
from taichi_nerfs_torch.data import colmap_utils as tcol
from taichi_nerfs_torch.data import dataset_dict as tdata
from taichi_nerfs_torch.data.nsvf_export import export_nsvf_dataset as t_nsvf
from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
from taichi_nerfs_torch.data.transforms_export import (
    export_blender_dataset as t_blender,
)
from taichi_nerfs_torch.data.transforms_export import (
    export_ngp_dataset as t_ngp,
)
from taichi_nerfs_tpu.data import color_utils as jcu
from taichi_nerfs_tpu.data import colmap2nerf as j2n
from taichi_nerfs_tpu.data import colmap_utils as jcol
from taichi_nerfs_tpu.data import dataset_dict as jdata
from taichi_nerfs_tpu.data.nsvf_export import export_nsvf_dataset as j_nsvf
from taichi_nerfs_tpu.data.transforms_export import (
    export_blender_dataset as j_blender,
)
from taichi_nerfs_tpu.data.transforms_export import (
    export_ngp_dataset as j_ngp,
)

POSE_TOL, IMG_TOL = 1e-6, 1e-5


def _smooth(h, w, c, seed=0):
    """An 8-bit image with gradients and noise: the encoder picks every
    scanline filter on it."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 3, yy * 5, xx + yy, 255 - 2 * xx], -1)[..., :c]
    noise = np.random.default_rng(seed).integers(0, 9, (h, w, c))
    return ((base + noise) % 256).astype(np.uint8)


# ------------------------------------------------------------ PNG reader


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("content", ["noise", "smooth"])
def test_png_reader_matches_imageio(tmp_path, mode, content):
    h, w = 23, 37
    if content == "noise":
        px = np.random.default_rng(1).integers(0, 256, (h, w, 4), np.uint8)
    else:
        px = _smooth(h, w, 4)
    if mode == "P":
        im = Image.fromarray(px[..., :3]).convert(
            "P", palette=Image.ADAPTIVE, colors=256)
    else:
        n = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        im = Image.fromarray(px[..., 0] if n == 1 else px[..., :n], mode)
    path = str(tmp_path / "img.png")
    im.save(path)
    want = imageio.imread(path)
    got = tcu.read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_png_writer_reads_back(tmp_path):
    from taichi_nerfs_torch.utils.viz import write_png

    img = _smooth(31, 17, 3)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    np.testing.assert_array_equal(tcu.read_png(path), img)
    np.testing.assert_array_equal(imageio.imread(path), img)


def test_other_files_go_through_imageio(tmp_path, monkeypatch):
    img = _smooth(16, 20, 3)
    jpg = str(tmp_path / "img.jpg")
    imageio.imwrite(jpg, img)
    np.testing.assert_array_equal(tcu.imread(jpg), imageio.imread(jpg))
    low = str(tmp_path / "palette4.png")  # 16 colours: 4 bits a pixel
    Image.fromarray(img).convert("P", palette=Image.ADAPTIVE,
                                 colors=16).save(low)
    with pytest.raises(tcu.UnsupportedPNG, match="4 bits"):
        tcu.read_png(low)
    np.testing.assert_array_equal(tcu.imread(low), imageio.imread(low))
    deep = str(tmp_path / "grey16.png")
    Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(deep)
    with pytest.raises(tcu.UnsupportedPNG, match="16 bits"):
        tcu.read_png(deep)
    np.testing.assert_array_equal(tcu.imread(deep), imageio.imread(deep))
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(RuntimeError, match="img.jpg"):
        tcu.imread(jpg)
    png = str(tmp_path / "plain.png")
    Image.fromarray(img).save(png)
    np.testing.assert_array_equal(tcu.imread(png), img)


@pytest.mark.parametrize("factor", [0.5, 0.37, 1.6])
@pytest.mark.parametrize("channels", [0, 3, 4])
def test_resize_matches_cv2(factor, channels):
    shape = (41, 58) + ((channels,) if channels else ())
    img = np.random.default_rng(2).uniform(size=shape).astype(np.float32)
    wh = (int(round(58 * factor)), int(round(41 * factor)))
    want = cv2.resize(img, wh)
    got = tcu.resize_bilinear(img, wh)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=IMG_TOL)


@pytest.mark.parametrize("blend_a", [True, False])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_read_image_matches_jax(tmp_path, mode, blend_a):
    px = _smooth(30, 30, 4)
    n = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    path = str(tmp_path / "img.png")
    Image.fromarray(px[..., 0] if n == 1 else px[..., :n], mode).save(path)
    for wh in ((30, 30), (11, 11), (48, 48)):
        want = jcu.read_image(path, wh, blend_a)
        got = tcu.read_image(path, wh, blend_a)
        assert got.shape == want.shape == (wh[0] * wh[1], 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=IMG_TOL)


# ---------------------------------------------------------------- loaders


@pytest.fixture(scope="module")
def scene():
    """A 32^2 checker rig at radius 1.5 (the Blender loader's radius), train
    and test splits."""
    kw = dict(img_wh=(32, 32), cam_radius=1.5, variant="checker",
              device="cpu")
    return {"train": SyntheticSphereDataset(n_images=4, **kw),
            "test": SyntheticSphereDataset(split="test", n_images=3, **kw)}


def _assert_same(got, want, src=None):
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(got.K, want.K, rtol=0, atol=POSE_TOL)
    assert got.img_wh == want.img_wh
    np.testing.assert_allclose(got.rays, want.rays, rtol=0, atol=IMG_TOL)
    np.testing.assert_allclose(got.directions, want.directions, rtol=0,
                               atol=POSE_TOL)
    if src is not None:  # the round trip gives back the source rig
        np.testing.assert_allclose(got.poses, src.poses, atol=1e-5)
        np.testing.assert_allclose(got.K, src.K, atol=1e-4)
        np.testing.assert_allclose(got.rays, src.rays, atol=0.5 / 255 + 1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", ["nerf", "nsvf", "ngp"])
def test_loaders_match_jax(tmp_path, scene, fmt, writer):
    if fmt == "nsvf":
        root = str(tmp_path / "Synthetic_Scene")
        (j_nsvf if writer == "jax" else t_nsvf)(root, scene)
        kw = dict(downsample=32 / 800)
    elif fmt == "nerf":
        root = str(tmp_path / "blender")
        (j_blender if writer == "jax" else t_blender)(root, scene)
        kw = dict(downsample=32 / 800)
    else:
        root = str(tmp_path / "ngp")
        (j_ngp if writer == "jax" else t_ngp)(root, scene["train"])
        kw = {}
    splits = ("train",) if fmt == "ngp" else ("train", "test")
    for split in splits:
        got = tdata[fmt](root, split=split, **kw)
        want = jdata[fmt](root, split=split, **kw)
        _assert_same(got, want, scene[split])
        assert len(got) == len(scene[split])
        item, jitem = got[1], want[1]
        np.testing.assert_array_equal(item["pose"], jitem["pose"])
        np.testing.assert_allclose(item["rgb"], jitem["rgb"], atol=IMG_TOL)


def test_exporters_write_what_jax_writes(tmp_path, scene):
    """The port's files decode to the JAX exporters' pixels, and the
    metadata files are the same."""
    t_blender(str(tmp_path / "t"), scene)
    j_blender(str(tmp_path / "j"), scene)
    for split in ("train", "test"):
        name = f"transforms_{split}.json"
        with open(tmp_path / "t" / name) as a, open(tmp_path / "j" / name) as b:
            assert json.load(a) == json.load(b)
        for i in range(len(scene[split])):
            png = f"r_{split}_{i}.png"
            np.testing.assert_array_equal(
                tcu.read_png(str(tmp_path / "t" / png)),
                imageio.imread(str(tmp_path / "j" / png)))


# ----------------------------------------------------------------- COLMAP


def _qvec(R):
    return tcol.rotmat2qvec(R)


def _write_colmap(root, poses, K, wh, images, pts, binary=True):
    """A COLMAP model of ``poses`` (c2w, [right down front]) with a PINHOLE
    camera, image files ``images/img_{i:03d}.png`` and ``pts`` points, each
    seen by image 0 (binary or text)."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    w, h = wh
    cam = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))
    recs = []
    for i, c2w in enumerate(poses):
        R = c2w[:3, :3].astype(np.float64)
        t = -R.T @ c2w[:3, 3].astype(np.float64)
        recs.append((i + 1, _qvec(R.T), t, f"img_{i:03d}.png"))
        Image.fromarray(images[i]).save(
            os.path.join(root, "images", f"img_{i:03d}.png"))
    if binary:
        with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<iiQQ", 1, 1, w, h))  # PINHOLE
            f.write(struct.pack("<4d", *cam))
        with open(os.path.join(sparse, "images.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(recs)))
            for iid, q, t, name in recs:
                f.write(struct.pack("<i4d3di", iid, *q, *t, 1))
                f.write(name.encode() + b"\x00")
                f.write(struct.pack("<Q", 2))
                f.write(struct.pack("<ddqddq", 1.5, 2.5, 1, 3.0, 4.0, -1))
        with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(pts)))
            for k, p in enumerate(pts):
                f.write(struct.pack("<Q3d3Bd", k + 1, *p, 10, 20, 30, 0.5))
                f.write(struct.pack("<Q", 1))
                f.write(struct.pack("<ii", 1, 0))
    else:
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write("# camera list\n1 PINHOLE %d %d %r %r %r %r\n"
                    % (w, h, *map(float, cam)))
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            for iid, q, t, name in recs:
                f.write(" ".join(map(repr, [iid, *map(float, q),
                                            *map(float, t), 1]))
                        + f" {name}\n")
                f.write("1.5 2.5 1 3.0 4.0 -1\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as f:
            for k, p in enumerate(pts):
                x, y, z = map(float, p)
                f.write(f"{k + 1} {x!r} {y!r} {z!r} 10 20 30 0.5 1 0\n")
    return sparse


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    ds = SyntheticSphereDataset(n_images=9, img_wh=(24, 20), cam_radius=3.0,
                                device="cpu")
    imgs = (np.clip(ds.rays.reshape(-1, 20, 24, 3), 0, 1) * 255 + 0.5
            ).astype(np.uint8)
    pts = np.random.default_rng(3).uniform(-0.4, 0.4, (50, 3))
    root = str(tmp_path_factory.mktemp("colmap"))
    _write_colmap(root, ds.poses, ds.K, (24, 20), imgs, pts)
    return root, ds, imgs, pts


def test_colmap_parsers_match_jax(colmap_scene, tmp_path):
    root, ds, imgs, pts = colmap_scene
    sparse = os.path.join(root, "sparse", "0")
    text = _write_colmap(str(tmp_path), ds.poses, ds.K, (24, 20), imgs, pts,
                         binary=False)
    pairs = [
        ("read_cameras_binary", "cameras.bin", sparse),
        ("read_images_binary", "images.bin", sparse),
        ("read_points3d_binary", "points3D.bin", sparse),
        ("read_cameras_text", "cameras.txt", text),
        ("read_images_text", "images.txt", text),
        ("read_points3D_text", "points3D.txt", text),
    ]
    for fn, name, d in pairs:
        got = getattr(tcol, fn)(os.path.join(d, name))
        want = getattr(jcol, fn)(os.path.join(d, name))
        assert got.keys() == want.keys()
        for k in got:
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # binary and text hold the same model
    b = tcol.read_images_binary(os.path.join(sparse, "images.bin"))
    t = tcol.read_images_text(os.path.join(text, "images.txt"))
    for k in b:
        np.testing.assert_array_equal(b[k].qvec2rotmat(),
                                      t[k].qvec2rotmat())
        np.testing.assert_allclose(tcol.qvec2rotmat(b[k].qvec),
                                   jcol.qvec2rotmat(b[k].qvec), atol=0)
        np.testing.assert_allclose(tcol.rotmat2qvec(b[k].qvec2rotmat()),
                                   jcol.rotmat2qvec(b[k].qvec2rotmat()),
                                   atol=1e-12)


@pytest.mark.parametrize("split", ["train", "test", "test_traj"])
def test_colmap_dataset_matches_jax(colmap_scene, split):
    root = colmap_scene[0]
    got = tdata["colmap"](root, split=split)
    want = jdata["colmap"](root, split=split)
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(got.K, want.K, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(got.rays, want.rays, rtol=0, atol=IMG_TOL)
    assert len(got) == {"train": 7, "test": 2, "test_traj": 120}[split]


def test_colmap_to_transforms_matches_jax(colmap_scene, tmp_path):
    root = colmap_scene[0]
    sparse, images = os.path.join(root, "sparse", "0"), os.path.join(
        root, "images")
    got = t2n.colmap_to_transforms(sparse, images,
                                   str(tmp_path / "t.json"))
    want = j2n.colmap_to_transforms(sparse, images,
                                    str(tmp_path / "j.json"))
    assert got.keys() == want.keys()
    for k in got:
        if k != "frames":
            assert got[k] == pytest.approx(want[k], abs=1e-12), k
    for a, b in zip(got["frames"], want["frames"]):
        assert a["file_path"] == b["file_path"]
        np.testing.assert_allclose(a["transform_matrix"],
                                   b["transform_matrix"], atol=1e-12)
        # the grey levels round as OpenCV's within one level on a few
        # pixels
        assert a["sharpness"] == pytest.approx(b["sharpness"], rel=1e-2)
    with open(tmp_path / "t.json") as f:
        assert json.load(f)["frames"][0]["file_path"] == os.path.relpath(
            os.path.join(images, "img_000.png"), str(tmp_path))


def test_sharpness_matches_opencv(tmp_path):
    for name, img in (("grey", _smooth(40, 30, 1)[..., 0]),
                      ("rgb", _smooth(40, 30, 3))):
        path = str(tmp_path / f"{name}.png")
        Image.fromarray(img).save(path)
        gray = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2GRAY)
        assert np.abs(t2n._gray(tcu.read_png(path)).astype(int)
                      - gray).max() <= 1
        np.testing.assert_allclose(t2n._laplacian(gray),
                                   cv2.Laplacian(gray, cv2.CV_64F), atol=0)
        assert t2n.sharpness(path) == pytest.approx(j2n.sharpness(path),
                                                    rel=1e-2)


def test_colmap_binaries_are_capability_gated(monkeypatch, tmp_path):
    monkeypatch.setattr(t2n.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="colmap"):
        t2n.run_colmap(str(tmp_path), str(tmp_path))
    with pytest.raises(RuntimeError, match="ffmpeg"):
        t2n.extract_frames("v.mp4", str(tmp_path))


# ------------------------------------------------------------ train entry


@pytest.fixture
def blender_root(tmp_path):
    kw = dict(img_wh=(16, 16), cam_radius=1.5, device="cpu")
    root = str(tmp_path / "blender")
    t_blender(root, {"train": SyntheticSphereDataset(n_images=4, **kw),
                     "test": SyntheticSphereDataset(split="test", n_images=2,
                                                    **kw)})
    return root


def test_train_entry_pyramid_on_a_nerf_scene(blender_root, tmp_path,
                                             monkeypatch, capsys):
    from taichi_nerfs_torch.train.__main__ import main

    monkeypatch.chdir(tmp_path)
    manifest = main([
        "--root_dir", blender_root, "--dataset_name", "nerf",
        "--downsample", str(16 / 800), "--model_name", "pyramid",
        "--pyramid_levels", "8,16", "--features", "4",
        "--resample_kind", "cubic", "--random_bg", "--max_steps", "3",
        "--exp_name", "tiny", "--eval_views", "2", "--device", "cpu",
    ])
    assert "loaded 6 nerf views at (16, 16)" in capsys.readouterr().out
    assert manifest["views_finite"] == 2
    assert (tmp_path / "results" / "tiny" / "model_pyramid.npz").exists()


def test_train_entry_pyramid_alpha_w_needs_alpha(blender_root, tmp_path,
                                                 monkeypatch):
    from taichi_nerfs_torch.train.__main__ import main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="alpha"):
        main(["--root_dir", blender_root, "--dataset_name", "nerf",
              "--downsample", str(16 / 800), "--model_name", "pyramid",
              "--pyramid_levels", "8,16", "--features", "4",
              "--alpha_w", "0.2", "--max_steps", "1", "--device", "cpu"])


def test_train_entry_ngp_on_a_nerf_scene(blender_root, tmp_path,
                                         monkeypatch):
    import taichi_nerfs_torch.train.__main__ as entry

    real = entry.config_from_opts

    def tiny(hp):
        cfg = real(hp)
        return cfg.replace(
            model=cfg.model.replace(
                grid_size=16, xyz_net_width=16, rgb_net_width=16,
                brick=dataclasses.replace(cfg.model.brick, levels=2,
                                          log2_rows=10, max_res=32)),
            render=dataclasses.replace(cfg.render, train_sample_cap=64,
                                       test_chunk_samples=16),
            train=dataclasses.replace(cfg.train, warmup_steps=4,
                                      update_interval=2),
        )

    monkeypatch.setattr(entry, "config_from_opts", tiny)
    monkeypatch.chdir(tmp_path)
    res = entry.main([
        "--root_dir", blender_root, "--dataset_name", "nerf",
        "--downsample", str(16 / 800), "--model_name", "ngp",
        "--max_steps", "6", "--batch_size", "128", "--exp_name", "tiny",
        "--eval_views", "2", "--device", "cpu",
    ])
    assert len(res["psnr"]) == 2 and np.all(np.isfinite(res["psnr"]))
    # fit runs max_steps + 1 steps, as the JAX loop does
    assert res["steps"] == 7 and np.isfinite(res["last_loss"])
    assert (tmp_path / "results" / "tiny" / "model.npz").exists()
