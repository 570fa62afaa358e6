"""Train a model, then evaluate it: the port's counterpart of ``train.py``.

Two branches, parsing ``train.py``'s flags with ``opt.get_opts`` (so a
record manifest's argv runs unchanged after the module name):

* ``--model_name ngp`` (the default) or ``svox``: the sample-gather path,
  configured by ``config.py:config_from_opts`` (``--encoder_type brick``
  (the default), ``hash`` or ``triplane``; svox's ``--grid_size``,
  ``--grid_radius`` and ``--sh_degree``).  It trains with
  ``train/loop.py:Trainer``, writes ``model.npz`` (the JAX checkpoint:
  params, Adam's state, occupancy; ``--ckpt_path`` resumes from one written
  by either package), renders every test view with the
  test-time renderer, writes ``rgb_000.png`` and ``depth_000.png`` and
  prints ``evaluation: psnr_avg=... | ssim_avg=...``.  ``--deployment``
  trains the small deployment model and writes ``deployment.npy`` to
  ``--deployment_model_path`` (the hash encoder only: with another it
  raises ``ValueError`` before training)::

    python -m taichi_nerfs_torch.train \
        --root_dir 'synthetic://lego?views=100&res=800' \
        --dataset_name synthetic --model_name ngp --max_steps 20000

* ``--model_name pyramid``: the dense pyramid on the shear-warp renderer.
  The default flags train linear with deferred shading (the sweep kernels
  on the card); ``--shading per_sample``, ``--sigma_res`` and
  ``--distortion_loss_w`` train through the renderer's slab scan, and so do
  cameras inside the scene cube (one cubemap face a step; ``random_bg`` is
  then on, as ``train.py`` sets it; ``--near_margin`` and ``--cam_carve``
  act on them).  An inside rig::

    python -m taichi_nerfs_torch.train \
        --root_dir 'synthetic://shell?views=100&res=256' \
        --dataset_name synthetic --model_name pyramid \
        --near_margin 0.05 --cam_carve 0.1 --max_steps 4000

  The record recipe::

    python -m taichi_nerfs_torch.train \\
        --root_dir 'synthetic://lego?views=100&res=800' \\
        --dataset_name synthetic --model_name pyramid \\
        --pyramid_levels 32,64,128,256 --features 8 --level_features 8,8,8,8 \\
        --bake_dtype float32 --lr 1e-2 --alpha_w 0.2 --random_bg \\
        --tv_w 5e-4 --sigma_l1 1e-5 --resample_kind cubic \\
        --max_steps 10000 --exp_name lego_proxy

  It trains, writes ``model_pyramid.npz`` (read by both packages),
  renders every test view uncapped for PSNR / SSIM, writes
  ``rgb_000.png`` and ``depth_000.png``, and writes
  ``model_pyramid.manifest.json`` in ``train.py``'s schema.  The R=512
  record (``docs/records/lego_proxy_r512_negative.manifest.json``) trains
  through the bf16 path: ``--bake_dtype bfloat16`` bakes in bf16 (the
  sweep kernels read a bf16 volume) and keeps Adam's first moment in bf16,
  as ``train.py`` sets ``adam_mu_bf16``::

    python -m taichi_nerfs_torch.train \\
        --root_dir 'synthetic://lego?views=100&res=800' \\
        --dataset_name synthetic --model_name pyramid \\
        --pyramid_levels 32,64,128,256,512 --features 8 \\
        --level_features 8,8,8,8,4 --bake_dtype bfloat16 --lr 1e-2 \\
        --alpha_w 0.2 --random_bg --tv_w 5e-4 --sigma_l1 1e-5 \\
        --resample_kind cubic --prog_steps 2250,4500 --max_steps 9000

Both read ``--dataset_name synthetic`` (procedural scenes, ``--root_dir
synthetic://<scene>?views=..&res=..``) and the file datasets ``nerf``
(Blender), ``nsvf``, ``ngp`` (instant-ngp ``transforms.json``) and
``colmap``, from ``--root_dir``::

    python -m taichi_nerfs_torch.train --root_dir data/lego \
        --dataset_name nerf --model_name pyramid --resample_kind cubic

Both train on the card: ``--device cuda`` is the default, and it raises
when there is no card; ``--device cpu`` asks for the CPU (the flag is the
port's own, taken out before ``opt.get_opts`` parses the rest).  With
``--profile_dir DIR`` the last 3 steps run under ``torch.profiler``: the op
table, the device-busy share and ``DIR/trace.json``.  ``--gui`` opens the
viewer (``viewer/gui.py``) after the evaluation, for both branches; without
``cv2`` or a display it renders 8 orbiting frames headless and returns.
``--num_devices N`` above 1 trains data-parallel on N ranks
(``parallel/``): NGP splits each ray batch over them, the pyramid trains
one crop a rank.  On the card the ranks are ``cuda:0`` .. ``cuda:N-1``
over NCCL (N above the visible count raises ``ValueError``); with
``--device cpu`` they are N processes over gloo.  0 (the default) means
every visible CUDA device.  Rank 0 alone prints, writes the checkpoint,
the exports and the manifest, evaluates and opens the viewer::

    python -m taichi_nerfs_torch.train --root_dir \\
        'synthetic://lego?views=100&res=800' --dataset_name synthetic \\
        --model_name pyramid --num_devices 4
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import config_from_opts
from ..data import dataset_dict
from ..models.pyramid import PyramidConfig
from ..parallel.mesh import launch
from ..utils.convert import load_ngp_npz, save_ngp_npz, save_pyramid_npz
from ..utils.device import resolve_device
from ..utils.export import check_deployable, save_deployment_model
from ..utils.viz import depth2img, write_png
from .metrics import psnr as psnr_fn
from .metrics import ssim as ssim_fn
from .eval import evaluate
from .loop import Trainer
from .state import TrainState, make_optimizer, trainable
from .swr_step import SwrTrainConfig, SwrTrainer, is_inside

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _num_devices(hp, device: str) -> int:
    """The ranks ``--num_devices`` asks for, as ``train.py`` reads it: 0
    means every visible CUDA device (one process on the CPU); on the card
    more than are visible raises ``ValueError``."""
    if torch.device(device).type != "cuda":
        return hp.num_devices or 1
    visible = torch.cuda.device_count()
    n = hp.num_devices or max(visible, 1)
    if n > 1 and n > visible:
        raise ValueError(f"--num_devices {n} but only {visible} CUDA devices "
                         "are visible")
    return n


def configs(hp, train_dataset):
    """``(PyramidConfig, SwrTrainConfig)`` from the flags, as ``train.py``
    builds them: ``random_bg`` is on whenever a training camera is inside
    the grid (their count is printed)."""
    levels = tuple(int(x) for x in hp.pyramid_levels.split(",") if x) or (
        32, 64, 128, 256)
    if hp.level_features:
        level_features = tuple(
            int(x) for x in hp.level_features.split(",") if x)
    elif hp.fine_features:
        level_features = (hp.features,) * (len(levels) - 1) + (
            hp.fine_features,)
    else:
        level_features = ()
    mcfg = PyramidConfig(
        resolutions=levels,
        scale=hp.scale,
        deferred=hp.shading == "deferred",
        sigma_res=hp.sigma_res,
        features=hp.features,
        level_features=level_features,
    )
    if mcfg.split:
        prog = ()  # split-resolution configs cannot truncate
    elif hp.prog_steps == "auto":
        # the coarse-to-fine split train.py uses, scaled to --max_steps
        prog = ((max(hp.max_steps * 3 // 16, 1),
                 max(hp.max_steps * 9 // 40, 1))
                if hp.max_steps >= 800 else ())
    elif hp.prog_steps:
        prog = tuple(int(x) for x in hp.prog_steps.split(",") if x)
    else:
        prog = ()
    n_in = sum(is_inside(p, hp.scale) for p in
               np.asarray(train_dataset.poses, np.float32).reshape(-1, 3, 4))
    if n_in:
        print(f"pyramid: {n_in}/{len(train_dataset)} training cameras are "
              "inside the grid; those train via the cubemap-face sweep")
    w0, h0 = train_dataset.img_wh
    tcfg = SwrTrainConfig(
        crop=min(256, w0, h0),
        lr=hp.lr,
        max_steps=hp.max_steps,
        white_bg=hp.scale <= 0.5,
        distortion_w=hp.distortion_loss_w,
        prog_steps=prog,
        near=hp.near_margin,
        # an enclosed scene needs random backgrounds: with a fixed one the
        # colour net saturates before opacity forms
        random_bg=hp.random_bg or n_in > 0,
        cam_carve=hp.cam_carve,
        bake_dtype=hp.bake_dtype,
        adam_mu_bf16=hp.bake_dtype == "bfloat16",
        tv_w=hp.tv_w,
        sigma_l1=hp.sigma_l1,
        alpha_w=hp.alpha_w,
        resample_kind=hp.resample_kind,
    )
    return mcfg, tcfg


def _fit(trainer, max_steps, profile_dir, device, n_prof=3):
    """``trainer.fit(max_steps)``; with ``profile_dir``, the last
    ``n_prof`` steps run under ``torch.profiler`` (op table, device-busy
    share, ``trace.json`` in ``profile_dir``)."""
    if not profile_dir:
        return trainer.fit(max_steps)
    from torch.profiler import ProfilerActivity, profile

    from ..utils.profiling import report_profile

    n = min(n_prof, max_steps)
    if max_steps > n:
        trainer.fit(max_steps - n)
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            m = trainer.run_step()
        float(m["loss"])
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, f"{n} training steps", cuda, profile_dir)
    return m


def _viewer(cfg, params, bitfield, test_dataset, render_fn=None):
    """``--gui``: the viewer on the test split's camera (headless without
    ``cv2`` or a display)."""
    from ..viewer.gui import NGPGUI

    NGPGUI(cfg, params, bitfield, test_dataset.K, test_dataset.img_wh,
           np.asarray(test_dataset.poses), render_fn=render_fn).render()


def _train_ngp(hp, train_dataset, test_dataset, val_dir, device,
               mesh=None):
    """``train.py``'s branch of every model but the pyramid (``ngp``,
    ``svox``): fit, ``--deployment``'s ``deployment.npy``, ``model.npz``,
    evaluate, ``--gui``.  Returns :func:`evaluate`'s dict and, when it
    trained, ``steps`` and the last step's ``last_loss`` (None on a rank
    but 0, which only trains)."""
    cfg = config_from_opts(hp)
    if hp.deployment:
        check_deployable(cfg.model)  # before training, not after it
    trainer = Trainer(cfg, train_dataset.as_batch(device), train_dataset.K,
                      train_dataset.img_wh, device=device, mesh=mesh)
    if hp.ckpt_path:
        # params, Adam's moments and counts, occupancy; a file without
        # optimizer state starts Adam afresh with the schedule at its step
        params, occ, step, opt = load_ngp_npz(hp.ckpt_path, device)
        params = trainable(params)
        if opt is None:
            opt = make_optimizer(cfg).init(params, sched_count=step)
        trainer.state = TrainState(params, opt, occ)
        trainer.step = step
        print(f"loaded NGP checkpoint from {hp.ckpt_path} (step {step})")
    if not hp.val_only:
        tic = time.time()
        m = _fit(trainer, hp.max_steps, _rank0(mesh) and hp.profile_dir,
                 device)
        last = float(m["loss"])  # waits for the queued device steps
        print(f"training done in {time.time() - tic:.1f}s on {device}")
    if not _rank0(mesh):
        return None
    params, bitfield = trainer.state.params, trainer.state.occupancy.bitfield
    if hp.deployment:
        path = save_deployment_model(params, cfg.model, bitfield,
                                     train_dataset.poses,
                                     hp.deployment_model_path)
        print(f"saved {path}")
    os.makedirs(val_dir, exist_ok=True)
    save_ngp_npz(os.path.join(val_dir, "model.npz"), trainer.state,
                 trainer.step, cfg.train.seed)
    out = evaluate(params, cfg, bitfield, test_dataset, save_dir=val_dir,
                   max_images=hp.eval_views or None)
    if not hp.val_only:
        out.update(steps=trainer.step, last_loss=last)
    if hp.gui:
        _viewer(cfg, params, bitfield, test_dataset)
    return out


def _split_device(argv):
    """``(device, the other flags)``: ``--device X`` or ``--device=X``
    (default ``"cuda"``) taken out of ``argv``, since ``opt.get_opts``
    does not know the flag."""
    device, rest, k = "cuda", [], 0
    while k < len(argv):
        a = argv[k]
        if a == "--device":
            if k + 1 == len(argv):
                raise SystemExit("--device needs a value: cuda or cpu")
            device, k = argv[k + 1], k + 2
            continue
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
        k += 1
    return device, rest


def _git_commit() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=_REPO,
        ).stdout.strip()
    except OSError:
        return ""


def _rank0(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def _parse(argv):
    """``(device, hp)`` from the command line."""
    # opt.py (the flags shared with train.py) sits at the repository root
    if _REPO not in sys.path:
        sys.path.insert(0, _REPO)
    from opt import get_opts

    device, opts_argv = _split_device(argv)
    return device, get_opts(opts_argv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    device, hp = _parse(argv)
    n = _num_devices(hp, device)
    if n == 1:
        return _run(hp, argv, resolve_device(device, "--device cpu"))
    if hp.model_name == "pyramid":
        print(f"pyramid: crop-parallel over a {n}-device mesh", flush=True)
    else:
        print(f"training data-parallel over a {n}-device mesh", flush=True)
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    # the ranks find _rank_main by this module's import name: a spawned
    # process cannot import the __main__ of a package run with -m
    rank_main = importlib.import_module(__spec__.name)._rank_main
    with tempfile.TemporaryDirectory() as tmp:
        return launch(rank_main, n, device=device, backend=backend,
                      rendezvous_dir=tmp, args=(argv,))[0]


def _rank_main(mesh, argv):
    """One rank of ``--num_devices N``: rank 0 alone prints."""
    _, hp = _parse(argv)
    with contextlib.ExitStack() as stack:
        if mesh.rank != 0:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        return _run(hp, argv, mesh.device, mesh)


def _run(hp, argv, device, mesh=None):
    """Load the data, train, and (rank 0) save and evaluate."""
    val_dir = ("results/" if hp.exp_name in ("exp", "lego_proxy")
               else os.path.join("results", hp.exp_name))
    dataset_cls = dataset_dict[hp.dataset_name]
    kw = dict(root_dir=hp.root_dir, downsample=hp.downsample)
    if hp.dataset_name == "synthetic":
        kw["device"] = device  # the GT is rendered there
    t0 = time.time()
    train_dataset = dataset_cls(split=hp.split, **kw)
    test_dataset = dataset_cls(split="test", **kw)
    n_views = len(train_dataset) + len(test_dataset)
    print(f"loaded {n_views} {hp.dataset_name} views at "
          f"{train_dataset.img_wh} in {time.time() - t0:.2f}s", flush=True)
    if hp.model_name != "pyramid":
        return _train_ngp(hp, train_dataset, test_dataset, val_dir, device,
                          mesh)
    mcfg, tcfg = configs(hp, train_dataset)
    # the GT alpha channel: the synthetic scenes keep it, the file loaders
    # blend it away
    alphas = getattr(train_dataset, "alphas", None)
    if tcfg.alpha_w > 0 and alphas is None:
        raise SystemExit("--alpha_w needs a dataset with a GT alpha channel "
                         "(dataset_name=synthetic keeps it)")
    trainer = SwrTrainer(
        mcfg, tcfg, train_dataset.rays, train_dataset.poses, train_dataset.K,
        train_dataset.img_wh,
        alphas=alphas if tcfg.alpha_w > 0 or hp.random_bg else None,
        device=device, mesh=mesh,
    )
    if hp.ckpt_path:
        trainer.load_npz(hp.ckpt_path)
        print(f"loaded pyramid checkpoint from {hp.ckpt_path}")
    train_wall = 0.0
    if not hp.val_only:
        tic = time.time()
        m = _fit(trainer, hp.max_steps, _rank0(mesh) and hp.profile_dir,
                 device)
        if m is not None:
            float(m["loss"])  # wait for the queued device steps
        train_wall = time.time() - tic
        print(f"training done in {train_wall:.1f}s on {device}")
    if not _rank0(mesh):
        return None

    os.makedirs(val_dir, exist_ok=True)
    save_pyramid_npz(os.path.join(val_dir, "model_pyramid.npz"),
                     trainer.state.params)
    # eval needs params only: free the Adam moments
    trainer.state = trainer.state._replace(opt_state=None)

    w, h = test_dataset.img_wh
    psnrs, ssims = [], []
    n_eval = hp.eval_views or len(test_dataset)
    for i in range(min(len(test_dataset), n_eval)):
        sample = test_dataset[i]
        # quality eval renders uncapped (the lattice cap is the
        # interactive-rate setting)
        out = trainer.render(sample["pose"], K=None, img_wh=(w, h),
                             lat_cap=None)
        rgb = out["rgb"]
        gt = torch.as_tensor(sample["rgb"], device=rgb.device)
        psnrs.append(float(psnr_fn(rgb, gt)))
        ssims.append(float(ssim_fn(rgb.reshape(h, w, 3),
                                   gt.reshape(h, w, 3))))
        if i == 0:
            img = rgb.reshape(h, w, 3).clamp(0, 1).cpu().numpy()
            write_png(os.path.join(val_dir, "rgb_000.png"),
                      (img * 255).astype(np.uint8))
            write_png(os.path.join(val_dir, "depth_000.png"),
                      depth2img(out["depth"].reshape(h, w).cpu().numpy()))
    manifest = None
    if psnrs:
        print(f"evaluation: psnr_avg={np.mean(psnrs):.4f} | "
              f"ssim_avg={np.mean(ssims):.4f}")
        manifest = _write_manifest(hp, argv, mcfg, trainer, psnrs, ssims,
                                   train_wall, val_dir)
    if hp.gui:
        # pyramid frames through the trainer's renderer (the sweep kernel
        # on the card)
        _viewer(None, trainer.state.params, None, test_dataset,
                render_fn=lambda pose, K, wh: trainer.render(pose, K=K,
                                                             img_wh=wh))
    return manifest


def _write_manifest(hp, argv, mcfg, trainer, psnrs, ssims, train_wall,
                    val_dir):
    """``model_pyramid.manifest.json`` in ``train.py``'s schema."""

    def _cfg_dict(c):
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in dataclasses.asdict(c).items()}

    cfg_blob = json.dumps(
        {"mcfg": _cfg_dict(mcfg), "tcfg": _cfg_dict(trainer.tcfg),
         "spec": hp.root_dir},
        sort_keys=True,
    )
    manifest = {
        "eval_psnr": round(float(np.mean(psnrs)), 3),
        "eval_ssim": round(float(np.mean(ssims)), 4),
        "per_view_psnr": [round(p, 2) for p in psnrs],
        "views_finite": int(np.sum(np.isfinite(psnrs))),
        "train_wall_s": round(train_wall, 1),
        "steps": int(hp.max_steps),
        "seed": trainer.seed,
        "argv": ["python", "-m", "taichi_nerfs_torch.train"] + argv,
        "config_sha1": hashlib.sha1(cfg_blob.encode()).hexdigest()[:12],
        "config": cfg_blob,
        "git_commit": _git_commit(),
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    mpath = os.path.join(val_dir, "model_pyramid.manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"saved {mpath}")
    return manifest


if __name__ == "__main__":
    main()
