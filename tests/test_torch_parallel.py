"""Data-parallel NGP training of the port on two CPU ranks over gloo.

The port's counterpart of the JAX package's ``tests/test_sharding.py``:
the 2-rank step, refreshes and packed evaluation against the one-process
ones from the same state and draws, at that file's tolerances (loss 1e-5
relative, PSNR 1e-4, params and Adam's moments 2e-6, density grid 2e-6 /
2e-5 with equal bitfields), every rank's params bitwise equal; the entry
(``entry()``, the dry run of ``python -m taichi_nerfs_torch.entry``) and
the train entry with ``--num_devices 2``.  One launch serves the step and
refresh cases.
"""

import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks
from torch_port_helpers import np32

from taichi_nerfs_torch.parallel import launch, shard_pack_cap
from taichi_nerfs_torch.train import step as tstep


def _launch(fn, tmp, *args):
    return launch(fn, 2, device="cpu", backend="gloo", rendezvous_dir=tmp,
                  args=(torch.get_num_threads(),) + args)


def _close(a, b, tol=2e-6):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_allclose(np32(x), np32(y), rtol=tol, atol=tol)


def _same_on_every_rank(outs, key):
    for other in outs[1:]:
        for x, y in zip(outs[0][key], other[key], strict=True):
            assert torch.equal(x, y)


def _reference_step(enc, pack_cap=None):
    cfg, data, state, draws = ranks.ngp_setup(enc)
    return ranks.step_result(*tstep.train_step(
        state, data, cfg, ranks.NGP_SAMPLE_CAP, pack_cap, draws))


def _pack_cap():
    """A global pack cap that truncates neither the one-process step nor a
    shard's, and packs (below a shard's dense size)."""
    cfg, data, state, draws = ranks.ngp_setup("hash")
    rgb, pose, d = tstep.sample_batch(data, draws.img_idxs, draws.pix_idxs)
    from taichi_nerfs_torch.ops.rays import get_rays
    from taichi_nerfs_torch.render.renderer import render_train

    o, dd = get_rays(d, pose)
    counts = render_train(state.params, cfg.model, cfg.render,
                          state.occupancy.bitfield, o, dd,
                          ranks.NGP_SAMPLE_CAP,
                          t_noise=draws.t_noise)["counts"]
    cap = int(counts.sum())
    b = cfg.train.batch_size
    shard = shard_pack_cap(cap, b, 2, ranks.NGP_SAMPLE_CAP)
    assert shard is not None and shard < (b // 2) * ranks.NGP_SAMPLE_CAP
    assert shard >= int(counts[: b // 2].sum())
    assert shard >= int(counts[b // 2:].sum())
    return cap


@pytest.fixture(scope="module")
def ngp_ranks(tmp_path_factory):
    cap = _pack_cap()
    outs = _launch(ranks.ngp_rank_cases, str(tmp_path_factory.mktemp("r")),
                   cap)
    return cap, outs


@pytest.mark.parametrize("enc", ["hash", "brick"])
def test_sharded_step_equals_one_process(ngp_ranks, enc):
    _, outs = ngp_ranks
    want = _reference_step(enc)
    got = outs[0][enc]
    wm, gm = want["metrics"], got["metrics"]
    assert int(wm["rm_samples"]) > 0
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(gm["psnr"]), float(wm["psnr"]),
                               rtol=1e-4)
    for k in ("rm_samples", "vr_samples", "counts_max"):
        assert int(gm[k]) == int(wm[k]), k
    for k in ("params", "mu", "nu"):
        _close(got[k], want[k])
    _same_on_every_rank([o[enc] for o in outs], "params")
    assert torch.equal(outs[1][enc]["metrics"]["loss"], gm["loss"])


def test_sharded_packed_eval_equals_one_process(ngp_ranks):
    """The per-shard packed evaluation under a global pack cap that
    truncates nothing: the one-process step's numbers."""
    cap, outs = ngp_ranks
    want = _reference_step("hash", cap)
    got = outs[0]["packed"]
    assert int(got["metrics"]["rm_samples"]) == int(
        want["metrics"]["rm_samples"])
    np.testing.assert_allclose(float(got["metrics"]["loss"]),
                               float(want["metrics"]["loss"]), rtol=1e-5)
    _close(got["params"], want["params"])
    _same_on_every_rank([o["packed"] for o in outs], "params")


def test_sharded_refreshes_equal_one_process(ngp_ranks):
    """The warm-up (every cell) and the steady (sampled cells) refresh,
    each rank probing half the cells."""
    _, outs = ngp_ranks
    cfg, _, state, _ = ranks.ngp_setup("hash")
    for (grid, bits), warmup, rtol in zip(outs[0]["grids"], (True, False),
                                          (2e-6, 2e-5)):
        state = tstep.density_grid_step(state, cfg, warmup,
                                        draws=ranks.grid_draws(cfg, warmup))
        np.testing.assert_allclose(np32(grid),
                                   np32(state.occupancy.density_grid),
                                   rtol=rtol, atol=2e-6)
        assert torch.equal(bits, state.occupancy.bitfield)
    assert int(state.occupancy.bitfield.ne(0).sum()) > 0
    for a, b in zip(outs[0]["grids"], outs[1]["grids"]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_launch_reraises_a_rank_failure(tmp_path):
    """A rank that raises ends the launch (the rank waiting for it in a
    collective is stopped) and the parent raises with its traceback."""
    from torch.multiprocessing import ProcessRaisedException

    with pytest.raises(ProcessRaisedException, match="rank 1 fails on "
                       "purpose"):
        _launch(ranks.failing_rank, str(tmp_path))
    with pytest.raises(ValueError, match="nccl needs one CUDA device"):
        launch(ranks.failing_rank, 2, device="cpu", backend="nccl",
               rendezvous_dir=str(tmp_path))


def test_shard_pack_cap():
    """JAX's per-shard budget: 1.5 x the share, bucketed, None at or above
    the shard's dense size."""
    assert shard_pack_cap(None, 64, 2, 16) is None
    assert shard_pack_cap(512, 64, 8, 16) == 96
    assert shard_pack_cap(4096, 64, 2, 16) is None
    assert shard_pack_cap(300, 64, 2, 32) == 256


def test_sharded_refresh_needs_divisible_cells_and_batch():
    from taichi_nerfs_torch.models.occupancy import update_density_grid
    from taichi_nerfs_torch.parallel import Mesh, sharded_density_grid_step

    cfg, _, state, _ = ranks.ngp_setup("hash")
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        update_density_grid(state.params, cfg.model, lambda p, c, x: x[:, 0],
                            state.occupancy, ranks.grid_draws(cfg, True),
                            0.01, warmup=True, cell_shard=(0, 3))
    mesh = Mesh(0, 3, torch.device("cpu"), "gloo")  # 64 rays, 3 ranks
    with pytest.raises(ValueError, match="batch_size 64 not divisible"):
        sharded_density_grid_step(state, cfg, mesh, True)


def test_entry_and_dryrun_multichip(capfd, monkeypatch):
    """``entry()`` on the CPU, and the 2-rank dry run: JAX's three ``ok``
    lines, finite losses, every rank's params equal."""
    from taichi_nerfs_torch import entry as tentry

    monkeypatch.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    fn, args = tentry.entry(device="cpu")
    with torch.no_grad():
        rgb, depth, opacity = fn(*args)
    assert tuple(rgb.shape) == (tentry.N_RAYS, 3)
    assert tuple(depth.shape) == tuple(opacity.shape) == (tentry.N_RAYS,)
    assert bool(torch.isfinite(rgb).all())
    assert float(opacity.max()) > 0  # every cell occupied: rays hit
    outs = tentry.dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    for line in ("dryrun_multichip(2): ok, loss=",
                 "dryrun_swr_multichip(2): ok, loss=",
                 "dryrun_swr_multichip(2) inside-camera: ok, loss="):
        assert out.count(line) == 1, out
    for k in ("loss", "swr_loss", "swr_inside_loss"):
        assert np.isfinite(outs[0][k]) and outs[0][k] == outs[1][k]
    assert outs[0]["occ_bits"] == outs[1]["occ_bits"] > 0
    _same_on_every_rank(outs, "params")


@pytest.mark.parametrize("model", ["ngp", "pyramid"])
def test_train_entry_num_devices(model, tmp_path, monkeypatch, capfd):
    """``python -m taichi_nerfs_torch.train --num_devices 2 --device cpu``:
    JAX's mesh line, training on both ranks (their params bitwise equal),
    rank 0's evaluation and files."""
    import taichi_nerfs_torch.train.__main__ as entry

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    argv = ["--root_dir", "synthetic://sphere?views=4&res=24",
            "--dataset_name", "synthetic", "--model_name", model,
            "--max_steps", "4", "--exp_name", "tiny", "--eval_views", "1",
            "--num_devices", "2", "--device", "cpu"]
    monkeypatch.setattr(entry, "_rank_main", ranks.tiny_ngp_rank_main)
    if model == "ngp":
        res = entry.main(argv + ["--batch_size", "128"])
        assert res["steps"] == 5 and np.isfinite(res["last_loss"])
        line, f = "training data-parallel over a 2-device mesh", "model.npz"
    else:
        res = entry.main(argv + ["--pyramid_levels", "8,16", "--features",
                                 "4"])
        assert res["views_finite"] == 1
        line = "pyramid: crop-parallel over a 2-device mesh"
        f = "model_pyramid.npz"
    out = capfd.readouterr().out
    assert out.count(line) == 1
    assert out.count("evaluation: psnr_avg=") == 1  # rank 0 alone
    assert (tmp_path / "results" / "tiny" / f).is_file()
    assert ranks.same_params_on_every_rank(tmp_path)
