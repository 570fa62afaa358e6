"""Crop-parallel pyramid training of the port on two CPU ranks over gloo.

Two steps of ``parallel/swr_shard.py:make_swr_sharded_step`` (outside
cameras sharing an axis, with random backgrounds; inside cameras on one
cubemap face, with the carving mask and per-crop slope bounds) against
one process that averages the two crops' gradients and applies Adam
once, within 2e-6; and ``SwrTrainer(mesh=...)`` over its coarse-to-fine
growth on outside and mixed rigs against the same reproduction of the
draws it made.  Every rank's params are bitwise equal.
"""

import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks
from torch_port_helpers import np32

from taichi_nerfs_torch.parallel import launch
from taichi_nerfs_torch.train import swr_step as tsw

N = 2


def _launch(fn, tmp, *args):
    return launch(fn, N, device="cpu", backend="gloo", rendezvous_dir=tmp,
                  args=(torch.get_num_threads(),) + args)


def _close(a, b, tol=2e-6):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_allclose(np32(x), np32(y), rtol=tol, atol=tol)


def _same_on_every_rank(outs, key="params"):
    for other in outs[1:]:
        for x, y in zip(outs[0][key], other[key], strict=True):
            assert torch.equal(x, y)


def _mean_step(state, tcfg, loss_fns):
    """One process: every crop's gradients, their mean (summed in rank
    order, then divided), Adam once."""
    parts = [tsw.loss_and_grads(f, state.params) for f in loss_fns]
    loss = sum(p[0] for p in parts) / len(parts)
    mse = sum(p[1] for p in parts) / len(parts)
    grads = [sum(gs) / len(parts) for gs in zip(*(p[2] for p in parts))]
    return tsw.apply_swr_grads(state, tcfg, loss, mse, grads)


@pytest.fixture(scope="module")
def swr_ranks(tmp_path_factory):
    return _launch(ranks.swr_rank_cases, str(tmp_path_factory.mktemp("r")))


@pytest.mark.parametrize("kind", ["outside", "inside"])
def test_sharded_step_equals_mean_of_crops(swr_ranks, kind):
    case = ranks.swr_case(kind, N)
    state = case.state()
    losses = []
    for s in range(2):
        fns = [case.loss_fn(s, r, state.params) for r in range(N)]
        state, m = _mean_step(state, case.tcfg, fns)
        losses.append(float(m["loss"]))
    got = swr_ranks[0][kind]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert all(np.isfinite(losses))
    _close(got["params"], ranks.host(state.params))
    _same_on_every_rank([o[kind] for o in swr_ranks])
    assert swr_ranks[1][kind]["losses"] == got["losses"]


def test_sharded_step_checks_its_operands():
    from taichi_nerfs_torch.parallel import Mesh, make_swr_sharded_step

    case = ranks.swr_case("inside", N)
    step = make_swr_sharded_step(ranks.SWR_MCFG, case.tcfg,
                                 Mesh(0, N, torch.device("cpu"), "gloo"), 0,
                                 False, inside=True, with_sigma_keep=True,
                                 with_slope_bounds=True)
    with pytest.raises(ValueError, match="2 extra operands"):
        step(case.state(), case.images[0], case.poses[0], case.K, (4, 4),
             case.sigma_keep)


@pytest.fixture(scope="module")
def trainer_ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("t"))
    return {kind: _launch(ranks.swr_trainer_rank, tmp, kind, 4)
            for kind in ("outside", "inside")}


@pytest.mark.parametrize("kind", ["outside", "inside"])
def test_trainer_mesh_equals_mean_of_crops(trainer_ranks, kind):
    """``SwrTrainer(mesh=...)``: the host draws are the same on every rank
    (crops of one sweep choice; an inside step: one pose, one face), and
    four steps through the growth to the last level are one process's
    mean-of-crops steps on those draws (each rank's own background and TV
    windows)."""
    outs = trainer_ranks[kind]
    ref = ranks.swr_trainer(ranks.swr_rig(kind))
    faces = []
    for s, d0 in enumerate(outs[0]["draws"]):
        for o in outs[1:]:
            d = o["draws"][s]
            assert (d.idxs, d.wins, d.face) == (d0.idxs, d0.wins, d0.face)
        ref._advance_phases()
        pl = ref.plan_sharded(d0)
        faces.append(d0.face)
        if d0.face is None:  # one sweep axis and direction for the crops
            assert len({ref._axis_flip[i] for i in d0.idxs}) == 1
        else:
            assert len(set(d0.idxs)) == 1
        fns = []
        for r in range(N):
            d = outs[r]["draws"][s]
            fns.append(tsw.make_swr_loss(
                ref.images[d.idxs[r]], ref.poses_np[d.idxs[r]], ref.K,
                d.wins[r], ref.cur_mcfg, ref.tcfg, pl.axis, pl.flip, d.bg,
                d.tv_starts, ref.lat_size, pl.warp, pl.slab_window,
                pl.inside, ref.sigma_keep,
                None if pl.slope_bounds is None else pl.slope_bounds[r]))
        ref.state, m = _mean_step(ref.state, ref.tcfg, fns)
        ref.step += 1
        np.testing.assert_allclose(outs[0]["losses"][s], float(m["loss"]),
                                   rtol=1e-5)
    assert ref._phase_idx == 1  # the growth replayed
    if kind == "inside":  # the draws took both kinds of step
        assert None in faces and any(f is not None for f in faces)
    _close(outs[0]["params"], ranks.host(ref.state.params))
    _same_on_every_rank(outs)
    assert outs[0]["render_finite"]
