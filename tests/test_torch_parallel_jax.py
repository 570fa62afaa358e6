"""The port's 2-rank NGP step against the JAX package's
``parallel.sharded_train_step`` on a 2-device mesh.

At ``__graft_entry__.py``'s dry-run configuration (4 hash levels, grid
32, batch 32), from the JAX state's params and a ball bitfield, with the
JAX step's own draws reproduced from its key splits and passed to the
port (as ``tests/test_torch_ngp_render.py`` does for one device): the loss
to 1e-5 relative, every updated leaf to 1e-5 relative norm, ``rm_samples``
and ``counts_max`` equal; the two ranks' params bitwise equal.  JAX runs
on the 8 virtual CPU devices of ``tests/conftest.py``.
"""

import jax
import numpy as np
import torch
import torch_parallel_ranks as ranks
from torch_port_helpers import np32, t32

from taichi_nerfs_torch import entry as tentry
from taichi_nerfs_torch.parallel import launch
from taichi_nerfs_torch.train import step as tstep
from taichi_nerfs_torch.utils import convert as tconv
from taichi_nerfs_tpu import config as jconfig
from taichi_nerfs_tpu.parallel import (
    make_mesh,
    shard_batch,
    shard_state,
    sharded_train_step,
)
from taichi_nerfs_tpu.train import state as jstate
from taichi_nerfs_tpu.train.step import Batch as JBatch

N = 2


def _jax_config(n):
    """``__graft_entry__.py:_dryrun_multichip_impl``'s configuration."""
    return jconfig.Config(
        model=jconfig.ModelConfig(
            scale=0.5,
            grid=jconfig.HashGridConfig(levels=4, feature_per_level=2,
                                        log2_T=10, base_res=4, max_res=32),
            grid_size=32, xyz_net_width=16, rgb_net_width=16,
            mlp_dtype="float32"),
        render=jconfig.RenderConfig(train_sample_cap=32),
        train=jconfig.TrainConfig(batch_size=16 * n),
    )


def _data(rng):
    pose = np.concatenate([np.eye(3), [[0], [0], [-1.5]]], axis=1)
    return (rng.uniform(0, 1, (3, 64, 3)).astype(np.float32),
            np.stack([pose] * 3).astype(np.float32),
            (rng.uniform(-0.3, 0.3, (64, 3)) + [0, 0, 1]).astype(np.float32))


def _jax_draws(rng_key, B, n_img, n_pix):
    """The sharded JAX step's full-batch draws from its key splits."""
    _, k_batch, k_render = jax.random.split(rng_key, 3)
    k_img, k_pix = jax.random.split(k_batch)
    img = jax.random.randint(k_img, (B,), 0, n_img)
    pix = jax.random.randint(k_pix, (B,), 0, n_pix)
    k_noise, _ = jax.random.split(k_render)
    noise = jax.random.uniform(k_noise, (B,))
    return tstep.StepDraws(torch.tensor(np.asarray(img)).long(),
                           torch.tensor(np.asarray(pix)).long(),
                           t32(noise), None)


def test_two_ranks_match_jax_sharded_step(tmp_path):
    jcfg = _jax_config(N)
    tcfg = tentry.dryrun_config(N)
    rays, poses, dirs = _data(np.random.RandomState(0))
    jst = jstate.create_train_state(jcfg)
    bits = ranks.ball_bitfield(jcfg.model.grid_size)
    jst = jst._replace(occupancy=jst.occupancy._replace(
        bitfield=jax.numpy.asarray(bits.numpy().view(np.uint32))))
    draws = _jax_draws(jst.rng, jcfg.train.batch_size, 3, 64)
    # copies: the JAX step donates (and overwrites) the state's buffers
    params = tconv.ngp_params_from_numpy(
        jax.tree_util.tree_map(np.array, jax.device_get(jst.params)))

    mesh = make_mesh(N)
    jdata = JBatch(rays=jax.numpy.asarray(rays),
                   poses=jax.numpy.asarray(poses),
                   directions=jax.numpy.asarray(dirs))
    jnew, jm = sharded_train_step(shard_state(jst, mesh),
                                  shard_batch(jdata, mesh), jcfg, mesh, 32)

    outs = launch(ranks.ngp_step_rank, N, device="cpu", backend="gloo",
                  rendezvous_dir=str(tmp_path),
                  args=(torch.get_num_threads(), tcfg,
                        tstep.Batch(t32(rays), t32(poses), t32(dirs)),
                        params, bits, draws))
    tm = outs[0]["metrics"]
    assert int(jm["rm_samples"]) > 0
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    assert int(tm["rm_samples"]) == int(jm["rm_samples"])
    assert int(tm["counts_max"]) == int(jm["counts_max"])
    jleaves = jax.tree_util.tree_leaves(jnew.params)
    assert len(jleaves) == len(outs[0]["params"])
    for a, b in zip(outs[0]["params"], jleaves):
        b = np.asarray(b)
        assert np.linalg.norm(np32(a) - b) <= 1e-5 * np.linalg.norm(b)
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        assert torch.equal(a, b)
