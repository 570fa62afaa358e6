"""End to end on the CPU: the port's copy of ``tests/test_train_e2e.py``.

The NGP trainer (hash encoder, the JAX test's tiny configuration) trains
300 steps on the procedural sphere scene: the loss at least halves, and a
held-out view rendered by the test-time renderer reaches PSNR > 17 and
SSIM > 0.5 against the analytic ground truth, opaque at the centre and
transparent at the corner.  A shorter brick-encoder run's loss falls.
"""

import numpy as np
import pytest
import torch
from torch_port_helpers import t32  # noqa: F401  (caps torch's threads)

from taichi_nerfs_torch.config import (
    BrickGridConfig,
    Config,
    HashGridConfig,
    ModelConfig,
    RenderConfig,
    TrainConfig,
)
from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
from taichi_nerfs_torch.ops.rays import get_rays
from taichi_nerfs_torch.render.renderer import render_image
from taichi_nerfs_torch.train.loop import Trainer
from taichi_nerfs_torch.train.metrics import psnr, ssim


def tiny_config(enc="hash") -> Config:
    """``tests/conftest.py:tiny_config`` (grid 32^3, 4 hash levels, thin
    fp32 MLPs); ``enc="brick"`` swaps in a 4-level brick grid."""
    model = ModelConfig(
        scale=0.5,
        pos_encoder_type=enc,
        grid=HashGridConfig(levels=4, feature_per_level=2, log2_T=11,
                            base_res=4, max_res=32),
        brick=BrickGridConfig(levels=4, feature_per_level=4, log2_rows=11,
                              base_res=4, max_res=32),
        grid_size=32,
        xyz_net_width=16,
        rgb_net_width=16,
        mlp_dtype="float32",
    )
    render = RenderConfig(exp_step_factor=0.0, train_sample_cap=256,
                          test_chunk_samples=16, white_bg=True)
    train = TrainConfig(batch_size=256, max_steps=200, warmup_steps=40,
                        update_interval=8)
    return Config(model=model, render=render, train=train)


@pytest.fixture(scope="module")
def scene():
    return SyntheticSphereDataset(n_images=12, img_wh=(48, 48))


def _train(scene, cfg, steps):
    trainer = Trainer(cfg, scene.as_batch(), scene.K, scene.img_wh,
                      log_fn=lambda *_: None)
    losses = [float(trainer.run_step()["loss"]) for _ in range(steps)]
    return trainer, losses


@pytest.fixture(scope="module")
def trained(scene):
    trainer, losses = _train(scene, tiny_config(), 300)
    return trainer, losses[0], losses[-1]


def test_loss_decreases(trained):
    _, first, last = trained
    assert last < first * 0.5, (first, last)


def test_render_matches_ground_truth(trained):
    trainer, _, _ = trained
    test_scene = SyntheticSphereDataset(split="test", n_images=2,
                                        img_wh=(48, 48))
    rays_o, rays_d = get_rays(torch.as_tensor(test_scene.directions),
                              torch.as_tensor(test_scene.poses[0]))
    out = render_image(trainer.state.params, trainer.cfg,
                       trainer.state.occupancy.bitfield, rays_o, rays_d,
                       chunk=48 * 48)
    gt = torch.as_tensor(test_scene.rays[0])
    p = float(psnr(out["rgb"], gt))
    assert p > 17.0, f"test-view PSNR too low: {p:.2f}"
    h, w = 48, 48
    s = float(ssim(out["rgb"].reshape(h, w, 3), gt.reshape(h, w, 3)))
    assert s > 0.5, f"test-view SSIM too low: {s:.3f}"
    opacity = out["opacity"].reshape(h, w).numpy()
    assert opacity[h // 2, w // 2] > 0.8
    assert opacity[0, 0] < 0.2


def test_brick_encoder_loss_falls(scene):
    _, losses = _train(scene, tiny_config("brick"), 120)
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < 0.7 * np.mean(losses[:10]), losses
