"""The port's Instant-NGP against the benchmark's plain reference
(``benchmark/reference/ngp.py``, and ``ngp_hash.py`` for the hash grid) on
the CPU, at a tiny size, on seeded random weights: the brick and the hash
encoders (forward and table gradient), the march's sample sets, the
composite, and on either grid one step's loss and gradients, one sampled
refresh and three Adam steps; then the benchmark's own comparison of each
NGP cell (``benchmark/systems/ngp.py``, ``ngp_hash.py``) at its tiny size,
which every planted fault (``benchmark/tests/families/ngp.py``,
``ngp_hash.py``) fails.  The references import neither the port nor JAX.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_helpers import t32  # noqa: F401  (caps torch's threads)

from benchmark.harness.spec import CHECKOUT, Spec
from benchmark.reference import ngp as ref_ngp
from benchmark.reference import ngp_hash as ref_hash
from benchmark.systems import ngp as system
from benchmark.systems import ngp_hash as hash_system
from benchmark.tests.families import ngp as family
from benchmark.tests.families import ngp_hash as hash_family
from taichi_nerfs_torch.config import (BrickGridConfig, HashGridConfig,
                                       config_for_scene)
from taichi_nerfs_torch.models.occupancy import draw_grid_inputs
from taichi_nerfs_torch.ops import brick_encoder, hash_encoder
from taichi_nerfs_torch.ops.composite import apply_background, composite_train
from taichi_nerfs_torch.ops.marching import (march_rays, perturb_t_start,
                                             valid_mask)
from taichi_nerfs_torch.ops.rays import ray_aabb_intersect
from taichi_nerfs_torch.train.state import Adam, create_train_state
from taichi_nerfs_torch.train.step import (Batch, density_grid_step,
                                           draw_step, loss_and_grads)

CELL = "ngp_brick_8x4.train"
SPEC = Spec(CHECKOUT)
# by grid: the configuration, its system, reference and CPU family
GRIDS = {"brick": ("ngp_brick_8x4", system, ref_ngp.NGPReference, family),
         "hash": ("ngp_hash_16x2", hash_system, ref_hash.NGPHashReference,
                  hash_family)}


def _config(grid: str = "brick") -> dict:
    """The cell's configuration, shrunk as the benchmark's CPU tests shrink
    it."""
    name, _, _, fam = GRIDS[grid]
    return fam.shrink_config(copy.deepcopy(SPEC.config(name)))


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _x01(n: int, seed: int) -> torch.Tensor:
    return torch.rand((n, 3), generator=torch.Generator().manual_seed(seed))


# ------------------------------------------------------------ the encoders

BRICKS = {"tiny": dict(levels=4, feature_per_level=4, log2_rows=10,
                       base_res=4, max_res=32),
          "small": dict(levels=8, feature_per_level=4, log2_rows=12,
                        base_res=8, max_res=128)}
HASHES = {"tiny": dict(levels=4, feature_per_level=2, log2_T=11, base_res=4,
                       max_res=32),
          "small": dict(levels=8, feature_per_level=2, log2_T=12,
                        base_res=8, max_res=128)}


def _program_and_reference_encode(encoder: str, size: str):
    """``(program, reference)``: each a function from its table leaves and
    positions to features; and the leaves."""
    gen = torch.Generator().manual_seed(7)
    if encoder == "brick":
        layout = brick_encoder.build_brick_layout(
            BrickGridConfig(**BRICKS[size]))
        leaves = brick_encoder.init_brick_params(layout, gen)
        geo = ref_ngp.BrickGeometry.of(BRICKS[size])

        def prog(lv, x):
            return brick_encoder.brick_encode(lv, x, layout)

        def ref(lv, x):
            return ref_ngp.brick_encode(lv["corners"], lv["bricks"], x, geo)

        return prog, ref, leaves
    layout = hash_encoder.build_layout(HashGridConfig(**HASHES[size]))
    leaves = {"table": hash_encoder.init_hash_table(layout, gen)}
    geo = ref_ngp.HashGeometry.of(HASHES[size])

    def prog(lv, x):
        return hash_encoder.hash_encode(lv["table"], x, layout)

    def ref(lv, x):
        return ref_ngp.hash_encode(lv["table"], x, geo)

    return prog, ref, leaves


@pytest.mark.parametrize("size", ["tiny", "small"])
@pytest.mark.parametrize("encoder", ["brick", "hash"])
def test_encoder_forward_and_table_gradient(encoder, size):
    prog, ref, leaves = _program_and_reference_encode(encoder, size)
    x = _x01(3000, 1)
    outs = {}
    for name, fn in (("prog", prog), ("ref", ref)):
        lv = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        y = fn(lv, x)
        cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
        grads = torch.autograd.grad((y * cot).sum(), list(lv.values()))
        outs[name] = (y.detach(), grads)
    (yp, gp), (yr, gr) = outs["prog"], outs["ref"]
    # the same 8 products a feature, summed in another order
    assert torch.allclose(yp, yr, rtol=1e-6, atol=1e-6)
    for a, b in zip(gp, gr):
        assert _rel(a, b) < 1e-6


def test_dense_and_hashed_levels_both_present():
    geo = ref_ngp.BrickGeometry.of(BRICKS["tiny"])
    layout = brick_encoder.build_brick_layout(
        BrickGridConfig(**BRICKS["tiny"]))
    assert geo.res == layout.resolutions and geo.dense == layout.dense
    assert set(geo.dense) == {True, False}


# ---------------------------------------------------- march and composite


def _rays(n: int, seed: int):
    """Rays from a ring of cameras at radius 1.2 towards the box."""
    g = torch.Generator().manual_seed(seed)
    theta = 2 * np.pi * torch.rand((n,), generator=g)
    eye = torch.stack([1.2 * torch.cos(theta), 1.2 * torch.sin(theta),
                       0.4 * torch.rand((n,), generator=g) - 0.2], dim=1)
    target = 0.6 * torch.rand((n, 3), generator=g) - 0.3
    return eye, target - eye, torch.rand((n,), generator=g)


def _occupancy(G: int, share: float, seed: int) -> torch.Tensor:
    """(G^3,) random occupancy bits, morton order, and the program's
    int32 words of them."""
    bits = torch.rand((G ** 3,), generator=torch.Generator().manual_seed(
        seed)) < share
    w = (bits.reshape(-1, 32).long() << torch.arange(32)).sum(dim=1)
    return bits, torch.where(w >= 2 ** 31, w - 2 ** 32, w).int()


def _program_march(cfg, o, d, noise, words, cap):
    mcfg = cfg.model
    hits = ray_aabb_intersect(o, d, mcfg.scale)
    t0 = perturb_t_start(hits, noise, cfg.render.exp_step_factor,
                         mcfg.grid_size, mcfg.scale)
    return march_rays(o, d, t0, hits[:, 1], words, cascades=mcfg.cascades,
                      scale=mcfg.scale, exp_step_factor=0.0,
                      grid_size=mcfg.grid_size, sample_cap=cap)


@pytest.mark.parametrize("cap", [16, 256])
@pytest.mark.parametrize("share", [0.1, 0.6])
def test_march_sample_sets(cap, share):
    config = _config()
    cfg = system.program_config(config, 0)
    ref = ref_ngp.NGPReference(config)
    o, d, noise = _rays(512, 3)
    bits, words = _occupancy(cfg.model.grid_size, share, 4)
    pm = _program_march(cfg, o, d, noise, words, cap)
    rm = ref.march(o, d, noise, bits, cap)
    pv = valid_mask(pm.counts, cap)
    # the program probes one point an interval between cell boundaries,
    # the reference each sample: a sample on a boundary may go either way
    same = torch.all(pv == rm.valid, dim=1) & torch.all(
        torch.where(pv, pm.ts, 0.0) == rm.ts, dim=1)
    assert float(same.float().mean()) >= 0.99
    assert abs(int(pm.counts.sum()) - int(rm.counts.sum())) <= 2
    assert int(rm.counts.sum()) > 0


def test_composite():
    config = _config()
    ref = ref_ngp.NGPReference(config)
    o, d, noise = _rays(256, 5)
    bits, _ = _occupancy(32, 0.5, 6)
    m = ref.march(o, d, noise, bits, 64)
    g = torch.Generator().manual_seed(8)
    sigma = 600.0 * torch.rand(m.ts.shape, generator=g)
    rgb = torch.rand(m.ts.shape + (3,), generator=g)
    deltas = torch.where(m.valid, m.dt, 0.0)
    comp = composite_train(sigma, rgb, deltas, m.ts, m.valid,
                           config["render"]["t_threshold"])
    pix = apply_background(comp.rgb, comp.opacity, torch.ones(3))
    want = ref.composite(sigma, rgb, m)
    assert torch.allclose(pix, want.rgb, rtol=1e-5, atol=1e-6)
    assert torch.allclose(comp.opacity, want.opacity, rtol=1e-5, atol=1e-6)
    # the early stop drops samples behind opaque ones
    assert 0 < int(comp.vr_samples) == int(want.vr_samples) < int(
        m.counts.sum())


# ------------------------------------------------------- step and refresh


def _setup(grid: str):
    """A tiny trainer's state on the lego proxy (seeded weights, a
    refreshed grid), its data, the reference and the grid's system."""
    from benchmark.scene import lego

    config = _config(grid)
    _, sys_, ref_cls, _ = GRIDS[grid]
    cfg = sys_.program_config(config, 11)
    sc = config["scene"]
    w, h = sc["img_wh"]
    K = lego.intrinsics(w, h)
    poses = lego.train_poses(sc["n_views"], sc["radius"])
    rgb, _ = lego.render_gt(poses, K, w, h, sc["gt_steps"], sc["gt_ss"])
    u8 = torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8)
    from taichi_nerfs_torch.ops.rays import get_ray_directions_np

    data = Batch(u8.float() / 255.0, torch.as_tensor(poses),
                 torch.as_tensor(get_ray_directions_np(h, w, K)))
    state = create_train_state(cfg)
    with torch.no_grad():
        mine = sys_.make_params(config, 5, "cpu")
        for k, p in sys_.leaves(state.params).items():
            p.copy_(mine[k])
    gen = torch.Generator().manual_seed(12)
    state = density_grid_step(state, cfg, True, gen)
    return config, cfg, data, state, u8, K, w, sys_, ref_cls(config)


@pytest.fixture(scope="module")
def setup():
    return _setup("brick")


@pytest.fixture(scope="module")
def hash_setup():
    return _setup("hash")


def _draws(cfg, data, seed):
    return draw_step(cfg, data, torch.Generator().manual_seed(seed))


def test_one_step_loss_and_gradients(setup):
    """The loss and every leaf's gradient of one step, the reference taken
    at the program's samples (whose march is held to the reference's in
    ``test_march_sample_sets``), and its own march's count."""
    _check_one_step(setup)


def test_one_step_loss_and_gradients_hash(hash_setup):
    """The same on the hash grid: the table's gradient is the scatter of
    its 16 x 8 corners a sample."""
    _check_one_step(hash_setup)


def _check_one_step(setup):
    config, cfg, data, state, u8, K, w, sys_, ref = setup
    draws = _draws(cfg, data, 13)
    loss, _, res, grads = loss_and_grads(state, data, cfg, 128, None, draws)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in sys_.leaves(state.params).items()}
    o, d = ref.rays(data.poses, K, w, draws.img_idxs, draws.pix_idxs)
    gt = u8[draws.img_idxs, draws.pix_idxs].float() / 255.0
    theirs = ref_ngp.March(res["ts"], res["valid"], res["counts"],
                           ref_ngp.SQRT3 / config["render"]["max_samples"])
    rloss, vr = ref.loss(params, gt, o, d, theirs)
    rgrads = dict(zip(params, torch.autograd.grad(rloss, list(
        params.values()))))
    rloss = float(rloss.detach())
    assert abs(float(loss) - rloss) <= 1e-5 * rloss
    assert int(res["vr_samples"]) == vr
    own = ref.march(o, d, draws.t_noise,
                    system.occupancy_bits(state.occupancy.bitfield), 128)
    # a sample on a cell boundary may fall either way (see the march)
    assert abs(int(res["rm_samples"]) - int(own.counts.sum())) <= 2
    assert int(own.counts.sum()) > 0
    for k, g in sys_.leaves(grads).items():
        # bf16 operands: a sum in another order may round one the other way
        assert _rel(g, rgrads[k]) < 1e-3, k


def test_one_sampled_refresh(setup):
    _check_one_refresh(setup)


def test_one_sampled_refresh_hash(hash_setup):
    _check_one_refresh(hash_setup)


def _check_one_refresh(setup):
    config, cfg, data, state, u8, K, w, sys_, ref = setup
    draws = draw_grid_inputs(cfg.model, False, torch.Generator().manual_seed(
        14))
    new = density_grid_step(state, cfg, False, draws=draws)
    params = sys_.leaves(state.params)
    grid, bits = ref.refresh(params, state.occupancy.density_grid[0],
                             draws[0].coords1, draws[0].keys, draws[0].noise)
    seen = grid >= 0
    assert _rel(new.occupancy.density_grid[0][seen], grid[seen]) < 1e-5
    got = system.occupancy_bits(new.occupancy.bitfield)
    assert float((got != bits).float().mean()) <= 1e-3
    assert 0 < int(bits.sum()) < bits.numel()


def test_three_adam_steps(setup):
    _check_three_adam_steps(setup)


def test_three_adam_steps_hash(hash_setup):
    _check_three_adam_steps(hash_setup)


def _check_three_adam_steps(setup):
    config, cfg, _, state, _, _, _, sys_, ref = setup
    opt = Adam(cfg.train.lr, cfg.train.max_steps, 1.0 / cfg.train.lr_final_div,
               cfg.train.adam_eps)
    params = {k: v.detach().clone() for k, v in sys_.leaves(
        state.params).items()}
    tree = {"p": {k: v.clone() for k, v in params.items()}}
    st = opt.init(tree, sched_count=40)
    mine = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    g = torch.Generator().manual_seed(15)
    for k in range(3):
        grads = {n: torch.randn(v.shape, generator=g) for n, v in
                 params.items()}
        st = opt.update({"p": grads}, st, tree)
        ref.adam(mine, grads, mu, nu, k, 40 + k)
    for n in params:
        assert _rel(tree["p"][n] - params[n], mine[n] - params[n]) < 1e-5, n


def test_configuration_is_the_default_command():
    """The cell's configuration holds the program's keys, field for field
    as ``config_for_scene(0.5)`` builds them (the seed is the run's)."""
    config = SPEC.config("ngp_brick_8x4")
    want = config_for_scene(0.5)
    got = system.program_config(config, want.train.seed)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_hash_configuration_is_the_encoder_flag():
    """The hash cell's configuration is ``config_for_scene(0.5,
    pos_encoder_type="hash")``, the program's ``--encoder_type hash``, field
    for field: the published 16 x 2 grid, T=2^19, 16 to 1024, an fp32
    table; and its leaves are the program's parameters, shape for shape."""
    config = SPEC.config("ngp_hash_16x2")
    want = config_for_scene(0.5, pos_encoder_type="hash")
    got = hash_system.program_config(config, want.train.seed)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.model.grid == HashGridConfig()
    layout = hash_encoder.build_layout(got.model.grid)
    geo = ref_ngp.HashGeometry.of(config["model"]["grid"])
    assert (geo.res, geo.size, geo.start) == (
        layout.resolutions, layout.map_sizes, layout.offsets)
    assert geo.hashed.index(True) == layout.begin_fast_hash_level == 6
    assert layout.feature_per_level * layout.n_entries == 11_420_064
    # what the train entry builds from ``train.py``'s flags
    if CHECKOUT not in sys.path:
        sys.path.insert(0, CHECKOUT)
    from opt import get_opts

    from taichi_nerfs_torch.config import config_from_opts

    hp = get_opts(["--root_dir", "synthetic://lego", "--encoder_type",
                   "hash"])
    assert config_from_opts(hp).model == got.model


# ------------------------------------------- the cell's comparison, faults


def _session(grid: str = "brick"):
    name, sys_, _, fam = GRIDS[grid]
    traffic = fam.shrink_traffic(copy.deepcopy(SPEC.traffic(
        SPEC.cell(f"{name}.train")["traffic"])))
    s = sys_.TrainSession(_config(grid), traffic, 2 ** 31 + 21, "cpu")
    s.release()
    return s


@pytest.mark.parametrize("fault", [None] + sorted(family.planted()))
def test_cell_comparison_and_planted_faults(fault):
    if fault is None:
        gaps = _session().check()
        assert all(v <= family.LIMITS[k] for k, v in gaps.items()), gaps
        return
    with family.planted()[fault]:
        gaps = _session().check()
    assert any(v > family.LIMITS[k] for k, v in gaps.items()), (fault, gaps)


@pytest.mark.parametrize("fault", [None] + sorted(hash_family.planted()))
def test_hash_cell_comparison_and_planted_faults(fault):
    """The hash cell's comparison at its tiny size: the program agrees
    with the reference; a bf16 table, a wrong prime and a dense level
    indexed as hashed each read past a limit."""
    limits = hash_family.LIMITS
    if fault is None:
        gaps = _session("hash").check()
        assert all(v <= limits[k] for k, v in gaps.items()), gaps
        return
    with hash_family.planted()[fault]:
        gaps = _session("hash").check()
    assert any(v > limits[k] for k, v in gaps.items()), (fault, gaps)


# --------------------------------------------------------- independence

FORBIDDEN = ("taichi_nerfs_torch", "taichi_nerfs_tpu", "jax", "jaxlib",
             "flax")


def _benchmark_imports(path, seen):
    """Top-level names a module imports, following ``benchmark.*``."""
    if path in seen:
        return set()
    seen.add(path)
    tops = set()
    for node in ast.walk(ast.parse(open(path).read())):
        names = ([a.name for a in node.names]
                 if isinstance(node, ast.Import) else
                 [node.module] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        for name in names:
            tops.add(name.split(".")[0])
            if name.startswith("benchmark."):
                sub = os.path.join(CHECKOUT, *name.split(".")) + ".py"
                if os.path.exists(sub):
                    tops |= _benchmark_imports(sub, seen)
    return tops


def test_reference_imports_neither_the_port_nor_jax():
    for name in ("ngp.py", "ngp_hash.py"):
        path = os.path.join(CHECKOUT, "benchmark", "reference", name)
        tops = _benchmark_imports(path, set())
        assert "torch" in tops and not tops & set(FORBIDDEN), name
    code = ("import sys, torch; import benchmark.reference.ngp_hash as r; "
            "r.NGPHashReference({'model': {'scale': 0.5, 'grid_size': 8, "
            "'brick': {'levels': 2, 'feature_per_level': 2, 'log2_rows': 6,"
            " 'base_res': 2, 'max_res': 4}, 'grid': {'levels': 2, "
            "'feature_per_level': 2, 'log2_T': 6, 'base_res': 2, "
            "'max_res': 4}}, 'render': {}, 'train': {}}); "
            "assert not torch.backends.cuda.matmul.allow_tf32; "
            "assert not torch.backends.cudnn.allow_tf32; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; assert not bad, bad")
    p = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
