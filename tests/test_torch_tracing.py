"""The port's tracing (``utils/profiling.py``) on the CPU, and its one
property that only the card shows.

With no profiler, ``span`` and ``backward_span`` enter no range and
install no hook.  Under ``torch.profiler`` one pyramid training step
records ``swr.step`` over four spans that do not overlap (``swr.plan``,
``swr.forward`` holding ``swr.bake`` and ``swr.loss``, ``swr.backward``,
``swr.adam``); the backward's ops, on the thread that runs them, lie
inside ``swr.backward`` (``ngp.backward`` for the NGP step); a frame is
one ``swr.frame`` with one ``swr.host_read`` a blocking read; a backward
that raises or skips a leaf still closes its range.  One NGP step of the
default path (the brick encoder) records one ``ngp.step`` holding every
other range of the step and all its ops, with ``ngp.encode`` in the
field's forward (and the refresh's) and again in the brick backward,
inside ``ngp.backward`` on its thread.  The ``cuda``-marked tests check on
the card that ``swr.backward`` is open on the thread that launches the
sweep backward's kernel, that the brick and hash backwards' ``ngp.encode``
is open on autograd's device thread where their kernels are launched, and
that the kernels launched while ``ngp.step`` is open (on its thread or
autograd's) take 99 % or more of the step's kernel time:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tracing.py
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_port_helpers import numpy_pyramid_params

from taichi_nerfs_torch.config import (
    BrickGridConfig,
    Config,
    HashGridConfig,
    ModelConfig,
    RenderConfig,
    TrainConfig,
)
from taichi_nerfs_torch.data.cameras import look_at
from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
from taichi_nerfs_torch.models import pyramid as tpyr
from taichi_nerfs_torch.render.serve import PyramidRenderer
from taichi_nerfs_torch.train import swr_step as tst
from taichi_nerfs_torch.train.loop import Trainer
from taichi_nerfs_torch.utils import profiling
from taichi_nerfs_torch.utils.convert import pyramid_params_from_numpy

SMALL = dict(resolutions=(8, 16), features=4, rgb_width=16, scale=0.5,
             deferred=True)
STEP_SPANS = ("swr.plan", "swr.forward", "swr.backward", "swr.adam")


@pytest.fixture(scope="module")
def sphere():
    return SyntheticSphereDataset(n_images=8, img_wh=(32, 32))


def _swr_trainer(sphere, device="cpu"):
    tcfg = tst.SwrTrainConfig(crop=32, lr=5e-2, max_steps=40, n_chunks=4,
                              resample_kind="cubic", random_bg=True,
                              alpha_w=0.1, tv_w=1e-3)
    return tst.SwrTrainer(tpyr.PyramidConfig(**SMALL), tcfg, sphere.rays,
                          sphere.poses, sphere.K, sphere.img_wh,
                          alphas=sphere.alphas, device=device)


def _ngp_trainer(encoder="hash", device="cpu"):
    """``tests/test_torch_ngp_e2e.py``'s tiny configuration: the hash
    encoder, or with ``encoder="brick"`` a 4-level brick grid (two dense
    levels, two hashed) and bf16 MLP operands, the default path's."""
    model = ModelConfig(
        scale=0.5, pos_encoder_type=encoder,
        grid=HashGridConfig(levels=4, feature_per_level=2, log2_T=11,
                            base_res=4, max_res=32),
        brick=BrickGridConfig(levels=4, feature_per_level=4, log2_rows=10,
                              base_res=4, max_res=32),
        grid_size=32, xyz_net_width=16, rgb_net_width=16,
        mlp_dtype="float32" if encoder == "hash" else "bfloat16")
    cfg = Config(model=model,
                 render=RenderConfig(exp_step_factor=0.0,
                                     train_sample_cap=256,
                                     test_chunk_samples=16, white_bg=True),
                 train=TrainConfig(batch_size=256, max_steps=20,
                                   warmup_steps=4, update_interval=8))
    scene = SyntheticSphereDataset(n_images=4, img_wh=(24, 24))
    return Trainer(cfg, scene.as_batch(device), scene.K, scene.img_wh,
                   log_fn=lambda *_: None, device=device)


def _renderer(deferred: bool):
    cfg = tpyr.PyramidConfig(**dict(SMALL, deferred=deferred))
    tree = numpy_pyramid_params((8, 16), (4, 4), 16, 2, seed=0, blob=12.0)
    K = np.array([[40.0, 0, 16.0], [0, 40.0, 16.0], [0, 0, 1]], np.float32)
    return PyramidRenderer(pyramid_params_from_numpy(tree), cfg, K, (32, 32),
                           resample_kind="cubic")


def _pose():
    return look_at(np.array([0.3, -1.6, 0.5]), np.zeros(3),
                   np.array([0.0, 0.0, 1.0])).astype(np.float32)


def _traced(fn, tmp_path, cuda=False):
    """``fn()`` under ``torch.profiler``: its chrome trace's complete
    events."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def _ranges(events, name):
    """``(start, end, tid)`` of each user range ``name``, in time order."""
    return sorted((e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"] == name)


def _within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


# ------------------------------------------------------------ profiler off


class _Raises:
    def __init__(self, what):
        self.what = what

    def __call__(self, *a, **k):
        raise AssertionError(f"{self.what} called with no profiler")


@pytest.fixture
def no_entry(monkeypatch):
    """Every way into a profiler range, and the tensor hook, raise."""
    monkeypatch.setattr(torch.profiler, "record_function",
                        _Raises("record_function"))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _Raises("record_function"))
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        _Raises("_record_function_enter_new"))
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        _Raises("register_hook"))


class _Stub:
    """A root or leaf whose hooks raise when registered."""

    register_hook = _Raises("register_hook")

    class grad_fn:  # noqa: N801
        register_prehook = _Raises("register_prehook")


def _off_span():
    with profiling.span("x"):
        pass


def _off_backward_span():
    with profiling.backward_span("x", _Stub(), [_Stub(), _Stub()]):
        pass
    a = torch.ones(3, requires_grad=True)
    loss = (a * a).sum()
    with profiling.backward_span("x", loss, [a]):
        (g,) = torch.autograd.grad(loss, [a])
    assert torch.equal(g, 2 * a.detach())


@pytest.mark.parametrize("case", ["span", "backward_span", "pyramid_step",
                                  "ngp_step", "ngp_brick_step", "frame"])
def test_no_profiler_enters_no_range_and_no_hook(case, sphere, no_entry):
    assert not torch.autograd._profiler_enabled()
    if case == "span":
        _off_span()
    elif case == "backward_span":
        _off_backward_span()
    elif case == "pyramid_step":
        assert np.isfinite(float(_swr_trainer(sphere).run_step()["loss"]))
    elif case == "ngp_step":
        assert np.isfinite(float(_ngp_trainer().run_step()["loss"]))
    elif case == "ngp_brick_step":
        assert np.isfinite(float(_ngp_trainer("brick").run_step()["loss"]))
    else:
        out = _renderer(True).render(_pose(), early_exit=1e-2)
        assert torch.isfinite(out["rgb"]).all()


# ------------------------------------------------------------- profiler on


def test_pyramid_step_spans(sphere, tmp_path):
    trainer = _swr_trainer(sphere)
    trainer.run_step()  # the first step builds what later steps reuse
    ev = _traced(trainer.run_step, tmp_path)
    (step,) = _ranges(ev, "swr.step")
    tops = [r for name in STEP_SPANS for r in _ranges(ev, name)]
    assert {name for name in STEP_SPANS if _ranges(ev, name)} == set(
        STEP_SPANS)
    tops.sort()
    for a, b in zip(tops, tops[1:]):
        assert a[1] <= b[0], (a, b)  # the four never overlap
    for r in tops:
        assert _within(r, step)
    (fwd,) = _ranges(ev, "swr.forward")
    for name in ("swr.bake", "swr.loss", "swr.sweep", "swr.warp",
                 "swr.shade"):
        rs = _ranges(ev, name)
        assert rs and all(_within(r, fwd) for r in rs), name


def _same_thread(inner, outer):
    return _within(inner, outer) and inner[2] == outer[2]


def _top_level_ops(events):
    """``(start, end, tid)`` of the ops no other op on their thread
    encloses."""
    evs = sorted((e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                 if e.get("cat") == "cpu_op")
    out, ends = [], {}
    for a, b, tid in evs:
        if a >= ends.get(tid, -1.0):
            out.append((a, b, tid))
            ends[tid] = b
    return out


@pytest.mark.parametrize("refresh", [False, True], ids=["step", "refresh"])
def test_ngp_step_spans(refresh, tmp_path):
    """One brick step (and one that opens with a refresh): one ``ngp.step``
    holding every range and op of the call; ``ngp.encode`` in the field's
    forward (and the refresh's), and in the backward on its thread."""
    trainer = _ngp_trainer("brick")
    trainer.run_step()  # the first step builds what later steps reuse
    while (trainer.step % trainer.cfg.train.update_interval == 0) != refresh:
        trainer.run_step()
    ev = _traced(trainer.run_step, tmp_path)
    (step,) = _ranges(ev, "ngp.step")
    names = {e["name"] for e in ev if e.get("cat") == "user_annotation"}
    assert {"ngp.march", "ngp.field", "ngp.encode", "ngp.backward",
            "ngp.adam"} <= names
    assert ("ngp.grid" in names) == refresh
    for name in names - {"ngp.step"}:
        assert all(_within(r, step) for r in _ranges(ev, name)), name
    (field,) = _ranges(ev, "ngp.field")
    (bwd,) = _ranges(ev, "ngp.backward")
    encodes = _ranges(ev, "ngp.encode")
    assert sum(_same_thread(r, field) for r in encodes) == 1
    assert sum(_same_thread(r, bwd) for r in encodes) == 1
    if refresh:
        (grid,) = _ranges(ev, "ngp.grid")
        assert sum(_same_thread(r, grid) for r in encodes) == 1
    assert len(encodes) == 2 + refresh
    ops = _top_level_ops(ev)
    inside = sum(b - a for a, b, _ in ops if step[0] <= a <= step[1])
    assert inside >= 0.99 * sum(b - a for a, b, _ in ops)


def _backward_ops(ev, rng):
    """The backward's op that was running when ``rng`` opened (the
    root's), and every backward op after it."""
    ops = sorted((e["ts"], e["ts"] + e["dur"], e["tid"], e["name"])
                 for e in ev if e.get("cat") == "cpu_op"
                 and e["name"].startswith("autograd::engine::evaluate_"))
    i = max(k for k, o in enumerate(ops) if o[0] <= rng[0])
    return ops[i], ops[i + 1:]


@pytest.mark.parametrize("path", ["pyramid", "ngp"])
def test_backward_span_holds_the_backward(path, sphere, tmp_path):
    """Every backward op after the root's starts inside the range, on the
    range's thread; those that compute lie wholly inside (the last leaf's
    hook closes the range inside its capture's op).  The root's op starts
    just before its pre-hook opens the range."""
    if path == "pyramid":
        trainer, name = _swr_trainer(sphere), "swr.backward"
    else:
        trainer, name = _ngp_trainer(), "ngp.backward"
    trainer.run_step()
    ev = _traced(trainer.run_step, tmp_path)
    (rng,) = _ranges(ev, name)
    first, rest = _backward_ops(ev, rng)
    assert first[0] <= rng[0] <= first[1] and first[2] == rng[2]
    assert len(rest) > 5
    for ts, end, tid, op in rest:
        assert tid == rng[2] and rng[0] <= ts <= rng[1], op
        if "AccumulateGrad" not in op:
            assert end <= rng[1], op


def _read_counter(monkeypatch):
    """Count every host read of a tensor (``item``, ``tolist``,
    ``float``, ``int``, ``bool``)."""
    n = [0]
    for attr in ("item", "tolist", "__float__", "__int__", "__bool__"):
        orig = getattr(torch.Tensor, attr)

        def counted(self, *a, _orig=orig, **k):
            n[0] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, attr, counted)
    return n


@pytest.mark.parametrize("deferred", [True, False], ids=["sweep", "scan"])
def test_frame_spans_each_host_read(deferred, tmp_path, monkeypatch):
    renderer = _renderer(deferred)
    renderer.grid  # baked outside the frame
    reads = _read_counter(monkeypatch)
    ev = _traced(lambda: renderer.render(_pose(), early_exit=1e-2), tmp_path)
    (frame,) = _ranges(ev, "swr.frame")
    spans = _ranges(ev, "swr.host_read")
    assert len(spans) == reads[0] >= 2
    assert all(_within(r, frame) for r in spans)


@pytest.mark.parametrize("how", ["raises", "leaf_unused"])
def test_backward_span_closes(how, tmp_path):
    a = torch.ones(4, requires_grad=True)
    b = torch.ones(4, requires_grad=True)

    class Fails(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            raise RuntimeError("planted")

    def run():
        if how == "raises":
            loss = Fails.apply(a).sum() + b.sum()
            with pytest.raises(RuntimeError, match="planted"):
                with profiling.backward_span("bwd", loss, [a, b]):
                    torch.autograd.grad(loss, [a, b])
        else:
            loss = (3 * a).sum()
            with profiling.backward_span("bwd", loss, [a, b]):
                ga, gb = torch.autograd.grad(loss, [a, b],
                                             allow_unused=True)
            assert gb is None and torch.equal(ga, torch.full((4,), 3.0))

    ev = _traced(run, tmp_path)
    (rng,) = _ranges(ev, "bwd")
    assert rng[1] >= rng[0]
    assert not a._backward_hooks and not b._backward_hooks
    with profiling.span("outer"):  # no range was left open
        pass


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sweep kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_backward_span_shares_the_sweep_backward_thread(cuda_device, sphere,
                                                         tmp_path):
    """On the card the backward runs on autograd's device thread: the
    sweep backward's kernel is launched there, inside ``swr.backward``."""
    trainer = _swr_trainer(sphere, cuda_device)
    trainer.run_step()
    ev = _traced(trainer.run_step, tmp_path, cuda=True)
    (rng,) = _ranges(ev, "swr.backward")
    (step,) = _ranges(ev, "swr.step")
    kernels = [e for e in ev if e.get("cat") == "kernel"
               and "swr_sweep_bwd_kernel" in e["name"]]
    assert kernels
    launches = {e["args"]["correlation"]: e for e in ev
                if e.get("cat", "").startswith("cuda_")  # the API calls
                and "correlation" in e.get("args", {})}
    for k in kernels:
        launch = launches[k["args"]["correlation"]]
        assert launch["tid"] == rng[2] != step[2]
        assert rng[0] <= launch["ts"] <= rng[1]


@pytest.mark.cuda
def test_ngp_backward_encode_on_autograd_thread(cuda_device, tmp_path):
    """On the card the brick backward's ``ngp.encode`` is open on autograd's
    device thread, with its kernels launched inside it; the kernels launched
    while ``ngp.step`` is open, on either thread, take 99 % or more of the
    step's kernel time."""
    _check_encode_on_autograd_thread("brick", cuda_device, tmp_path)


@pytest.mark.cuda
def test_ngp_hash_backward_encode_on_autograd_thread(cuda_device, tmp_path):
    """The same for the hash encoder's backward kernels."""
    _check_encode_on_autograd_thread("hash", cuda_device, tmp_path)


def _check_encode_on_autograd_thread(encoder, device, tmp_path):
    trainer = _ngp_trainer(encoder, device)
    trainer.run_step()
    ev = _traced(trainer.run_step, tmp_path, cuda=True)
    (step,) = _ranges(ev, "ngp.step")
    (bwd,) = _ranges(ev, "ngp.backward")
    (encode,) = [r for r in _ranges(ev, "ngp.encode")
                 if _same_thread(r, bwd)]
    assert bwd[2] != step[2]
    launches = {e["args"]["correlation"]: e for e in ev
                if e.get("cat", "").startswith("cuda_")
                and "correlation" in e.get("args", {})}
    under = total = 0.0
    in_encode = 0
    for k in (e for e in ev if e.get("cat") == "kernel"):
        total += k["dur"]
        launch = launches.get(k["args"].get("correlation"))
        if launch is None:
            continue
        ts, tid = launch["ts"], launch["tid"]
        in_encode += encode[0] <= ts <= encode[1] and tid == encode[2]
        under += k["dur"] if step[0] <= ts <= step[1] else 0.0
    assert in_encode > 0
    assert under >= 0.99 * total
