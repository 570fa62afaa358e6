"""Port parity: the compiled-artifact export (``utils/aot.py``) and the
sweep kernels as registered operators.

Mirrors ``tests/test_aot.py`` on ``torch.export``: a toy round trip, and
the pyramid's six entry points exported from the CPU, where the program
holds the plain sweep inline.  The same numpy weights (a seed's levels
plus 0.5 noise) go through the JAX module (``jax.export`` on the CPU, as
``tests/test_aot.py`` runs it) and the port.  Tolerances: the loaded frame
within 1e-5 of the port's live gather render (``tests/test_aot.py``'s), and
within 2e-4 of the JAX artifact's frame (the render parity tests',
``tests/test_torch_render.py``).  The operators' fake versions are checked
under ``FakeTensorMode`` (shapes and dtypes of the plain version's
outputs), and a sweep traced from fake CUDA tensors exports as one node of
``taichi_nerfs_torch::swr_sweep_fwd``.  The export from real CUDA tensors
runs in the ``cuda``-marked test and in ``chip_smoke.py``'s ``aot``
phase::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_aot.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch_port_helpers import (
    np32,
    numpy_pyramid_params,
    rand_sweep_inputs,
    t32,
)

from taichi_nerfs_torch.data.cameras import look_at
from taichi_nerfs_torch.models import pyramid as tpyr
from taichi_nerfs_torch.ops import swr_sweep as tsw
from taichi_nerfs_torch.ops._build import LAUNCHES
from taichi_nerfs_torch.render import swr as tswr
from taichi_nerfs_torch.utils import aot as taot
from taichi_nerfs_torch.utils.convert import pyramid_params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIVE_TOL = 1e-5  # tests/test_aot.py: the loaded artifact against the render
JAX_TOL = 2e-4  # tests/test_torch_render.py: the port against JAX
K = np.array([[40.0, 0, 16.0], [0, 40.0, 16.0], [0, 0, 1]], np.float32)
WH = (32, 32)
CFG_KW = dict(resolutions=(8, 16), features=4, rgb_width=16, scale=0.5,
              deferred=True)
EYES = ([0.2, 0.1, 1.2], [1.1, 0.3, -0.2], [-0.2, -1.3, 0.4])
NAMES = [f"pyramid_render_a{a}f{f}" for a in range(3) for f in (0, 1)]


def _pose(eye):
    return look_at(np.asarray(eye), np.zeros(3),
                   np.array([0.0, 0.0, 1.0])).astype(np.float32)


def test_export_compiled_roundtrip(tmp_path):
    def f(x, y):
        return {"z": torch.tanh(x) @ y}

    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    y = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    path = taot.export_compiled(f, [t32(x), t32(y)], str(tmp_path),
                                name="toy")
    meta = json.load(open(tmp_path / "metadata.json"))["toy"]
    assert meta["in_avals"] == [{"shape": [8, 4], "dtype": "float32"},
                                {"shape": [4, 3], "dtype": "float32"}]
    assert meta["out_avals"] == [{"shape": [8, 3], "dtype": "float32"}]
    assert meta["platforms"] == ["cpu"]
    assert meta["torch_version"] == torch.__version__
    assert path == str(tmp_path / meta["file"])
    assert os.path.getsize(path) > 0
    g = taot.load_compiled(str(tmp_path), "toy")
    np.testing.assert_allclose(np32(g(t32(x), t32(y))["z"]),
                               np.tanh(x) @ y, rtol=1e-5, atol=1e-5)


def test_export_compiled_merges_entries_and_checks_devices(tmp_path):
    """A second entry joins ``metadata.json``; explicit ``platforms`` name
    the file; example arguments on two device types, or a platform the
    entry was not exported for, raise."""
    x = torch.ones(3)
    taot.export_compiled(lambda a: a + 1, [x], str(tmp_path), name="one",
                         extra_meta={"tag": 7})
    taot.export_compiled(lambda a: [a * 2], [x], str(tmp_path), name="two",
                         platforms=["cpu"])
    meta = json.load(open(tmp_path / "metadata.json"))
    assert set(meta) == {"one", "two"} and meta["one"]["tag"] == 7
    assert meta["two"]["files"] == {"cpu": "two.cpu.pt2"}
    assert float(taot.load_compiled(str(tmp_path), "two",
                                    device="cpu")(x)[0][0]) == 2.0
    with pytest.raises(ValueError, match="exported for"):
        taot.load_compiled(str(tmp_path), "two", device="cuda")
    with pytest.raises(ValueError, match="one device type"):
        taot.export_compiled(lambda a, b: a, [x, torch.ones(3,
                                                           device="meta")],
                             str(tmp_path), name="bad")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The tiny pyramid of ``tests/test_aot.py`` (levels plus 0.5 noise,
    from numpy), exported by both packages with the full lattice
    (``lat_cap=48``), so the live uncapped render is the same program."""
    from torch_port_helpers import jax_tree

    from taichi_nerfs_tpu.models import pyramid as jpyr
    from taichi_nerfs_tpu.utils import aot as jaot

    tree = numpy_pyramid_params((8, 16), (4, 4), 16, 2, seed=0)
    rng = np.random.default_rng(1)
    tree["levels"] = [(g + 0.5 * rng.normal(size=g.shape)).astype(np.float32)
                      for g in tree["levels"]]
    root = tmp_path_factory.mktemp("aot")
    out_t, out_j = str(root / "torch"), str(root / "jax")
    params = pyramid_params_from_numpy(tree)
    tcfg = tpyr.PyramidConfig(**CFG_KW)
    assert taot.export_pyramid_compiled(params, tcfg, K, WH, out_t,
                                        lat_cap=48) == out_t
    jp, jcfg = jax_tree(tree), jpyr.PyramidConfig(**CFG_KW)
    jaot.export_pyramid_compiled(jp, jcfg, K, WH, out_j, lat_cap=48)
    return {"dir": out_t, "params": params, "cfg": tcfg,
            "grid": tpyr.bake(params, tcfg),
            "render": taot.load_pyramid_renderer(out_t),
            "jax_render": jaot.load_pyramid_renderer(out_j),
            "jax_params": jp, "jax_grid": jpyr.bake_jit(jp, jcfg)}


def test_pyramid_artifact_entries(artifact):
    meta = json.load(open(os.path.join(artifact["dir"], "metadata.json")))
    assert set(meta) == set(NAMES)
    for n in NAMES:
        e = meta[n]
        assert os.path.getsize(os.path.join(artifact["dir"], e["file"])) > 0
        assert e["platforms"] == ["cpu"]
        assert (e["model"], e["grid_res"], e["scale"], e["img_wh"],
                e["white_bg"], e["lat_cap"]) == ("pyramid", 16, 0.5,
                                                 [32, 32], True, 48)
        assert (e["axis"], int(e["flip"])) == (int(n[-3]), int(n[-1]))
        # inputs: the grid, the rgb MLP's three weights, the pose
        assert [a["shape"] for a in e["in_avals"]] == [
            [16, 16, 16, 4], [19, 16], [16, 16], [16, 3], [3, 4]]
        assert [a["shape"] for a in e["out_avals"]] == [
            [1024, 3], [1024], [1024]]


@pytest.mark.parametrize("eye", EYES, ids=["+z", "+x", "-y"])
def test_pyramid_artifact_matches_live_and_jax(artifact, eye):
    """The loaded entry point against the port's live gather render (1e-5)
    and the JAX artifact's frame of the same weights (2e-4)."""
    import jax.numpy as jnp

    render = artifact["render"]
    pose = _pose(eye)
    got = render(artifact["grid"], artifact["params"]["rgb_mlp"], pose)
    with torch.no_grad():
        want = tswr.render_swr(artifact["params"], artifact["grid"],
                               artifact["cfg"], pose, K, WH, skip_empty=True,
                               warp="gather")
    for k in ("rgb", "depth", "opacity"):
        np.testing.assert_allclose(np32(got[k]), np32(want[k]),
                                   rtol=LIVE_TOL, atol=LIVE_TOL)
    assert np.isfinite(np32(got["rgb"])).all()
    # the frame composites something: not all background
    assert np32(got["opacity"]).max() > 0.1
    jax_out = artifact["jax_render"](
        artifact["jax_grid"], artifact["jax_params"]["rgb_mlp"],
        jnp.asarray(pose))
    for k in ("rgb", "opacity"):
        np.testing.assert_allclose(np32(got[k]), np.asarray(jax_out[k]),
                                   rtol=JAX_TOL, atol=JAX_TOL)


def test_inside_pose_raises_in_both_packages(artifact):
    import jax.numpy as jnp

    pose = _pose([0.1, 0.05, 0.3])  # |o_z| = 0.3 <= 1.05 * 0.5
    render = artifact["render"]
    with pytest.raises(ValueError, match="inside the grid"):
        render(artifact["grid"], artifact["params"]["rgb_mlp"], pose)
    with pytest.raises(ValueError, match="inside the grid"):
        artifact["jax_render"](artifact["jax_grid"],
                               artifact["jax_params"]["rgb_mlp"],
                               jnp.asarray(pose))


def test_renderer_refuses_tf32(artifact):
    render = artifact["render"]
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            render(artifact["grid"], artifact["params"]["rgb_mlp"],
                   _pose(EYES[0]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_export_refuses_configs_off_the_sweep_path(tmp_path):
    params = pyramid_params_from_numpy(
        numpy_pyramid_params((8, 16), (4, 4), 16, 2, seed=0))
    cfg = tpyr.PyramidConfig(**dict(CFG_KW, deferred=False))
    with pytest.raises(ValueError, match="deferred, unsplit"):
        taot.export_pyramid_compiled(params, cfg, K, WH, str(tmp_path))


def test_artifact_loads_without_the_defining_python(artifact, tmp_path):
    """A fresh process whose ``render_swr_fixed_axis`` raises renders the
    same frame from the artifact: nothing is re-traced."""
    pose = _pose(EYES[1])
    inputs = str(tmp_path / "inputs.pt")
    torch.save({"grid": artifact["grid"],
                "rgb_mlp": artifact["params"]["rgb_mlp"],
                "pose": torch.as_tensor(pose)}, inputs)
    code = (
        "import sys, torch\n"
        "import taichi_nerfs_torch.render.swr as s\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('the defining Python was re-traced')\n"
        "s.render_swr_fixed_axis = boom\n"
        "from taichi_nerfs_torch.utils.aot import load_pyramid_renderer\n"
        "d = torch.load(sys.argv[2])\n"
        "out = load_pyramid_renderer(sys.argv[1])(d['grid'], d['rgb_mlp'],"
        " d['pose'])\n"
        "torch.save(out['rgb'], sys.argv[3])\n"
    )
    out_path = str(tmp_path / "rgb.pt")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code, artifact["dir"], inputs,
                        out_path], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    with torch.no_grad():
        want = tswr.render_swr(artifact["params"], artifact["grid"],
                               artifact["cfg"], pose, K, WH, skip_empty=True,
                               warp="gather")["rgb"]
    np.testing.assert_allclose(np32(torch.load(out_path)), np32(want),
                               rtol=LIVE_TOL, atol=LIVE_TOL)


@pytest.mark.parametrize("vol_dtype", [torch.float32, torch.bfloat16],
                         ids=["vol_f32", "vol_bf16"])
@pytest.mark.parametrize("F", [4, 8, 16])
def test_fake_ops_match_plain_shapes(F, vol_dtype):
    """Both operators' fake versions (what ``torch.export`` traces), on
    fake CUDA tensors, give the plain versions' output shapes and dtypes;
    ``chunk_sweep`` on such tensors takes the operator."""
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(seed=0, nc=2, dc=3, Rb=9,
                                               Rc=7, F=F, nq=11)
    cpu = [t32(vol).to(vol_dtype), t32(rs), t32(z_rel), t32(ch)]
    frames = tsw.chunk_sweep_reference(*cpu, nq, "cubic", torch.bfloat16)
    g = torch.ones_like(frames)
    dvol = tsw.chunk_sweep_bwd_reference(*cpu, g, nq, "cubic",
                                         torch.bfloat16)
    launches = (LAUNCHES["swr_sweep_fwd"], LAUNCHES["swr_sweep_bwd"])
    with FakeTensorMode():
        fake = [torch.empty(x.shape, dtype=x.dtype, device="cuda")
                for x in cpu]
        out = tsw.chunk_sweep(*fake, nq, "cubic", torch.bfloat16)
        fg = torch.empty_like(out)
        d = tsw.chunk_sweep_bwd(*fake, out, fg, nq, "cubic", torch.bfloat16)
    assert (tuple(out.shape), out.dtype, out.device.type) == (
        tuple(frames.shape), frames.dtype, "cuda")
    assert (tuple(d.shape), d.dtype, d.device.type) == (
        tuple(dvol.shape), dvol.dtype, "cuda")
    # a fake run launches nothing
    assert (LAUNCHES["swr_sweep_fwd"], LAUNCHES["swr_sweep_bwd"]) == launches


def test_fake_op_checks_its_arguments():
    with FakeTensorMode():
        vol = torch.empty(2, 3, 5, 9, 7, device="cuda")  # F=5: no kernel
        rs, z, ch = (torch.empty(s, device="cuda")
                     for s in ((2, 3, 4), (2, 3), (2, 6)))
        with pytest.raises(ValueError, match="F in"):
            tsw.chunk_sweep(vol, rs, z, ch, 11)


def test_cuda_sweep_exports_as_one_operator_node(tmp_path):
    """Traced from fake CUDA tensors, ``chunk_sweep`` is one node of the
    registered operator, which survives save and load; from CPU tensors
    the plain sweep is inline and no operator node appears."""

    class Sweep(torch.nn.Module):
        def forward(self, vol, rs, z_rel, ch):
            return tsw.chunk_sweep(vol, rs, z_rel, ch, 11, "cubic")

    vol, rs, z_rel, ch, _ = rand_sweep_inputs(seed=0, nc=2, dc=3, Rb=9,
                                              Rc=7, F=8, nq=11)
    cpu = (t32(vol), t32(rs), t32(z_rel), t32(ch))
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = tuple(torch.empty(x.shape, device="cuda") for x in cpu)
        ep = torch.export.export(Sweep(), args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets == ["taichi_nerfs_torch.swr_sweep_fwd.default"]
    path = str(tmp_path / "sweep.pt2")
    torch.export.save(ep, path)
    back = torch.export.load(path)
    assert [str(n.target) for n in back.graph.nodes
            if n.op == "call_function"] == targets

    ep_cpu = torch.export.export(Sweep(), cpu, strict=False)
    assert not any("swr_sweep" in str(n.target) for n in ep_cpu.graph.nodes)
    np.testing.assert_allclose(
        np32(ep_cpu.module()(*cpu)),
        np32(tsw.chunk_sweep_reference(*cpu, 11, "cubic")), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_operator_autograd_gives_the_plain_gradient(kind):
    """The forward operator's registered autograd (``setup_context`` saves
    the frames; the backward calls ``chunk_sweep_bwd``) gives the plain
    sweep's gradient of ``vol_cs`` and none of the camera parameters."""
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(seed=11, nc=1, dc=4, Rb=10,
                                               Rc=7, nq=13)
    cam = [t32(rs), t32(z_rel), t32(ch).requires_grad_(True)]
    g = t32(np.random.default_rng(5).normal(
        size=(1, vol.shape[2] + 2, nq, nq)))
    # a CPU kernel of the forward operator for this test alone (the plain
    # sweep, without autograd inside the operator), so that the operator's
    # own autograd formula runs here
    lib = torch.library.Library("taichi_nerfs_torch", "IMPL")
    lib.impl("swr_sweep_fwd", tsw.chunk_sweep_reference, "CPU")
    try:
        v = t32(vol).requires_grad_(True)
        out = torch.ops.taichi_nerfs_torch.swr_sweep_fwd(
            v, *cam, nq, kind, torch.float32)
        got, dch = torch.autograd.grad(out, (v, cam[2]), g,
                                       allow_unused=True)
    finally:
        lib._destroy()
    w = t32(vol).requires_grad_(True)
    (want,) = torch.autograd.grad(
        tsw.chunk_sweep(w, *[c.detach() for c in cam], nq, kind), w, g)
    np.testing.assert_array_equal(np32(got), np32(want))
    assert dch is None


@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_cpu_gradient_unchanged_against_jax(kind):
    """``chunk_sweep`` under autograd and the ``chunk_sweep_bwd`` wrapper on
    the CPU against the JAX VJP (the Pallas reverse sweep in interpret
    mode), 2e-4 as in ``tests/test_torch_swr_sweep_bwd.py``."""
    from test_torch_swr_sweep_bwd import TOL, _cotangent, _jax_vjp

    vol, rs, z_rel, ch, nq = rand_sweep_inputs(seed=11, nc=1, dc=4, Rb=10,
                                               Rc=7, nq=13)
    g = _cotangent(vol, nq)
    want = _jax_vjp(vol, rs, z_rel, ch, nq, kind, g)
    vt = t32(vol).requires_grad_(True)
    out = tsw.chunk_sweep(vt, t32(rs), t32(z_rel), t32(ch), nq, kind)
    out.backward(t32(g))
    np.testing.assert_allclose(np32(vt.grad), want, rtol=TOL, atol=TOL)
    dvol = tsw.chunk_sweep_bwd(t32(vol), t32(rs), t32(z_rel), t32(ch),
                               out.detach(), t32(g), nq, kind)
    np.testing.assert_allclose(np32(dvol), want, rtol=TOL, atol=TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sweep kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_artifact_for_two_platforms_on_card(cuda_device, tmp_path):
    """Exported for ("cuda", "cpu") from the card: each file renders on its
    own device, the CUDA one through one ``swr_sweep_fwd`` launch a frame,
    within 2e-4 of the other."""
    params = pyramid_params_from_numpy(
        numpy_pyramid_params((8, 16), (4, 4), 16, 2, seed=0, blob=4.0),
        cuda_device)
    cfg = tpyr.PyramidConfig(**CFG_KW)
    out = str(tmp_path / "compiled")
    taot.export_pyramid_compiled(params, cfg, K, WH, out,
                                 platforms=("cuda", "cpu"))
    meta = json.load(open(os.path.join(out, "metadata.json")))
    assert meta[NAMES[0]]["platforms"] == ["cuda", "cpu"]
    grid = tpyr.bake(params, cfg)
    pose = _pose(EYES[0])
    rc = taot.load_pyramid_renderer(out, device="cuda")
    rcpu = taot.load_pyramid_renderer(out, device="cpu")
    n0 = LAUNCHES["swr_sweep_fwd"]
    a = rc(grid, params["rgb_mlp"], pose)["rgb"]
    torch.cuda.synchronize()
    assert LAUNCHES["swr_sweep_fwd"] == n0 + 1
    b = rcpu(grid.cpu(), {k: v.cpu() for k, v in params["rgb_mlp"].items()},
             pose)["rgb"]
    np.testing.assert_allclose(np32(a), np32(b), rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("vol_dtype", [torch.float32, torch.bfloat16],
                         ids=["vol_f32", "vol_bf16"])
def test_opcheck_on_card(cuda_device, vol_dtype):
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(seed=0, nc=2, dc=3, Rb=9,
                                               Rc=7, F=8, nq=11)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (vol, rs, z_rel, ch)]
    args[0] = args[0].to(vol_dtype).requires_grad_(True)
    torch.library.opcheck(torch.ops.taichi_nerfs_torch.swr_sweep_fwd,
                          (*args, nq, "cubic", torch.float32))
    frames = tsw.chunk_sweep(*[a.detach() for a in args], nq, "cubic")
    g = torch.randn_like(frames)
    torch.library.opcheck(torch.ops.taichi_nerfs_torch.swr_sweep_bwd,
                          (*[a.detach() for a in args], frames, g, nq,
                           "cubic", torch.float32))
