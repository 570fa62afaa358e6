"""The NGP march's CUDA kernel and its plain version.

``csrc/ngp_march.cu`` walks each ray's cell crossings in order (a merge of
the three axes' monotone plane sequences, no sort) and writes its first
``S`` samples; ``ops/marching.py:_march_rays_intervals`` is the plain
version it is held to.  The kernel has no CPU mode, so its walk is written
here again in fp32 numpy scalars, line for line (:func:`_walk`), and held
on the CPU to the plain version bit for bit, with the CPU's division; the
operator's fake version and argument checks are checked on ``meta``
tensors, and what it hands the C entry on CPU tensors.  The
``cuda``-marked tests hold the kernel to the plain version on the card,
bit for bit, and count its launches::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_ngp_march_kernel.py

This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from taichi_nerfs_torch.ops import marching as tmarch
from taichi_nerfs_torch.ops._build import LAUNCHES
from taichi_nerfs_torch.ops.math import packbits_u32
from taichi_nerfs_torch.ops.rays import ray_aabb_intersect

torch.set_num_threads(2)

F32 = np.float32
SCALE = 0.5


def _plane(i, G, scale=SCALE):
    """Plane ``i`` of an axis as the march computes it in fp32."""
    h, _, _ = tmarch._kernel_lattice(scale, G)
    return F32(F32(i) * F32(h)) + F32(-scale)


def _crossing(i, o, d, G):
    """The fp32 ``t`` at which a ray (one axis of it) crosses plane ``i``."""
    return F32(_plane(i, G) - F32(o)) * (F32(1) / F32(d))


def _case(n, seed, G, occupancy):
    """``n`` rays of every kind the march meets, their ``t_start`` and
    ``t_end``, and a bitfield with ``occupancy`` of the cells set.

    Most rays come from outside the box towards it; an eighth start inside,
    an eighth point away and miss (``t_start < 0``), an eighth run along
    an axis (two components exactly 0, or below 1e-12), an eighth leave a
    grid vertex along a diagonal (crossings that tie on two or three axes).
    Of those from inside, half start and end exactly on a crossing; the
    others start at the box's entry, jittered as the training step does
    (some by 0)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n, 3))
    o = 1.4 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.uniform(-0.4, 0.4, (n, 3))
    parts = np.array_split(np.arange(n), 8)
    inside, miss, axis, diag = parts[1], parts[2], parts[3], parts[4]
    o[inside] = rng.uniform(-0.45, 0.45, (len(inside), 3))
    d[inside] = rng.normal(size=(len(inside), 3))
    d[miss] = o[miss] + rng.uniform(-0.1, 0.1, (len(miss), 3))
    o[axis] = rng.uniform(-0.45, 0.45, (len(axis), 3))
    d[axis] = 0.0
    which = rng.integers(0, 3, len(axis))
    d[axis, which] = rng.choice([-1.0, 1.0], len(axis))
    d[axis[::2], (which[::2] + 1) % 3] = 1e-13
    vert = rng.integers(1, G, (len(diag), 3))
    o[diag] = np.reshape([_plane(i, G) for i in vert.ravel()], (-1, 3))
    d[diag] = rng.choice([-1.0, 1.0], (len(diag), 3))
    d[diag[::2], rng.integers(0, 3, len(diag[::2]))] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(F32), d.astype(F32)
    hits = ray_aabb_intersect(torch.tensor(o), torch.tensor(d), SCALE)
    noise = rng.uniform(size=n).astype(F32)
    noise[::5] = 0.0
    t_start = tmarch.perturb_t_start(hits, torch.tensor(noise), 0.0, G,
                                     SCALE).numpy()
    t_end = hits[:, 1].numpy().copy()
    for r in inside[::2]:
        a = int(np.argmax(np.abs(d[r])))
        i0 = int(np.floor((o[r, a] + SCALE) * G)) + (d[r, a] > 0)
        step = 1 if d[r, a] > 0 else -1
        if 1 <= i0 + 3 * step < G:
            t_start[r] = _crossing(i0 + step, o[r, a], d[r, a], G)
            t_end[r] = _crossing(i0 + 3 * step, o[r, a], d[r, a], G)
    cells = (rng.uniform(size=G**3) < occupancy).astype(np.float32)
    bitfield = packbits_u32(torch.tensor(cells), 0.5)
    return (torch.tensor(o), torch.tensor(d), torch.tensor(t_start),
            torch.tensor(t_end), bitfield)


def _cpu_divide(x, s):
    """``x / s`` for a Python scalar ``s``, as PyTorch divides on the CPU:
    an fp32 division by the fp32 scalar (on CUDA it multiplies by the fp32
    reciprocal, as the kernel does)."""
    return (np.asarray(x, F32) / F32(s)).astype(F32)


def _morton(v):
    out = np.zeros_like(v)
    for b in range(10):
        out |= ((v >> b) & 1) << (3 * b)
    return out


def _walk(o, d, start, end, words, G, S, divide=_cpu_divide):
    """The kernel's march of one ray in fp32 numpy, a warp's 32 lanes as
    arrays: ``(ts row, count, t_final)``.  ``divide(x, s)`` divides by the
    Python scalar ``s`` as the device's PyTorch does."""
    h, dt, E = tmarch._kernel_lattice(SCALE, G)
    h, dt, neg_s, e_max = F32(h), F32(dt), F32(-SCALE), F32(E)
    inf = F32(np.inf)
    lanes = np.arange(32)
    o, d = [F32(v) for v in o], [F32(v) for v in d]
    start, end = F32(start), F32(end)
    words = words.astype(np.int64) & 0xFFFFFFFF

    def crossing(i, a, inv):
        plane = (np.asarray(i).astype(F32) * h).astype(F32) + neg_s
        return (plane - o[a]) * inv

    def first_crossing(a, t0):
        """[inverse, plane index, step] of the axis's first crossing after
        t0 (step 0: none)."""
        if not abs(d[a]) > F32(1e-12):
            return [None, 0, 0]
        inv = F32(1) / d[a]
        u = min(max((o[a] + t0 * d[a] - neg_s) / h, F32(-1)), F32(G + 1))
        if d[a] > 0:
            i = min(max(int(np.floor(u)) + 1, 1), G)
            while i > 1 and crossing(i - 1, a, inv) > t0:
                i -= 1
            while i < G and not crossing(i, a, inv) > t0:
                i += 1
            return [inv, i, 1]
        i = min(max(int(np.ceil(u)) - 1, 0), G - 1)
        while i < G - 1 and crossing(i + 1, a, inv) > t0:
            i += 1
        while i > 0 and not crossing(i, a, inv) > t0:
            i -= 1
        return [inv, i, -1]

    def candidates(a, ax, t1):
        inv, i0, step = ax
        i = i0 + lanes * step
        if step == 0:
            return np.full(32, inf)
        c = np.where((i >= 1) & (i < G), crossing(i, a, inv), inf)
        return np.where(c < t1, c, inf).astype(F32)

    alive = start >= 0
    t0 = start if alive else F32(0)
    t1 = max(end if alive else F32(0), t0)
    row, count, t_cap = np.zeros(S, F32), 0, None
    if t0 < t1:
        axes = [first_crossing(a, t0) for a in range(3)]
        lo = t0
        while True:
            cx, cy, cz = (candidates(a, axes[a], t1) for a in range(3))
            ss = np.searchsorted
            ranks = (lanes + ss(cy, cx, "left") + ss(cz, cx, "left"),
                     lanes + ss(cx, cy, "right") + ss(cz, cy, "left"),
                     lanes + ss(cx, cz, "right") + ss(cy, cz, "right"))
            slot = np.full(32, inf)
            for a, (c, rank) in enumerate(zip((cx, cy, cz), ranks)):
                take = (c < inf) & (rank < 32)
                slot[rank[take]] = c[take]
                axes[a][1] += int(take.sum()) * axes[a][2]
            hi = slot.copy()
            start_j = np.concatenate([[lo], hi[:-1]]).astype(F32)
            crossings = int((hi < inf).sum())
            closing = crossings < 32
            valid = lanes < crossings
            if closing and t1 < inf:
                hi[crossings], valid[crossings] = t1, True
            lo = hi[31]
            # the lanes past the exit probe nothing
            mid = np.where(valid, (start_j + hi) * F32(0.5), t0)
            code = 0
            for a in range(3):
                x = o[a] + mid * d[a]
                q = divide(x, SCALE) + F32(1)
                q = (F32(0.5) * q) * F32(G)
                q = np.minimum(np.maximum(q, F32(0)), F32(G - 1))
                cell = np.where(valid, q, 0).astype(np.int64)
                code = code | (_morton(cell) << a)
            occ = valid & (((words[code >> 5] >> (code & 31)) & 1) == 1)
            k_lo = np.ceil(divide(start_j - t0, dt))
            k_hi = np.ceil(divide(np.minimum(hi, t1) - t0, dt))
            span = np.minimum(np.maximum(k_hi - k_lo, F32(0)), e_max)
            points = np.where(occ, span, 0).astype(np.int64)
            first = count + np.cumsum(points) - points
            for j in np.flatnonzero(points):
                for e in range(points[j]):
                    if first[j] + e >= S:
                        break
                    t = t0 + F32(F32(k_lo[j] + F32(e)) * dt)
                    row[first[j] + e] = t
                    if first[j] + e == S - 1:
                        t_cap = F32(t + dt)
            count = min(count + int(points.sum()), S)
            if count == S or closing:
                break
    t_final = start if not alive else (t_cap if count == S else end)
    return row[:count], count, t_final


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, F32)).view(np.int32)


def _assert_bit_equal(got, want):
    for name in ("ts", "deltas", "counts", "t_final"):
        a = getattr(got, name).cpu().numpy()
        b = getattr(want, name).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == np.float32:
            a, b = _bits(a), _bits(b)
        bad = np.flatnonzero((a != b).reshape(a.shape[0], -1).any(axis=1))
        assert bad.size == 0, (name, bad[:8])


# (G, S, occupancy): the walk on the CPU against the plain version; the
# cap binds at S = 32 (and everywhere at occupancy 1)
WALK_CASES = [(32, 32, 1.0), (32, 256, 0.3), (32, 256, 0.02),
              (16, 512, 1.0)]


@pytest.mark.parametrize("G,S,occupancy", WALK_CASES)
def test_walk_equals_the_plain_version(G, S, occupancy):
    """The kernel's walk, with the CPU's division, gives the plain
    version's CPU result bit for bit: the merge of monotone crossings is
    the sort, ties and crossings on t0 or t1 included."""
    n = 160
    o, d, t_start, t_end, bitfield = _case(n, G + S, G, occupancy)
    want = tmarch._march_rays_intervals(o, d, t_start, t_end, bitfield,
                                        scale=SCALE, grid_size=G,
                                        sample_cap=S)
    words = bitfield.numpy()
    dt = F32(tmarch._kernel_lattice(SCALE, G)[1])
    ts = np.zeros((n, S), F32)
    deltas = np.zeros((n, S), F32)
    counts = np.zeros(n, np.int32)
    t_final = np.zeros(n, F32)
    for r in range(n):
        row, counts[r], t_final[r] = _walk(
            o[r].numpy(), d[r].numpy(), t_start[r].item(), t_end[r].item(),
            words, G, S)
        ts[r, : counts[r]] = row
        deltas[r, : counts[r]] = dt
    got = tmarch.MarchResult(*(torch.tensor(a) for a in (ts, deltas, counts,
                                                         t_final)))
    _assert_bit_equal(got, want)
    # the cases reach what they are for
    assert int(want.counts.max()) == S or occupancy < 1.0
    assert bool((want.counts > 0).any()) and bool((t_start < 0).any())


def test_merged_crossings_are_monotone():
    """The walk's premise: along one axis the fp32 crossings never fall
    (rise) as the plane index rises, for d > 0 (d < 0), so the crossings
    inside (t0, t1) are one run of plane indices."""
    rng = np.random.default_rng(7)
    for G in (32, 128):
        for _ in range(200):
            o = F32(rng.uniform(-0.6, 0.6))
            d = F32(rng.choice([-1, 1]) * 10 ** rng.uniform(-11, 0))
            c = np.array([_crossing(i, o, d, G) for i in range(1, G)])
            steps = np.diff(c) * np.sign(d)
            assert (steps >= 0).all()


def test_kernel_lattice_is_the_plain_versions():
    """The constants the kernel takes: the NGP cell's grid gives 9 lattice
    points an interval at most."""
    h, dt, e_max = tmarch._kernel_lattice(0.5, 128)
    assert (h, e_max) == (1 / 128, 9)
    assert dt == tmarch.SQRT3_MAX_SAMPLES


def _meta(n=40, G=32):
    meta = dict(device="meta")
    return dict(rays_o=torch.empty((n, 3), **meta),
                rays_d=torch.empty((n, 3), **meta),
                t_start=torch.empty((n,), **meta),
                t_end=torch.empty((n,), **meta),
                bitfield=torch.empty((G**3 // 32,), dtype=torch.int32,
                                     **meta),
                scale=SCALE, grid_size=G, sample_cap=64)


def _op(a):
    return torch.ops.taichi_nerfs_torch.ngp_march(
        a["rays_o"], a["rays_d"], a["t_start"], a["t_end"], a["bitfield"],
        a["scale"], a["grid_size"], a["sample_cap"])


@pytest.mark.parametrize("n,S,G", [(40, 64, 32), (1, 1024, 128),
                                   (0, 32, 128)])
def test_fake_gives_the_shapes(n, S, G):
    a = _meta(n, G)
    a["sample_cap"] = S
    ts, deltas, counts, t_final = _op(a)
    assert ts.shape == deltas.shape == (n, S)
    assert counts.shape == t_final.shape == (n,)
    assert ts.dtype == deltas.dtype == t_final.dtype == torch.float32
    assert counts.dtype == torch.int32 and ts.device.type == "meta"


BAD = {
    "fp64 rays": (lambda a: a.update(rays_o=a["rays_o"].double()),
                  TypeError),
    "bf16 t_start": (lambda a: a.update(t_start=a["t_start"].bfloat16()),
                     TypeError),
    "int64 bitfield": (lambda a: a.update(bitfield=a["bitfield"].long()),
                       TypeError),
    "rays (n, 2)": (lambda a: a.update(rays_d=a["rays_d"][:, :2]),
                    ValueError),
    "t_end too long": (lambda a: a.update(
        t_end=torch.empty((41,), device="meta")), ValueError),
    "strided rays": (lambda a: a.update(
        rays_o=torch.empty((3, 40), device="meta").T), ValueError),
    "strided t_end": (lambda a: a.update(
        t_end=torch.empty((40, 2), device="meta")[:, 1]), ValueError),
    "cpu bitfield": (lambda a: a.update(
        bitfield=torch.zeros((1024,), dtype=torch.int32)), ValueError),
    "bitfield too short": (lambda a: a.update(
        bitfield=a["bitfield"][:-1]), ValueError),
    "grid 100": (lambda a: a.update(grid_size=100), ValueError),
    "grid 2048": (lambda a: a.update(grid_size=2048), ValueError),
    "cap 0": (lambda a: a.update(sample_cap=0), ValueError),
    "scale 0": (lambda a: a.update(scale=0.0), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_argument_checks_raise(case):
    change, err = BAD[case]
    a = _meta()
    change(a)
    with pytest.raises(err):
        _op(a)


def test_operator_hands_the_kernel_its_arguments():
    """What the operator passes to the C entry, recorded on CPU tensors by
    the ``launch`` the implementation is given, the outputs allocated by
    the fake version: the device, the nine pointers in the entry's order,
    N, G, S, E, then scale, h and dt; with no rays, nothing is
    launched."""
    o, d, t_start, t_end, bitfield = _case(50, 3, 32, 0.3)
    seen = []

    def launch(device, *args):
        seen.append((device, args))

    def run(n):
        args = (o[:n], d[:n], t_start[:n], t_end[:n], bitfield, SCALE, 32,
                48)
        out = tmarch._march_fake(*args)
        tmarch._march_op(launch, out, *args)
        return out

    out = run(50)
    ((device, args),) = seen
    assert device == o.device
    assert args[:9] == tuple(t.data_ptr() for t in (o, d, t_start, t_end,
                                                    bitfield, *out))
    # E: a cell of 1/32 holds up to 32 steps of sqrt(3)/1024 on a diagonal
    assert args[9:] == (50, 32, 48, 33, SCALE, 1 / 32,
                        tmarch.SQRT3_MAX_SAMPLES)
    run(0)
    assert len(seen) == 1


def test_cpu_rays_take_the_plain_version():
    """Off the card ``march_rays`` returns the plain version's result on
    the interval path, and no ``ngp_march`` launch is counted."""
    o, d, t_start, t_end, bitfield = _case(64, 4, 32, 0.3)
    kw = dict(scale=SCALE, grid_size=32, sample_cap=64)
    before = LAUNCHES["ngp_march"]
    got = tmarch.march_rays(o, d, t_start, t_end, bitfield, cascades=1,
                            exp_step_factor=0.0, **kw)
    want = tmarch._march_rays_intervals(o, d, t_start, t_end, bitfield, **kw)
    _assert_bit_equal(got, want)
    assert LAUNCHES["ngp_march"] == before


def test_no_kernel_off_the_card():
    """Rays on a device that is neither the CPU nor CUDA raise on the
    interval path: there is no fallback."""
    a = _meta()
    with pytest.raises(ValueError, match="no ngp-march kernel"):
        tmarch.march_rays(a["rays_o"], a["rays_d"], a["t_start"],
                          a["t_end"], a["bitfield"], cascades=1,
                          scale=SCALE, exp_step_factor=0.0, grid_size=32,
                          sample_cap=64)


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the ngp-march kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


def _on(case, device):
    return [t.to(device) for t in case]


@pytest.mark.cuda
@pytest.mark.parametrize("occupancy", [0.02, 0.3, 1.0])
@pytest.mark.parametrize("G", [32, 128])
@pytest.mark.parametrize("S", [32, 256, 1024])
@pytest.mark.parametrize("n", [1, 33, 8192])
def test_kernel_is_bit_equal_to_the_plain_version(cuda_device, n, S, G,
                                                  occupancy):
    o, d, t_start, t_end, bitfield = _on(_case(n, n + S + G, G, occupancy),
                                         cuda_device)
    kw = dict(scale=SCALE, grid_size=G, sample_cap=S)
    before = LAUNCHES["ngp_march"]
    got = tmarch.march_rays(o, d, t_start, t_end, bitfield, cascades=1,
                            exp_step_factor=0.0, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["ngp_march"] == before + 1
    want = tmarch._march_rays_intervals(o, d, t_start, t_end, bitfield, **kw)
    _assert_bit_equal(got, want)
    if n > 1 and occupancy == 1.0 and S == 32:
        assert int(want.counts.max()) == S  # the cap binds


@pytest.mark.cuda
def test_no_rays_no_launch(cuda_device):
    o, d, t_start, t_end, bitfield = _on(_case(8, 1, 32, 0.3), cuda_device)
    before = dict(LAUNCHES)
    out = tmarch.march_rays(o[:0], d[:0], t_start[:0], t_end[:0], bitfield,
                            cascades=1, scale=SCALE, exp_step_factor=0.0,
                            grid_size=32, sample_cap=64)
    assert out.ts.shape == (0, 64) and out.counts.shape == (0,)
    assert dict(LAUNCHES) == before


@pytest.mark.cuda
def test_one_launch_a_training_step(cuda_device):
    """An NGP training step marches once through the kernel; the test
    renderer (the lattice marcher's windows) and a pyramid step never
    launch it."""
    from taichi_nerfs_torch.config import config_for_scene
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.models import pyramid as tpyr
    from taichi_nerfs_torch.ops.rays import get_rays
    from taichi_nerfs_torch.render.renderer import render_image
    from taichi_nerfs_torch.train.loop import Trainer
    from taichi_nerfs_torch.train.swr_step import SwrTrainConfig, SwrTrainer

    ds = SyntheticSphereDataset(n_images=2, img_wh=(64, 64),
                                variant="checker", device=cuda_device)
    cfg = config_for_scene(0.5)
    trainer = Trainer(cfg, ds.as_batch(cuda_device), ds.K, ds.img_wh,
                      device=cuda_device)
    for _ in range(3):
        before = LAUNCHES["ngp_march"]
        trainer.run_step()
        assert LAUNCHES["ngp_march"] == before + 1
    rays_o, rays_d = get_rays(
        torch.as_tensor(ds.directions, device=cuda_device),
        torch.as_tensor(ds.poses[0], device=cuda_device))
    before = LAUNCHES["ngp_march"]
    render_image(trainer.state.params, cfg, trainer.state.occupancy.bitfield,
                 rays_o, rays_d)
    sphere = SyntheticSphereDataset("synthetic://sphere?views=2&res=64",
                                    split="train", device="cpu")
    swr = SwrTrainer(
        tpyr.PyramidConfig(resolutions=(16, 32), features=8, deferred=True),
        SwrTrainConfig(crop=64, n_chunks=4, resample_kind="cubic"),
        sphere.rays, sphere.poses, sphere.K, sphere.img_wh,
        device=cuda_device)
    swr.run_step()
    torch.cuda.synchronize()
    assert LAUNCHES["ngp_march"] == before
