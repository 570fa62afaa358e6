"""The hash grid's counts (``counts/ngp_hash.py``) at a tiny case, its
weights against the program's parameters, and its session's rebinding of
the brick session's functions (``systems/ngp_hash.py``)."""

from __future__ import annotations

import dis
import math
import types

import torch

from benchmark.counts import ngp_hash as counts
from benchmark.counts.flops import mlp_macs
from benchmark.reference.ngp import PRIMES, HashGeometry
from benchmark.systems import ngp, ngp_hash
from benchmark.systems.ngp_hash import make_params

GRID = {"levels": 4, "feature_per_level": 2, "log2_T": 9, "base_res": 4,
        "max_res": 32}
MODEL = {"grid": GRID, "xyz_net_depth": 1, "xyz_net_width": 8,
         "xyz_net_out_dim": 4, "rgb_net_depth": 2, "rgb_net_width": 8,
         "sh_degree": 4, "grid_size": 8}


def _brute_entries(x01, geo):
    """Per level, the set of entries the positions read, one position and
    corner at a time in Python."""
    out = []
    for lv, r in enumerate(geo.res):
        seen = set()
        for x in x01.tolist():
            cell = [math.floor(v * geo.scale[lv] + 0.5) for v in x]
            for c in range(8):
                k = [cell[d] + ((c >> d) & 1) for d in range(3)]
                if geo.hashed[lv]:
                    i = 0
                    for d in range(3):
                        i ^= (k[d] * PRIMES[d]) & 0xFFFFFFFF
                else:
                    i = k[0] + k[1] * r + k[2] * r * r
                seen.add(i % geo.size[lv])
        out.append(len(seen))
    return out


def test_distinct_entries_and_bytes_by_brute_force():
    geo = HashGeometry.of(GRID)
    x = torch.rand((400, 3), generator=torch.Generator().manual_seed(1))
    x[:50] = x[50:100]  # repeated positions read their entries once
    want = _brute_entries(x, geo)
    assert counts.distinct_entries(x, geo) == want
    assert not geo.hashed[0] and geo.hashed[-1]
    table = 4 * 2 * sum(want)
    _, _, fwd, _ = counts.encode_bound(x, geo, backward=False)
    _, _, both, flops = counts.encode_bound(x, geo, backward=True)
    assert fwd == 12 * 400 + table and both == 12 * 400 + 2 * table
    assert flops == 2 * 2 * 8 * 2 * 4 * 400


def test_step_terms_and_weights_by_hand():
    """The MLPs take the grid's L F wide encoding; the parameters Adam
    counts are the weights' leaves, the table ``(F, entries)``; the program
    makes a table of the same shape."""
    from taichi_nerfs_torch.config import HashGridConfig
    from taichi_nerfs_torch.ops.hash_encoder import build_layout

    xyz, rgb = counts.mlp_dims(MODEL)
    assert xyz == [(8, 8), (8, 4)] and rgb == [(20, 8), (8, 8), (8, 3)]
    params = make_params({"model": MODEL}, 1, "cpu")
    layout = build_layout(HashGridConfig(**GRID))
    assert params["grid.table"].shape == (2, layout.n_entries)
    assert counts.param_count(MODEL) == sum(v.numel() for v in
                                            params.values())
    terms = {n: (f, p) for n, f, p in counts.step_terms(MODEL, 10, 2, 30)}
    macs = mlp_macs(xyz) + mlp_macs(rgb)
    assert terms["mlp"] == (3 * 2 * macs * 10, "bf16")
    assert terms["encode"] == (2 * 2 * 8 * 2 * 4 * 10, "fp32")
    assert terms["adam"] == (12 * counts.param_count(MODEL), "fp32")
    ref = {n: (f, p) for n, f, p in counts.refresh_terms(MODEL, 7)}
    assert ref["refresh_encode"] == (2 * 8 * 2 * 4 * 7, "fp32")
    assert ref["refresh_mlp"] == (2 * mlp_macs(xyz) * 7, "bf16")


def _loads(fn):
    """The global names ``fn`` and the code nested in it load."""
    out, codes = set(), [fn.__code__]
    while codes:
        code = codes.pop()
        codes += [c for c in code.co_consts if isinstance(c, types.CodeType)]
        out |= {i.argval for i in dis.get_instructions(code)
                if i.opname in ("LOAD_GLOBAL", "LOAD_NAME")}
    return out


def _helpers(fn, module, skip, seen):
    """The functions of ``module`` that ``fn`` calls, and theirs, those
    named in ``skip`` left out."""
    for name in _loads(fn) - set(skip):
        g = fn.__globals__.get(name)
        if (isinstance(g, types.FunctionType)
                and g.__module__ == module.__name__ and g not in seen):
            seen.add(g)
            _helpers(g, module, skip, seen)
    return seen


def test_every_reader_of_a_family_name_is_rebound():
    """``systems/ngp_hash.py`` rebinds the brick session's functions that
    read its module's weights, leaves, reference or counts; one that reads
    them and is not rebound would run the brick's in the hash cell, and a
    function of the module that reads them cannot be rebound at all."""
    ours = ngp_hash._OURS
    readers = []
    for attr, member in vars(ngp.TrainSession).items():
        fn = getattr(member, "__func__", member)
        if not isinstance(fn, types.FunctionType):
            continue
        for helper in _helpers(fn, ngp, ours, set()):
            assert not set(ours) & _loads(helper), (attr, helper.__name__)
        read = set(ours) & _loads(fn)
        if not read:
            continue
        readers.append(attr)
        mine = vars(ngp_hash.TrainSession).get(attr)
        assert isinstance(mine, types.FunctionType), attr
        assert mine.__code__ is fn.__code__, attr
        assert all(mine.__globals__[n] is ours[n] for n in read), attr
    assert {"__init__", "reference", "profiled"} <= set(readers)
