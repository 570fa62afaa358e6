"""Instant-NGP on the paper's hash grid: what the hash cell drives of the
program (``train/loop.py:Trainer.run_step``, the step of ``python -m
taichi_nerfs_torch.train --encoder_type hash``), the inputs it gives it
and the comparison with the plain reference
(``benchmark/reference/ngp_hash.py``).

The session is ``systems/ngp.py``'s: the same scene, settle, snapshot,
checked steps, replayed draws, comparison and profiled counts.  Four names
it reads from its module are this family's instead: the weights
(:func:`make_params`: the hash table as the leaf ``grid.table``), the
program's leaves (:func:`leaves`), the reference (``NGPHashReference``) and
the counts (``counts/ngp_hash.py``), so that the profiled steps' least
encoder time, the context key ``ngp_encode_bound_ms`` that
``metrics/ngp_encode_roofline.train.py`` reads, is the hash grid's.
``benchmark/tests/test_ngp_hash_counts.py`` fails if a function of the
brick's session reads one of these names without being rebound here.
"""

from __future__ import annotations

import types
from typing import Dict

import numpy as np
import torch

from benchmark.counts import ngp_hash as counts
from benchmark.reference.ngp import HashGeometry
from benchmark.reference.ngp_hash import NGPHashReference
from benchmark.systems import ngp
from benchmark.systems.ngp import program_config  # noqa: F401

TABLE = "hash_table"  # the program's key of the table


def make_params(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights from ``seed``, as named leaves on ``device``: the hash
    table U[0, 1), the MLPs Xavier-uniform (stored (in, out)), each leaf
    one call of a generator on the device."""
    model = config["model"]
    geo = HashGeometry.of(model["grid"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {"grid.table": torch.rand((geo.F, geo.start[-1] + geo.size[-1]),
                                    generator=gen, device=device)}
    for name, dims in zip(("xyz_mlp", "rgb_mlp"), counts.mlp_dims(model)):
        for i, (fi, fo) in enumerate(dims):
            u = torch.rand((fi, fo), generator=gen, device=device)
            out[f"{name}.w{i}"] = (2.0 * u - 1.0) * float(
                np.sqrt(6.0 / (fi + fo)))
    return out


def leaves(tree) -> Dict[str, torch.Tensor]:
    """The program's params (or a moment) as named leaves: its table as
    ``grid.table``, its MLP groups as ``systems/ngp.py`` names them."""
    return {"grid.table": tree[TABLE],
            **ngp.leaves({k: v for k, v in tree.items() if k != TABLE})}


def _rebound(fn, **names):
    """``fn``, a function of ``systems/ngp.py``, reading ``names`` as this
    family's where it reads its module's."""
    return types.FunctionType(fn.__code__, {**fn.__globals__, **names},
                              fn.__name__, fn.__defaults__, fn.__closure__)


_OURS = dict(make_params=make_params, leaves=leaves,
             NGPReference=NGPHashReference, counts=counts)


class TrainSession(ngp.TrainSession):
    """``Trainer`` at ``config_for_scene(0.5, pos_encoder_type="hash")``
    (the configuration's keys) on the lego views, its weights and generator
    seed the benchmark's."""

    __init__ = _rebound(ngp.TrainSession.__init__, **_OURS)
    _checked_steps = _rebound(ngp.TrainSession._checked_steps, **_OURS)
    reference = _rebound(ngp.TrainSession.reference, **_OURS)
    profiled = _rebound(ngp.TrainSession.profiled, **_OURS)
