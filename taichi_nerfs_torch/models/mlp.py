"""Functional skip-connection MLP on a plain dict of weights.

Port of the JAX package's ``models/mlp.py``.  Weights keep the JAX layout:
``w{i}`` stored ``(in, out)`` so a layer is ``x @ w``, and ``b{i}`` when
biases are enabled.

Compute dtype: the JAX version rounds each layer's operands to the compute
dtype (bf16 by default), multiplies with fp32 accumulation and keeps the
fp32 result until the next layer's cast.  A plain bf16 ``torch.matmul``
would also round the *output* to bf16, so the port rounds the operands and
multiplies in fp32 instead: ``a.bfloat16().float() @ w.bfloat16().float()``.
The product of two bf16 values is exact in fp32, so only the summation
order differs from the JAX result.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    input_dim: int
    output_dim: Optional[int] = None
    net_depth: int = 8
    net_width: int = 256
    skip_layer: Optional[int] = 4
    output_enabled: bool = True
    bias_enabled: bool = True
    hidden_activation: str = "relu"
    output_activation: str = "none"  # {"none", "sigmoid"}

    def layer_dims(self):
        """(in, out) per layer."""
        dims = []
        in_features = self.input_dim
        for i in range(self.net_depth):
            dims.append((in_features, self.net_width))
            if (
                self.skip_layer is not None
                and i % self.skip_layer == 0
                and i > 0
            ):
                in_features = self.net_width + self.input_dim
            else:
                in_features = self.net_width
        if self.output_enabled:
            dims.append((in_features, self.output_dim))
        return dims


def init_mlp(
    spec: MLPSpec,
    generator: torch.Generator | None = None,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Xavier-uniform weights stored (in, out); zero biases."""
    params: Dict[str, torch.Tensor] = {}
    for i, (fi, fo) in enumerate(spec.layer_dims()):
        a = math.sqrt(6.0 / (fi + fo))
        u = torch.rand((fi, fo), generator=generator, dtype=torch.float32)
        params[f"w{i}"] = ((2.0 * u - 1.0) * a).to(device)
        if spec.bias_enabled:
            params[f"b{i}"] = torch.zeros(
                (fo,), dtype=torch.float32, device=device
            )
    return params


def _act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "relu":
        return torch.relu
    if name == "sigmoid":
        return torch.sigmoid
    if name == "none":
        return lambda x: x
    raise ValueError(name)


def apply_mlp(
    params: Dict[str, torch.Tensor],
    spec: MLPSpec,
    x: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Forward pass; fp32 result.

    ``compute_dtype`` is the operand rounding (bf16 by default, as in the
    JAX version); the products accumulate in fp32 either way.
    """
    hidden = _act(spec.hidden_activation)

    def linear(i: int, h: torch.Tensor) -> torch.Tensor:
        w = params[f"w{i}"].to(compute_dtype).float()
        y = torch.matmul(h.to(compute_dtype).float(), w)
        if spec.bias_enabled:
            y = y + params[f"b{i}"]
        return y

    inputs = x
    h = x
    for i in range(spec.net_depth):
        h = hidden(linear(i, h))
        if (
            spec.skip_layer is not None
            and i % spec.skip_layer == 0
            and i > 0
        ):
            h = torch.cat([h, inputs], dim=-1)
    if spec.output_enabled:
        h = _act(spec.output_activation)(linear(spec.net_depth, h))
    return h
