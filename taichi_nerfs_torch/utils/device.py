"""The device an entry point runs on: the card unless the caller asks for
the CPU.  A missing card is an error, never a quiet CPU run."""

from __future__ import annotations

import torch


def resolve_device(device, how_to_ask_for_cpu: str) -> torch.device:
    """``device`` (``None`` means ``"cuda"``) as a ``torch.device``.

    Raises ``RuntimeError`` when it names CUDA and no CUDA device is
    available; the message says how to ask for the CPU
    (``how_to_ask_for_cpu``, e.g. ``"--device cpu"``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device (torch.cuda.is_available() is false); pass "
            f"{how_to_ask_for_cpu} to run on the CPU"
        )
    return dev


def require_fp32_matmul() -> None:
    """Raise if TF32 matmuls are on: the renderer and the trainers need
    full-fp32 matmuls (PyTorch's default)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on; the renderer "
            "needs full-fp32 matmuls"
        )


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
