"""Explicit device handling.

Every device-side object of the port takes a ``torch.device``; nothing
picks one by probing.  Asking for CUDA without a usable card is an
error, never a silent CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``"cuda"``/``"cpu"`` (or a ``torch.device``) -> a usable device."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass --device cpu to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_precision(precision: str, device: torch.device) -> str:
    """``auto`` -> exact on the CPU (f64 parity mode), fast on CUDA.

    Mirrors the JAX CLI's rule (exact on CPU, fast on accelerators).
    Both modes run on either device; ``--precision exact`` on CUDA runs
    the exact-mode kernel."""
    if precision != "auto":
        return precision
    return "exact" if device.type == "cpu" else "fast"
