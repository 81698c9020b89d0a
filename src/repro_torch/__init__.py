"""PyTorch + CUDA port of the streaming/serverless characterization stack.

Module paths mirror ``repro`` (the JAX package) so each counterpart is easy
to find; this package imports nothing of ``jax`` or ``repro``, and the
top level loads ``torch`` only when called, so the stdlib-only simlint
(``python -m repro_torch.analysis``) runs without it.
Entry points take an explicit ``device`` (default ``"cuda"``) and raise when
the card is missing; they never fall back to the CPU on their own.
"""

from __future__ import annotations

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device`` for ``device``; raises if a CUDA device is asked for
    and no card is present (no silent CPU fallback)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev
