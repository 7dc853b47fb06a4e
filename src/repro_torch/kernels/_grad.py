"""The kernels have no backward yet: a wrapper refuses, on CUDA tensors, a
call whose output autograd would need to differentiate."""

from __future__ import annotations

import torch

__all__ = ["refuse_grad"]


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad.

    The kernels write their outputs through ctypes, so autograd would see
    outputs with no ``grad_fn``: gradients would stop here without a word.
    The plain version (CPU tensors) stays differentiable."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward yet, and an input requires grad; "
            "call it under torch.no_grad() or detach the inputs")
