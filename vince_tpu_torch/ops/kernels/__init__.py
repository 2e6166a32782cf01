"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

A wrapper runs its kernel on a CUDA tensor and its plain version on a CPU
tensor. ``plain_versions()`` selects the plain versions on the GPU too, for a
check that compares a whole step against them; nothing selects them silently.
"""

import contextlib

import torch

_FORCE_PLAIN = False


@contextlib.contextmanager
def plain_versions():
    """Run the plain PyTorch versions instead of the kernels, on any device."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


def use_kernel(t: torch.Tensor) -> bool:
    return t.is_cuda and not _FORCE_PLAIN


def check_tensor(t: torch.Tensor, name: str, dtype, ndim: int, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
