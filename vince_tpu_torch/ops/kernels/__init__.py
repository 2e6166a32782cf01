"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

A wrapper runs its kernel on a CUDA tensor and its plain version on a CPU
tensor. ``plain_versions()`` selects the plain versions on the GPU too, for a
check that compares a whole step against them; nothing selects them silently.
"""

import contextlib
import functools

import torch

_FORCE_PLAIN = False
H100_SMS = 132  # the schedules' SM count where no card is asked (the CPU tests)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of the CUDA device that a kernel launches on."""
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


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
