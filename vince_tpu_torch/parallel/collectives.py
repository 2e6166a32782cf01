"""Shuffled-BN permutation for one device (counterpart of
``vince_tpu/parallel/collectives.py``): with one device the cross-device
gather and slice reduce to a local permutation of the key batch."""

import torch


def make_shuffle_perm(generator: torch.Generator, global_batch: int) -> torch.Tensor:
    return torch.randperm(global_batch, generator=generator, device=generator.device)


def shuffle(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return x[perm]


def unshuffle(y: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return y[torch.argsort(perm)]
