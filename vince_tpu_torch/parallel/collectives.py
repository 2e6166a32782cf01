"""Collectives of the train step over a mesh axis (counterpart of
``vince_tpu/parallel/collectives.py``), on ``torch.distributed``.

Each function takes the process group of one axis (``Mesh.data_group`` or
``Mesh.queue_group``), or None for an axis of one member, where it is the
local computation and calls no collective.

- The key batch's global gather (MoCo's ``concat_all_gather``) and shuffled
  BN, MoCo's control of BatchNorm leakage: the key images are permuted across
  the data axis before the key forward and put back after it, so that no
  rank's BN statistics are those of its own query batch. ``gather`` mode
  gathers the global batch on every rank and keeps a slice of its
  permutation; ``a2a`` mode runs a block-balanced permutation as local
  permutation → balanced ``all_to_all`` → local permutation, 1/d of the
  gather's traffic.
- The differentiable ``psum`` and ``all_gather`` of the step's loss and of
  sync-BN, as ``torch.autograd.Function``s whose backwards are JAX's
  transposes under ``check_vma=False``: the psum of the cotangent, and the
  psum of the full cotangent sliced to the rank's rows (``gloo`` has no
  reduce-scatter, so none is used). ``pmax`` has no gradient: JAX detaches
  its operands first.
"""

from typing import Tuple

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


# torch 2.13 renamed all_gather_into_tensor
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """[b, ...] on each member → [n·b, ...], in the group's rank order."""
    x = x.contiguous()
    out = torch.empty((group_size(group) * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather_single(out, x, group=group)
    return out


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        start = group_rank(ctx.group) * ctx.rows
        return _all_reduce(grad, ctx.group)[start:start + ctx.rows], None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's members, differentiable."""
    return x if group is None else _PSum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the group's members (flax's ``pmean``), differentiable."""
    return x if group is None else psum(x, group) / group_size(group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group's members, detached."""
    return x.detach() if group is None else _all_reduce(x, group, dist.ReduceOp.MAX)


def gather_global_batch(x_local: torch.Tensor, group) -> torch.Tensor:
    """[b, ...] per rank → [n·b, ...] on every rank, differentiable."""
    return x_local if group is None else _AllGather.apply(x_local, group)


def make_shuffle_perm(generator: torch.Generator, global_batch: int) -> torch.Tensor:
    """A permutation of the global batch, the same on every rank: the
    generator is seeded alike everywhere."""
    return torch.randperm(global_batch, generator=generator, device=generator.device)


def _gathered(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _gather(x, group)


def cross_device_shuffle(x_local: torch.Tensor, perm: torch.Tensor, group) -> torch.Tensor:
    """Rank d ends up with rows ``perm[d·b:(d+1)·b]`` of the global batch
    (with one member: the rows in the permutation's order)."""
    b = x_local.shape[0]
    start = group_rank(group) * b
    return _gathered(x_local, group)[perm][start:start + b]


def cross_device_unshuffle(y_local: torch.Tensor, perm: torch.Tensor, group) -> torch.Tensor:
    """The inverse of ``cross_device_shuffle``, as the *global* batch in its
    original order (the step needs every key for the loss and the queue)."""
    return _gathered(y_local, group)[torch.argsort(perm)]


def balanced_perm(sigma: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """JAX's composite of the two stages: on destination i, received row m
    (before ``tau``) came from source j = m // c, slot r = m % c of its
    chunk, i.e. global row j·b + sigma[j, i·c + r]."""
    d, b = sigma.shape
    c = b // d
    i = torch.arange(d, device=sigma.device)[:, None]
    j, r = tau // c, tau % c
    return (j * b + sigma[j, i * c + r]).reshape(d * b)


def make_balanced_shuffle_perm(generator: torch.Generator, global_batch: int,
                               num_devices: int
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A block-balanced global permutation that an ``all_to_all`` runs: every
    destination receives exactly b/d rows from every source.

    Returns ``(perm, sigma, tau)``: ``perm`` [B] the composite (rank i's
    shuffled rows are ``x_global[perm][i·b:(i+1)·b]``; ``cross_device_unshuffle``
    takes it unchanged), ``sigma`` [d, b] the source-side local permutations
    (rows ordered by destination chunk) and ``tau`` [d, b] the
    destination-side ones. Needs ``b % d == 0``.

    With one data index the all-to-all moves nothing and every permutation is
    balanced: sigma is the plain shuffle's draw (``make_shuffle_perm``) and tau
    the identity, so that both modes shuffle alike there.
    """
    if global_batch % num_devices:
        raise ValueError(f"global batch {global_batch} not divisible by {num_devices}")
    b = global_batch // num_devices
    if b % num_devices:
        raise ValueError(f"balanced a2a shuffle needs per-device batch {b} divisible by "
                         f"device count {num_devices}")
    dev = generator.device
    if num_devices == 1:
        sigma = make_shuffle_perm(generator, b)[None]
        tau = torch.arange(b, device=dev)[None]
    else:
        draws = torch.stack([torch.randperm(b, generator=generator, device=dev)
                             for _ in range(2 * num_devices)])
        sigma, tau = draws[:num_devices], draws[num_devices:]
    return balanced_perm(sigma, tau), sigma, tau


def cross_device_shuffle_a2a(x_local: torch.Tensor, sigma: torch.Tensor, tau: torch.Tensor,
                             group) -> torch.Tensor:
    """The balanced permutation of ``make_balanced_shuffle_perm`` by one
    ``all_to_all``: equal to ``cross_device_shuffle`` with its composite."""
    d = group_rank(group)
    received = x_local[sigma[d]]
    if group is not None:
        sent, received = received.contiguous(), torch.empty_like(received)
        dist.all_to_all_single(received, sent, group=group)
    return received[tau[d]]


def flat_all_reduce_(tensors, group, divisor: int = 1) -> None:
    """Sum ``tensors`` over the group in one collective on one flat buffer
    (all of one dtype), then divide by ``divisor``; in place. Nothing for a
    group of None or no tensors."""
    tensors = list(tensors)
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if divisor != 1:
        flat.div_(divisor)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
