"""Streamed queue log-sum-exp for InfoNCE (counterpart of
``vince_tpu/ops/pallas/infonce_kernel.py``).

For queries q [B, D] and the negative queue [K, D] it returns, per row, the
max m of q·queueᵀ/τ, the sum S = Σ exp(q·queueᵀ/τ − m) and, kept for the
backward, the exp-weighted key sum W = Σ exp(…)·queue, without the [B, K]
logits ever reaching device memory (``csrc/queue_logsumexp.cu``). The queue is
a buffer and gets no gradient; m is returned detached, so the only cotangent is
∂S/∂q = W/τ.
"""

import ctypes
import functools
import math

import torch

from vince_tpu_torch.ops.kernels import H100_SMS, build, check_tensor, sm_count, use_kernel

_BLOCK_KEYS = 64  # keys per tile of the queue
_MAX_D = 256


def _reference_queue_logsumexp(q, queue, temperature):
    """The plain PyTorch version: (m, S, W) from the materialised logits."""
    logits = (q.float() @ queue.float().T) / temperature
    m = logits.max(dim=-1).values
    p = torch.exp(logits - m[:, None])
    return m, p.sum(dim=-1), p @ queue.float()


def _block_rows(d: int) -> int:
    """Rows of q a CTA holds: 16 row groups of 8 rows, of 4 above 128 features."""
    return 128 if d <= 128 else 64


def _smem_bytes(d: int) -> int:
    """Shared memory of the partial kernel (the source's count): q [rows][DP+4],
    two key tiles [64][DP+4] and p [64][rows+4] in f32, DP = D padded to 64,
    128 or 256."""
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    rows = _block_rows(d)
    return 4 * (rows * (dp + 4) + 2 * _BLOCK_KEYS * (dp + 4) + _BLOCK_KEYS * (rows + 4))


def _chunking(b: int, k: int, d: int, sms: int = H100_SMS):
    """(row blocks, chunks, tiles a chunk): the queue's 64-key tiles split into
    chunks so that the CTAs, one per (row block, chunk), come to about one per
    SM; every chunk holds at least one tile, and every tile a valid key."""
    tiles = math.ceil(k / _BLOCK_KEYS)
    row_blocks = math.ceil(b / _block_rows(d))
    nchunks = max(1, min(tiles, sms // row_blocks))
    tiles_per_chunk = math.ceil(tiles / nchunks)
    return row_blocks, math.ceil(tiles / tiles_per_chunk), tiles_per_chunk


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("queue_logsumexp").vince_queue_logsumexp_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, queue, temperature):
    check_tensor(q, "q", torch.float32, 2, q.device)
    check_tensor(queue, "queue", torch.float32, 2, q.device)
    b, d = q.shape
    k = queue.shape[0]
    if queue.shape[1] != d or d > _MAX_D or b == 0 or k == 0:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, queue {tuple(queue.shape)}")
    _, nchunks, tiles_per_chunk = _chunking(b, k, d, sm_count(q.device))
    m = torch.empty(b, device=q.device, dtype=torch.float32)
    s = torch.empty_like(m)
    w = torch.empty_like(q)
    m_part = torch.empty(b, nchunks, device=q.device, dtype=torch.float32)
    s_part = torch.empty_like(m_part)
    w_part = torch.empty(nchunks, b, d, device=q.device, dtype=torch.float32)
    status = _entry()(q.data_ptr(), queue.data_ptr(), m.data_ptr(), s.data_ptr(), w.data_ptr(),
                      m_part.data_ptr(), s_part.data_ptr(), w_part.data_ptr(), b, k, d,
                      1.0 / temperature, nchunks, tiles_per_chunk,
                      torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "queue_logsumexp")
    queue_logsumexp.launches += 1
    return m, s, w


def queue_logsumexp_forward(q, queue, temperature):
    """(m, S, W): the kernel on a CUDA tensor, the plain version on the CPU."""
    if use_kernel(q):
        return _launch(q, queue, temperature)
    queue_logsumexp.plain_calls += 1
    return _reference_queue_logsumexp(q, queue, temperature)


class _QueueLogsumexp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, queue, temperature):
        m, s, w = queue_logsumexp_forward(q, queue, temperature)
        ctx.save_for_backward(w)
        ctx.temperature = temperature
        ctx.mark_non_differentiable(m)
        return m, s

    @staticmethod
    def backward(ctx, dm, ds):
        (w,) = ctx.saved_tensors
        return ds[:, None] * w * (1.0 / ctx.temperature), None, None


def queue_logsumexp(q: torch.Tensor, queue: torch.Tensor, temperature: float = 0.07):
    """(m, S): per-row max and exp-sum of q·queueᵀ/τ; m is detached and the
    queue receives no gradient."""
    return _QueueLogsumexp.apply(q, queue, temperature)


queue_logsumexp.launches = 0
queue_logsumexp.plain_calls = 0
