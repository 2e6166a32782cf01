"""Operations and bytes of the pretraining step and of its kernels, and the
peaks of the card they are held against.

The model's operations count every convolution and linear layer of the
encoder and its projection (two operations a multiply-add; the
configuration's counter, ``flops/<name>.py``, counts them for its backbone)
and InfoNCE's products: a step is the key forward, the query forward and the query
backward at twice the forward; nothing recomputed and no moment dot of the
folded BatchNorm counts. The kernels' operations and bytes are those of one
call at its shapes, each input byte read once and each output byte written
once (the arithmetic of ``chip_smoke.py``'s kernel checks).

Peaks of one NVIDIA H100 SXM, dense, from NVIDIA's data sheet, at the full
power limit of 700 W.
"""

from typing import List, Tuple

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def _counter(config: dict):
    """The configuration's counter of operations, ``flops/<flops>.py``."""
    from vince_bench import harness

    return harness.find("flops", config["flops"])


def bn_train_bytes(n: int, h: int, w: int, c: int, stats_fused: bool = False) -> int:
    """A train-mode BatchNorm over bf16 activations [n, h, w, c]: its
    statistics' read of the input (none where the producing kernel's
    epilogue makes them) and the normalisation's read and write."""
    act = 2 * n * h * w * c
    return (0 if stats_fused else act) + 2 * act


def infonce_flops(batch: int, queue: int, embed: int, self_batch: bool) -> int:
    """q·[keys; queue]ᵀ forward and its gradient in q (the keys and the
    queue take none); the self-batch term's q·qᵀ and its gradient in both
    operands."""
    flops = 4 * batch * (batch + queue) * embed
    return flops + (6 * batch * batch * embed if self_batch else 0)


def step_flops(config: dict) -> int:
    """Model operations of one training step of a configuration file."""
    b = config["batch_size"]
    return (4 * b * _counter(config).encoder_flops(config["backbone"], config["input_width"],
                                                   config["vince_embedding_size"])
            + infonce_flops(b, config["vince_queue_size"], config["vince_embedding_size"],
                            config.get("self_batch_comparison", False)))


def bound_s(bytes_moved: float, ops: float, peak_ops: float) -> float:
    """The least time of a call: the larger of its bytes at the memory's rate
    and its operations at the peak of their type."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / peak_ops)


def k1_bound_s(b: int, k: int, d: int) -> float:
    """K1 (queue_logsumexp), float32: per row of q [b, d] the max and the sum
    of exp(q·queueᵀ/τ) over the queue [k, d], and their weighted queue sum."""
    return bound_s(4 * (b * d + k * d + 2 * b + b * d), 4 * b * k * d + b * k, F32_FLOPS)


def k2_bound_s(m: int, c: int, f: int) -> float:
    """K2 (affine_relu_dot_moments), bf16: x̂ = relu(y·a + b) of y [m, c],
    x̂@W [c, f], Σx̂ and the upper triangle of x̂ᵀx̂."""
    return bound_s(2 * m * c + 8 * c + 2 * c * f + 2 * m * f + 4 * c + 4 * c * c,
                   2 * m * c * f + m * c * (c + 1), BF16_FLOPS)


def k2_sites(config: dict) -> List[Tuple[int, int, int]]:
    """(M, C, F) of each K2 site of one forward at the configuration's batch
    and size: its counter's ``k2_sites``, none where it has none."""
    sites = getattr(_counter(config), "k2_sites", None)
    return sites(config["backbone"], config["batch_size"], config["input_width"]) if sites else []


def mfu_pct(flops: float, seconds: float) -> float:
    return 100.0 * flops / seconds / BF16_FLOPS
