"""Pieces every reference encoder shares, in plain float32 PyTorch: weights
from a list of specs in one draw, train-mode BatchNorm on the batch's
statistics, and the fp8 rounding that the comparison's control applies to
the operands of every convolution and linear layer.

BatchNorm takes flax's definition, as the port states it: the uncentered
variance max(E[x²] − E[x]², 0) and ε = 1e-5. No running averages: a
train-mode forward does not read them.
"""

import math
from typing import Dict, List, Tuple

import torch

BN_EPS = 1e-5
FP8_MAX = 448.0  # the largest finite float8_e4m3fn

# (name, shape, init, fan_in); init is "lecun" (a normal truncated at ±2σ,
# variance 1/fan_in), "one" or "zero"
Spec = Tuple[str, Tuple[int, ...], str, int]


def make_params(specs: List[Spec], gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Weights from ``gen`` on its device in one draw: a truncated normal
    for all the weights together, scaled per leaf."""
    dev = gen.device
    sizes = [math.prod(shape) for _, shape, init, _ in specs if init == "lecun"]
    flat = torch.empty(sum(sizes), device=dev)
    torch.nn.init.trunc_normal_(flat, std=1.0, a=-2.0, b=2.0, generator=gen)
    # lecun_normal: the truncated normal's std is 0.8796 of its parameter
    std = torch.tensor([math.sqrt(1.0 / fan) / 0.87962566103423978
                        for _, _, init, fan in specs if init == "lecun"], device=dev)
    flat *= torch.repeat_interleave(std, torch.tensor(sizes, device=dev))
    params, off = {}, 0
    for name, shape, init, _ in specs:
        if init == "lecun":
            n = math.prod(shape)
            params[name] = flat[off:off + n].view(shape)
            off += n
        else:
            params[name] = torch.full(shape, 1.0 if init == "one" else 0.0, device=dev)
    return params


def batch_norm(x, weight, bias):
    """NCHW ``x`` normalised per channel over the batch and the plane."""
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    scale = torch.rsqrt(var + BN_EPS) * weight
    return (x - mean[None, :, None, None]) * scale[None, :, None, None] + bias[None, :, None, None]


def identity(x):
    return x


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude onto the format's largest), returned in float32; the gradient
    passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()
