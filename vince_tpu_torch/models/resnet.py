"""ResNet backbones (counterpart of ``vince_tpu/models/resnet.py``).

Activations are NHWC at every public boundary, as in the JAX package. A 3×3
or stem convolution views its NHWC input as channels-last NCHW, which cuDNN
takes without a copy; a 1×1 convolution is a matmul over the last dimension.
Parameter names follow torchvision (``layer1.0.conv1.weight``, conv weights
[O, I, kh, kw]).

BatchNorm follows flax, not ``torch.nn.BatchNorm2d``: statistics in float32,
the uncentered variance max(E[x²]−μ², 0), and running averages updated as
0.9·old + 0.1·batch with the *biased* batch variance.

``bn_fold != "none"`` folds the batch statistics of the expanding 1×1 convs
into their weights from the input moments (``folded_dot_bn``); with
``fold_kernel`` the bottleneck chain bn2 → relu → conv3 → bn3 runs through
K2 (``fused_bn_relu_folded_dot``) at the sites ``_kernel_site_supported``
admits, the same sites as in JAX.
"""

import functools
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vince_tpu_torch.ops.kernels import folded_dot_kernel


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator=None):
    """flax's lecun_normal: a normal truncated at ±2σ, rescaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


class Conv2d(nn.Module):
    """Bias-free convolution on NHWC tensors, computed in the input's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.stride, self.padding, self.dilation = stride, padding, dilation

    def reset_parameters(self, generator=None):
        _lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def forward(self, x):
        w = self.weight.to(x.dtype).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.stride,
                     padding=self.padding, dilation=self.dilation)
        return y.permute(0, 2, 3, 1)


class StemConvS2D(Conv2d):
    """The 7×7 stride-2 stem. The JAX module computes it as a space-to-depth
    4×4 conv for the TPU's matrix unit; the math is that of this direct
    7×7 stride-2 pad-3 convolution, with the same [7,7,Cin,Cout] kernel."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 7, stride=2, padding=3)


class Conv1x1(nn.Module):
    """1×1 convolution as a strided slice and a matmul over channels."""

    def __init__(self, cin: int, cout: int, stride: int = 1, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride = stride

    def reset_parameters(self, generator=None):
        _lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def matrix(self) -> torch.Tensor:
        """The [Cin, Cout] dot weights."""
        return self.weight[:, :, 0, 0].T

    def forward(self, x):
        if self.stride != 1:
            x = x[:, :: self.stride, :: self.stride, :]
        y = x @ self.matrix().to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class BatchNorm(nn.Module):
    """flax BatchNorm semantics over the last (channel) dimension."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5,
                 zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.momentum, self.eps, self.zero_scale = momentum, eps, zero_scale

    def reset_parameters(self, generator=None):
        nn.init.constant_(self.weight, 0.0 if self.zero_scale else 1.0)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def batch_stats(self, mean: torch.Tensor, var: torch.Tensor):
        """Record a train-mode batch's (mean, biased var) in the running
        averages and return them; in eval mode return the running averages."""
        if not self.training:
            return self.running_mean, self.running_var
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        return mean, var

    def forward(self, x):
        if self.training:
            x32 = x.float()
            dims = tuple(range(x.dim() - 1))
            mean = x32.mean(dim=dims)
            var = torch.clamp((x32 * x32).mean(dim=dims) - mean * mean, min=0.0)
            mean, var = self.batch_stats(mean, var)
        else:
            mean, var = self.batch_stats(None, None)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x.float() - mean) * mul + self.bias).to(x.dtype)


def _fold_affine(bn: BatchNorm, mu, var):
    scale, bias, mu, var = bn.weight, bn.bias, *bn.batch_stats(mu, var)
    a = scale * torch.rsqrt(var + bn.eps)
    return a, bias - mu * a


def _moment_stats(s1, s2, w, n):
    """Batch (mean, var) of y = x@w from x's moments s1 = Σx, s2 = xᵀx."""
    mu = (s1 / n) @ w
    var = torch.clamp(((s2 @ w) * w).sum(dim=0) / n - mu * mu, min=0.0)
    return mu, var


def folded_dot_bn(x, conv: Conv1x1, bn: BatchNorm, dtype, *,
                  act: Optional[Callable] = None, residual=None):
    """1×1 conv + BatchNorm (+ residual, + activation) with the batch
    statistics derived from the input's uncentered moments and folded into
    the dot: BN(x@W) = x@(W·a) + b (counterpart of the JAX ``folded_dot_bn``)."""
    w = conv.matrix()  # [Cin, Cout] f32
    if conv.stride != 1:
        x = x[:, :: conv.stride, :: conv.stride, :]
    mu = var = None
    if bn.training:
        x2 = x.reshape(-1, x.shape[-1]).float()
        mu, var = _moment_stats(x2.sum(dim=0), x2.T @ x2, w, x2.shape[0])
    a, b = _fold_affine(bn, mu, var)
    y = x.to(dtype) @ (w * a[None, :]).to(dtype) + b.to(dtype)
    if residual is not None:
        y = y + residual
    return act(y) if act is not None else y


def fused_bn_relu_folded_dot(y, in_bn: BatchNorm, conv: Conv1x1, bn: BatchNorm, dtype, *,
                             act: Optional[Callable] = None, residual=None):
    """bn2 → relu → conv3(1×1) → bn3 with one pass of K2 over the raw conv2
    output ``y`` [N,H,W,C] (counterpart of the JAX function of the same name):
    bn2's statistics come from one reduction over y, K2 applies bn2's affine
    and the ReLU in registers while computing the dot and x̂'s moments, and
    bn3's statistics follow from those moments."""
    c = y.shape[-1]
    n = y[..., 0].numel()
    w = conv.matrix()  # [C, F] f32
    features = w.shape[1]
    if in_bn.training:
        y32 = y.reshape(-1, c).float()
        mu2 = y32.sum(dim=0) / n
        var2 = torch.clamp((y32 * y32).sum(dim=0) / n - mu2 * mu2, min=0.0)
        a2, b2 = _fold_affine(in_bn, mu2, var2)
        out_raw, s1, s2 = folded_dot_kernel.affine_relu_dot_moments(
            y.reshape(-1, c).to(dtype), a2, b2, w)
        a3, b3 = _fold_affine(bn, *_moment_stats(s1, s2, w, n))
        out = out_raw.reshape(*y.shape[:-1], features)
    else:
        a2, b2 = _fold_affine(in_bn, None, None)
        a3, b3 = _fold_affine(bn, None, None)
        xh = torch.relu(y.to(dtype) * a2.to(dtype) + b2.to(dtype))
        out = xh @ w.to(dtype)
    out = out * a3.to(dtype) + b3.to(dtype)
    if residual is not None:
        out = out + residual
    return act(out) if act is not None else out


def _kernel_site_supported(y, features: int) -> bool:
    """The JAX rule (M, C and F multiples of 128), which is what the CUDA
    kernel takes; any other site takes the unfused ``folded_dot_bn`` chain."""
    m = math.prod(y.shape[:-1])
    return m % 128 == 0 and folded_dot_kernel.kernel_supported(m, y.shape[-1], features)


class BasicBlock(nn.Module):
    """2×(3×3 conv) residual block."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1, downsample: bool = False,
                 fold: bool = False, fold_kernel: bool = False, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, filters, 3, stride=stride, padding=1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv2d(filters, filters, 3, padding=1)
        self.bn2 = BatchNorm(filters, zero_scale=True)
        self.downsample = (
            nn.ModuleList([Conv1x1(cin, filters, stride), BatchNorm(filters)])
            if downsample else None
        )
        self.fold, self.dtype = fold, dtype

    def forward(self, x):
        residual = x
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            conv, bn = self.downsample
            if self.fold:
                residual = folded_dot_bn(residual, conv, bn, self.dtype)
            else:
                residual = bn(conv(residual))
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """1×1 → 3×3 → 1×1 residual block, stride on the 3×3."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1, downsample: bool = False,
                 fold: bool = False, fold_kernel: bool = False, dtype=torch.float32):
        super().__init__()
        out_ch = filters * self.expansion
        self.conv1 = Conv1x1(cin, filters)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv2d(filters, filters, 3, stride=stride, padding=1)
        self.bn2 = BatchNorm(filters)
        self.conv3 = Conv1x1(filters, out_ch)
        self.bn3 = BatchNorm(out_ch, zero_scale=True)
        self.downsample = (
            nn.ModuleList([Conv1x1(cin, out_ch, stride), BatchNorm(out_ch)])
            if downsample else None
        )
        self.fold, self.fold_kernel, self.dtype = fold, fold_kernel, dtype

    def forward(self, x):
        residual = x
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.conv2(y)
        if self.fold:
            if self.downsample is not None:
                residual = folded_dot_bn(residual, *self.downsample, self.dtype)
            out_ch = self.conv3.weight.shape[0]
            if self.fold_kernel and _kernel_site_supported(y, out_ch):
                return fused_bn_relu_folded_dot(
                    y, self.bn2, self.conv3, self.bn3, self.dtype,
                    act=torch.relu, residual=residual)
            y = torch.relu(self.bn2(y))
            return folded_dot_bn(y, self.conv3, self.bn3, self.dtype,
                                 act=torch.relu, residual=residual)
        y = torch.relu(self.bn2(y))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            conv, bn = self.downsample
            residual = bn(conv(residual))
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """Feature-extractor ResNet: NHWC images → spatial features [N, H/32, W/32, C]."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_filters: int = 64,
                 bn_fold: str = "none", fold_kernel: bool = False, dtype=torch.float32,
                 in_channels: int = 3):
        super().__init__()
        if bn_fold not in ("none", "expand"):
            raise ValueError(f"bn_fold={bn_fold!r} is not ported; use 'none' or 'expand'")
        self.dtype = dtype
        self.conv1 = StemConvS2D(in_channels, num_filters)
        self.bn1 = BatchNorm(num_filters)
        cin = num_filters
        fold = bn_fold != "none"
        for stage, num_blocks in enumerate(stage_sizes):
            filters = num_filters * 2 ** stage
            blocks = []
            for block in range(num_blocks):
                s = (1 if stage == 0 else 2) if block == 0 else 1
                needs_down = s != 1 or cin != filters * block_cls.expansion
                blocks.append(block_cls(cin, filters, s, needs_down, fold=fold,
                                        fold_kernel=fold_kernel, dtype=dtype))
                cin = filters * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.output_channels = cin

    def reset_parameters(self, generator=None):
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck)
