"""EfficientNet-B0…B4 feature extractors (counterpart of
``vince_tpu/models/efficientnet.py``): MBConv inverted bottlenecks with
squeeze-excitation and swish, compound width and depth scaling, NHWC at every
public boundary. The output is the spatial map after the head conv.

Parameter names follow ``efficientnet_pytorch`` (``_conv_stem``, ``_bn0``,
``_blocks.{i}._expand_conv`` …), with conv weights [O, I, kh, kw] and the
depthwise weight [C, 1, k, k]. Convolutions pad as TensorFlow's SAME does:
for stride 2 the padding is asymmetric (total = (out−1)·s + k − in, the
smaller half first), so it is applied with ``F.pad`` and not through
``F.conv2d``'s symmetric ``padding``.

The depthwise convolution has three emissions (``dw_kind``) over one weight:
``conv`` is the library's grouped convolution, ``tap`` the k² shifted
multiply-adds as tensor operations, and ``kernel`` the hand-written CUDA
kernel (``ops/kernels/depthwise_kernel.py``) at the stride-1 sites, with the
grouped convolution at the stride-2 sites. In B0, 12 of the 16 depthwise sites
are stride 1. ``se_kind="fold"`` folds the squeeze-excitation gate into the
project conv's weights, one weight matrix per sample.
"""

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vince_tpu_torch.models.resnet import (
    BatchNorm, Conv1x1, _lecun_normal_, folded_dot_bn, remat_block)
from vince_tpu_torch.ops.kernels import depthwise_kernel

# (expand_ratio, out_channels, num_repeats, stride, kernel_size) per stage
_BASE_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# variant -> (width_mult, depth_mult)
_SCALING = {
    "b0": (1.0, 1.0),
    "b1": (1.0, 1.1),
    "b2": (1.1, 1.2),
    "b3": (1.2, 1.4),
    "b4": (1.4, 1.8),
}

BN_MOMENTUM = 0.9
BN_EPSILON = 1e-3


def round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def _same_padding(size: int, k: int, s: int):
    """(output size, padding before, padding after) of TensorFlow's SAME."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return out, total // 2, total - total // 2


def _same_pad(x, k: int, s: int):
    """Zero-pad an NHWC tensor as SAME does for a k×k window at stride s;
    returns the padded tensor and the output's (H, W)."""
    h_out, top, bottom = _same_padding(x.shape[1], k, s)
    w_out, left, right = _same_padding(x.shape[2], k, s)
    return F.pad(x, (0, 0, left, right, top, bottom)), (h_out, w_out)


def _conv_same(x, weight, stride: int, groups: int = 1):
    """SAME convolution of an NHWC tensor with an [O, I/groups, k, k] weight."""
    k = weight.shape[-1]
    _, top, bottom = _same_padding(x.shape[1], k, stride)
    _, left, right = _same_padding(x.shape[2], k, stride)
    padding = (top, left)
    if top != bottom or left != right:  # conv2d pads both sides alike
        x, padding = F.pad(x, (0, 0, left, right, top, bottom)), 0
    w = weight.to(x.dtype).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding,
                    groups=groups).permute(0, 2, 3, 1)


def _tap_sum(x, w, k: int, s: int):
    """The depthwise convolution as k² shifted multiply-adds on tensors: each
    product in x's dtype, widened and summed in f32. (The CUDA kernel widens
    each tap and weight before the product; see ``depthwise_kernel._reference``.)"""
    xp, (h_out, w_out) = _same_pad(x, k, s)
    acc = None
    for i in range(k):
        for j in range(k):
            tap = xp[:, i:i + (h_out - 1) * s + 1:s, j:j + (w_out - 1) * s + 1:s, :] * w[i, j, 0]
            acc = tap.float() if acc is None else acc + tap.float()
    return acc.to(x.dtype)


class StemConv(nn.Module):
    """The 3×3 stride-2 stem. Its product runs in float32 whatever the compute
    dtype, as flax promotes the images to the float32 filter."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))

    def reset_parameters(self, generator=None):
        _lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def forward(self, x):
        return _conv_same(x.float(), self.weight, 2)


class DepthwiseConv(nn.Module):
    """Depthwise k×k SAME convolution; ``kind`` selects the emission."""

    def __init__(self, channels: int, kernel: int, stride: int = 1, kind: str = "conv"):
        super().__init__()
        if kind not in ("conv", "tap", "kernel"):
            raise ValueError(f"dw_kind={kind!r}; choices: conv, tap, kernel")
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel, kernel))
        self.kernel, self.stride, self.kind = kernel, stride, kind

    def reset_parameters(self, generator=None):
        _lecun_normal_(self.weight, self.kernel * self.kernel, generator)

    def forward(self, x):
        k, s = self.kernel, self.stride
        if self.kind == "kernel" and depthwise_kernel.kernel_supported(x.shape, k, s):
            return depthwise_kernel.depthwise_conv(x, self.weight.permute(2, 3, 1, 0).to(x.dtype))
        if self.kind == "tap":
            return _tap_sum(x, self.weight.permute(2, 3, 1, 0).to(x.dtype), k, s)
        return _conv_same(x, self.weight, s, groups=x.shape[-1])


def squeeze_excite(x, reduce: Conv1x1, expand: Conv1x1, return_scale: bool = False):
    """Squeeze-excitation: the gate sigmoid(expand(swish(reduce(mean_hw x)))),
    applied to x or, with ``return_scale``, returned as [N,1,1,C]."""
    s = x.mean(dim=(1, 2), keepdim=True, dtype=torch.float32).to(x.dtype)
    gate = torch.sigmoid(expand(F.silu(reduce(s))))
    return gate if return_scale else x * gate


def se_folded_project(x, conv: Conv1x1, gate):
    """The project conv with the per-sample gate folded into its weights:
    (x·diag(g_n)) W = x (diag(g_n) W), one batched product."""
    n, h, w, c = x.shape
    weights = conv.matrix().to(x.dtype)[None, :, :] * gate[:, 0, 0, :, None].to(x.dtype)
    return torch.bmm(x.reshape(n, h * w, c), weights).reshape(n, h, w, -1)


class MBConv(nn.Module):
    """Inverted bottleneck: 1×1 expand → depthwise → squeeze-excite → 1×1
    project, with a residual where the shape is kept. ``fold`` derives the
    expand conv's batch statistics from its input's moments
    (``folded_dot_bn``); the project conv narrows 6C → C, where the fold costs
    more than it saves, so it is never folded."""

    def __init__(self, cin: int, filters: int, expand_ratio: int, kernel: int, stride: int,
                 se_ratio: float = 0.25, fold: bool = False, dw_kind: str = "conv",
                 se_kind: str = "mul", dtype=torch.float32, axis_name: Optional[str] = None):
        super().__init__()
        if se_kind not in ("mul", "fold"):
            raise ValueError(f"se_kind={se_kind!r}; choices: mul, fold")
        bn = functools.partial(BatchNorm, momentum=BN_MOMENTUM, eps=BN_EPSILON,
                               axis_name=axis_name)
        expanded = cin * expand_ratio
        if expand_ratio != 1:
            self._expand_conv = Conv1x1(cin, expanded)
            self._bn0 = bn(expanded)
        self._depthwise_conv = DepthwiseConv(expanded, kernel, stride, dw_kind)
        self._bn1 = bn(expanded)
        reduced = max(1, int(cin * se_ratio))
        self._se_reduce = Conv1x1(expanded, reduced, bias=True)
        self._se_expand = Conv1x1(reduced, expanded, bias=True)
        self._project_conv = Conv1x1(expanded, filters)
        self._bn2 = bn(filters)
        self.expand = expand_ratio != 1
        self.residual = stride == 1 and cin == filters
        self.fold, self.se_kind, self.dtype = fold, se_kind, dtype

    def forward(self, x):
        y = x
        if self.expand:
            if self.fold:
                y = folded_dot_bn(y, self._expand_conv, self._bn0, self.dtype, act=F.silu)
            else:
                y = F.silu(self._bn0(self._expand_conv(y)))
        y = F.silu(self._bn1(self._depthwise_conv(y)))
        if self.se_kind == "fold":
            gate = squeeze_excite(y, self._se_reduce, self._se_expand, return_scale=True)
            y = se_folded_project(y, self._project_conv, gate)
        else:
            y = self._project_conv(squeeze_excite(y, self._se_reduce, self._se_expand))
        y = self._bn2(y)
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    """Feature-extractor EfficientNet: NHWC images → [N, H/32, W/32, C_head]."""

    def __init__(self, variant: str = "b0", bn_fold: str = "none", dw_kind: str = "conv",
                 se_kind: str = "mul", dtype=torch.float32, in_channels: int = 3,
                 axis_name: Optional[str] = None, remat: bool = False):
        super().__init__()
        if bn_fold not in ("none", "expand", "all"):
            raise ValueError(f"bn_fold={bn_fold!r}; choices: none, expand, all")
        width, depth = _SCALING[variant]
        self.dtype, self.remat = dtype, remat  # remat: each MBConv recomputed in the backward
        self.fold = bn_fold != "none"  # "all" behaves like "expand" here
        # axis_name: the mesh axis that train-mode statistics are summed over
        bn = functools.partial(BatchNorm, momentum=BN_MOMENTUM, eps=BN_EPSILON,
                               axis_name=axis_name)
        cin = round_filters(32, width)
        self._conv_stem = StemConv(in_channels, cin)
        self._bn0 = bn(cin)
        blocks = []
        for expand, channels, repeats, stride, kernel in _BASE_BLOCKS:
            out_ch = round_filters(channels, width)
            for r in range(round_repeats(repeats, depth)):
                blocks.append(MBConv(cin, out_ch, expand, kernel, stride if r == 0 else 1,
                                     fold=self.fold, dw_kind=dw_kind, se_kind=se_kind,
                                     dtype=dtype, axis_name=axis_name))
                cin = out_ch
        self._blocks = nn.ModuleList(blocks)
        self.output_channels = round_filters(1280, width)
        self._conv_head = Conv1x1(cin, self.output_channels)
        self._bn1 = bn(self.output_channels)

    def reset_parameters(self, generator=None):
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x):
        x = F.silu(self._bn0(self._conv_stem(x.to(self.dtype))).to(self.dtype))
        for block in self._blocks:
            x = remat_block(block, x) if self.remat else block(x)
        if self.fold:
            return folded_dot_bn(x, self._conv_head, self._bn1, self.dtype, act=F.silu)
        return F.silu(self._bn1(self._conv_head(x)))


EfficientNetB0 = functools.partial(EfficientNet, variant="b0")
EfficientNetB1 = functools.partial(EfficientNet, variant="b1")
EfficientNetB2 = functools.partial(EfficientNet, variant="b2")
EfficientNetB3 = functools.partial(EfficientNet, variant="b3")
EfficientNetB4 = functools.partial(EfficientNet, variant="b4")
