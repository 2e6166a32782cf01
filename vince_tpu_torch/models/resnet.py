"""ResNet backbones (counterpart of ``vince_tpu/models/resnet.py``).

Activations are NHWC at every public boundary, as in the JAX package. A 3×3
or stem convolution views its NHWC input as channels-last NCHW, which cuDNN
takes without a copy; a 1×1 convolution is a matmul over the last dimension.
Parameter names follow torchvision (``layer1.0.conv1.weight``, conv weights
[O, I, kh, kw]).

BatchNorm follows flax, not ``torch.nn.BatchNorm2d``: statistics in float32,
the uncentered variance max(E[x²]−μ², 0), and running averages updated as
0.9·old + 0.1·batch with the *biased* batch variance. Its arithmetic, and the
residual add and the ReLU that the blocks fuse into its call, are
``ops/kernels/batch_norm_kernel.py``'s (CUDA kernels on the card). Inside
``unrecorded_batch_stats(model)`` a train-mode forward normalises by the
batch's statistics and leaves the running averages as they were, as the JAX
eval and prefill steps do when they drop the ``batch_stats`` they mutated.

``bn_fold="expand"`` folds the batch statistics of the expanding 1×1 convs
(conv3 and the downsample) into their weights from the input moments
(``folded_dot_bn``), and ``"all"`` folds a bottleneck's conv1 too; with
``fold_kernel`` the bottleneck chain bn2 → relu → conv3 → bn3 runs through
K2 (``fused_bn_relu_folded_dot``) at the sites ``_kernel_site_supported``
admits, the same sites as in JAX.

``norm_kind="groupnorm"`` puts flax's ``GroupNorm`` (32 groups, ε = 1e-6, no
running statistics) in every norm's place. It has no batch statistics to
fold, so ``bn_fold`` is ignored and the blocks run unfolded, without K2, as
in JAX.

``axis_name`` (the mesh's ``DATA_AXIS``, for ``--sync-bn``) makes every
train-mode statistics site sum its moments over that axis of the bound mesh
(``parallel/mesh.py``) through the differentiable ``psum``, as the JAX
modules do with theirs: ``BatchNorm`` the mean and the mean of squares
(flax's ``pmean``), ``folded_dot_bn`` the input's Σx, xᵀx and count, and
``fused_bn_relu_folded_dot`` Σy and Σy² of its input, then K2's s1 and s2, so
that K2's backward receives the summed cotangents. Outside a bound mesh the
axis has one member and nothing is summed.

``stem_kind`` chooses the stem's arithmetic, not its math: "s2d" runs the
7×7 stride-2 convolution in the compute dtype (the JAX module casts its
filter to it), "conv7" in float32, as flax promotes the images to the f32
filter of its ``nn.Conv``; the stem's BatchNorm casts back to the compute
dtype either way.

``remat`` recomputes each residual block's activations in the backward
(``remat_block``, flax's ``nn.remat`` of the block class): less memory, the
block's forward run twice, the running averages moved once.
"""

import contextlib
import functools
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vince_tpu_torch.ops.kernels import batch_norm_kernel, folded_dot_kernel
from vince_tpu_torch.parallel.collectives import group_size, psum
from vince_tpu_torch.parallel.mesh import axis_group, bind, bound_mesh


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


class StemConv7(StemConvS2D):
    """The same 7×7 stride-2 stem in float32 whatever the input's type."""

    def forward(self, x):
        return super().forward(x.float())


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
                 zero_scale: bool = False, axis_name: Optional[str] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.momentum, self.eps, self.zero_scale = momentum, eps, zero_scale
        self.axis_name = axis_name  # the mesh axis train-mode statistics are summed over
        self.record_stats = True  # train mode: update the running averages

    def reset_parameters(self, generator=None):
        nn.init.constant_(self.weight, 0.0 if self.zero_scale else 1.0)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def batch_stats(self, mean: torch.Tensor, var: torch.Tensor):
        """Record a train-mode batch's (mean, biased var) in the running
        averages, unless ``record_stats`` is off, and return them; in eval
        mode return the running averages."""
        if not self.training:
            return self.running_mean, self.running_var
        if self.record_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        return mean, var

    def forward(self, x, relu: bool = False, residual=None, dtype=None):
        """BN(x) [+ residual] [relu] in x's dtype (or ``dtype``, without a
        residual), through ``batch_norm_kernel``: its kernels on the card."""
        if self.training:
            y, mean, var = batch_norm_kernel.batch_norm(
                x, self.weight, self.bias, self.eps, group=axis_group(self.axis_name),
                relu=relu, residual=residual, dtype=dtype)
            self.batch_stats(mean, var)
            return y
        return batch_norm_kernel.batch_norm(
            x, self.weight, self.bias, self.eps, running=self.batch_stats(None, None),
            relu=relu, residual=residual, dtype=dtype)[0]


class GroupNorm(nn.Module):
    """flax ``GroupNorm`` over the last (channel) dimension: per sample and
    group, E[x] and max(E[x²]−E[x]², 0) over H, W and the group's channels,
    in float32; no running statistics."""

    def __init__(self, features: int, zero_scale: bool = False, groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        if features % groups:
            raise ValueError(f"{groups} groups do not divide {features} channels")
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.groups, self.eps, self.zero_scale = groups, eps, zero_scale

    def reset_parameters(self, generator=None):
        nn.init.constant_(self.weight, 0.0 if self.zero_scale else 1.0)
        nn.init.zeros_(self.bias)

    def forward(self, x, relu: bool = False, residual=None, dtype=None):
        """GN(x) [+ residual] [relu], cast to ``dtype``: ``BatchNorm``'s call."""
        n, c, g = x.shape[0], x.shape[-1], self.groups
        x32 = x.float().reshape(n, -1, g, c // g)
        mean = x32.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(g, c // g)
        y = ((x32 - mean) * mul + self.bias.reshape(g, c // g)).reshape(x.shape).to(x.dtype)
        if residual is not None:
            y = y + residual
        if relu:
            y = torch.relu(y)
        return y.to(dtype or x.dtype)


@contextlib.contextmanager
def unrecorded_batch_stats(*modules: nn.Module):
    """Train-mode BatchNorm in ``modules`` that records nothing in its running
    averages (every path reads them through ``BatchNorm.batch_stats``: the
    module, the folded dots and K2's chain)."""
    bns = [m for mod in modules for m in mod.modules() if isinstance(m, BatchNorm)]
    before = [bn.record_stats for bn in bns]
    for bn in bns:
        bn.record_stats = False
    try:
        yield
    finally:
        for bn, rec in zip(bns, before):
            bn.record_stats = rec


def remat_block(block: nn.Module, x):
    """``block(x)`` with its activations recomputed in the backward instead
    of kept (flax's ``nn.remat``), where autograd records the forward; a
    forward under ``no_grad`` (the key encoder's, the eval paths') runs the
    block as it is. The recompute runs under the mesh bound at the forward
    (the backward may run on autograd's own threads, which see none, and a
    sync-BN block must sum its statistics there too) and records no batch
    statistics: the forward moved the running averages once, and JAX's remat
    drops the recompute's mutation. The blocks draw no random numbers, so the
    RNG state is not stashed, which a CUDA graph capture could not take."""
    if not torch.is_grad_enabled():
        return block(x)
    mesh = bound_mesh()

    @contextlib.contextmanager
    def recompute():
        with bind(mesh), unrecorded_batch_stats(block):
            yield

    return checkpoint(block, x, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), recompute()))


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
        s1, s2, n = x2.sum(dim=0), x2.T @ x2, x2.shape[0]
        group = axis_group(bn.axis_name)
        if group is not None:
            s1, s2, n = psum(s1, group), psum(s2, group), n * group_size(group)
        mu, var = _moment_stats(s1, s2, w, n)
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
        s1y, s2y = y32.sum(dim=0), (y32 * y32).sum(dim=0)
        group = axis_group(in_bn.axis_name)
        if group is not None:
            s1y, s2y, n = psum(s1y, group), psum(s2y, group), n * group_size(group)
        mu2 = s1y / n
        var2 = torch.clamp(s2y / n - mu2 * mu2, min=0.0)
        a2, b2 = _fold_affine(in_bn, mu2, var2)
        out_raw, s1, s2 = folded_dot_kernel.affine_relu_dot_moments(
            y.reshape(-1, c).to(dtype), a2, b2, w)
        if group is not None:
            s1, s2 = psum(s1, group), psum(s2, group)
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
    """2×(3×3 conv) residual block (``fold_all`` is the bottleneck's: this
    block has no 1×1 conv1). Only conv1 takes the ``dilation``; conv2 stays
    undilated, as in the reference's block."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1, downsample: bool = False,
                 fold: bool = False, fold_kernel: bool = False, fold_all: bool = False,
                 dtype=torch.float32, norm=BatchNorm, dilation: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, filters, 3, stride=stride, padding=dilation, dilation=dilation)
        self.bn1 = norm(filters)
        self.conv2 = Conv2d(filters, filters, 3, padding=1)
        self.bn2 = norm(filters, zero_scale=True)
        self.downsample = (
            nn.ModuleList([Conv1x1(cin, filters, stride), norm(filters)])
            if downsample else None
        )
        self.fold, self.dtype = fold, dtype

    def forward(self, x):
        residual = x
        if self.downsample is not None:
            conv, bn = self.downsample
            if self.fold:
                residual = folded_dot_bn(residual, conv, bn, self.dtype)
            else:
                residual = bn(conv(residual))
        y = self.bn1(self.conv1(x), relu=True)
        return self.bn2(self.conv2(y), residual=residual, relu=True)


class Bottleneck(nn.Module):
    """1×1 → 3×3 → 1×1 residual block, stride and dilation on the 3×3."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1, downsample: bool = False,
                 fold: bool = False, fold_kernel: bool = False, fold_all: bool = False,
                 dtype=torch.float32, norm=BatchNorm, dilation: int = 1):
        super().__init__()
        out_ch = filters * self.expansion
        self.conv1 = Conv1x1(cin, filters)
        self.bn1 = norm(filters)
        self.conv2 = Conv2d(filters, filters, 3, stride=stride, padding=dilation,
                            dilation=dilation)
        self.bn2 = norm(filters)
        self.conv3 = Conv1x1(filters, out_ch)
        self.bn3 = norm(out_ch, zero_scale=True)
        self.downsample = (
            nn.ModuleList([Conv1x1(cin, out_ch, stride), norm(out_ch)])
            if downsample else None
        )
        self.fold, self.fold_kernel, self.dtype = fold, fold_kernel, dtype
        self.fold_all = fold and fold_all  # conv1 through folded_dot_bn too

    def forward(self, x):
        residual = x
        if self.fold_all:
            y = folded_dot_bn(x, self.conv1, self.bn1, self.dtype, act=torch.relu)
        else:
            y = self.bn1(self.conv1(x), relu=True)
        y = self.conv2(y)
        if self.fold:
            if self.downsample is not None:
                residual = folded_dot_bn(residual, *self.downsample, self.dtype)
            out_ch = self.conv3.weight.shape[0]
            if self.fold_kernel and _kernel_site_supported(y, out_ch):
                return fused_bn_relu_folded_dot(
                    y, self.bn2, self.conv3, self.bn3, self.dtype,
                    act=torch.relu, residual=residual)
            y = self.bn2(y, relu=True)
            return folded_dot_bn(y, self.conv3, self.bn3, self.dtype,
                                 act=torch.relu, residual=residual)
        y = self.bn2(y, relu=True)
        if self.downsample is not None:
            conv, bn = self.downsample
            residual = bn(conv(residual))
        return self.bn3(self.conv3(y), residual=residual, relu=True)


class ResNet(nn.Module):
    """Feature-extractor ResNet: NHWC images → spatial features [N, H/32, W/32, C].

    ``replace_stride_with_dilation[i]`` turns stage i+2's stride of 2 into a
    doubled dilation, torchvision's rule: the stage's first block keeps the
    previous dilation, its later blocks take the new one, and its downsample
    is a stride-1 1×1 conv wherever the channels change. The SiamFC backbones
    dilate stages 3 and 4 and give features at stride 8."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_filters: int = 64,
                 bn_fold: str = "none", fold_kernel: bool = False, dtype=torch.float32,
                 in_channels: int = 3, norm_kind: str = "batchnorm", stem_kind: str = "conv7",
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 axis_name: Optional[str] = None, remat: bool = False):
        super().__init__()
        if bn_fold not in ("none", "expand", "all"):
            raise ValueError(f"bn_fold={bn_fold!r}; choices: none, expand, all")
        norms = {"batchnorm": functools.partial(BatchNorm, axis_name=axis_name),
                 "groupnorm": GroupNorm}
        stems = {"conv7": StemConv7, "s2d": StemConvS2D}
        if norm_kind not in norms or stem_kind not in stems:
            raise ValueError(f"norm_kind={norm_kind!r}, stem_kind={stem_kind!r}; choices: "
                             f"{sorted(norms)}, {sorted(stems)}")
        self.dtype, self.remat = dtype, remat
        norm = norms[norm_kind]
        self.conv1 = stems[stem_kind](in_channels, num_filters)
        self.bn1 = norm(num_filters)
        cin = num_filters
        fold = bn_fold != "none" and norm_kind == "batchnorm"
        dilation = 1
        for stage, num_blocks in enumerate(stage_sizes):
            filters = num_filters * 2 ** stage
            stride = 1 if stage == 0 else 2
            previous = dilation
            if stage > 0 and replace_stride_with_dilation[stage - 1]:
                dilation, stride = dilation * stride, 1
            blocks = []
            for block in range(num_blocks):
                s = stride if block == 0 else 1
                needs_down = s != 1 or cin != filters * block_cls.expansion
                blocks.append(block_cls(cin, filters, s, needs_down, fold=fold,
                                        fold_kernel=fold_kernel, fold_all=bn_fold == "all",
                                        dtype=dtype, norm=norm,
                                        dilation=previous if block == 0 else dilation))
                cin = filters * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.output_channels = cin

    def reset_parameters(self, generator=None):
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x):
        x = self.bn1(self.conv1(x.to(self.dtype)), relu=True, dtype=self.dtype)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        for stage in range(self.num_stages):
            for block in getattr(self, f"layer{stage + 1}"):
                x = remat_block(block, x) if self.remat else block(x)
        return x


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3], block_cls=Bottleneck)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3], block_cls=Bottleneck)
# SimCLR's width multipliers (ResNet50-2x, -4x)
ResNet50w2 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck,
                               num_filters=128)
ResNet50w4 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck,
                               num_filters=256)
# dense features for SiamFC tracking: stages 3 and 4 dilated, stride 8
ResNet18SiamFCDilated = functools.partial(
    ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock,
    replace_stride_with_dilation=(False, True, True))
ResNet50SiamFCDilated = functools.partial(
    ResNet, stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck,
    replace_stride_with_dilation=(False, True, True))
