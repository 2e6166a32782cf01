"""The VINCE encoder on a ResNet in plain float32 PyTorch: a torchvision-layout
ResNet (7×7 stem, max pool, basic or bottleneck blocks with the stride on
the 3×3), train-mode BatchNorm on the batch's statistics, global average
pool, the Linear→ReLU→Linear projection and L2 normalisation.

A configuration names this file by ``"reference_model": "resnet"``; its
``backbone`` picks the depth from ``ARCHS``. Another ResNet depth can be
added in a file of its own that hands its ``Arch`` to ``param_specs`` and
``forward_arch``.

Parameters are a flat ``{name: tensor}`` dict under the names the port's
``VinceEncoder`` gives them (``backbone.layer1.0.conv1.weight``,
``embedding.fc1.bias``), so that the benchmark can hand one set of weights
to both. ``quant`` is applied to both operands of every convolution and
linear layer; the control of the benchmark's comparison passes an fp8
rounding there.
"""

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vince_bench.reference.layers import Spec, batch_norm, identity
from vince_bench.reference.layers import make_params as params_from_specs

# (blocks per stage, block kind)
Arch = Tuple[Tuple[int, ...], str]
ARCHS: Dict[str, Arch] = {"ResNet18": ((2, 2, 2, 2), "basic"),
                          "ResNet50": ((3, 4, 6, 3), "bottleneck")}


def blocks(arch: Arch):
    """(prefix, kind, cin, filters, stride, downsample) of every residual block."""
    stages, kind = arch
    expansion = 4 if kind == "bottleneck" else 1
    cin, out = 64, []
    for s, n in enumerate(stages):
        filters = 64 * 2 ** s
        for b in range(n):
            stride = 2 if s > 0 and b == 0 else 1
            down = stride != 1 or cin != filters * expansion
            out.append((f"backbone.layer{s + 1}.{b}", kind, cin, filters, stride, down))
            cin = filters * expansion
    return out


def output_channels(arch: Arch) -> int:
    return 512 * (4 if arch[1] == "bottleneck" else 1)


def param_specs(arch: Arch, embed: int) -> List[Spec]:
    """The specs of every parameter (``layers.Spec``). The last BatchNorm of
    each block starts at scale 0."""
    specs = []

    def conv(name, cout, cin, k):
        specs.append((f"{name}.weight", (cout, cin, k, k), "lecun", cin * k * k))

    def bn(name, c, zero_scale=False):
        specs.append((f"{name}.weight", (c,), "zero" if zero_scale else "one", 0))
        specs.append((f"{name}.bias", (c,), "zero", 0))

    conv("backbone.conv1", 64, 3, 7)
    bn("backbone.bn1", 64)
    for prefix, kind, cin, f, _, down in blocks(arch):
        if kind == "bottleneck":
            conv(f"{prefix}.conv1", f, cin, 1)
            bn(f"{prefix}.bn1", f)
            conv(f"{prefix}.conv2", f, f, 3)
            bn(f"{prefix}.bn2", f)
            conv(f"{prefix}.conv3", 4 * f, f, 1)
            bn(f"{prefix}.bn3", 4 * f, zero_scale=True)
            cout = 4 * f
        else:
            conv(f"{prefix}.conv1", f, cin, 3)
            bn(f"{prefix}.bn1", f)
            conv(f"{prefix}.conv2", f, f, 3)
            bn(f"{prefix}.bn2", f, zero_scale=True)
            cout = f
        if down:
            conv(f"{prefix}.downsample.0", cout, cin, 1)
            bn(f"{prefix}.downsample.1", cout)
    c = output_channels(arch)
    for name, cout, cin in (("embedding.fc1", c, c), ("embedding.fc2", embed, c)):
        specs.append((f"{name}.weight", (cout, cin), "lecun", cin))
        specs.append((f"{name}.bias", (cout,), "zero", 0))
    return specs


def make_params(backbone: str, embed: int, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    return params_from_specs(param_specs(ARCHS[backbone], embed), gen)


def _block(p, prefix, kind, stride, down, quant, x):
    def conv(name, y, s=1, pad=0):
        return F.conv2d(quant(y), quant(p[f"{prefix}.{name}.weight"]), stride=s, padding=pad)

    def bn(name, y):
        return batch_norm(y, p[f"{prefix}.{name}.weight"], p[f"{prefix}.{name}.bias"])

    if kind == "bottleneck":
        y = torch.relu(bn("bn1", conv("conv1", x)))
        y = torch.relu(bn("bn2", conv("conv2", y, stride, 1)))
        y = bn("bn3", conv("conv3", y))
    else:
        y = torch.relu(bn("bn1", conv("conv1", x, stride, 1)))
        y = bn("bn2", conv("conv2", y, 1, 1))
    residual = bn("downsample.1", conv("downsample.0", x, stride)) if down else x
    return torch.relu(y + residual)


def forward_arch(arch: Arch, p: Dict[str, torch.Tensor], images: torch.Tensor,
                 quant: Optional[Callable] = None, remat: bool = False) -> torch.Tensor:
    """NHWC float images → unit embeddings [N, E], all in float32. With
    ``remat`` each block's activations are recomputed in the backward
    (``torch.utils.checkpoint``): the sums are the same, the memory a block's."""
    quant = quant or identity
    x = images.permute(0, 3, 1, 2)
    x = F.conv2d(quant(x), quant(p["backbone.conv1.weight"]), stride=2, padding=3)
    x = torch.relu(batch_norm(x, p["backbone.bn1.weight"], p["backbone.bn1.bias"]))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for prefix, kind, _, _, stride, down in blocks(arch):
        args = (p, prefix, kind, stride, down, quant)
        if remat and torch.is_grad_enabled():
            x = checkpoint(_block, *args, x, use_reentrant=False)
        else:
            x = _block(*args, x)
    feats = x.mean(dim=(2, 3))
    h = torch.relu(F.linear(quant(feats), quant(p["embedding.fc1.weight"]),
                            p["embedding.fc1.bias"]))
    z = F.linear(quant(h), quant(p["embedding.fc2.weight"]), p["embedding.fc2.bias"])
    return z / torch.linalg.norm(z, dim=-1, keepdim=True).clamp(min=1e-12)


def forward(p: Dict[str, torch.Tensor], backbone: str, images: torch.Tensor,
            quant: Optional[Callable] = None, remat: bool = False) -> torch.Tensor:
    return forward_arch(ARCHS[backbone], p, images, quant, remat)
