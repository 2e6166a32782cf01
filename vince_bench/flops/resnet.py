"""Operations of a ResNet encoder and its K2 sites, for the configurations
that name this file by ``"flops": "resnet"``; the depths are the
reference's (``reference/models/resnet.py``'s ``ARCHS``). A counter of
another backbone is a file of its own beside this one with the same two
functions (``k2_sites`` may be left out where the backbone has none).
"""

from typing import List, Tuple

from vince_bench.reference.models.resnet import ARCHS, Arch


def _conv(hw: int, cin: int, cout: int, k: int) -> int:
    return 2 * hw * hw * cin * cout * k * k


def arch_flops(arch: Arch, image: int, embed: int) -> int:
    """Operations of one frame's forward through the encoder: every
    convolution and the projection's two linear layers."""
    stages, kind = arch
    bottleneck = kind == "bottleneck"
    hw = image // 2
    flops = _conv(hw, 3, 64, 7)
    hw //= 2  # max pool
    cin = 64
    for s, n in enumerate(stages):
        f = 64 * 2 ** s
        cout = 4 * f if bottleneck else f
        for b in range(n):
            stride = 2 if s > 0 and b == 0 else 1
            out = hw // stride
            if bottleneck:
                flops += _conv(hw, cin, f, 1) + _conv(out, f, f, 3) + _conv(out, f, cout, 1)
            else:
                flops += _conv(out, cin, f, 3) + _conv(out, f, f, 3)
            if stride != 1 or cin != cout:
                flops += _conv(out, cin, cout, 1)
            cin, hw = cout, out
    return flops + 2 * cin * cin + 2 * cin * embed


def encoder_flops(backbone: str, image: int, embed: int) -> int:
    return arch_flops(ARCHS[backbone], image, embed)


def arch_k2_sites(arch: Arch, frames: int, image: int) -> List[Tuple[int, int, int]]:
    """(M, C, F) of each K2 site of one forward: the bottleneck blocks whose
    conv2 output has C and F = 4C multiples of 128 and M rows a multiple of
    128, the rule under which the port routes bn2 → relu → conv3 → bn3 to
    the kernel."""
    stages, kind = arch
    if kind != "bottleneck":
        return []
    sites, hw = [], image // 4
    for s, n in enumerate(stages):
        f = 64 * 2 ** s
        for b in range(n):
            hw //= 2 if s > 0 and b == 0 else 1
            m = frames * hw * hw
            if f % 128 == 0 and m % 128 == 0:
                sites.append((m, f, 4 * f))
    return sites


def k2_sites(backbone: str, frames: int, image: int) -> List[Tuple[int, int, int]]:
    return arch_k2_sites(ARCHS[backbone], frames, image)
