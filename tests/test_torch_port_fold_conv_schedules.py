"""The schedules of the fused 1×1 kernel (K2: ``folded_dot_kernel.plan``) and
of the fused 3×3 kernel (K3: ``conv_bn_kernel._tiling``), held on the CPU to
covering every output element exactly once and to the card's limits.

These tests hold the Python model of each schedule: ``main_tiles``,
``moment_tiles`` and ``output_pixels`` restate the kernels' index arithmetic,
and ``_smem_bytes`` the source's shared-memory count. The kernels themselves
are held on the card by ``chip_smoke.py``: it compares every output element
with the plain version at the sites' and at ragged shapes (an element no CTA
stored holds memory of an earlier, unrelated computation), and it holds
``_smem_bytes`` equal to the source's count. K3's C entry refuses a launch
whose partials have another number of rows than it has CTAs."""

import math

import numpy as np
import pytest

from vince_tpu_torch.ops.kernels import conv_bn_kernel as k3
from vince_tpu_torch.ops.kernels import folded_dot_kernel as k2

# (M, C, F) of the K2 sites: ResNet50 and ResNet101 (the same shapes, more
# sites) at batch 128 and 32, stage 4 of ResNet50 at four times the width,
# and ragged rows with C no power of two or above the 512 kept in shared memory
K2_SHAPES = [(100352, 128, 512), (25088, 256, 1024), (6272, 512, 2048),
             (25088, 128, 512), (6272, 256, 1024), (1568, 512, 2048),
             (6272, 2048, 8192),
             (200, 128, 256), (200, 384, 256), (130, 768, 128), (200, 1152, 384),
             (130, 2048, 256), (1000, 512, 2048), (64, 128, 128), (1, 128, 128)]
# (N, H, W, F) of the K3 sites: ResNet18/50/101 3×3 convs at batch 128 and 32
# with C % 128 = 0, and ragged shapes
K3_SHAPES = [(128, 28, 28, 128), (128, 14, 14, 256), (128, 7, 7, 512),
             (32, 28, 28, 128), (32, 14, 14, 256), (32, 7, 7, 512),
             (3, 10, 6, 256), (2, 5, 33, 20), (1, 40, 3, 136), (5, 7, 7, 512),
             (7, 2, 9, 128), (2, 3, 70, 128), (1, 2, 2, 128)]


@pytest.mark.parametrize("m,c,f", K2_SHAPES)
def test_k2_main_tiles_cover_out_once(m, c, f):
    p = k2.plan(m, c, f)
    assert 1 <= p.grid <= 132 and (f // 128) % p.fsplit == 0
    assert p.sc % 128 == 0 and c % p.sc == 0 and p.sc <= 512 and (c > 512 or p.sc == c)
    count = np.zeros((math.ceil(m / 64), f // 128), np.int32)
    for (r0, r1), (f0, f1) in k2.main_tiles(m, f, p):
        assert r0 % 64 == 0 and r1 == min(r0 + 64, m) and f1 - f0 == 128
        count[r0 // 64, f0 // 128] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("m,c,f", K2_SHAPES)
def test_k2_moment_tiles_cover_s2_and_s1_once_per_split(m, c, f):
    p = k2.plan(m, c, f)
    assert p.rows % 64 == 0 and p.msplit * p.rows >= m > (p.msplit - 1) * p.rows
    blocks = c // 64
    count = np.zeros((p.msplit, blocks, blocks), np.int32)
    s1 = np.zeros((p.msplit, c // 128), np.int32)
    rows = set()
    for split, (r0, r1), (i0, i1), (j0, j1), mirrored in k2.moment_tiles(m, c, p):
        assert r0 < r1 and i1 - i0 == 64 and j1 - j0 == 128
        rows.add((r0, r1))
        count[split, i0 // 64, j0 // 64:j1 // 64] += 1
        if mirrored:
            count[split, j0 // 64:j1 // 64, i0 // 64] += 1
        elif i0 % 128 == 0:  # a diagonal tile sums its 128 channels once
            s1[split, i0 // 128] += 1
    assert (count == 1).all() and (s1 == 1).all()
    covered = np.zeros(m, np.int32)
    for r0, r1 in rows:
        covered[r0:r1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("n,h,w,f", K3_SHAPES)
def test_k3_tiles_cover_every_pixel_once_and_fit(n, h, w, f):
    tile = k3._tiling(n, h, w, f)
    pw = 1 + tile.images * (tile.cols + 1)
    assert tile.rows * pw <= 256 and tile.rows <= h and tile.cols <= w
    assert tile.images == 1 or tile.cols == w  # images side by side span the width
    assert k3._smem_bytes(tile) <= k3._SMEM_LIMIT
    count = np.zeros((n, h, w), np.int32)
    ctas = set()
    for cta, *pixel in k3.output_pixels(n, h, w, tile):
        count[tuple(pixel)] += 1
        ctas.add(cta)
    assert (count == 1).all()
    assert ctas == set(range(k3._parts(n, h, w, tile)))  # one row of partials each


def test_k3_packs_images_on_the_smallest_map():
    """At 7×7 a CTA holds several images side by side, so that most of its
    wgmma rows are output pixels (one image fills 49 of 64)."""
    tile = k3._tiling(128, 7, 7, 512)
    pw = 1 + tile.images * (tile.cols + 1)
    assert tile.images > 1
    assert tile.images * 49 / (math.ceil(tile.rows * pw / 64) * 64) > 0.7
