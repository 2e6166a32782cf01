"""The tile that ``depthwise_kernel._tiling`` gives the depthwise CUDA kernels
(K4 and its filter gradient), held to the card's limits on the CPU, and the
bf16 identity that the filter gradient's packed product rests on."""

import numpy as np
import pytest
import torch

from vince_tpu_torch.ops.kernels import depthwise_kernel as tk
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

# the stride-1 depthwise sites of EfficientNet-B0 at batch 128, 224x224 (the
# shapes chip_smoke.py times), and B4's widest one: (N, H, W, C, k, itemsize)
PATH_SHAPES = [(128, 112, 112, 32, 3, 2), (128, 56, 56, 144, 3, 2), (128, 28, 28, 240, 5, 2),
               (128, 14, 14, 480, 3, 2), (128, 14, 14, 480, 5, 2), (128, 14, 14, 672, 5, 2),
               (128, 7, 7, 1152, 5, 2), (128, 7, 7, 1152, 3, 2), (128, 7, 7, 2688, 3, 2)]
# the ragged shapes that chip_smoke.py checks on the card
RAGGED_SHAPES = [(2, 16, 16, 32, 3, 2), (2, 12, 12, 144, 3, 2), (4, 9, 9, 240, 5, 2),
                 (3, 7, 5, 50, 5, 2), (2, 6, 5, 51, 3, 2), (3, 20, 9, 24, 5, 4),
                 (2, 19, 40, 12, 3, 4), (3, 9, 13, 8, 3, 2), (5, 9, 9, 72, 5, 2),
                 (11, 7, 7, 1152, 5, 2), (37, 14, 14, 200, 3, 2), (2, 3, 70, 36, 3, 2),
                 (3, 5, 6, 20, 5, 4), (1, 5, 300, 7, 5, 2), (70000, 3, 3, 2, 3, 4)]


def _ceil_div(a, b):
    return -(-a // b)


@pytest.mark.parametrize("wgrad", [False, True], ids=["forward", "wgrad"])
@pytest.mark.parametrize("n,h,w,c,k,itemsize", PATH_SHAPES + RAGGED_SHAPES)
def test_tile_fits_the_card(n, h, w, c, k, itemsize, wgrad):
    t = tk._tiling(n, h, w, c, k, itemsize, wgrad)
    # shared memory, threads and the grid inside CUDA's limits
    assert 0 < t.smem_bytes <= 232448
    assert t.threads == t.slots * t.groups * t.chunk // t.cpt <= 256
    assert 0 < t.ctas <= 2**31 - 1
    # 16-byte channel vectors where C allows, else a narrower one that divides C
    vc = t.vec_bytes // itemsize
    if (c * itemsize) % 16 == 0:
        assert t.vec_bytes == 16
    else:
        assert t.vec_bytes in (itemsize, 2 * itemsize)
    assert c % vc == 0 and c % t.cpt == 0 and vc % t.cpt == 0
    assert t.chunk % vc == 0 and t.pitch % vc == 0 and t.pitch >= t.chunk
    assert (t.pitch * itemsize) % t.vec_bytes == 0  # every staged pixel stays aligned
    assert t.cols in ((2, 4, 8) if k == 3 and t.vec_bytes == 16 else
                      (2, 4) if t.vec_bytes == 16 else (2,))
    # the grid covers the tensor: chunks x column tiles x bands x image groups
    assert t.images % t.slots == 0 and t.band_rows >= 1
    parts = (_ceil_div(w, t.groups * t.cols) * _ceil_div(h, t.band_rows)
             * _ceil_div(n, t.images))
    assert t.parts == parts and t.ctas == _ceil_div(c, t.chunk) * parts
    # a thread's share of one staged row fits the kernel's fixed number of copies
    per_thread = _ceil_div((t.cols + k - 1) * t.cpt, vc)
    vectors = t.slots * (t.groups * t.cols + k - 1) * (t.chunk // vc)
    assert vectors <= per_thread * t.threads


@pytest.mark.parametrize("wgrad", [False, True], ids=["forward", "wgrad"])
@pytest.mark.parametrize("n,h,w,c,k,itemsize", PATH_SHAPES)
def test_path_shapes_fill_the_card(n, h, w, c, k, itemsize, wgrad):
    """Two CTAs for each of the 132 SMs; for the filter gradient the partials,
    written once and read once in f32, stay under a tenth of the bytes of x and g."""
    t = tk._tiling(n, h, w, c, k, itemsize, wgrad)
    assert t.ctas >= 264
    if wgrad:
        partial_bytes = 2 * t.parts * k * k * c * 4
        assert partial_bytes <= 0.1 * 2 * n * h * w * c * itemsize


def test_tile_choices_can_be_fixed():
    """The measurement tool sweeps the tile through keyword arguments."""
    t = tk._tiling(128, 28, 28, 240, 5, 2, False, cols=2, chunk=48, images=4, band_rows=14)
    assert (t.cols, t.chunk, t.images, t.band_rows) == (2, 48, 4, 14)
    with pytest.raises(ValueError):
        tk._tiling(128, 112, 112, 32, 3, 2, False, cols=4, chunk=128, slots=8)


def test_bf16_product_is_the_rounded_f32_product():
    """a·b of two bf16 values, rounded once to bf16 (what one packed multiply
    gives), equals the f32 product of the widened values rounded to bf16: the
    f32 product of two 8-bit significands is exact. Random values, and a sweep
    of exponents down to where products are subnormal and up to overflow."""
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(1 << 16).astype(np.float32))
    b = torch.from_numpy(rng.randn(1 << 16).astype(np.float32))
    for ea in range(-70, 71, 7):
        for eb in (-60, -20, 0, 20, 60):
            x = (a * 2.0 ** ea).bfloat16()
            y = (b * 2.0 ** eb).bfloat16()
            assert torch.equal(x * y, (x.float() * y.float()).bfloat16())
