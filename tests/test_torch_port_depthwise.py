"""The port's depthwise convolution (K4) against the JAX package's Pallas
kernel run in interpret mode. On the CPU the wrapper runs its plain version
(``chip_smoke.py`` holds the CUDA kernel against it on a card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.ops.pallas import depthwise_kernel as dk
from vince_tpu_torch.ops.kernels import depthwise_kernel as tk

# the shapes of tests/test_depthwise_kernel.py: (N, H, W, C, k)
SHAPES = [(2, 16, 16, 32, 3), (2, 12, 12, 144, 3), (4, 9, 9, 240, 5), (2, 7, 7, 256, 3)]
# and shapes that cross the CUDA kernels' tile edges (chip_smoke.py checks them
# on the card): W no multiple of the columns per thread, one 16-byte vector of
# channels, a ragged last chunk, odd N, fewer rows than the ring holds
SHAPES += [(3, 9, 13, 8, 3), (5, 9, 9, 72, 5), (11, 7, 7, 72, 5), (5, 14, 14, 200, 3),
           (2, 3, 70, 36, 3), (3, 5, 6, 20, 5)]


def _data(n, h, wd, c, k, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h, wd, c).astype(np.float32),
            (rng.randn(k, k, 1, c) * 0.1).astype(np.float32),
            rng.randn(n, h, wd, c).astype(np.float32))


@pytest.mark.parametrize("n,h,wd,c,k", SHAPES)
def test_forward_matches_pallas_interpret(n, h, wd, c, k):
    """f32 sums of k² products in the same order on both sides: 1e-6 relative,
    1e-6 absolute (XLA may contract a product and a sum into one fma)."""
    x, w, _ = _data(n, h, wd, c, k)
    ref = dk.depthwise_conv_pallas(jnp.asarray(x), jnp.asarray(w), True)
    before = tk.depthwise_conv.plain_calls
    got = tk.depthwise_conv(torch.from_numpy(x), torch.from_numpy(w))
    assert tk.depthwise_conv.plain_calls == before + 1
    assert got.shape == (n, h, wd, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,h,wd,c,k", SHAPES)
def test_gradients_match_pallas_vjp(n, h, wd, c, k):
    """dx (the same convolution with the flipped filter) and dw (k² shifted
    multiply-reduces) against the JAX custom VJP. dx sums k² terms: 1e-5; dw
    sums N·H·W products in f32 in another order: 1e-4 relative to its largest
    entry."""
    x, w, ct = _data(n, h, wd, c, k, seed=1)
    gx, gw = jax.grad(lambda x_, w_: jnp.sum(dk.depthwise_conv_pallas(x_, w_, True) * ct),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    before, before_w = tk.depthwise_conv.plain_calls, tk.depthwise_wgrad.plain_calls
    (tk.depthwise_conv(xt, wt) * torch.from_numpy(ct)).sum().backward()
    assert tk.depthwise_conv.plain_calls == before + 2  # the forward and the dgrad
    assert tk.depthwise_wgrad.plain_calls == before_w + 1
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    gw = np.asarray(gw)
    np.testing.assert_allclose(wt.grad.numpy(), gw, rtol=1e-4, atol=1e-4 * np.abs(gw).max())


def test_bf16_rounds_once_from_f32_sums():
    """In bf16 the plain version widens each tap and weight, sums in f32 and
    rounds once: it equals the f32 result of the bf16-rounded inputs, rounded."""
    x, w, _ = _data(2, 8, 8, 16, 5, seed=2)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = tk.depthwise_conv(xb, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    ref = tk.depthwise_conv(xb.float(), wb.float()).bfloat16()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape,k,stride,ok", [
    ((2, 16, 16, 32), 3, 1, True),
    ((2, 16, 16, 32), 5, 1, True),
    ((2, 16, 16, 32), 3, 2, False),   # stride 2
    ((2, 16, 16, 32), 4, 1, False),   # even k
    ((2, 2, 2, 32), 5, 1, False),     # smaller than the filter
    ((128, 112, 112, 32), 3, 1, True),  # no VMEM budget on a GPU: B0's block_0 runs
])
def test_kernel_supported(shape, k, stride, ok):
    assert tk.kernel_supported(shape, k, stride) is ok
    if dk.kernel_supported(shape, k, stride):  # the port takes what the JAX rule takes
        assert ok
