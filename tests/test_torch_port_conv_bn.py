"""The port's fused affine + ReLU + conv3×3 + statistics op (K3) against the
JAX package's: the Pallas kernel in interpret mode for the forward, the custom
VJP for the gradients. On the CPU the wrapper runs its plain version
(``chip_smoke.py`` holds the CUDA kernel against it on a card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.ops.pallas import conv_bn_kernel as ck
from vince_tpu_torch.ops.kernels import conv_bn_kernel as tk
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)


def _data(n, h, w, c, f, seed=0, post_relu=False):
    rng = np.random.RandomState(seed)
    y_prev = rng.randn(n, h, w, c).astype(np.float32)
    if post_relu:
        y_prev = np.maximum(y_prev, 0.0)  # about half the entries exactly 0
    return (y_prev, (rng.rand(c) + 0.5).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.randn(3, 3, c, f) * 0.1).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 16), (1, 14, 7, 16, 8)])
@pytest.mark.parametrize("output", ["y", "s1", "s2"])
def test_forward_matches_pallas_interpret(shape, output):
    """f32 convolution sums in another order: 1e-5 of the output's largest
    entry (the JAX package's own test allows 1e-3)."""
    args = _data(*shape)
    ref = dict(zip(("y", "s1", "s2"),
                   ck._pallas_impl(*map(jnp.asarray, args), interpret=True)))
    before = tk.affine_conv3x3_stats.plain_calls
    got = dict(zip(("y", "s1", "s2"), tk.affine_conv3x3_stats(*map(torch.from_numpy, args))))
    assert tk.affine_conv3x3_stats.plain_calls == before + 1
    r = np.asarray(ref[output])
    np.testing.assert_allclose(got[output].numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("post_relu_input", [False, True])
@pytest.mark.parametrize("grad", ["y_prev", "a", "b", "kernel"])
def test_gradients_match_jax_vjp(post_relu_input, grad):
    """The four gradients against the JAX custom VJP, with the loss of the JAX
    package's test (all three outputs carry a cotangent). ``post_relu_input``
    puts exact zeros into x̂ where b is 0, which pins the strict x̂ > 0 mask.
    1e-4 of the gradient's largest entry: f32 sums in another order."""
    n, h, w, c, f = 1, 8, 8, 8, 8
    y_prev, a, b, k = _data(n, h, w, c, f, seed=1, post_relu=post_relu_input)
    if post_relu_input:
        b[::2] = 0.0  # x̂ = a·0 + 0 = 0 exactly on those channels' zeros
    coef = np.arange(f, dtype=np.float32)

    def loss(fn, args, np_):
        y, s1, s2 = fn(*args)
        return (y ** 2).mean() + (s1 * np_.asarray(coef)).sum() * 1e-3 + (s2 * 1e-4).sum()

    names = ("y_prev", "a", "b", "kernel")
    g_jax = dict(zip(names, jax.grad(lambda args: loss(ck.affine_conv3x3_stats, args, jnp))(
        tuple(map(jnp.asarray, (y_prev, a, b, k))))))
    ins = [torch.from_numpy(t).requires_grad_(True) for t in (y_prev, a, b, k)]
    loss(tk.affine_conv3x3_stats, ins, torch).backward()
    got = dict(zip(names, (t.grad.numpy() for t in ins)))
    if post_relu_input:
        xh = np.maximum(y_prev * a + b, 0.0)
        assert (xh == 0).mean() > 0.2 and (got["y_prev"][xh == 0] == 0).all()
    r = np.asarray(g_jax[grad])
    np.testing.assert_allclose(got[grad], r, rtol=1e-4, atol=1e-4 * np.abs(r).max())


def test_stats_describe_the_stored_output():
    """In bf16, s1 and s2 are sums of the rounded y, not of the f32 sums."""
    args = [torch.from_numpy(t) for t in _data(2, 6, 6, 8, 8, seed=2)]
    y, s1, s2 = tk.affine_conv3x3_stats(args[0].bfloat16(), *args[1:])
    assert y.dtype == torch.bfloat16 and s1.dtype == s2.dtype == torch.float32
    np.testing.assert_allclose(s1.numpy(), y.float().sum((0, 1, 2)).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), y.float().square().sum((0, 1, 2)).numpy(), rtol=1e-5)


@pytest.mark.parametrize("y_shape,k_shape,kwargs,ok", [
    ((2, 28, 28, 128), (3, 3, 128, 128), {}, True),
    ((128, 14, 14, 256), (3, 3, 256, 256), {}, True),
    ((2, 56, 56, 128), (3, 3, 128, 128), {}, True),    # H > 32: a VMEM limit, not carried over
    ((2, 56, 56, 64), (3, 3, 64, 64), {}, False),      # C % 128 != 0
    ((2, 28, 28, 128), (3, 3, 128, 128), {"stride": (2, 2)}, False),
    ((2, 28, 28, 128), (3, 3, 128, 128), {"dilation": (2, 2)}, False),
    ((2, 28, 28, 128), (1, 1, 128, 128), {}, False),   # not 3×3
    ((2, 1, 28, 128), (3, 3, 128, 128), {}, False),    # H < 2
])
def test_kernel_supported(y_shape, k_shape, kwargs, ok):
    assert tk.kernel_supported(y_shape, k_shape, **kwargs) is ok
    # the port takes every shape the JAX rule takes
    if ck.kernel_supported(jnp.zeros(y_shape, jnp.bfloat16), jnp.zeros(k_shape), **kwargs):
        assert ok
