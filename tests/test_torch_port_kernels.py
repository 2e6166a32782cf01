"""The port's kernel modules against the JAX package: K1 (queue log-sum-exp)
and K2 (affine + relu + dot + moments). On the CPU the wrappers run their
plain versions (``chip_smoke.py`` holds the CUDA kernels against them on a
card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.ops.pallas import folded_dot_kernel as jk2
from vince_tpu.ops.pallas import infonce_kernel as jk1
from vince_tpu_torch.ops.kernels import folded_dot_kernel as tk2
from vince_tpu_torch.ops.kernels import infonce_kernel as tk1
from vince_tpu_torch.ops.kernels import plain_versions


def _queue_data(b=16, d=128, k=1024, seed=0):
    rng = np.random.RandomState(seed)
    norm = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    return norm(rng.randn(b, d).astype(np.float32)), norm(rng.randn(k, d).astype(np.float32))


def _fold_data(m=256, c=128, f=256, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, c).astype(np.float32),
            (np.abs(rng.randn(c)) + 0.5).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.randn(c, f) * 0.05).astype(np.float32))


@pytest.mark.parametrize("output", ["m", "s", "w"])
def test_queue_logsumexp_plain_matches_jax_reference(output):
    q, queue = _queue_data()
    ref = dict(zip("msw", jk1._reference_queue_logsumexp(jnp.asarray(q), jnp.asarray(queue), 0.07)))
    before = tk1.queue_logsumexp.plain_calls
    got = dict(zip("msw", tk1.queue_logsumexp_forward(
        torch.from_numpy(q), torch.from_numpy(queue), 0.07)))
    assert tk1.queue_logsumexp.plain_calls == before + 1
    np.testing.assert_allclose(got[output].numpy(), np.asarray(ref[output]), rtol=1e-5, atol=1e-6)


def test_queue_logsumexp_vjp_matches_jax():
    """dq through the port's autograd Function equals the JAX custom VJP."""
    q, queue = _queue_data()
    r = np.random.RandomState(1).rand(q.shape[0]).astype(np.float32)

    def loss(qq):
        m, s = jk1.queue_logsumexp(qq, jnp.asarray(queue), 0.07)
        return jnp.sum(s * r) + jnp.sum(m)

    g_jax = jax.grad(loss)(jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_(True)
    m, s = tk1.queue_logsumexp(qt, torch.from_numpy(queue), 0.07)
    assert not m.requires_grad  # m is detached, as in JAX
    ((s * torch.from_numpy(r)).sum() + m.sum()).backward()
    # f32 sums over 1024 keys in another order: 4.3e-5 relative at worst here
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(g_jax), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("output", ["out", "s1", "s2"])
def test_affine_relu_dot_moments_plain_matches_jax_reference(output):
    y, a, b, w = _fold_data()
    ref = dict(zip(("out", "s1", "s2"), jk2._reference(*map(jnp.asarray, (y, a, b, w)))))
    before = tk2.affine_relu_dot_moments.plain_calls
    got = dict(zip(("out", "s1", "s2"), tk2.affine_relu_dot_moments_forward(
        *map(torch.from_numpy, (y, a, b, w)))))
    assert tk2.affine_relu_dot_moments.plain_calls == before + 1
    np.testing.assert_allclose(got[output].numpy(), np.asarray(ref[output]), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("arg", ["y", "a", "b", "w"])
def test_affine_relu_dot_moments_backward_matches_jax_grad(arg):
    """The port's hand backward equals ``jax.grad`` through the JAX function
    (as ``tests/test_fold_kernel.py`` weighs the three outputs)."""
    y, a, b, w = _fold_data()

    def loss_jax(*xs):
        out, s1, s2 = jk2.affine_relu_dot_moments(*xs, False)
        return jnp.sum(out * 0.3) + jnp.sum(s1 * 0.7) + jnp.sum(s2 * 0.01)

    g_jax = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (y, a, b, w)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (y, a, b, w)]
    out, s1, s2 = tk2.affine_relu_dot_moments(*ts)
    ((out * 0.3).sum() + (s1 * 0.7).sum() + (s2 * 0.01).sum()).backward()
    i = "yabw".index(arg)
    np.testing.assert_allclose(ts[i].grad.numpy(), np.asarray(g_jax[i]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("m,c,f,ok", [(256, 1152, 256, True), (128, 2048, 8192, True),
                                      (100352, 128, 512, True), (256, 64, 256, False),
                                      (256, 128, 200, False), (0, 128, 128, False)])
def test_kernel_supported_takes_any_c_that_is_a_multiple_of_128(m, c, f, ok):
    """No cap on C any more (the JAX kernel has none): above 512 channels the
    CUDA kernel rebuilds x̂ for each chunk of F."""
    assert tk2.kernel_supported(m, c, f) is ok


@pytest.mark.parametrize("output", ["out", "s1", "s2"])
def test_affine_relu_dot_moments_plain_matches_jax_reference_at_c_1152(output):
    y, a, b, w = _fold_data(m=128, c=1152, f=128, seed=1)
    ref = dict(zip(("out", "s1", "s2"), jk2._reference(*map(jnp.asarray, (y, a, b, w)))))
    got = dict(zip(("out", "s1", "s2"), tk2.affine_relu_dot_moments_forward(
        *map(torch.from_numpy, (y, a, b, w)))))
    np.testing.assert_allclose(got[output].numpy(), np.asarray(ref[output]), rtol=1e-5, atol=1e-4)


def test_affine_relu_dot_moments_backward_matches_jax_grad_at_c_1152():
    """All four gradients at C = 1152 against ``jax.grad``, the loss of the
    test above."""
    y, a, b, w = _fold_data(m=128, c=1152, f=128, seed=2)

    def loss_jax(*xs):
        out, s1, s2 = jk2.affine_relu_dot_moments(*xs, False)
        return jnp.sum(out * 0.3) + jnp.sum(s1 * 0.7) + jnp.sum(s2 * 0.01)

    g_jax = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (y, a, b, w)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (y, a, b, w)]
    out, s1, s2 = tk2.affine_relu_dot_moments(*ts)
    ((out * 0.3).sum() + (s1 * 0.7).sum() + (s2 * 0.01).sum()).backward()
    for t, g in zip(ts, g_jax):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-5)


def test_cuda_tensor_never_takes_the_plain_version_silently():
    """On a CPU tensor the wrapper runs the plain version; ``plain_versions``
    is the only other way to reach it."""
    y, a, b, w = map(torch.from_numpy, _fold_data(m=128))
    before = tk2.affine_relu_dot_moments.plain_calls, tk2.affine_relu_dot_moments.launches
    with plain_versions():
        tk2.affine_relu_dot_moments_forward(y, a, b, w)
    assert tk2.affine_relu_dot_moments.plain_calls == before[0] + 1
    assert tk2.affine_relu_dot_moments.launches == before[1]
