"""The port's SGD and LARS (``VinceOptimizer``, learning rate as a device
tensor) against the optax transforms of ``vince_tpu.solvers.vince_step.
build_vince_optimizer``: three updates of a small tree with a matrix, a conv
kernel, a bias and a zero matrix, the rate changing at each step, float32 on
the CPU."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vince_tpu.solvers import vince_step as jvs
from vince_tpu_torch.solvers import vince_step as tvs
from vince_tpu_torch.utils.jax_weights import _find_trace
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

RATES = (0.1, 0.05, 0.02)


def schedule(count):
    return jnp.asarray(RATES)[count]


def _tree(rng):
    return {"w": rng.randn(4, 3).astype(np.float32),
            "conv": rng.randn(2, 3, 3, 4).astype(np.float32),
            "b": rng.randn(4).astype(np.float32),
            # zero parameter norm; at the first step a zero gradient too, so
            # LARS's update norm is zero as well
            "z": np.zeros((3, 3), np.float32)}


@pytest.mark.parametrize("kind", ["sgd", "lars"])
def test_optimizer_matches_optax(kind):
    rng = np.random.RandomState(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in RATES]
    for name, g in grads[1].items():
        grads[1][name] = g + 1.0  # gradients of the zero matrix after its first step
    opt_j = jvs.build_vince_optimizer(schedule, kind)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    s_j = opt_j.init(p_j)

    spec = tvs.build_vince_optimizer(lambda step: RATES[step], kind)
    p_t = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt_t = spec.make(p_t.values())
    assert opt_t.lr.shape == () and opt_t.lr.dtype == torch.float32

    for step, g in enumerate(grads):
        upd, s_j = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, s_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for k, p in p_t.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt_t.set_lr(spec.lr(step))
        opt_t.step()
        trace_j = _find_trace(s_j)
        for k, p in p_t.items():
            close(p.detach().numpy(), p_j[k], f"{kind} step {step} param {k}")
            close(opt_t.state[p]["momentum_buffer"].numpy(), trace_j[k],
                  f"{kind} step {step} trace {k}")


def close(got, ref, msg):
    """rtol 1e-6, plus 1e-6 of the tensor's largest entry: LARS's norms are
    f32 sums in another order (one ulp in the trust ratio), and 0.9·t − lr·u
    cancels in a few entries, which magnifies that ulp there (2.8e-6
    relative on an entry 80 times smaller than the largest)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(), err_msg=msg)


def test_unknown_optimizer_kind_raises():
    with pytest.raises(ValueError, match="unknown optimizer kind"):
        tvs.build_vince_optimizer(0.1, "adam")
