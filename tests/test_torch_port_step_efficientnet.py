"""The second slice: two VINCE train steps of the port with an EfficientNet-B0
backbone against ``vince_tpu.solvers.vince_step.make_train_step_fn`` on a 1x1
mesh: 64x64 images, 8 frames (2 videos x 4), queue 64, embeddings 128, fused
InfoNCE, ``bn_fold="expand"``, ``dw_kind="kernel"``, float32 on the CPU. The
JAX side runs ``dw_kind="conv"``: its own kernel emission is the grouped
convolution on the CPU. Same inputs, state and checks as the ResNet50 slice in
``test_torch_port_step.py``."""

import numpy as np
import pytest

from tests.test_torch_port_step import (
    BATCH, METRICS, QUEUE, STEPS, check_momentum_buffers, run_steps)
from vince_tpu_torch.ops.kernels.depthwise_kernel import depthwise_conv
from vince_tpu_torch.ops.kernels.infonce_kernel import queue_logsumexp
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)


@pytest.fixture(scope="module")
def runs():
    return run_steps((queue_logsumexp, depthwise_conv), {"dw_kind": "conv"},
                     backbone="EfficientNetB0", dw_kind="kernel", se_kind="mul")


@pytest.mark.parametrize("step", range(STEPS))
def test_step_metrics(runs, step):
    got, ref = runs[step]["metrics"]
    for k in METRICS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("which", ["params", "key_params"])
def test_step_weights_and_batch_stats(runs, step, which):
    """Weights, SGD-updated, and BN running statistics of the query and key
    encoders: every element to 1e-4 relative plus 5e-4, and each tensor's
    change since the start to 5% in norm (f32 sums in another order through
    16 blocks and the derived-statistic fold), as for the ResNet50 slice, plus
    1e-6: a BN bias whose block has no residual feeds a 1×1 conv and the next
    BN, which removes any shift, so its gradient is zero in exact arithmetic
    and its update of ~1e-7 is rounding noise on both sides."""
    got, ref = runs[step][which]
    init = runs[step]["init"]
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=5e-4, err_msg=k)
        if which == "params":
            d_got, d_ref = got[k] - init[k], ref[k] - init[k]
            assert np.linalg.norm(d_got - d_ref) <= 5e-2 * np.linalg.norm(d_ref) + 1e-6, k


@pytest.mark.parametrize("step", range(STEPS))
def test_step_momentum_buffers(runs, step):
    check_momentum_buffers(*runs[step]["momentum"])


@pytest.mark.parametrize("step", range(STEPS))
def test_step_queue(runs, step):
    (v, s, tail, total), (v_j, s_j, tail_j, total_j) = runs[step]["queue"]
    np.testing.assert_allclose(v, v_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(s, s_j)
    assert (tail, total) == (tail_j, total_j) == ((step + 1) * BATCH % QUEUE, (step + 1) * BATCH)


@pytest.mark.parametrize("step", range(STEPS))
def test_step_runs_both_plain_kernels(runs, step):
    """Per step: one K1 call; K4 at the 5 stride-1 sites that are at least as
    large as their filter at 64x64 (blocks 0, 2, 4, 6, 7), in the key forward,
    the query forward and the query backward (dgrad)."""
    assert runs[step]["calls"] == (1, 15)
