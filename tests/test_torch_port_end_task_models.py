"""The port's end-task decoders against ``vince_tpu.models``: ``MultiLinearModel``
and ``classifier_losses``, ``Kinetics400Model`` and ``kinetics_losses``, with
flax weights carried by ``flax_decoder_to_state_dict``, reduced and per
sample; one Adam step with weight decay of the LSTM decoder against optax,
which holds the LSTM to flax's one bias per gate. float32 on the CPU, to
1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_port_runner import one_intra_op_thread  # noqa: F401
from vince_tpu.models.kinetics_model import Kinetics400Model as JaxKinetics400Model
from vince_tpu.models.kinetics_model import kinetics_losses as jax_kinetics_losses
from vince_tpu.models.linear_model import MultiLinearModel as JaxMultiLinearModel
from vince_tpu.models.linear_model import classifier_losses as jax_classifier_losses
from vince_tpu_torch.models.kinetics_model import Kinetics400Model, kinetics_losses
from vince_tpu_torch.models.linear_model import MultiLinearModel, classifier_losses
from vince_tpu_torch.solvers.end_task_step import EndTaskOptimizer
from vince_tpu_torch.utils.jax_weights import flax_decoder_to_state_dict

RTOL, ATOL = 1e-5, 1e-6
B, T, F, HIDDEN, CLASSES = 6, 5, 24, 16, 7


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def _perturbed_init(module, x, seed=0):
    """flax init, every leaf then moved off its init (the biases start at 0)."""
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.randn(*p.shape)).astype(np.float32), params)


def _load(module, params):
    arrays = flax_decoder_to_state_dict(params)
    if "lstm.bias_ih_l0" in module.state_dict():
        arrays["lstm.bias_ih_l0"] = np.zeros(4 * module.hidden_size, np.float32)
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in arrays.items()},
                           strict=True)
    return module


def _labels(n, seed=2):
    return np.random.RandomState(seed).randint(0, CLASSES, n).astype(np.int32)


def test_flax_names_of_the_decoders():
    """The trees that ``flax_decoder_to_state_dict`` reads: ``classifier_{i}``
    of ``MultiLayerLinear``s, and ``LSTMCell_0`` (kernels on the input side,
    kernels and biases on the hidden side) with ``fc``."""
    x = np.zeros((2, T, F), np.float32)
    lstm = JaxKinetics400Model(CLASSES, HIDDEN).init(jax.random.PRNGKey(0), x)["params"]
    assert sorted(lstm) == ["LSTMCell_0", "fc"]
    assert {k: sorted(v) for k, v in lstm["LSTMCell_0"].items()} == {
        **{g: ["kernel"] for g in ("ii", "if", "ig", "io")},
        **{g: ["bias", "kernel"] for g in ("hi", "hf", "hg", "ho")}}
    probe = JaxMultiLinearModel(CLASSES).init(jax.random.PRNGKey(0), x[:, 0])["params"]
    assert {k: sorted(v) for k, v in probe.items()} == {
        "classifier_0": ["fc_out"], "classifier_1": ["fc0", "fc_out"]}
    assert sorted(flax_decoder_to_state_dict(lstm)) == [
        "fc.bias", "fc.weight", "lstm.bias_hh_l0", "lstm.weight_hh_l0", "lstm.weight_ih_l0"]


@pytest.mark.parametrize("reduce", [True, False])
def test_multi_linear_model_and_classifier_losses_match_jax(reduce):
    x = np.random.RandomState(1).randn(B, F).astype(np.float32)
    labels = _labels(B)
    jmod = JaxMultiLinearModel(CLASSES)
    params = _perturbed_init(jmod, x)
    ref_logits = jmod.apply({"params": params}, jnp.asarray(x))
    model = _load(MultiLinearModel(F, CLASSES), params)
    logits = model(torch.from_numpy(x))
    assert len(logits) == 2 and model.classifier_1.hidden == ["fc0"]
    for got, ref in zip(logits, ref_logits):
        _close(got.detach(), ref)
    ref = jax_classifier_losses(ref_logits, jnp.asarray(labels), reduce=reduce)
    out = classifier_losses(logits, torch.from_numpy(labels), reduce=reduce)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].shape == ((() if reduce else (B,)))
        _close(out[k].detach(), ref[k])


@pytest.mark.parametrize("reduce", [True, False])
def test_kinetics_model_and_losses_match_jax(reduce):
    x = np.random.RandomState(1).randn(B, T, F).astype(np.float32)
    labels = _labels(B)
    jmod = JaxKinetics400Model(CLASSES, HIDDEN)
    params = _perturbed_init(jmod, x)
    ref_logits = jmod.apply({"params": params}, jnp.asarray(x))
    model = _load(Kinetics400Model(F, CLASSES, HIDDEN), params)
    # bf16 features: the LSTM runs in f32 on them, as flax promotes its Dense
    xb = torch.from_numpy(x).bfloat16()
    logits = model(torch.from_numpy(x))
    _close(logits.detach(), ref_logits)
    assert model(xb).dtype == torch.float32
    ref = jax_kinetics_losses(ref_logits, jnp.asarray(labels), reduce=reduce)
    out = kinetics_losses(logits, torch.from_numpy(labels), reduce=reduce)
    assert sorted(out) == sorted(ref)
    for k in ref:
        _close(out[k].detach(), ref[k])


def _adam_step(model, x, labels, bias_ih_trainable=False):
    """One step of the port's Adam (weight decay 1e-4, rate 0.01) on the
    decoder's CE; with ``bias_ih_trainable`` the LSTM's input-side bias is
    a second trained bias, as a plain ``nn.LSTM`` would have."""
    model.lstm.bias_ih_l0.requires_grad_(bias_ih_trainable)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    opt = EndTaskOptimizer({"decoder": named}, "adam", lambda step: 0.01, {"decoder": 1.0}, 1e-4)
    loss = kinetics_losses(model(torch.from_numpy(x)), torch.from_numpy(labels))
    loss["loss/classifier_loss_0"].backward()
    opt.step()
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def test_one_adam_step_of_the_lstm_decoder_matches_optax():
    x = np.random.RandomState(1).randn(B, T, F).astype(np.float32)
    labels = _labels(B)
    jmod = JaxKinetics400Model(CLASSES, HIDDEN)
    params = _perturbed_init(jmod, x)
    tx = optax.chain(optax.add_decayed_weights(1e-4), optax.adam(0.01))

    def loss_fn(p):
        logits = jmod.apply({"params": p}, jnp.asarray(x))
        return jax_kinetics_losses(logits, jnp.asarray(labels))["loss/classifier_loss_0"]

    grads = jax.grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    ref = flax_decoder_to_state_dict(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, updates)))

    got = _adam_step(_load(Kinetics400Model(F, CLASSES, HIDDEN), params), x, labels)
    assert set(ref) == set(got) - {"lstm.bias_ih_l0"}
    for k in ref:
        _close(got[k], ref[k], rtol=1e-5, atol=1e-6)
    assert not got["lstm.bias_ih_l0"].any()

    # a trained second bias moves the gates' bias by two Adam steps where flax
    # moves it by one: the sum of the biases is off by about the rate
    two = _adam_step(_load(Kinetics400Model(F, CLASSES, HIDDEN), params), x, labels,
                     bias_ih_trainable=True)
    gap = np.abs(two["lstm.bias_ih_l0"] + two["lstm.bias_hh_l0"] - ref["lstm.bias_hh_l0"])
    assert np.median(gap) > 5e-3
