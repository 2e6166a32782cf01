"""Carry the JAX package's weights and state into the port.

Input is what ``jax.tree_util.tree_map(np.asarray, …)`` gives: the flax
``(params, batch_stats)`` trees as nested dicts of numpy arrays or, for
``load_jax_state`` and ``load_jax_end_task_state``, a whole ``VinceState`` or
``EndTaskState`` with numpy leaves. Layouts:
conv kernel [kh, kw, I, O] → weight [O, I, kh, kw]; Dense kernel [I, O] →
weight [O, I]; BatchNorm scale/bias → weight/bias, mean/var →
running_mean/running_var. Nothing here imports JAX.
"""

import re
from typing import Any, Dict

import numpy as np
import torch

_BLOCK_MODULES = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
# EfficientNet: flax module names -> efficientnet_pytorch's
_EFFNET_TOP = {"stem_conv": "_conv_stem", "stem_bn": "_bn0",
               "head_conv": "_conv_head", "head_bn": "_bn1"}
# the heads beside the backbone, under their flax names (AveragePool has no parameters)
_HEADS = ("pool", "embedding", "jigsaw", "imagenet_decoder_0", "imagenet_decoder_1")
# the port's head names → the reference VinceModel's (``torch_export``'s naming)
_REFERENCE_HEADS = (
    (r"^pool\.attn_logits\.", "average_layers.attention."),
    (r"^embedding\.fc1\.", "embedding.0."),
    (r"^embedding\.fc2\.", "embedding.2."),
    (r"^jigsaw\.jigsaw_linear\.", "jigsaw_linear."),
    (r"^jigsaw\.fc1\.", "jigsaw_embedding.0."),
    (r"^jigsaw\.fc2\.", "jigsaw_embedding.2."),
    (r"^imagenet_decoder_0\.fc_out\.", "imagenet_decoders.0."),
    (r"^imagenet_decoder_1\.fc0\.", "imagenet_decoders.1.0."),
    (r"^imagenet_decoder_1\.fc_out\.", "imagenet_decoders.1.2."),
)
_MBCONV_MODULES = {"expand_conv": "_expand_conv", "expand_bn": "_bn0",
                   "depthwise_conv": "_depthwise_conv", "depthwise_bn": "_bn1",
                   "project_conv": "_project_conv", "project_bn": "_bn2"}


def _emit(out: Dict, name: str, leafs: Dict, stats) -> None:
    if "kernel" in leafs:
        k = np.asarray(leafs["kernel"], np.float32)
        out[f"{name}.weight"] = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        if "bias" in leafs:
            out[f"{name}.bias"] = np.asarray(leafs["bias"], np.float32)
    elif "scale" in leafs:
        out[f"{name}.weight"] = np.asarray(leafs["scale"], np.float32)
        out[f"{name}.bias"] = np.asarray(leafs["bias"], np.float32)
        if stats is not None:
            out[f"{name}.running_mean"] = np.asarray(stats["mean"], np.float32)
            out[f"{name}.running_var"] = np.asarray(stats["var"], np.float32)
    else:
        raise ValueError(f"unknown flax module at {name}: {sorted(leafs)}")


def flax_to_state_dict(params: Dict, batch_stats: Dict) -> Dict[str, np.ndarray]:
    """``VinceEncoder`` flax trees (ResNet or EfficientNet backbone, and the
    heads it has) → the port's ``state_dict`` names and layouts."""
    out: Dict[str, np.ndarray] = {}
    stats = batch_stats.get("backbone", {})
    for name, p in params["backbone"].items():
        s = stats.get(name, {})
        m = re.match(r"layer(\d+)_(\d+)$", name)
        mb = re.match(r"block_(\d+)$", name)
        if m:
            for mod, leafs in p.items():
                _emit(out, f"backbone.layer{m[1]}.{m[2]}.{_BLOCK_MODULES.get(mod, mod)}",
                      leafs, s.get(mod))
        elif mb:
            for mod, leafs in p.items():
                if mod == "se":  # two biased 1×1 convs, no statistics
                    for se_mod in ("reduce", "expand"):
                        _emit(out, f"backbone._blocks.{mb[1]}._se_{se_mod}", leafs[se_mod], None)
                else:
                    _emit(out, f"backbone._blocks.{mb[1]}.{_MBCONV_MODULES[mod]}",
                          leafs, s.get(mod))
        elif name in _EFFNET_TOP:
            _emit(out, f"backbone.{_EFFNET_TOP[name]}", p, stats.get(name))
        else:
            _emit(out, f"backbone.{name}", p, stats.get(name))
    for head in _HEADS:
        for name, leafs in params.get(head, {}).items():
            _emit(out, f"{head}.{name}", leafs, None)
    return out


def to_reference_name(name: str) -> str:
    """The port's parameter name → the reference ``VinceModel`` state-dict name
    (the naming of ``export_vince_state_dict`` in ``vince_tpu/utils/torch_export.py``)."""
    name = re.sub(r"^backbone\.", "feature_extractor.module.model.", name)
    for pattern, ref in _REFERENCE_HEADS:
        name = re.sub(pattern, ref, name)
    return name


def _tensors(arrays: Dict[str, np.ndarray], like: torch.nn.Module) -> Dict[str, torch.Tensor]:
    # copies: a numpy view of a JAX buffer must not become a tensor that the
    # optimizer then updates in place
    ref = like.state_dict()
    return {k: torch.from_numpy(np.array(v, copy=True)).to(ref[k].device, ref[k].dtype)
            for k, v in arrays.items()}


def load_jax_variables(model: torch.nn.Module, params: Dict, batch_stats: Dict) -> None:
    """Load flax ``(params, batch_stats)`` into a ``VinceEncoder``; every
    parameter and buffer must be covered."""
    model.load_state_dict(_tensors(flax_to_state_dict(params, batch_stats), model), strict=True)


def _find_trace(opt_state: Any):
    """The momentum ``trace`` tree inside an optax SGD or LARS state: the
    field of optax's ``TraceState`` (a named tuple), not an array's ``trace``
    method, which LARS's schedule count ahead of it also has."""
    if "trace" in getattr(opt_state, "_fields", ()):
        return opt_state.trace
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            t = _find_trace(s)
            if t is not None:
                return t
    return None


def load_jax_state(state, jax_state) -> None:
    """Load a JAX ``VinceState`` with numpy leaves into the port's state: query
    and key weights and statistics, the queue with its pointers, the step and
    the momentum traces of its SGD or LARS (the port's optimizer keeps optax's
    trace of its kind). The key encoder takes its tracked parameters from
    ``key_params`` and the rest (the ImageNet decoders, which no key path
    reads) from ``params``, as the JAX prefill merges them. Tensors are written in place, so a captured step bound
    to ``state`` replays on the loaded values."""
    load_jax_variables(state.model, jax_state.params, jax_state.batch_stats)
    key_params = dict(jax_state.params)
    key_params.update(jax_state.key_params)
    load_jax_variables(state.key_model, key_params, jax_state.key_batch_stats)
    q = jax_state.queue
    dev = state.queue.vectors.device
    state.queue.vectors.copy_(torch.from_numpy(np.array(q.vectors, np.float32)).to(dev))
    state.queue.sources.copy_(torch.from_numpy(np.array(q.sources, np.int32)).to(dev))
    state.queue.tail.fill_(int(q.tail))
    state.queue.total.fill_(int(q.total))
    state.queue.inserted = int(q.total)
    state.step = int(jax_state.step)
    trace = _find_trace(jax_state.opt_state)
    if trace is not None:
        buffers = _tensors(flax_to_state_dict(trace, {}), state.model)
        params = dict(state.model.named_parameters())
        for name, buf in buffers.items():
            state.optimizer.state[params[name]]["momentum_buffer"].copy_(buf)


# flax LSTMCell's gate modules in torch's gate order i, f, g, o
_LSTM_INPUT_GATES = ("ii", "if", "ig", "io")
_LSTM_HIDDEN_GATES = ("hi", "hf", "hg", "ho")


def flax_decoder_to_state_dict(params: Dict) -> Dict[str, np.ndarray]:
    """An end-task decoder's flax tree → the port's names and layouts:
    ``MultiLinearModel``'s ``classifier_{i}/{fc0,fc_out}``,
    ``Kinetics400Model``'s ``LSTMCell_0`` (the gates' kernels, transposed and
    stacked in torch's order, and the hidden side's biases as ``bias_hh_l0``;
    the input side has no bias) and ``fc``, and ``SiamFCTrackingModel``'s
    ``exemplar_decoder`` and ``search_patch_decoder`` (1×1 kernels
    [1, 1, C, 256] → weight [256, C, 1, 1], and the biases). Also maps an
    optimizer buffer of that tree's shape."""
    out: Dict[str, np.ndarray] = {}
    for top, sub in params.items():
        if top == "LSTMCell_0":
            for key, gates in (("weight_ih_l0", _LSTM_INPUT_GATES),
                               ("weight_hh_l0", _LSTM_HIDDEN_GATES)):
                out[f"lstm.{key}"] = np.concatenate(
                    [np.asarray(sub[g]["kernel"], np.float32).T for g in gates])
            out["lstm.bias_hh_l0"] = np.concatenate(
                [np.asarray(sub[g]["bias"], np.float32) for g in _LSTM_HIDDEN_GATES])
        elif "kernel" in sub:
            _emit(out, top, sub, None)
        else:
            for name, leafs in sub.items():
                _emit(out, f"{top}.{name}", leafs, None)
    return out


def _unmasked(tree):
    """The tree without optax's ``MaskedNode``s (empty named tuples), which
    stand where a parameter belongs to another group."""
    if isinstance(tree, dict):
        kept = {k: _unmasked(v) for k, v in tree.items()}
        return {k: v for k, v in kept.items() if v is not None}
    return None if isinstance(tree, tuple) and not tree else tree


def _group_buffers(inner) -> Dict[str, Any]:
    """The optax buffers of one group's chain state: SGD's ``trace``, Adam's
    ``mu`` and ``nu``, and the update count (None for ``set_to_zero``)."""
    found: Dict[str, Any] = {}

    def walk(s):
        fields = getattr(s, "_fields", ())
        for f in ("trace", "mu", "nu", "count"):
            if f in fields and f not in found:
                found[f] = getattr(s, f)
        if isinstance(s, (tuple, list)):
            for x in s:
                walk(x)

    walk(inner)
    return found


def load_jax_end_task_state(state, jax_state) -> None:
    """Load a JAX ``EndTaskState`` with numpy leaves into the port's, for any
    of the three tasks: the encoder's weights and statistics, the decoder, the
    step, and each optimizer group's buffers (SGD's trace, as the tracking
    task's groups hold it; Adam's ``mu``, ``nu``) and update count. The LSTM's
    ``bias_ih_l0``, which flax does not have, is zero."""
    load_jax_variables(state.encoder, jax_state.encoder_params, jax_state.encoder_batch_stats)
    decoder = flax_decoder_to_state_dict(jax_state.decoder_params)
    if "lstm.bias_ih_l0" in state.decoder.state_dict():
        decoder["lstm.bias_ih_l0"] = np.zeros_like(decoder["lstm.bias_hh_l0"])
    state.decoder.load_state_dict(_tensors(decoder, state.decoder), strict=True)
    state.step = int(jax_state.step)
    opt = state.optimizer
    for label, masked in jax_state.opt_state.inner_states.items():
        found = _group_buffers(masked.inner_state)
        if "count" in found:
            opt.count = int(found["count"])
        for kind in ("trace", "mu", "nu"):
            if kind not in found:
                continue
            tree = _unmasked(found[kind])
            arrays = {}
            if "decoder" in tree:
                arrays.update({f"decoder.{k}": v for k, v in
                               flax_decoder_to_state_dict(tree["decoder"]).items()})
            if "encoder" in tree:
                arrays.update({f"encoder.{k}": v for k, v in
                               flax_to_state_dict(tree["encoder"], {}).items()})
            for name, v in arrays.items():
                buf = opt.state[name][kind]
                buf.copy_(torch.from_numpy(np.array(v, copy=True)).to(buf.device, buf.dtype))
