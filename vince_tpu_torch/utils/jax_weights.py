"""Carry the JAX package's weights and state into the port.

Input is what ``jax.tree_util.tree_map(np.asarray, …)`` gives: the flax
``(params, batch_stats)`` trees as nested dicts of numpy arrays or, for
``load_jax_state``, a whole ``VinceState`` with numpy leaves. Layouts:
conv kernel [kh, kw, I, O] → weight [O, I, kh, kw]; Dense kernel [I, O] →
weight [O, I]; BatchNorm scale/bias → weight/bias, mean/var →
running_mean/running_var. Nothing here imports JAX.
"""

import re
from typing import Any, Dict

import numpy as np
import torch

_BLOCK_MODULES = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


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
    """``VinceEncoder`` flax trees → the port's ``state_dict`` names and layouts."""
    out: Dict[str, np.ndarray] = {}
    stats = batch_stats.get("backbone", {})
    for name, p in params["backbone"].items():
        m = re.match(r"layer(\d+)_(\d+)$", name)
        if m:
            s = stats.get(name, {})
            for mod, leafs in p.items():
                _emit(out, f"backbone.layer{m[1]}.{m[2]}.{_BLOCK_MODULES.get(mod, mod)}",
                      leafs, s.get(mod))
        else:
            _emit(out, f"backbone.{name}", p, stats.get(name))
    for name, leafs in params.get("embedding", {}).items():
        _emit(out, f"embedding.{name}", leafs, None)
    return out


def to_reference_name(name: str) -> str:
    """The port's parameter name → the reference ``VinceModel`` state-dict name
    (the naming of ``export_vince_state_dict`` in ``vince_tpu/utils/torch_export.py``)."""
    name = re.sub(r"^backbone\.", "feature_extractor.module.model.", name)
    return re.sub(r"^embedding\.fc([12])\.",
                  lambda m: f"embedding.{0 if m[1] == '1' else 2}.", name)


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
    """The momentum ``trace`` tree inside an optax SGD state."""
    if hasattr(opt_state, "trace"):
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
    the SGD momentum traces."""
    load_jax_variables(state.model, jax_state.params, jax_state.batch_stats)
    key_params = dict(jax_state.params)
    key_params.update(jax_state.key_params)
    load_jax_variables(state.key_model, key_params, jax_state.key_batch_stats)
    q = jax_state.queue
    dev = state.queue.vectors.device
    state.queue.vectors.copy_(torch.from_numpy(np.array(q.vectors, np.float32)).to(dev))
    state.queue.sources.copy_(torch.from_numpy(np.array(q.sources, np.int32)).to(dev))
    state.queue.tail, state.queue.total = int(q.tail), int(q.total)
    state.step = int(jax_state.step)
    trace = _find_trace(jax_state.opt_state)
    if trace is not None:
        buffers = _tensors(flax_to_state_dict(trace, {}), state.model)
        params = dict(state.model.named_parameters())
        for name, buf in buffers.items():
            state.optimizer.state[params[name]]["momentum_buffer"] = buf
