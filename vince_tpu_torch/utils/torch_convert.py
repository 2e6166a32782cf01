"""The reference's PyTorch weights into the port (counterpart of
``vince_tpu/utils/torch_convert.py``).

A released VINCE checkpoint is a ``VinceModel`` state dict whose backbone
keys carry the DataParallel and ``Backbone`` wrappers' prefixes
(``feature_extractor.module.model.``). The port keeps torchvision's and
``efficientnet_pytorch``'s names and layouts under ``backbone.``, so the
conversion is a prefix strip and a rename of the heads: the inverse of
``utils/jax_weights.py::to_reference_name``. Values keep their layout
([O, I, kh, kw] convolutions, [O, I] linears).

Each converter keeps and drops the keys that JAX's keeps and drops (the
torchvision classifier ``fc``, EfficientNet's ``_fc``, ``num_batches_tracked``,
convolution biases, keys of no known module) and raises ``KeyError`` where
JAX's raises: a BatchNorm leaf, an EfficientNet BatchNorm or a
squeeze-excite module it does not know.
"""

import re
from typing import Dict, List

import numpy as np
import torch

from vince_tpu_torch.utils.jax_weights import to_reference_name

_KNOWN_PREFIXES = (
    "feature_extractor.module.model.",
    "feature_extractor.module.",
    "feature_extractor.model.",
    "feature_extractor.",
    "module.model.",
    "module.",
    "model.",
)
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
_EN_BLOCK_CONVS = ("_expand_conv.weight", "_depthwise_conv.weight", "_project_conv.weight")
_EN_BLOCK_BNS = ("_bn0", "_bn1", "_bn2")
_SE_MODULES = ("_se_reduce", "_se_expand")
# the reference VinceModel's head modules → the port's
_HEADS = (
    ("embedding.0", "embedding.fc1"),
    ("embedding.2", "embedding.fc2"),
    ("imagenet_decoders.0", "imagenet_decoder_0.fc_out"),
    ("imagenet_decoders.1.0", "imagenet_decoder_1.fc0"),
    ("imagenet_decoders.1.2", "imagenet_decoder_1.fc_out"),
    ("jigsaw_linear", "jigsaw.jigsaw_linear"),
    ("jigsaw_embedding.0", "jigsaw.fc1"),
    ("jigsaw_embedding.2", "jigsaw.fc2"),
)


def _strip_prefix(key: str) -> str:
    for p in _KNOWN_PREFIXES:
        if key.startswith(p):
            return key[len(p):]
    return key


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.array(value, copy=True))


def _known(leaf: str, choices, what: str) -> str:
    if leaf not in choices:
        raise KeyError(f"{what}: {leaf!r} (known: {', '.join(choices)})")
    return leaf


def convert_resnet_state_dict(state_dict: Dict, strip_prefixes: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet state dict → the port's ``ResNet`` names
    (``layer1.0.conv1.weight``, ``bn1.running_mean``, …)."""
    out: Dict[str, torch.Tensor] = {}
    for raw_key, value in state_dict.items():
        key = _strip_prefix(raw_key) if strip_prefixes else raw_key
        if key in ("fc.weight", "fc.bias") or key.endswith("num_batches_tracked"):
            continue
        m = re.match(r"layer(\d+)\.(\d+)\.(.*)", key)
        block, rest = (f"layer{m[1]}.{m[2]}.", m[3]) if m else ("", key)
        parts = rest.split(".")
        if parts[0].startswith("conv") and parts[-1] == "weight":
            out[f"{block}{parts[0]}.weight"] = _tensor(value)
        elif parts[0].startswith("bn"):
            leaf = _known(parts[1], _BN_LEAVES, raw_key)
            out[f"{block}{parts[0]}.{leaf}"] = _tensor(value)
        elif parts[0] == "downsample":
            if parts[1] == "0" and parts[2] == "weight":
                out[f"{block}downsample.0.weight"] = _tensor(value)
            elif parts[1] == "1":
                leaf = _known(parts[2], _BN_LEAVES, raw_key)
                out[f"{block}downsample.1.{leaf}"] = _tensor(value)
    return out


def convert_efficientnet_state_dict(state_dict: Dict, strip_prefixes: bool = True
                                    ) -> Dict[str, torch.Tensor]:
    """An ``efficientnet_pytorch`` state dict → the port's ``EfficientNet``
    names, which are that package's; the classifier ``_fc`` is dropped."""
    out: Dict[str, torch.Tensor] = {}
    for raw_key, value in state_dict.items():
        key = _strip_prefix(raw_key) if strip_prefixes else raw_key
        if key.startswith("_fc.") or key.endswith("num_batches_tracked"):
            continue
        m = re.match(r"_blocks\.(\d+)\.(.*)", key)
        if m:
            block, rest = f"_blocks.{m[1]}.", m[2]
            module, _, leaf = rest.partition(".")
            if rest in _EN_BLOCK_CONVS:
                out[block + rest] = _tensor(value)
            elif rest.startswith("_se_"):
                # JAX takes any leaf but the weight for the bias
                _known(module, _SE_MODULES, raw_key)
                leaf = "weight" if leaf == "weight" else "bias"
                out[f"{block}{module}.{leaf}"] = _tensor(value)
            elif rest.startswith("_bn"):
                _known(module, _EN_BLOCK_BNS, raw_key)
                out[f"{block}{module}.{_known(leaf, _BN_LEAVES, raw_key)}"] = _tensor(value)
        elif key in ("_conv_stem.weight", "_conv_head.weight"):
            out[key] = _tensor(value)
        elif key.startswith(("_bn0.", "_bn1.")):
            module, leaf = key.split(".")[:2]
            out[f"{module}.{_known(leaf, _BN_LEAVES, raw_key)}"] = _tensor(value)
    return out


def _convert_attention_pool(tensors: Dict[str, torch.Tensor]):
    """``average_layers.*`` onto the attention pool's 1×1 C→1 logits conv,
    only when the shapes say so unambiguously: one weight of one output unit
    (a conv [1, C, 1, 1] or a linear [1, C]) and at most one [1] bias. Returns
    the pool's tensors, or None."""
    weights, biases = [], []
    for v in tensors.values():
        if v.dim() == 0 or not v.is_floating_point():
            continue  # counters such as num_batches_tracked
        if v.dim() == 4 and v.shape[0] == 1 and v.shape[2] == v.shape[3] == 1:
            weights.append(v)
        elif v.dim() == 2 and v.shape[0] == 1:
            weights.append(v.reshape(1, v.shape[1], 1, 1))
        elif v.dim() == 1 and v.shape[0] == 1:
            biases.append(v)
        else:
            return None
    if len(weights) != 1 or len(biases) > 1:
        return None
    out = {"pool.attn_logits.weight": weights[0]}
    if biases:
        out["pool.attn_logits.bias"] = biases[0]
    return out


def convert_vince_state_dict(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """A reference ``VinceModel`` state dict → the port's ``VinceEncoder``
    state-dict names: the backbone (ResNet or, by its ``_conv_stem``,
    EfficientNet) under ``backbone.``, the projection MLP, the ImageNet
    decoders, the jigsaw head and the attention pool."""
    backbone_sd, other = {}, {}
    for key, value in state_dict.items():
        skey = _strip_prefix(key)
        if skey.startswith(("embedding.", "imagenet_decoders.", "jigsaw")):
            other[skey] = value
        elif key != skey or re.match(r"(conv1|bn1|layer\d|_conv_stem|_blocks|_conv_head|_bn\d)",
                                     skey):
            backbone_sd[skey] = value
    convert = (convert_efficientnet_state_dict
               if any(k.startswith("_conv_stem") for k in backbone_sd)
               else convert_resnet_state_dict)
    out = {f"backbone.{k}": v for k, v in convert(backbone_sd, strip_prefixes=False).items()}
    for ref, port in _HEADS:
        if ref + ".weight" in other:
            out[port + ".weight"] = _tensor(other[ref + ".weight"])
            if ref + ".bias" in other:
                out[port + ".bias"] = _tensor(other[ref + ".bias"])
    attn = {k: _tensor(v) for k, v in state_dict.items()
            if _strip_prefix(k).startswith("average_layers.") and hasattr(v, "shape")}
    if attn:
        pool = _convert_attention_pool(attn)
        if pool is not None:
            out.update(pool)
        else:
            print("WARNING: checkpoint carries attention-pool (average_layers.*) weights whose "
                  "shapes do not identify a single 1x1 C->1 attention map: NOT converted; "
                  "--use-attention keeps the pool's own initialisation")
    return out


@torch.no_grad()
def load_converted(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> List[str]:
    """Copy converted tensors into ``model`` in place, by top-level module as
    JAX replaces its subtrees: a module that both have takes every one of
    its parameters from ``tensors`` (a missing one raises), and its running
    statistics where ``tensors`` has them; modules that only one of the two
    has are left alone. Returns the modules loaded."""
    own = model.state_dict()
    params = dict(model.named_parameters())
    tops = sorted({name.split(".", 1)[0] for name in tensors}
                  & {name.split(".", 1)[0] for name in own})
    for top in tops:
        missing = [n for n in params if n.split(".", 1)[0] == top and n not in tensors]
        if missing:
            raise ValueError(f"the checkpoint's {top} lacks {len(missing)} parameters of the "
                             f"model's, first {missing[:3]}")
        for name, value in tensors.items():
            if name.split(".", 1)[0] != top or name not in own:
                continue
            if own[name].shape != value.shape:
                raise ValueError(f"{name}: the checkpoint's shape {tuple(value.shape)}, the "
                                 f"model's {tuple(own[name].shape)}")
            own[name].copy_(value)
    return tops


def load_torch_checkpoint(path: str) -> Dict:
    """A ``.pt``/``.pth`` file's state dict, on the CPU: its ``state_dict``
    entry where it has one. The reference's files are whole pickles (a
    checkpoint may carry its run's arguments), so they are loaded as such:
    read only files from the reference or this package."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def init_from_reference(state, tensors: Dict[str, torch.Tensor]) -> List[str]:
    """Start a fresh ``VinceState`` from converted reference tensors
    (``convert_vince_state_dict``'s), as JAX's solver and conversion tool
    start theirs: the query encoder's parameters and running statistics
    replaced by module (``load_converted``), then the key encoder a copy of
    the query encoder; the queue and the optimizer's traces stay as they
    are. In place. Returns the modules loaded."""
    loaded = load_converted(state.model, tensors)
    state.key_model.load_state_dict(state.model.state_dict())
    return loaded


def export_vince_state_dict(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An encoder's state-dict tensors (the port's names) → the reference
    ``VinceModel`` state dict in float32 (``to_reference_name``'s names, the
    naming of ``vince_tpu/utils/torch_export.py``), with a zero
    ``num_batches_tracked`` beside each BatchNorm's running statistics, as
    JAX's export writes; the inverse of ``convert_vince_state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in tensors.items():
        ref = to_reference_name(name)
        out[ref] = value.detach().cpu().float().clone()
        if ref.endswith(".running_var"):
            out[ref[:-len("running_var")] + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64)
    return out
