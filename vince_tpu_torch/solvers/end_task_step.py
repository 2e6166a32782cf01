"""End-task train and eval steps on one GPU (counterpart of
``vince_tpu/solvers/end_task_step.py``): a frozen or fine-tuned VINCE encoder
and a decoder, for three tasks:

- ``classifier``: ``MultiLinearModel``'s two heads, a linear probe and a
  2-layer MLP (the ImageNet and SUN-397 probes), each with its CE loss;
- ``kinetics``: an LSTM over the per-frame features of each clip;
- ``tracking``: the SiamFC head on the spatial features of a dilated ResNet.

    uint8 frames → augmentation on the device (one draw per clip for
    Kinetics) → encoder features (eval mode under no_grad when frozen; train
    mode, its BatchNorm running averages moving, when fine-tuned) → decoder →
    CE and accuracy per head → backward → one update of each optimizer group

For tracking the host has already cropped the exemplar and search images,
so the step only normalises them; the exemplar forward comes first, then the
search forward, and a fine-tuned encoder's running averages move through
both, in that order, as the JAX step chains them.

The JAX step is a pure function of an immutable state. Here the state holds
the modules and the optimizer, and a step updates them in place and returns
the same object. The steps run eagerly. The encoder is built as the JAX one
is: no fold kernel and the grouped depthwise convolution, so no kernel of
``ops/kernels`` runs on these steps.

With a ``mesh`` (``parallel/mesh.py``: one process per GPU, a data axis and
a queue axis of one) a train step is JAX's ``shard_map`` step: each rank
takes its rows (Kinetics: its clips) of the global batch, the augmentation
draws for the global rows and keeps the rank's, so that its output does not
depend on the mesh's shape; the gradients are averaged over the data axis
before the update, a fine-tuned encoder's running averages after it (its
BatchNorm normalises by the rank's own batch statistics: JAX's end task has
no sync-BN), and so are the metrics. The per-sample eval step returns the
rank's rows and calls no collective; the eval step of batch means averages
them over the data axis. ``mesh=None`` calls no collective, and a 1x1 mesh
calls each over a world of one.
"""

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from vince_tpu_torch.device import full_f32_products, resolve_device
from vince_tpu_torch.models.kinetics_model import Kinetics400Model, kinetics_losses
from vince_tpu_torch.models.linear_model import MultiLinearModel, classifier_losses
from vince_tpu_torch.models.tracking_model import SiamFCTrackingModel, tracking_losses
from vince_tpu_torch.models.vince_model import VinceEncoder
from vince_tpu_torch.ops.augment import AugmentConfig, _finalize, augment_batch
from vince_tpu_torch.parallel.collectives import flat_all_reduce_
from vince_tpu_torch.parallel.mesh import Mesh
from vince_tpu_torch.solvers.vince_step import _generator, _mean_metrics, _running_averages
from vince_tpu_torch.utils.checkpoint import load_pretrain_encoder
from vince_tpu_torch.utils.transforms import make_config

TASKS = ("classifier", "kinetics", "tracking")


@dataclasses.dataclass(frozen=True)
class EndTaskConfig:
    """Static configuration of an end-task step: the JAX config's fields."""

    task: str  # "classifier" | "kinetics" | "tracking"
    backbone: str = "ResNet18"
    embed_size: int = 64  # must match the pretrain checkpoint
    num_classes: int = 1000
    num_frames: int = 1  # frames per clip (kinetics)
    image_size: int = 224
    transform: str = "BasicImagenetTransform"
    freeze_feature_extractor: bool = True
    use_attention: bool = False
    compute_dtype: torch.dtype = torch.float32
    data_axis_size: int = 1  # the mesh's data axis (1 without a mesh)
    lstm_hidden: int = 512
    # the heads' rates are base_lr times these: ImageNet (1, 0.01), SUN equal
    head_lr_scales: Tuple[float, ...] = (1.0, 0.01)
    bn_fold: str = "expand"
    norm_kind: str = "batchnorm"  # must match the pretrain checkpoint


def _check_task(cfg: EndTaskConfig) -> None:
    if cfg.task not in TASKS:
        raise ValueError(f"unknown end task {cfg.task!r}; choices: {TASKS}")


SGD_MOMENTUM = 0.9
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults
FINETUNE_WEIGHT_DECAY = 1e-4
_BUFFERS = {"sgd": ("trace",), "adam": ("mu", "nu")}


class EndTaskOptimizer:
    """optax's ``multi_transform`` of the JAX package's ``build_optimizer``,
    over named parameter groups, each
    ``chain(add_decayed_weights(wd), sgd(lr·scale, momentum=0.9))`` or
    ``chain(add_decayed_weights(wd), adam(lr·scale))``:

    - the decay is an L2 term added to the gradient before the momentum or
      Adam's moments, on every parameter of the group, biases too;
    - SGD: t ← (g + wd·p) + 0.9·t, p ← p − lr·t;
    - Adam: μ ← 0.9μ + 0.1g, ν ← 0.999ν + 0.001g², then with n updates made
      p ← p − lr·(μ/(1−0.9ⁿ)) / (√(ν/(1−0.999ⁿ)) + 1e-8);
    - update k (from 0) uses ``schedule(k)`` times the group's scale;
    - a frozen group (optax's ``set_to_zero``) takes no update and holds no
      state.

    ``state[name]`` holds a parameter's buffers (``trace``, or ``mu`` and
    ``nu``) under its qualified name (``decoder.fc.weight``); ``count`` is the
    number of updates made. A parameter whose gradient is None takes a zero
    gradient, as JAX's gradient of an unused parameter is zero.
    """

    def __init__(self, groups: Dict[str, List[Tuple[str, nn.Parameter]]], kind: str,
                 schedule: Callable[[int], float], scales: Dict[str, float],
                 weight_decay: float, frozen: Tuple[str, ...] = ()):
        if kind not in _BUFFERS:
            raise ValueError(f"unknown optimizer kind {kind!r}; choices: {sorted(_BUFFERS)}")
        self.groups, self.kind, self.schedule = groups, kind, schedule
        self.scales, self.weight_decay, self.frozen = scales, weight_decay, tuple(frozen)
        self.count = 0
        self.state = {name: {b: torch.zeros_like(p) for b in _BUFFERS[kind]}
                      for label, named in groups.items() if label not in self.frozen
                      for name, p in named}

    def zero_grad(self) -> None:
        for named in self.groups.values():
            for _, p in named:
                p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        lr = float(self.schedule(self.count))
        n = self.count + 1
        for label, named in self.groups.items():
            if label in self.frozen or not named:
                continue
            names = [name for name, _ in named]
            params = [p for _, p in named]
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            if self.weight_decay:
                grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
            rate = lr * self.scales[label]
            if self.kind == "sgd":
                traces = [self.state[k]["trace"] for k in names]
                torch._foreach_mul_(traces, SGD_MOMENTUM)
                torch._foreach_add_(traces, grads)
                torch._foreach_add_(params, traces, alpha=-rate)
                continue
            mu = [self.state[k]["mu"] for k in names]
            nu = [self.state[k]["nu"] for k in names]
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, grads, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - ADAM_B2)
            mu_hat = torch._foreach_div(mu, 1.0 - ADAM_B1 ** n)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - ADAM_B2 ** n))
            torch._foreach_add_(denom, ADAM_EPS)
            torch._foreach_addcdiv_(params, mu_hat, denom, value=-rate)
        self.count = n

    def state_tree(self) -> Dict:
        """The buffers by kind and qualified name, and ``count`` (the
        tensors are the optimizer's own)."""
        tree = {"count": self.count}
        for b in _BUFFERS[self.kind]:
            tree[b] = {name: s[b] for name, s in self.state.items()}
        return tree


@dataclasses.dataclass(frozen=True)
class EndTaskOptimizerSpec:
    """The end task's optimizer before it has parameters: ``make`` builds it
    over an encoder and a decoder."""

    task: str
    kind: str  # "sgd" | "adam"
    schedule: Callable[[int], float]  # the rate at update k, base_lr included
    head_lr_scales: Tuple[float, ...]
    weight_decay: float
    freeze_feature_extractor: bool

    def group_of(self, decoder_param: str) -> str:
        """The group of a decoder parameter: ``head{i}`` for the classifier's
        ``classifier_{i}`` (any other name ``head0``), else ``decoder``."""
        if self.task != "classifier":
            return "decoder"
        top = decoder_param.split(".", 1)[0]
        return f"head{int(top.split('_')[-1])}" if top.startswith("classifier_") else "head0"

    def make(self, encoder: nn.Module, decoder: nn.Module) -> EndTaskOptimizer:
        if self.task == "classifier":
            groups = {f"head{i}": [] for i in range(len(self.head_lr_scales))}
            scales = {f"head{i}": s for i, s in enumerate(self.head_lr_scales)}
        else:
            groups, scales = {"decoder": []}, {"decoder": 1.0}
        for name, p in decoder.named_parameters():
            if p.requires_grad:
                groups[self.group_of(name)].append((f"decoder.{name}", p))
        groups["encoder"] = [(f"encoder.{name}", p) for name, p in encoder.named_parameters()]
        scales["encoder"] = 1.0
        frozen = ("encoder",) if self.freeze_feature_extractor else ()
        return EndTaskOptimizer(groups, self.kind, self.schedule, scales, self.weight_decay,
                                frozen)


def build_optimizer(cfg: EndTaskConfig, base_lr: float, optimizer_kind: str = "adam",
                    schedule: Optional[Callable[[int], float]] = None) -> EndTaskOptimizerSpec:
    """Per-head groups (ImageNet: SGD with momentum; SUN and Kinetics: Adam),
    weight decay 0 with a frozen encoder and 1e-4 when it is fine-tuned, the
    encoder then a group of its own at the base rate. ``schedule`` (step →
    rate, ``base_lr`` included) gives the epoch decay and the warm-up; without
    it the rate is ``base_lr``."""
    _check_task(cfg)
    if optimizer_kind not in _BUFFERS:
        raise ValueError(f"unknown optimizer kind {optimizer_kind!r}")
    return EndTaskOptimizerSpec(
        task=cfg.task, kind=optimizer_kind,
        schedule=schedule if schedule is not None else (lambda step: base_lr),
        head_lr_scales=tuple(cfg.head_lr_scales),
        weight_decay=0.0 if cfg.freeze_feature_extractor else FINETUNE_WEIGHT_DECAY,
        freeze_feature_extractor=cfg.freeze_feature_extractor)


@dataclasses.dataclass
class EndTaskState:
    step: int
    encoder: VinceEncoder  # parameters and BatchNorm running statistics
    decoder: nn.Module
    optimizer: EndTaskOptimizer


def build_models(cfg: EndTaskConfig) -> Tuple[VinceEncoder, nn.Module]:
    """The encoder as the JAX end task builds it (the conv7 stem, no fold
    kernel, the grouped depthwise convolution) and the task's decoder."""
    _check_task(cfg)
    encoder = VinceEncoder(cfg.backbone, cfg.embed_size, use_attention=cfg.use_attention,
                           dtype=cfg.compute_dtype, bn_fold=cfg.bn_fold,
                           norm_kind=cfg.norm_kind)
    channels = encoder.output_channels
    if cfg.task == "classifier":
        return encoder, MultiLinearModel(channels, cfg.num_classes)
    if cfg.task == "tracking":
        return encoder, SiamFCTrackingModel(channels)
    return encoder, Kinetics400Model(channels, cfg.num_classes, cfg.lstm_hidden)


def init_end_task_state(seed: int, cfg: EndTaskConfig, optimizer: EndTaskOptimizerSpec,
                        encoder_tensors: Optional[Dict[str, torch.Tensor]] = None,
                        device="cuda") -> EndTaskState:
    """Random encoder and decoder from ``seed``, the encoder then taken from
    ``encoder_tensors`` (a pretraining checkpoint's query encoder) where they
    are given; on the GPU unless ``device`` says otherwise."""
    device = resolve_device(device)
    full_f32_products()
    gen = torch.Generator().manual_seed(seed)
    encoder, decoder = build_models(cfg)
    encoder.reset_parameters(gen)
    decoder.reset_parameters(gen)
    if encoder_tensors is not None:
        load_pretrain_encoder(encoder, encoder_tensors)
    encoder.to(device)
    decoder.to(device)
    return EndTaskState(step=0, encoder=encoder, decoder=decoder,
                        optimizer=optimizer.make(encoder, decoder))


def _extract(encoder: VinceEncoder, images, train: bool, frozen: bool, spatial: bool = False):
    """The pooled features (the backbone's spatial ones with ``spatial``):
    train mode with a gradient for a fine-tuned train step (the running
    averages move); eval mode, no gradient, otherwise."""
    key = "spatial_features" if spatial else "extracted_features"
    if train and not frozen:
        encoder.train()
        return encoder.extract_features(images)[key]
    encoder.eval()
    with torch.no_grad():
        return encoder.extract_features(images)[key]


def _normalized(cfg: EndTaskConfig, images_u8):
    """Crops made on the host: ImageNet's normalisation only."""
    return _finalize(images_u8.float() / 255.0, AugmentConfig()).to(cfg.compute_dtype)


def _track(cfg: EndTaskConfig, state, batch, train: bool, reduce: bool):
    """The exemplar forward, then the search forward (a fine-tuned train
    step moves the running averages through both, in that order), the
    SiamFC head and its loss and metrics."""
    frozen = cfg.freeze_feature_extractor or not train
    zf = _extract(state.encoder, _normalized(cfg, batch["exemplar"]), train, frozen, True)
    xf = _extract(state.encoder, _normalized(cfg, batch["search"]), train, frozen, True)
    out = tracking_losses(state.decoder(zf, xf)[..., 0], batch["labels"], reduce)
    out["loss/total_loss"] = out["loss/siam_tracking_loss"]
    return out


def _decode(cfg: EndTaskConfig, decoder: nn.Module, features, labels,
            reduce: bool) -> Dict[str, torch.Tensor]:
    if cfg.task == "kinetics":
        # [B·T, F] frame-major → [B, T, F]
        logits = decoder(features.reshape(-1, cfg.num_frames, features.shape[-1]))
        if logits.shape[0] != labels.shape[0]:
            raise ValueError(f"{logits.shape[0]} clips of {cfg.num_frames} frames, "
                             f"{labels.shape[0]} labels")
        out = kinetics_losses(logits, labels, reduce)
    else:
        out = classifier_losses(decoder(features), labels, reduce)
    out["loss/total_loss"] = sum(v for k, v in out.items() if k.startswith("loss/"))
    return out


def _check_mesh(cfg: EndTaskConfig, mesh: Optional[Mesh]) -> None:
    """The mesh's data axis is the config's, and its queue axis is 1 (an end
    task has no queue)."""
    shape = (1, 1) if mesh is None else (mesh.data_size, mesh.queue_size)
    if shape != (cfg.data_axis_size, 1):
        raise ValueError(f"the end task's data axis is {cfg.data_axis_size} and its queue axis "
                         f"1, the mesh is {shape[0]}x{shape[1]}")


def make_end_task_train_step(cfg: EndTaskConfig, train: bool = True, per_sample: bool = False,
                             mesh: Optional[Mesh] = None):
    """With ``train``, the train step ``(state, batch, seed) → (state,
    metrics)``; else the eval step ``(state, batch, seed) → metrics``, with
    ``per_sample`` per-sample [B] tensors in row order instead of batch means
    (the val pass weights a padded last batch by them).

    ``batch`` holds uint8 ``data`` [B, H, W, 3] (Kinetics: B = clips ×
    ``num_frames``, frame-major) and int32 ``labels`` [B] (one per clip) on
    the state's device; on a mesh, the rank's rows of the global batch. The
    train step augments with draws from the run's seed and the step (one per
    clip) for the global rows; the eval step takes the val path (resize
    and centre crop), eval-mode BatchNorm and no gradient, and changes
    nothing. Metrics are each head's ``loss/classifier_loss_{i}`` and
    ``classifier_accuracy_{i}`` and ``loss/total_loss``, the sum of the
    losses; on a mesh, batch means are averaged over the data axis.

    For tracking, ``batch`` holds uint8 ``exemplar`` [B, hz, wz, 3] and
    ``search`` [B, hx, wx, 3] crops and float ``labels`` [B, hy, wy], the
    response maps; the metrics are ``loss/siam_tracking_loss``,
    ``loss/total_loss``, ``dist``, ``center_dist`` and ``mean_iou``."""
    if train and per_sample:
        raise ValueError("per_sample is for the eval step")
    _check_task(cfg)
    _check_mesh(cfg, mesh)
    full_f32_products()
    tcfg = make_config(cfg.transform, cfg.image_size)
    group = cfg.num_frames if cfg.task == "kinetics" else 1
    d_idx = 0 if mesh is None else mesh.data_index
    data_group = None if mesh is None else mesh.data_group

    def _averaged(out):
        if mesh is None:
            return {k: v.detach() for k, v in out.items()}
        return _mean_metrics(out, data_group)

    def _update(state: EndTaskState, out):
        opt = state.optimizer
        opt.zero_grad()
        out["loss/total_loss"].backward()
        if mesh is not None:
            flat_all_reduce_([p.grad for label, named in opt.groups.items()
                              if label not in opt.frozen for _, p in named
                              if p.grad is not None], data_group, divisor=cfg.data_axis_size)
        opt.step()
        if mesh is not None and not cfg.freeze_feature_extractor:
            # the running averages moved with each rank's batch statistics
            flat_all_reduce_(_running_averages(state.encoder), data_group,
                             divisor=cfg.data_axis_size)
        state.step += 1
        return state, _averaged(out)

    def train_step(state: EndTaskState, batch, seed: int = 0):
        if cfg.task == "tracking":
            out = _track(cfg, state, batch, train=True, reduce=True)
            return _update(state, out)
        gen = _generator(batch["data"].device, seed, state.step, 0)
        images = augment_batch(gen, batch["data"], tcfg, cfg.compute_dtype, train=True,
                               group_size=group, data_size=cfg.data_axis_size,
                               data_index=d_idx)
        features = _extract(state.encoder, images, train=True,
                            frozen=cfg.freeze_feature_extractor)
        return _update(state, _decode(cfg, state.decoder, features, batch["labels"], reduce=True))

    @torch.no_grad()
    def eval_step(state: EndTaskState, batch, seed: int = 0) -> Dict[str, torch.Tensor]:
        if cfg.task == "tracking":
            out = _track(cfg, state, batch, train=False, reduce=not per_sample)
        else:
            images = augment_batch(None, batch["data"], tcfg, cfg.compute_dtype, train=False)
            features = _extract(state.encoder, images, train=False, frozen=True)
            out = _decode(cfg, state.decoder, features, batch["labels"], reduce=not per_sample)
        # per-sample rows stay the rank's own
        return out if per_sample else _averaged(out)

    return train_step if train else eval_step
