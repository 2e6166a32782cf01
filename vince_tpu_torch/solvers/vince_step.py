"""The VINCE pretraining step on one GPU (counterpart of
``vince_tpu/solvers/vince_step.py::make_train_step_fn``).

    uint8 frames → augmentation on the device → key forward (no grad,
    shuffled BN) → query forward → multi-pair InfoNCE against the batch keys
    and the queue → backward → SGD → EMA of the key encoder → enqueue

in the JAX order: the loss reads the queue as it was before this step's
insert, the EMA follows the SGD step, and the enqueue comes last. The key
encoder's BatchNorm running statistics move with its own train-mode forward,
not with the EMA.

The JAX step is a pure function of an immutable state. Here the state holds
``nn.Module``s and a ``torch.optim.SGD``, and a step updates them in place and
returns the same object.
"""

import copy
import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from vince_tpu_torch.device import full_f32_products, resolve_device
from vince_tpu_torch.models.vince_model import VinceEncoder, split_vince_params
from vince_tpu_torch.ops.augment import apply_augment, draw_augment_params
from vince_tpu_torch.ops.ema import ema_update
from vince_tpu_torch.ops.queue import QueueState, enqueue, init_queue
from vince_tpu_torch.ops.sharded_infonce import sharded_multi_pair_infonce
from vince_tpu_torch.parallel.collectives import make_shuffle_perm, shuffle, unshuffle
from vince_tpu_torch.utils.transforms import make_config


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """One data source of the batch."""

    name: str
    batch_size: int  # rows for this source (= num_videos * num_frames)
    num_frames: int = 1
    transform: str = "StandardVideoTransform"
    shared_transform: bool = False  # same augmentation for query and key
    source_id: int = 0  # tag stored in the queue


@dataclasses.dataclass(frozen=True)
class VinceConfig:
    """Static configuration of the pretraining step."""

    sources: Tuple[SourceSpec, ...]
    backbone: str = "ResNet18"
    embed_size: int = 64
    image_size: int = 224
    queue_size: int = 65536
    temperature: float = 0.07
    momentum: float = 0.999
    inter_batch: bool = True
    shuffle_bn: bool = True
    compute_dtype: torch.dtype = torch.float32
    use_fused_infonce: bool = False  # K1 for the queue sweep
    bn_fold: str = "expand"
    fold_kernel: bool = False  # K2 at the supported bottleneck sites
    jitter_order: str = "torchvision"

    @property
    def total_batch(self) -> int:
        return sum(s.batch_size for s in self.sources)


@dataclasses.dataclass
class VinceState:
    step: int
    model: VinceEncoder  # query encoder: params and BN running statistics
    key_model: VinceEncoder  # momentum encoder
    optimizer: torch.optim.SGD
    queue: QueueState

    @property
    def device(self) -> torch.device:
        return self.queue.vectors.device


SGD_MOMENTUM = 0.9
WEIGHT_DECAY = 1e-4


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """SGD with momentum 0.9 and weight decay 1e-4 on a learning-rate
    schedule: ``torch.optim.SGD(momentum, weight_decay, dampening=0)`` equals
    ``optax.chain(add_decayed_weights(wd), sgd(schedule, momentum))``."""

    lr_schedule: Union[float, Callable[[int], float]]

    def lr(self, step: int) -> float:
        s = self.lr_schedule
        return float(s(step)) if callable(s) else float(s)

    def make(self, params) -> torch.optim.SGD:
        return torch.optim.SGD(params, lr=self.lr(0), momentum=SGD_MOMENTUM,
                               dampening=0.0, weight_decay=WEIGHT_DECAY)


def build_vince_optimizer(lr_schedule) -> OptimizerSpec:
    """The pretraining optimizer: SGD (LARS is not ported yet)."""
    return OptimizerSpec(lr_schedule)


def build_encoder(cfg: VinceConfig) -> VinceEncoder:
    return VinceEncoder(cfg.backbone, cfg.embed_size, dtype=cfg.compute_dtype,
                        bn_fold=cfg.bn_fold, fold_kernel=cfg.fold_kernel)


def init_vince_state(seed: int, cfg: VinceConfig, optimizer: OptimizerSpec,
                     device="cuda") -> VinceState:
    """Random weights and queue from ``seed``; on the GPU unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    full_f32_products()
    gen = torch.Generator().manual_seed(seed)
    model = build_encoder(cfg)
    model.reset_parameters(gen)
    model.to(device).train()
    key_model = copy.deepcopy(model).requires_grad_(False)
    queue = init_queue(gen, cfg.queue_size, cfg.embed_size, device=device)
    return VinceState(step=0, model=model, key_model=key_model,
                      optimizer=optimizer.make(model.parameters()), queue=queue)


def _generator(device, seed: int, step: int, stream: int) -> torch.Generator:
    """A generator for one use (``stream``) in one step, from the run's seed."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step * 16 + stream) % 2 ** 63)


def _source_masks(cfg: VinceConfig, src: SourceSpec, device):
    """Positives and batch negatives of the source's queries against its keys:
    inter-batch → keys of the same video positive, every other key negative;
    MoCo → own key positive, batch keys not negatives."""
    idx = torch.arange(src.batch_size, device=device)
    if cfg.inter_batch:
        groups = idx // src.num_frames
        return groups[:, None] == groups[None, :], None
    pos = idx[:, None] == idx[None, :]
    return pos, torch.zeros_like(pos)


def _source_offsets(cfg: VinceConfig):
    offs, off = [], 0
    for src in cfg.sources:
        offs.append((off, off + src.batch_size))
        off += src.batch_size
    return offs


def _augment_sources(cfg: VinceConfig, batch, generator: torch.Generator):
    """Augment every source's query and key frames on the device."""
    q_imgs, k_imgs = [], []
    for si, src in enumerate(cfg.sources):
        tcfg = make_config(src.transform, cfg.image_size, jitter_order=cfg.jitter_order)
        data, queue_data = batch[si]["data"], batch[si]["queue_data"]
        b, h, w, _ = data.shape
        q_draws = draw_augment_params(generator, b, h, w, tcfg)
        k_draws = q_draws if src.shared_transform else draw_augment_params(
            generator, b, h, w, tcfg)
        q_imgs.append(apply_augment(data, q_draws, tcfg, cfg.compute_dtype))
        k_imgs.append(apply_augment(queue_data, k_draws, tcfg, cfg.compute_dtype))
    return torch.cat(q_imgs, 0), torch.cat(k_imgs, 0)


def make_train_step_fn(cfg: VinceConfig, optimizer: OptimizerSpec):
    """Build the train step ``(state, batch, seed) → (state, metrics)``.
    ``batch`` is a tuple of per-source dicts holding uint8 ``data`` and
    ``queue_data`` [B_s, H, W, 3] on the state's device; the metrics are
    0-dim tensors on that device."""
    full_f32_products()

    def step(state: VinceState, batch, seed: int = 0):
        dev = state.device
        q_all, k_all = _augment_sources(cfg, batch, _generator(dev, seed, state.step, 0))

        # key (momentum) forward, no grad, shuffled BN
        with torch.no_grad():
            perm: Optional[torch.Tensor] = None
            k_in = k_all
            if cfg.shuffle_bn:
                perm = make_shuffle_perm(_generator(dev, seed, state.step, 1), k_all.shape[0])
                k_in = shuffle(k_all, perm)
            k_emb = state.key_model(k_in)["embeddings"].float()
            if perm is not None:
                k_emb = unshuffle(k_emb, perm)
        k_sources = [k_emb[a:b] for a, b in _source_offsets(cfg)]
        queue_snapshot = state.queue.vectors  # read before this step's enqueue

        # query forward + per-source losses
        out = state.model(q_all)
        q_emb = out["embeddings"].float()
        losses, metrics = [], {}
        for si, ((a, b), src) in enumerate(zip(_source_offsets(cfg), cfg.sources)):
            mask, neg_mask = _source_masks(cfg, src, dev)
            res = sharded_multi_pair_infonce(
                q_emb[a:b], k_sources[si], mask, cfg.temperature,
                queue_shard=queue_snapshot, batch_neg_mask=neg_mask,
                use_fused_queue_kernel=cfg.use_fused_infonce)
            losses.append(res["dist"])
            for mk in ("nce_accuracy", "softmax_weight", "cosine_sim", "cosine_sim_neg_max"):
                metrics.setdefault(mk, []).append(res[mk])
        total = torch.stack(losses).mean()

        # backward + SGD
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        total.backward()
        for group in opt.param_groups:
            group["lr"] = optimizer.lr(state.step)
        opt.step()

        # EMA of the tracked parameters, after the optimizer step
        tracked, _ = split_vince_params(dict(state.model.named_parameters()))
        key_params = dict(state.key_model.named_parameters())
        ema_update([key_params[k] for k in tracked], tracked.values(), cfg.momentum)

        # enqueue the keys, last
        for si, src in enumerate(cfg.sources):
            enqueue(state.queue, k_sources[si], src.source_id)

        state.step += 1
        out_metrics: Dict[str, torch.Tensor] = {
            k: torch.stack(v).mean().detach() for k, v in metrics.items()}
        out_metrics["loss/nce_loss"] = total.detach()
        out_metrics["loss/total_loss"] = total.detach()
        return state, out_metrics

    return step
