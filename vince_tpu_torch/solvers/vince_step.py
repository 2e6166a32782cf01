"""The VINCE pretraining step on one GPU or over a (data, queue) mesh of GPUs
(counterpart of ``vince_tpu/solvers/vince_step.py``), and the steps beside
it: eval, key prefill, embedding and panels.

    uint8 frames → augmentation on the device → key forward (no grad,
    shuffled BN) → query forward → multi-pair InfoNCE against the batch keys
    and the queue [+ self-batch InfoNCE, + ImageNet CE of the decoders on
    detached features, + the jigsaw alignment term] → backward → SGD or LARS
    → EMA of the key encoder → enqueue

in the JAX order: the loss reads the queue as it was before this step's
insert, the EMA follows the optimizer step, and the enqueue comes last. The
key encoder's BatchNorm running statistics move with its own train-mode
forward, not with the EMA.

The JAX step is a pure function of an immutable state. Here the state holds
``nn.Module``s, a ``VinceOptimizer`` and the queue, and a step updates them in
place and returns the same object. A step is split in two: the draws (every
random number of the step: the augmentation's, the shuffled-BN permutation
and the jigsaw permutations, drawn eagerly from generators seeded by the
run's seed and the step) and the body (everything from the augmentation's
apply to the enqueue), which reads only tensors. ``make_train_step_fn`` runs both eagerly;
``make_train_step``, the counterpart of ``jax.jit(..., donate_argnums=(0,))``,
captures the body in a CUDA graph and replays it.

With a ``mesh`` (``parallel/mesh.py``: one process per GPU) a step is the JAX
``shard_map`` step's body on this rank, with the same collectives:

- the batch is the rank's rows of the global batch (its data index's), and
  every draw is made for the global rows and sliced to the rank's, so that
  the augmentation does not depend on the mesh's shape;
- the key images are shuffled across the data axis (``gather`` or ``a2a``
  mode) and the key embeddings gathered back in global order;
- the self-batch and alignment terms score against the data axis's
  differentiable gather of the queries; the queue term scores the rank's
  queue shard and merges the shards over the queue axis (K1 per shard with
  the fused kernel); with ``sync_bn`` the BatchNorm statistics are summed
  over the data axis (K2's moments too);
- the loss is divided by the queue axis's size, and the gradients summed over
  every rank in one flat bucket and divided by the data axis's size: JAX's
  mean over data and sum over queue;
- after the step the BatchNorm running averages of both encoders are
  averaged over the data axis, the global keys go into the rank's queue shard
  (``enqueue_sharded``), and the metrics are averaged over the data axis.

``mesh=None`` runs the same body with every group None, where each
collective is the local computation and none is called; a 1×1 mesh runs
every collective over a world of one and computes the same bits.

With ``jigsaw_side`` a step runs PIRL's jigsaw on the query encoder, the key
encoder or both: that side's images are cut into 3×3 patches whose features
the jigsaw head combines in a random order, in place of the projection. The
solver alternates a query-side and a key-side step on one state.
"""

import copy
import dataclasses
import hashlib
import types
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from vince_tpu_torch.device import full_f32_products, resolve_device
from vince_tpu_torch.models.resnet import BatchNorm, unrecorded_batch_stats
from vince_tpu_torch.models.vince_model import (
    VinceEncoder, jigsaw_patchify, random_jigsaw_perms, split_vince_params)
from vince_tpu_torch.ops.augment import (
    AugmentConfig, AugmentDraws, _finalize, apply_augment, augment_batch, draw_rank_rows)
from vince_tpu_torch.ops.ema import ema_update
from vince_tpu_torch.ops.queue import QueueState, enqueue_sharded, init_queue
from vince_tpu_torch.ops.sharded_infonce import sharded_multi_pair_infonce
from vince_tpu_torch.parallel.collectives import (
    cross_device_shuffle, cross_device_shuffle_a2a, cross_device_unshuffle, flat_all_reduce_,
    gather_global_batch, make_balanced_shuffle_perm, make_shuffle_perm, pmean)
from vince_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, bind
from vince_tpu_torch.utils import tracing
from vince_tpu_torch.utils.transforms import make_config


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """One data source of the batch."""

    name: str
    batch_size: int  # GLOBAL rows for this source (= num_videos * num_frames)
    num_frames: int = 1
    transform: str = "StandardVideoTransform"
    shared_transform: bool = False  # same augmentation for query and key
    use_imagenet_ce: bool = False  # supervised decoders on this source; its batch has labels
    source_id: int = 0  # tag stored in the queue


@dataclasses.dataclass(frozen=True)
class VinceConfig:
    """Static configuration of the pretraining step: the JAX config's fields."""

    sources: Tuple[SourceSpec, ...]
    backbone: str = "ResNet18"
    embed_size: int = 64
    image_size: int = 224
    queue_size: int = 65536
    temperature: float = 0.07
    self_temperature: float = 0.07  # the self-batch term's
    momentum: float = 0.999
    inter_batch: bool = True
    self_batch: bool = False  # InfoNCE of each source's queries against themselves
    use_attention: bool = False  # attention pool in place of the average
    jigsaw: bool = False  # the jigsaw head (the steps' jigsaw_side chooses where it runs)
    shuffle_bn: bool = True
    # how shuffled BN moves the key rows across the data axis: "gather" (the
    # global batch on every rank, a slice kept) or "a2a" (a balanced
    # all-to-all, 1/d of the traffic; the per-rank batch divisible by d)
    shuffle_mode: str = "gather"
    compute_dtype: torch.dtype = torch.float32
    data_axis_size: int = 1
    queue_axis_size: int = 1
    sync_bn: bool = False  # BatchNorm statistics over the data axis, not per rank
    # the query encoder's blocks recomputed in its backward, not kept
    # (``models/resnet.py::remat_block``); the running averages move once
    remat: bool = False
    use_fused_infonce: bool = False  # K1 for the queue sweep
    bn_fold: str = "expand"
    fold_kernel: bool = False  # K2 at the supported bottleneck sites (ResNet)
    dw_kind: str = "conv"  # EfficientNet depthwise emission: conv, tap or kernel (K4)
    se_kind: str = "mul"  # EfficientNet squeeze-excite gate: mul or fold
    norm_kind: str = "batchnorm"  # ResNet norm: batchnorm or groupnorm
    stem_kind: str = "s2d"  # ResNet stem arithmetic: s2d (compute dtype) or conv7 (f32)
    jitter_order: str = "torchvision"
    # a diagnostic: the jigsaw path with the identity permutation
    jigsaw_identity_perms: bool = False
    # weight of PIRL's cross-head alignment term on a query- or key-side jigsaw
    # step (a second query forward through the other head); 0 is the reference
    jigsaw_align_weight: float = 0.0

    @property
    def total_batch(self) -> int:
        return sum(s.batch_size for s in self.sources)

    def local_batch(self, s: SourceSpec) -> int:
        """The rows of source ``s`` on one rank of the data axis."""
        if s.batch_size % self.data_axis_size:
            raise ValueError(f"{s.name}: {s.batch_size} rows do not split over a data axis of "
                             f"{self.data_axis_size}")
        b = s.batch_size // self.data_axis_size
        if b % s.num_frames:
            raise ValueError(f"{s.name}: a rank's {b} rows hold no whole number of videos of "
                             f"{s.num_frames} frames")
        return b


SGD_MOMENTUM = 0.9
WEIGHT_DECAY = 1e-4
LARS_TRUST_COEFFICIENT = 1e-3  # optax.lars's default (eps 0)


class VinceOptimizer:
    """SGD or LARS in a form that a CUDA graph can capture: the learning rate
    is a 0-dim tensor on the parameters' device (``set_lr`` writes it and does
    not sync), the momentum traces exist from the start, and ``step`` reads
    nothing on the host.

    - SGD equals ``optax.chain(add_decayed_weights(1e-4), sgd(lr, momentum=0.9))``:
      t ← (g + λp) + 0.9·t, then p ← p − lr·t.
    - LARS equals ``optax.lars(lr, weight_decay=1e-4, momentum=0.9)`` with the
      decay and the trust ratio masked to parameters of more than one
      dimension (biases and BN scales and biases take neither):
      u = g + λp, then u ← r·u with r = 0.001·‖p‖/‖u‖ (1 where either norm is
      0), then t ← 0.9·t − lr·u and p ← p + t.

    ``state[p]["momentum_buffer"]`` is the trace t, in optax's convention for
    each kind.
    """

    def __init__(self, params, kind: str = "sgd"):
        if kind not in ("sgd", "lars"):
            raise ValueError(f"unknown optimizer kind {kind!r}")
        self.params = list(params)
        self.kind = kind
        self.lr = torch.zeros((), dtype=torch.float32, device=self.params[0].device)
        self.state = {p: {"momentum_buffer": torch.zeros_like(p)} for p in self.params}
        # LARS: which parameters take the decay and the trust ratio
        self._adapted = [i for i, p in enumerate(self.params) if p.dim() > 1]

    def set_lr(self, lr: float) -> None:
        self.lr.fill_(lr)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        params = self.params
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        traces = [self.state[p]["momentum_buffer"] for p in params]
        if self.kind == "sgd":
            updates = torch._foreach_add(grads, params, alpha=WEIGHT_DECAY)
            torch._foreach_mul_(traces, SGD_MOMENTUM)
            torch._foreach_add_(traces, updates)
            torch._foreach_sub_(params, torch._foreach_mul(traces, self.lr))
            return
        adapted = [params[i] for i in self._adapted]
        decayed = torch._foreach_add([grads[i] for i in self._adapted], adapted,
                                     alpha=WEIGHT_DECAY)
        p_norm = torch.stack(torch._foreach_norm(adapted))
        u_norm = torch.stack(torch._foreach_norm(decayed))
        ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0,
                            LARS_TRUST_COEFFICIENT * p_norm / u_norm)
        torch._foreach_mul_(decayed, list(ratio.unbind()))
        updates = list(grads)
        for i, u in zip(self._adapted, decayed):
            updates[i] = u
        torch._foreach_mul_(traces, SGD_MOMENTUM)
        torch._foreach_sub_(traces, torch._foreach_mul(updates, self.lr))
        torch._foreach_add_(params, traces)


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """The optimizer's kind and learning-rate schedule; ``make`` builds it
    over the parameters, and each step writes ``lr(state.step)`` into it, as
    the optax schedule is evaluated at its update count."""

    lr_schedule: Union[float, Callable[[int], float]]
    kind: str = "sgd"

    def lr(self, step: int) -> float:
        s = self.lr_schedule
        return float(s(step)) if callable(s) else float(s)

    def make(self, params) -> VinceOptimizer:
        return VinceOptimizer(params, self.kind)


def build_vince_optimizer(lr_schedule, kind: str = "sgd") -> OptimizerSpec:
    """The pretraining optimizer: ``kind`` "sgd" or "lars"."""
    if kind not in ("sgd", "lars"):
        raise ValueError(f"unknown optimizer kind {kind!r}")
    return OptimizerSpec(lr_schedule, kind)


@dataclasses.dataclass
class VinceState:
    step: int
    model: VinceEncoder  # query encoder: params and BN running statistics
    key_model: VinceEncoder  # momentum encoder
    optimizer: VinceOptimizer
    queue: QueueState

    @property
    def device(self) -> torch.device:
        return self.queue.vectors.device


def build_encoder(cfg: VinceConfig) -> VinceEncoder:
    return VinceEncoder(cfg.backbone, cfg.embed_size, use_attention=cfg.use_attention,
                        jigsaw=cfg.jigsaw,
                        use_imagenet_decoders=any(s.use_imagenet_ce for s in cfg.sources),
                        dtype=cfg.compute_dtype, norm_kind=cfg.norm_kind,
                        stem_kind=cfg.stem_kind, bn_fold=cfg.bn_fold,
                        fold_kernel=cfg.fold_kernel, dw_kind=cfg.dw_kind, se_kind=cfg.se_kind,
                        bn_axis_name=DATA_AXIS if cfg.sync_bn else None, remat=cfg.remat)


def _check_shuffle_mode(cfg: VinceConfig) -> None:
    if cfg.shuffle_mode not in ("gather", "a2a"):
        raise ValueError(f"unknown shuffle_mode {cfg.shuffle_mode!r}")
    if cfg.shuffle_bn and cfg.shuffle_mode == "a2a":
        b_local = cfg.total_batch // cfg.data_axis_size
        if b_local % cfg.data_axis_size:
            raise ValueError(
                f"--shuffle-mode a2a needs the per-device batch ({b_local}) "
                f"divisible by the data axis size ({cfg.data_axis_size}); "
                "use --shuffle-mode gather")


# the rank's place without a mesh: one rank at (0, 0), every group None
_ONE_DEVICE = types.SimpleNamespace(data_index=0, queue_index=0, data_group=None,
                                    queue_group=None, world_group=None)


def _place(mesh: Optional[Mesh]):
    """The rank's coordinates and groups: the mesh's, or ``_ONE_DEVICE``'s."""
    return _ONE_DEVICE if mesh is None else mesh


def _check_mesh(cfg: VinceConfig, mesh: Optional[Mesh]) -> None:
    """The mesh's shape is the config's (no mesh: a 1×1 config)."""
    shape = (1, 1) if mesh is None else (mesh.data_size, mesh.queue_size)
    if shape != (cfg.data_axis_size, cfg.queue_axis_size):
        raise ValueError(f"the config's mesh is {cfg.data_axis_size}x{cfg.queue_axis_size}, "
                         f"the step's {shape[0]}x{shape[1]}")


JIGSAW_SIDES = (None, "query", "key", "both")


def _jigsaw_roles(cfg: VinceConfig, jigsaw_side: Optional[str]) -> Tuple[str, ...]:
    """The forwards of a train step that take the jigsaw path, in the order
    the step runs them: the key's, the query's, and the alignment pass's (which
    runs the head the query pass did not)."""
    roles = []
    if jigsaw_side in ("key", "both"):
        roles.append("key")
    if jigsaw_side in ("query", "both"):
        roles.append("query")
    if cfg.jigsaw_align_weight > 0 and jigsaw_side == "key":
        roles.append("align")
    return tuple(roles)


def _check_jigsaw_side(cfg: VinceConfig, jigsaw_side: Optional[str]) -> None:
    if jigsaw_side not in JIGSAW_SIDES:
        raise ValueError(f"jigsaw_side={jigsaw_side!r}; choices: {JIGSAW_SIDES}")
    if jigsaw_side is not None and not cfg.jigsaw:
        raise ValueError(f"jigsaw_side={jigsaw_side!r} needs VinceConfig.jigsaw")
    if jigsaw_side in ("query", "both") and any(s.use_imagenet_ce for s in cfg.sources):
        # the decoders then read the jigsaw head's embed_size-wide output, and
        # their weights are output_channels wide: the JAX step fails at trace
        # time on the mismatch of shapes, so this one refuses the build
        with torch.device("meta"):
            channels = build_encoder(cfg).output_channels
        if channels != cfg.embed_size:
            raise ValueError(
                f"a {jigsaw_side}-side jigsaw step feeds the ImageNet decoders the jigsaw "
                f"head's {cfg.embed_size}-wide output, and they take the backbone's "
                f"{channels} channels")


def init_vince_state(seed: int, cfg: VinceConfig, optimizer: OptimizerSpec,
                     device="cuda", mesh: Optional[Mesh] = None) -> VinceState:
    """Random weights and queue from ``seed``; on the GPU unless ``device`` says
    otherwise. On a mesh every rank makes the same weights and the same
    global queue, and keeps its queue shard."""
    with tracing.span("vince.setup.init_state"):
        device = resolve_device(device)
        _check_mesh(cfg, mesh)
        full_f32_products()
        gen = torch.Generator().manual_seed(seed)
        with tracing.span("vince.setup.init_weights"):
            model = build_encoder(cfg)
            model.reset_parameters(gen)
        with tracing.span("vince.setup.to_device"):
            model.to(device).train()
            key_model = copy.deepcopy(model).requires_grad_(False)
        with tracing.span("vince.setup.init_queue"):
            queue = init_queue(gen, cfg.queue_size, cfg.embed_size, device=device,
                               shard_index=_place(mesh).queue_index,
                               num_shards=cfg.queue_axis_size)
        return VinceState(step=0, model=model, key_model=key_model,
                          optimizer=optimizer.make(model.parameters()), queue=queue)


def fold_in(seed: int, data: int) -> int:
    """A new seed from ``seed`` and ``data`` (``jax.random.fold_in`` for the
    port's integer seeds): the solver folds the prefill's call count and the
    val pass's batch index into the run's seed."""
    digest = hashlib.blake2b(f"{int(seed)},{int(data)}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def _generator(device, seed: int, index: int, stream: int) -> torch.Generator:
    """A generator for one use (``stream``) at one index (the step, or the
    source of a prefill), from the run's seed."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + index * 16 + stream) % 2 ** 63)


def _source_masks(cfg: VinceConfig, src: SourceSpec, device, data_index: int = 0):
    """Positives and batch negatives of the rank's queries of the source
    against its global keys: inter-batch → keys of the same video positive,
    every other key negative; MoCo → own key positive, batch keys not
    negatives."""
    b_local = cfg.local_batch(src)
    local = data_index * b_local + torch.arange(b_local, device=device)
    keys = torch.arange(src.batch_size, device=device)
    if cfg.inter_batch:
        return (local // src.num_frames)[:, None] == (keys // src.num_frames)[None, :], None
    pos = local[:, None] == keys[None, :]
    return pos, torch.zeros_like(pos)


def _source_offsets(cfg: VinceConfig):
    """Each source's rows in a rank's concatenated batch."""
    offs, off = [], 0
    for src in cfg.sources:
        b = cfg.local_batch(src)
        offs.append((off, off + b))
        off += b
    return offs


def _transform(cfg: VinceConfig, src: SourceSpec) -> AugmentConfig:
    return make_config(src.transform, cfg.image_size, jitter_order=cfg.jitter_order)


@dataclasses.dataclass
class StepDraws:
    """The random numbers of one step: per source the query's and the key's
    augmentation draws of the rank's rows (None for the val path), the
    shuffled-BN permutation of the global batch (None without shuffled BN)
    with, in ``a2a`` mode, its two stages ``sigma`` and ``tau`` [d, b], and
    the jigsaw permutations [b, 9] of the rank's rows for each forward that
    takes the jigsaw path, by role (``_jigsaw_roles``)."""

    augment: List[Tuple[Optional[AugmentDraws], Optional[AugmentDraws]]]
    perm: Optional[torch.Tensor]
    jigsaw: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    sigma: Optional[torch.Tensor] = None
    tau: Optional[torch.Tensor] = None


def _draw_step(cfg: VinceConfig, batch, seed: int, step: int, mode: str = "train",
               jigsaw_side: Optional[str] = None, data_index: int = 0) -> StepDraws:
    """Draw a step's random numbers on the batch's device, for the global rows
    (the rank's batch times the data axis), and keep the rank's: a row's draws
    depend on the seed, the step and its global index only. ``mode="val"``
    mirrors the reference's val loaders: queries take the val path, which
    draws nothing; keys of single-frame sources stay train-augmented, keys of
    video sources take the val path too."""
    dev = batch[0]["data"].device
    md = cfg.data_axis_size
    gen = _generator(dev, seed, step, 0)
    augment = []
    for src, src_batch in zip(cfg.sources, batch):
        b, h, w, _ = src_batch["data"].shape
        tcfg = _transform(cfg, src)

        def draw():
            return draw_rank_rows(gen, b, h, w, tcfg, data_size=md, data_index=data_index)

        if mode == "train":
            q = draw()
            k = q if src.shared_transform else draw()
        else:
            q = None
            k = draw() if src.num_frames == 1 else None
        augment.append((q, k))
    perm = sigma = tau = None
    if cfg.shuffle_bn:
        perm_gen = _generator(dev, seed, step, 1)
        if cfg.shuffle_mode == "a2a":
            perm, sigma, tau = make_balanced_shuffle_perm(perm_gen, cfg.total_batch, md)
        else:
            perm = make_shuffle_perm(perm_gen, cfg.total_batch)
    jigsaw, gen = {}, _generator(dev, seed, step, 3)
    b_total = cfg.total_batch // md
    for role in _jigsaw_roles(cfg, jigsaw_side):
        perms = (torch.arange(9, device=dev).repeat(cfg.total_batch, 1)
                 if cfg.jigsaw_identity_perms
                 else random_jigsaw_perms(gen, cfg.total_batch))
        jigsaw[role] = perms[data_index * b_total:(data_index + 1) * b_total]
    return StepDraws(augment, perm, jigsaw, sigma, tau)


def _augment(images, draws: Optional[AugmentDraws], tcfg: AugmentConfig, dtype):
    if draws is None:
        return augment_batch(None, images, tcfg, dtype, train=False)
    return apply_augment(images, draws, tcfg, dtype)


def _augment_sources(cfg: VinceConfig, batch, draws):
    """Augment every source's query and key frames on the device with the
    step's draws."""
    q_imgs, k_imgs = [], []
    for src, src_batch, (q_draws, k_draws) in zip(cfg.sources, batch, draws):
        tcfg = _transform(cfg, src)
        q_imgs.append(_augment(src_batch["data"], q_draws, tcfg, cfg.compute_dtype))
        k_imgs.append(_augment(src_batch["queue_data"], k_draws, tcfg, cfg.compute_dtype))
    return torch.cat(q_imgs, 0), torch.cat(k_imgs, 0)


def _encode(model: VinceEncoder, images, jigsaw_perm=None):
    """The encoder's forward; with ``jigsaw_perm`` the jigsaw path over the
    images' 3×3 patches."""
    if jigsaw_perm is None:
        return model(images)
    return model(jigsaw_patchify(images), jigsaw=True, jigsaw_perm=jigsaw_perm)


@torch.no_grad()
def _key_embeddings(cfg: VinceConfig, state: VinceState, k_all, draws: StepDraws,
                    jigsaw_perm=None, mesh: Optional[Mesh] = None):
    """The key encoder's f32 embeddings of each source's global rows, through
    shuffled BN when the draws hold a permutation (the jigsaw patches are cut
    after the shuffle). On a mesh the global key batch is [d, b_local_total]
    rank by rank, so source s's block is its rows of every rank, in the order
    of ``_source_masks``'s global index."""
    perm = draws.perm
    group = _place(mesh).data_group
    if perm is None:
        k_in = k_all
    elif cfg.shuffle_mode == "a2a":
        k_in = cross_device_shuffle_a2a(k_all, draws.sigma, draws.tau, group)
    else:
        k_in = cross_device_shuffle(k_all, perm, group)
    k_emb = _encode(state.key_model, k_in, jigsaw_perm)["embeddings"].float()
    k_global = (gather_global_batch(k_emb, group) if perm is None
                else cross_device_unshuffle(k_emb, perm, group))
    kg = k_global.reshape(cfg.data_axis_size, k_all.shape[0], -1)
    return [kg[:, a:b].reshape(-1, kg.shape[-1]) for a, b in _source_offsets(cfg)]


METRIC_KEYS = ("nce_accuracy", "softmax_weight", "cosine_sim", "cosine_sim_neg_max")


def _objective(cfg: VinceConfig, model: VinceEncoder, out, k_sources, queue, batch,
               align_emb=None, mesh: Optional[Mesh] = None):
    """The loss terms of JAX's ``loss_fn`` from the query forward ``out``:
    per source the InfoNCE against its keys and the queue, the self-batch
    InfoNCE, and the decoders' CE on the detached features of a CE source;
    the alignment term of ``align_emb`` (the other head's embeddings) against
    the queries. Each term and each metric is the mean over the sources that
    have it; ``loss/total_loss`` is the sum of the terms. On a mesh the
    queries are the rank's rows, scored against the global keys, the rank's
    queue shard (merged over the queue axis), and the data axis's gather of
    the queries for the self-batch and alignment terms."""
    q_emb = out["embeddings"].float()
    features = out["extracted_features"]
    terms, metrics = {}, {}
    place = _place(mesh)
    d_idx, data_group, queue_group = place.data_index, place.data_group, place.queue_group

    def add(into, key, value):
        into.setdefault(key, []).append(value)

    offsets = _source_offsets(cfg)
    for si, ((a, b), src) in enumerate(zip(offsets, cfg.sources)):
        mask, neg_mask = _source_masks(cfg, src, q_emb.device, d_idx)
        res = sharded_multi_pair_infonce(
            q_emb[a:b], k_sources[si], mask, cfg.temperature,
            queue_shard=queue, batch_neg_mask=neg_mask,
            use_fused_queue_kernel=cfg.use_fused_infonce, queue_group=queue_group)
        add(terms, "nce_loss", res["dist"])
        for mk in METRIC_KEYS:
            add(metrics, mk, res[mk])
        if cfg.self_batch:
            # q·qᵀ over the global batch with the same positives (its
            # diagonal included), no queue
            q_global = gather_global_batch(q_emb[a:b], data_group)
            res = sharded_multi_pair_infonce(q_emb[a:b], q_global, mask, cfg.self_temperature)
            add(terms, "nce_loss_self", res["dist"])
            add(metrics, "nce_accuracy_self", res["nce_accuracy"])
        if src.use_imagenet_ce:
            labels = batch[si]["labels"]
            for di, logits in enumerate(model.imagenet_logits(features[a:b].detach())):
                logits = logits.float()
                add(terms, f"imagenet_loss_{di}", F.cross_entropy(logits, labels.long()))
                add(metrics, f"imagenet_accuracy_{di}",
                    (logits.argmax(dim=-1) == labels).float().mean())
    if align_emb is not None:
        for (a, b), src in zip(offsets, cfg.sources):
            mask, _ = _source_masks(cfg, src, q_emb.device, d_idx)
            res = sharded_multi_pair_infonce(align_emb[a:b],
                                             gather_global_batch(q_emb[a:b], data_group),
                                             mask, cfg.temperature)
            add(terms, "nce_loss_align", cfg.jigsaw_align_weight * res["dist"])
            add(metrics, "nce_accuracy_align", res["nce_accuracy"])
    losses = {k: torch.stack(v).mean() for k, v in terms.items()}
    result = {k: torch.stack(v).mean() for k, v in metrics.items()}
    result.update({f"loss/{k}": v for k, v in losses.items()})
    result["loss/total_loss"] = sum(losses.values())
    return result


def _running_averages(*models: VinceEncoder) -> List[torch.Tensor]:
    return [t for model in models for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


def _mean_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The metrics averaged over ``group`` in one collective."""
    keys = list(metrics)
    values = pmean(torch.stack([metrics[k].detach().float() for k in keys]), group)
    return dict(zip(keys, values.unbind()))


# the step body's timed device regions, end to end (``tracing.regions``)
STEP_REGIONS = ("augment", "forward", "loss", "backward", "update")


def _train_body(cfg: VinceConfig, state: VinceState, batch, draws: StepDraws,
                jigsaw_side: Optional[str] = None, mesh: Optional[Mesh] = None,
                marks=tracing.NO_REGIONS):
    """One step from the augmentation's apply to the enqueue; the learning
    rate is already in ``state.optimizer``. ``marks`` (``tracing.regions``
    of ``STEP_REGIONS``) is marked at each region's boundary."""
    with bind(mesh):
        marks.mark()
        q_all, k_all = _augment_sources(cfg, batch, draws.augment)
        marks.mark()
        k_sources = _key_embeddings(cfg, state, k_all, draws, draws.jigsaw.get("key"), mesh)
        out = _encode(state.model, q_all, draws.jigsaw.get("query"))
        align_emb = None
        if cfg.jigsaw_align_weight > 0 and jigsaw_side in ("query", "key"):
            # the same queries through the head the query pass did not run, in
            # a second train-mode forward whose batch statistics are dropped
            with unrecorded_batch_stats(state.model):
                align_emb = _encode(state.model, q_all,
                                    draws.jigsaw.get("align"))["embeddings"].float()
        marks.mark()
        # the loss reads the queue before this step's enqueue
        metrics = _objective(cfg, state.model, out, k_sources, state.queue.vectors, batch,
                             align_emb, mesh)
        marks.mark()
    place = _place(mesh)
    opt = state.optimizer
    opt.zero_grad()
    # each queue shard's rank holds 1/mq of the loss; the sum of the
    # gradients over every rank, over md, is JAX's mean over the data axis of
    # the sum over the queue axis
    (metrics["loss/total_loss"] / cfg.queue_axis_size).backward()
    flat_all_reduce_([p.grad for p in opt.params if p.grad is not None], place.world_group,
                     divisor=cfg.data_axis_size)
    marks.mark()
    opt.step()
    # the running averages moved with each rank's batch statistics
    flat_all_reduce_(_running_averages(state.model, state.key_model), place.data_group,
                     divisor=cfg.data_axis_size)

    # EMA of the tracked parameters, after the optimizer step
    tracked, _ = split_vince_params(dict(state.model.named_parameters()))
    key_params = dict(state.key_model.named_parameters())
    ema_update([key_params[k] for k in tracked], tracked.values(), cfg.momentum)

    # enqueue the global keys, last
    for si, src in enumerate(cfg.sources):
        enqueue_sharded(state.queue, k_sources[si], src.source_id,
                        shard_index=place.queue_index, num_shards=cfg.queue_axis_size)
    metrics = _mean_metrics(metrics, place.data_group)
    marks.mark()
    return metrics


def _check_step(cfg: VinceConfig, jigsaw_side: Optional[str], mesh: Optional[Mesh]) -> None:
    _check_jigsaw_side(cfg, jigsaw_side)
    _check_shuffle_mode(cfg)
    _check_mesh(cfg, mesh)


def make_train_step_fn(cfg: VinceConfig, optimizer: OptimizerSpec,
                       jigsaw_side: Optional[str] = None, mesh: Optional[Mesh] = None):
    """Build the eager train step ``(state, batch, seed) → (state, metrics)``.
    ``batch`` is a tuple of per-source dicts holding uint8 ``data`` and
    ``queue_data`` [B_s, H, W, 3] on the state's device (on a mesh the rank's
    B_s/d rows), and ``labels`` [B_s] for a CE source; the metrics are 0-dim
    tensors on that device, under the JAX step's names (on a mesh, averaged
    over the data axis). ``jigsaw_side`` ∈ {None, "query", "key", "both"}."""
    _check_step(cfg, jigsaw_side, mesh)
    full_f32_products()
    d_idx = _place(mesh).data_index

    def step(state: VinceState, batch, seed: int = 0):
        with tracing.span("vince.step.draws"):
            draws = _draw_step(cfg, batch, seed, state.step, jigsaw_side=jigsaw_side,
                               data_index=d_idx)
        with tracing.span("vince.step.body"):
            state.optimizer.set_lr(optimizer.lr(state.step))
            metrics = _train_body(cfg, state, batch, draws, jigsaw_side, mesh,
                                  tracing.regions(STEP_REGIONS, state.device))
        state.step += 1
        return state, metrics

    return step


WARMUP_STEPS = 3  # eager steps before the capture


def _leaves(tree):
    """The tensors of a tree of dataclasses, dicts (by sorted key), lists and
    tuples, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)


def _copy_leaves(dst, src) -> None:
    dst, src = list(_leaves(dst)), list(_leaves(src))
    if len(dst) != len(src) or any(d.shape != s.shape or d.dtype != s.dtype
                                   for d, s in zip(dst, src)):
        raise ValueError("a captured step takes inputs of the shapes and types it captured")
    for d, s in zip(dst, src):
        d.copy_(s)


NCCL_CAPTURE_ITEM = "ROADMAP.md §1 item 8c"  # where a failed capture of collectives goes


class _CapturedTrainStep:
    """The train step as one CUDA graph (see ``make_train_step``)."""

    def __init__(self, cfg: VinceConfig, optimizer: OptimizerSpec,
                 jigsaw_side: Optional[str] = None, mesh: Optional[Mesh] = None):
        self.cfg, self.optimizer, self.jigsaw_side = cfg, optimizer, jigsaw_side
        self.mesh = mesh
        self.state: Optional[VinceState] = None  # the state the graph is bound to
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_batch = self.static_draws = self.static_metrics = None
        self.marks = tracing.NO_REGIONS  # the graph's timed regions, kept while it lives
        self.calls = 0

    def __call__(self, state: VinceState, batch, seed: int = 0):
        if self.state is None:
            if state.device.type != "cuda":
                raise ValueError(f"a captured step runs on a CUDA device, not {state.device}")
            self.state = state
        elif state is not self.state:
            raise ValueError("this captured step is bound to another state; make a step for "
                             "each state")
        if self.graph is None:
            warm = self.calls < WARMUP_STEPS
            with tracing.span("vince.step.warmup" if warm else "vince.step.capture"):
                draws = self._draws(state, batch, seed)
                state.optimizer.set_lr(self.optimizer.lr(state.step))
                if warm:
                    metrics = self._warm_up(state, batch, draws)
                else:
                    metrics = self._capture(state, batch, draws)
                metrics = {k: v.clone() for k, v in metrics.items()}
            if self.calls == WARMUP_STEPS - 1:
                _count_memory("warmup", state.device)
        else:
            with tracing.span("vince.step.draws"):
                draws = self._draws(state, batch, seed)
            with tracing.span("vince.step.inputs"):
                state.optimizer.set_lr(self.optimizer.lr(state.step))
                _copy_leaves(self.static_batch, batch)
                _copy_leaves(self.static_draws, draws)
            with tracing.span("vince.step.replay"):
                self.graph.replay()
            self.marks.arm()
            with tracing.span("vince.step.outputs"):
                # the body's Python, and so enqueue's host count, ran at capture only
                state.queue.count_inserted(self.cfg.total_batch)
                metrics = {k: v.clone() for k, v in self.static_metrics.items()}
        self.calls += 1
        state.step += 1
        return state, metrics

    def _draws(self, state, batch, seed):
        return _draw_step(self.cfg, batch, seed, state.step, jigsaw_side=self.jigsaw_side,
                          data_index=_place(self.mesh).data_index)

    def _warm_up(self, state, batch, draws):
        # on a side stream, as PyTorch's recipe for capturing a whole network
        # asks: it makes the libraries' workspaces and the kernels' one-time
        # attributes before the capture
        main = torch.cuda.current_stream(state.device)
        side = torch.cuda.Stream(state.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            metrics = _train_body(self.cfg, state, batch, draws, self.jigsaw_side, self.mesh)
        main.wait_stream(side)
        return metrics

    def _capture(self, state, batch, draws):
        static_batch = tuple({k: v.clone() for k, v in src.items()} for src in batch)
        graph = torch.cuda.CUDAGraph()
        # the regions' events become the graph's event-record nodes, only
        # while tracing is on
        marks = tracing.regions(STEP_REGIONS, state.device)
        # thread-local: another thread (the solver's batch staging) may copy
        # and allocate on its own stream while this one captures
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                metrics = _train_body(self.cfg, state, static_batch, draws, self.jigsaw_side,
                                      self.mesh, marks)
        except RuntimeError as e:
            if self.mesh is None:
                raise
            raise RuntimeError(f"the capture of the distributed step's collectives failed "
                               f"({NCCL_CAPTURE_ITEM}): {e}") from e
        _count_memory("capture", state.device)
        # kept only once the capture succeeded; a capture runs nothing, so
        # this call's step is the first replay
        self.graph, self.static_batch, self.static_draws = graph, static_batch, draws
        self.static_metrics, self.marks = metrics, marks
        graph.replay()
        return metrics


def _count_memory(after: str, device) -> None:
    """The caching allocator's reserved and allocated bytes, as counters
    ``reserved_after_<after>`` and ``allocated_after_<after>``."""
    if tracing.enabled():
        tracing.count(f"reserved_after_{after}", torch.cuda.memory_reserved(device))
        tracing.count(f"allocated_after_{after}", torch.cuda.memory_allocated(device))


def make_train_step(cfg: VinceConfig, optimizer: OptimizerSpec,
                    jigsaw_side: Optional[str] = None, mesh: Optional[Mesh] = None):
    """The captured train step ``(state, batch, seed) → (state, metrics)``, the
    counterpart of ``jax.jit(make_train_step_fn(...), donate_argnums=(0,))``,
    with the meaning of ``make_train_step_fn``'s step.

    The first ``WARMUP_STEPS`` calls are real steps run eagerly. The next one
    captures the body (augmentation apply → key forward → query forward and
    backward → update → EMA → enqueue) in one ``torch.cuda.CUDAGraph`` and
    replays it once. Every later call makes the step's draws eagerly, copies
    them and the batch into the graph's static inputs, writes the learning
    rate, and replays. The graph holds the addresses of one state's tensors,
    so the step is bound to the first state it is given; another raises. If
    the capture fails, the error surfaces: there is no eager fallback. The
    kernels' launch counters move while the graph is captured and not when it
    is replayed. The metrics are copies of the graph's outputs.

    Steps of other ``jigsaw_side``s may share one state, as the solver's
    alternation of a query-side and a key-side step does: each captures its
    own graph (in a memory pool of its own) after its own warm-up calls, and
    every replay advances the queue's host count, whichever graph ran.

    On a mesh the graph holds the step's NCCL collectives. The warm-up calls
    run a collective on every group the body uses, so that each communicator
    exists before the capture; a capture that fails raises, naming the
    ``ROADMAP.md`` item, and nothing falls back to the eager step.
    """
    _check_step(cfg, jigsaw_side, mesh)
    full_f32_products()
    return _CapturedTrainStep(cfg, optimizer, jigsaw_side, mesh)


def make_eval_step(cfg: VinceConfig, mesh: Optional[Mesh] = None):
    """The validation step ``(state, batch, seed) → metrics``: the training
    forward and loss terms (InfoNCE, self-batch, ImageNet CE; never jigsaw)
    with the val-mode augmentation and train-mode BatchNorm that records
    nothing (the JAX step runs train-mode BN, as the reference's validation
    does, and drops the statistics); no gradient, and no change to the state.
    The metrics are JAX's: each loss term, no total; on a mesh, averaged over
    the data axis."""
    _check_shuffle_mode(cfg)
    _check_mesh(cfg, mesh)
    full_f32_products()
    place = _place(mesh)

    @torch.no_grad()
    def eval_step(state: VinceState, batch, seed: int = 0) -> Dict[str, torch.Tensor]:
        draws = _draw_step(cfg, batch, seed, state.step, mode="val",
                           data_index=place.data_index)
        with bind(mesh), unrecorded_batch_stats(state.model, state.key_model):
            q_all, k_all = _augment_sources(cfg, batch, draws.augment)
            k_sources = _key_embeddings(cfg, state, k_all, draws, mesh=mesh)
            out = state.model(q_all)
            metrics = _objective(cfg, state.model, out, k_sources, state.queue.vectors, batch,
                                 mesh=mesh)
        del metrics["loss/total_loss"]
        return _mean_metrics(metrics, place.data_group)

    return eval_step


def _gathered(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The data axis's rows of ``x`` on every rank: JAX's data-sharded output."""
    return gather_global_batch(x, _place(mesh).data_group)


def make_key_prefill_fn(cfg: VinceConfig, src_idx: int, mesh: Optional[Mesh] = None):
    """The key embedder for the queue prefill, ``(state, images, seed) →``
    f32 embeddings: train-mode key augmentation of the source's
    ``queue_data`` and a train-mode forward of the key encoder whose
    statistics are dropped, the distribution of the keys a train step
    enqueues. The key encoder stands for JAX's merge of the key's tracked
    parameters and the query's rest: its untracked parameters (the ImageNet
    decoders) stay as they were made, and no key path reads them. On a mesh
    each rank embeds its rows, drawn for their global index, and the
    embeddings of the data axis's rows are gathered on every rank."""
    _check_mesh(cfg, mesh)
    tcfg = _transform(cfg, cfg.sources[src_idx])
    full_f32_products()
    place = _place(mesh)

    @torch.no_grad()
    def prefill(state: VinceState, images, seed: int = 0) -> torch.Tensor:
        b, h, w, _ = images.shape
        draws = draw_rank_rows(_generator(images.device, seed, src_idx, 2), b, h, w, tcfg,
                               data_size=cfg.data_axis_size, data_index=place.data_index)
        imgs = apply_augment(images, draws, tcfg, cfg.compute_dtype)
        with bind(mesh), unrecorded_batch_stats(state.key_model):
            return _gathered(state.key_model(imgs)["embeddings"].float(), mesh)

    return prefill


def _eval_forward(cfg: VinceConfig, model: VinceEncoder, images):
    """uint8 images → /255 → normalised → eval-mode forward (running statistics)."""
    imgs = _finalize(images.float() / 255.0, AugmentConfig()).to(cfg.compute_dtype)
    training = model.training
    model.eval()
    try:
        return model(imgs)
    finally:
        model.train(training)


def make_embed_fn(cfg: VinceConfig, use_key_encoder: bool = False,
                  mesh: Optional[Mesh] = None):
    """The embedding extractor for validation and kNN probes, ``(state,
    images) → (embeddings, extracted_features)`` in f32, eval-mode BN; with
    ``use_key_encoder`` the key encoder's parameters and statistics. On a
    mesh each rank embeds its images and both outputs are gathered over the
    data axis."""
    _check_mesh(cfg, mesh)
    full_f32_products()

    @torch.no_grad()
    def embed(state: VinceState, images):
        out = _eval_forward(cfg, state.key_model if use_key_encoder else state.model, images)
        return (_gathered(out["embeddings"].float(), mesh),
                _gathered(out["extracted_features"].float(), mesh))

    return embed


def make_panel_fn(cfg: VinceConfig, mesh: Optional[Mesh] = None):
    """The forward for the training loop's image panels, ``(state, images) →
    dict`` in f32, eval-mode BN: ``embeddings``, the pool's
    ``attention_masks`` [B, H', W', 1] with ``use_attention``, and
    ``imagenet_logits_0``/``_1`` when a source trains the decoders. On a mesh
    each output is gathered over the data axis."""
    _check_mesh(cfg, mesh)
    has_decoders = any(s.use_imagenet_ce for s in cfg.sources)
    full_f32_products()

    @torch.no_grad()
    def panel(state: VinceState, images) -> Dict[str, torch.Tensor]:
        out = _eval_forward(cfg, state.model, images)
        res = {"embeddings": out["embeddings"].float()}
        if "attention_masks" in out:
            res["attention_masks"] = out["attention_masks"].float()
        if has_decoders:
            for di, logits in enumerate(state.model.imagenet_logits(out["extracted_features"])):
                res[f"imagenet_logits_{di}"] = logits.float()
        return {k: _gathered(v, mesh) for k, v in res.items()}

    return panel
