"""The VINCE pretraining solver (counterpart of
``vince_tpu/solvers/vince_solver.py``): the training engine around the step,
on one device or, under ``--distributed``, on one rank of a (data, queue)
mesh of processes.

- Sources: an ImageNet-shaped source (decoders trained by CE) and/or a video
  source, one batch of each per iteration, concatenated; a persistent loader
  for each, and a thread that stages the next batch on the device.
- Setup: the ``VinceConfig`` from the flags, the state from the seed, restore
  of the latest checkpoint (the epoch from its step), the steps (the
  captured one on a CUDA device, the eager one on the CPU), a queue prefill
  by a repeated key batch unless a restored queue holds rows.
- An iteration: wait for the staged batch, the step, the metrics brought to
  the host in one copy, meters and log, the thumbnail ring, image panels,
  the save cadence on the global step.
- Validation: the val loaders' loss terms over one epoch-sized pass (capped
  at five minutes), and the CIFAR kNN probe (k = 11, the sample itself left
  out, a mode vote).

The step updates the state in place and, captured, holds the addresses of
its tensors: the solver never rebinds ``self.state`` or a tensor of it, and
writes the queue's prefill and a restore into the existing tensors.

On a mesh: the mesh is ``--mesh-data-size`` × ``--mesh-queue-size`` with the
data axis clamped to the processes present, as JAX clamps it to the devices;
each loader reads the shard of the rank's data index, so the ranks of one
data row read the same items, and with a queue axis the row's first rank's
batch is broadcast to the others (a video's frames are drawn at random per
process); the prefill gathers the keys over the data axis and each rank
writes its queue shard; the val pass runs its full count of batches on every
rank; logs, the profiler trace, the thumbnail ring, the image panels and the
kNN probe run with one process only, as in JAX, and the checkpoint is the
primary's.
"""

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vince_tpu_torch import native
from vince_tpu_torch.data import get_dataset
from vince_tpu_torch.data.loader import PersistentDataLoader
from vince_tpu_torch.data.npz_dataset import NPZDataset
from vince_tpu_torch.data.prefetch import BatchPrefetcher, pull_with_kill, ready, stage
from vince_tpu_torch.device import resolve_device
from vince_tpu_torch.ops.queue import HostImageRing
from vince_tpu_torch.parallel import multihost
from vince_tpu_torch.parallel.mesh import Mesh, MeshSpec
from vince_tpu_torch.solvers.base_solver import BaseSolver
from vince_tpu_torch.solvers.vince_step import (
    SourceSpec,
    VinceConfig,
    build_vince_optimizer,
    fold_in,
    init_vince_state,
    make_embed_fn,
    make_eval_step,
    make_key_prefill_fn,
    make_panel_fn,
    make_train_step,
    make_train_step_fn,
)
from vince_tpu_torch.utils.checkpoint import CheckpointManager
from vince_tpu_torch.utils.meters import AverageMeter, Stopwatch
from vince_tpu_torch.utils.torch_convert import (
    convert_vince_state_dict, init_from_reference, load_torch_checkpoint)

PROFILE_STEPS = (5, 8)  # the global steps a --profile-dir trace starts and stops at


def open_native_decode(args, device: torch.device):
    """With ``--native-decode``, build and load the decode for ``device``
    before any loader thread or worker process starts, so that a build
    failure raises in the solver's own thread and a worker process only loads
    the library."""
    if native.wanted(args) and not native.available(device):
        raise RuntimeError(f"--native-decode: the decode does not run on {device}")


def mesh_shape(args, world: int) -> Tuple[int, int]:
    """(data, queue) axis sizes from the flags over ``world`` processes: the
    data axis defaults to all the processes a queue row leaves and is clamped
    to them (JAX clamps to the devices present: ``--pytorch-gpu-ids 0,1`` on
    one process trains on one GPU), and the mesh must fill the world."""
    mq = max(getattr(args, "mesh_queue_size", 1), 1)
    asked = getattr(args, "mesh_data_size", 0) or world // mq
    md = max(1, min(asked, world // mq))
    if md != asked:
        print(f"--mesh-data-size {asked} clamped to {md}: {world} process(es), a queue axis "
              f"of {mq}")
    if md * mq != world:
        raise ValueError(f"a {md}x{mq} mesh needs {md * mq} processes, the run has {world} "
                         "(--distributed starts one per GPU)")
    return md, mq


def metrics_to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-dim device metrics → host floats in one device-to-host copy."""
    keys = list(metrics)
    values = torch.stack([metrics[k].detach().float() for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


class VinceSolver(BaseSolver):
    def __init__(self, args, train_logger=None, val_logger=None):
        platform = getattr(args, "platform", "cuda")
        self.device = (multihost.local_device(platform) if dist.is_initialized()
                       else resolve_device(platform))
        open_native_decode(args, self.device)
        md, mq = mesh_shape(args, multihost.process_count())
        # a mesh only under a process group; one process without one is the
        # single-device step (a 1x1 mesh's collectives over a world of one
        # run under --distributed)
        self.mesh = Mesh(MeshSpec(md, mq)) if dist.is_initialized() else None
        self.seed = getattr(args, "seed", 0)
        self.train_loaders: List[Tuple[str, PersistentDataLoader]] = []
        self.val_loaders: List[Tuple[str, PersistentDataLoader]] = []
        self.cifar_dataset: Optional[NPZDataset] = None
        self.image_ring: Optional[HostImageRing] = None
        self._prefetcher: Optional[BatchPrefetcher] = None
        self._profiler = None
        self._trace_done = False
        self._queue_restored = False
        super().__init__(args, train_logger, val_logger)

    @property
    def model_name(self):
        return "VinceModel"

    # ------------------------------------------------------------------ data
    def _make_dataset(self, name: str, subset: str):
        cls = get_dataset(name)
        kwargs = {}
        if name in ("R2V2Dataset", "GOT10KR2V2Dataset"):
            kwargs["num_images_to_return"] = self.args.num_frames
        if name in ("SyntheticVideoDataset", "SyntheticTextureVideoDataset"):
            kwargs["num_videos"] = getattr(self.args, "synthetic_num_videos", 512)
            kwargs["num_images_to_return"] = self.args.num_frames
        return cls(self.args, subset, **kwargs)

    def setup_dataloader(self):
        args = self.args
        self.sources: List[SourceSpec] = []
        if args.disable_dataloader:
            return
        nf = max(args.num_frames, 1)
        # the loaders shard by data index: the ranks of one data row read the
        # same items, those of other rows disjoint stride slices of one
        # shared-seed epoch permutation
        md = 1 if self.mesh is None else self.mesh.data_size
        d_idx = 0 if self.mesh is None else self.mesh.data_index

        def add_source(spec: SourceSpec, dataset_name: str):
            self.sources.append(spec)
            items_per_batch = spec.batch_size // spec.num_frames
            if items_per_batch % md:
                raise ValueError(f"{spec.name}: {items_per_batch} videos/batch not divisible by "
                                 f"a data axis of {md} — raise --batch-size")
            items = items_per_batch // md
            train_loader = PersistentDataLoader(
                batch_size=items,
                num_workers=min(args.num_workers, 16),
                never_ending=True,
                use_processes=getattr(args, "loader_processes", False),
                num_shards=md,
                shard_id=d_idx,
            )
            train_loader.set_dataset(self._make_dataset(dataset_name, "train"))
            val_loader = PersistentDataLoader(
                batch_size=items,
                num_workers=min(args.num_workers, 8),
                never_ending=True,
                num_shards=md,
                shard_id=d_idx,
            )
            val_ds = self._make_dataset(dataset_name, "val")
            val_loader.set_dataset(val_ds)
            # one pass over the val set: ceil(the shard's share / items)
            # batches, the same count on every rank
            self._val_epoch_batches = max(getattr(self, "_val_epoch_batches", 0),
                                          -(-(len(val_ds) // md) // items))
            self.train_loaders.append((spec.name, train_loader))
            self.val_loaders.append((spec.name, val_loader))

        if args.use_imagenet:
            name = "SyntheticImageDataset" if not args.imagenet_data_path else "ImagenetDataset"
            add_source(
                SourceSpec(
                    "IN", batch_size=args.batch_size, num_frames=nf,
                    transform=args.transform, use_imagenet_ce=True, source_id=0,
                ),
                name,
            )
        if args.use_videos or (args.dataset and not args.use_imagenet):
            add_source(
                SourceSpec(
                    "YT", batch_size=args.batch_size, num_frames=nf,
                    transform=args.transform, source_id=1,
                ),
                args.dataset or "R2V2Dataset",
            )
        if not self.sources:
            raise ValueError("no data sources configured (--use-imagenet / --use-videos / "
                             "--dataset)")

    def setup_other(self):
        path = getattr(self.args, "cifar_data_path", "")
        try:
            self.cifar_dataset = NPZDataset(self.args, path, "train", 10000)
            print(f"CIFAR probe loaded: {len(self.cifar_dataset)} images")
        except (FileNotFoundError, OSError, KeyError, ValueError):
            self.cifar_dataset = None
            print("CIFAR probe data not found; kNN probe disabled")

    # ----------------------------------------------------------------- model
    def _config(self) -> VinceConfig:
        args = self.args
        return VinceConfig(
            sources=tuple(self.sources),
            backbone=args.backbone,
            embed_size=args.vince_embedding_size,
            image_size=args.input_width,
            queue_size=args.vince_queue_size,
            temperature=args.vince_temperature,
            self_temperature=args.vince_self_temperature,
            momentum=args.vince_momentum,
            inter_batch=args.inter_batch_comparison,
            self_batch=args.self_batch_comparison,
            use_attention=args.use_attention,
            jigsaw=args.jigsaw,
            jigsaw_align_weight=getattr(args, "jigsaw_align_weight", 0.0),
            shuffle_bn=getattr(args, "shuffle_bn", True),
            compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32,
            # the streamed kernel pays at large queues: on by itself above 65536
            use_fused_infonce=getattr(args, "use_fused_infonce", False)
            or args.vince_queue_size > 65536,
            remat=getattr(args, "remat", False),
            stem_kind=getattr(args, "stem_kind", "s2d"),
            bn_fold=getattr(args, "bn_fold", "expand"),
            norm_kind=getattr(args, "norm_kind", "batchnorm"),
            fold_kernel=getattr(args, "fold_kernel", False),
            dw_kind={"pallas": "kernel"}.get(getattr(args, "dw_kind", "conv"),
                                             getattr(args, "dw_kind", "conv")),
            se_kind=getattr(args, "se_kind", "mul"),
            jitter_order=getattr(args, "jitter_order", "torchvision"),
            shuffle_mode=getattr(args, "shuffle_mode", "gather"),
            data_axis_size=1 if self.mesh is None else self.mesh.data_size,
            queue_axis_size=1 if self.mesh is None else self.mesh.queue_size,
            sync_bn=getattr(args, "sync_bn", False),
        )

    def setup_model(self):
        args = self.args
        self.cfg = self._config()
        self.optimizer = build_vince_optimizer(self.lr_schedule,
                                               kind=getattr(args, "optimizer", "sgd"))
        mesh = self.mesh
        self.state = init_vince_state(self.seed, self.cfg, self.optimizer, device=self.device,
                                      mesh=mesh)
        weights_path = getattr(args, "pretrained_weights_path", "")
        if (getattr(args, "use_imagenet_weights", False) or weights_path) \
                and os.path.exists(weights_path):
            # a reference (torchvision / VinceModel) checkpoint as the encoders' start
            init_from_reference(self.state,
                                convert_vince_state_dict(load_torch_checkpoint(weights_path)))
            print(f"Initialized backbone from torch weights: {weights_path}")
        self.ckpt = CheckpointManager(
            args.checkpoint_dir,
            args.long_save_checkpoint_dir,
            max_to_keep=5,
            long_save_frequency=args.long_save_frequency,
            mesh=mesh,
        )
        if args.restore and self.ckpt.restore(
                self.state, saved_variable_prefix=args.saved_variable_prefix,
                new_variable_prefix=args.new_variable_prefix) is not None:
            self.iteration = self.state.step * args.batch_size
            self.epoch = self.iteration // (args.iterations_per_epoch * args.batch_size)
            # the checkpoint holds the queue: a restored bank is not refilled
            self._queue_restored = self.state.queue.inserted > 0
            print(f"Restored step {self.state.step}; resuming epoch {self.epoch}")

        # the captured step on a CUDA device; the eager one only on the CPU
        capture = make_train_step if self.device.type == "cuda" else make_train_step_fn

        def make_step(cfg, optimizer, jigsaw_side=None):
            return capture(cfg, optimizer, jigsaw_side=jigsaw_side, mesh=mesh)

        self.train_step = make_step(self.cfg, self.optimizer)
        if self.cfg.jigsaw:
            if getattr(args, "jigsaw_sides", "alternate") == "both":
                both = make_step(self.cfg, self.optimizer, jigsaw_side="both")
                self.train_step_jigsaw_q = self.train_step_jigsaw_k = both
            else:
                self.train_step_jigsaw_q = make_step(self.cfg, self.optimizer, jigsaw_side="query")
                self.train_step_jigsaw_k = make_step(self.cfg, self.optimizer, jigsaw_side="key")
                both = None
            if getattr(args, "jigsaw_warmup_steps", 0) > 0:
                # the warm-up's both-sides step exists whatever the sides
                self.train_step_jigsaw_both = both or make_step(
                    self.cfg, self.optimizer, jigsaw_side="both")
        self.eval_step = make_eval_step(self.cfg, mesh)
        self.embed_fn = make_embed_fn(self.cfg, mesh=mesh)
        self.key_embed_fn = make_embed_fn(self.cfg, use_key_encoder=True, mesh=mesh)
        self.key_prefill_fns = [make_key_prefill_fn(self.cfg, i, mesh)
                                for i in range(len(self.sources))]
        self._prefill_counter = 0
        self.panel_fn = make_panel_fn(self.cfg, mesh)
        self._prefetch_stream = (torch.cuda.Stream(self.device)
                                 if self.device.type == "cuda" else None)
        # a thumbnail of each queue row for the panels, at a resolution that
        # holds the ring under VINCE_THUMB_RING_MB (default 256) of host memory
        self.image_ring = HostImageRing(self.cfg.queue_size)
        budget = float(os.environ.get("VINCE_THUMB_RING_MB", 256)) * 1e6
        side = max(8.0, np.sqrt(budget / (3 * max(self.cfg.queue_size, 1))))
        canvas = int(self.cfg.image_size / 0.875)
        self._thumb_stride = max(1, int(np.ceil(canvas / side)))
        if self._queue_restored:
            self.image_ring.clear(tail=int(self.state.queue.tail))
        self._np_rng = np.random.RandomState(1234)

        if not args.disable_dataloader and not self._queue_restored:
            self.fill_queue_repeat()
        if not args.disable_dataloader:
            # the prefill above stages its batch itself
            self.start_prefetch()

    def setup_optimizer(self):
        pass  # built in setup_model (the step holds it)

    # ----------------------------------------------------------------- batch
    def _host_arrays(self, host_batches) -> List[Dict[str, np.ndarray]]:
        out = []
        for spec, hb in zip(self.sources, host_batches):
            d = {"data": hb["data"], "queue_data": hb["queue_data"]}
            if spec.use_imagenet_ce:
                d["labels"] = hb["imagenet_labels"].astype(np.int32)
            out.append(d)
        return out

    def _stage_batch(self, should_stop=None, stream=None):
        """Pull one host batch per source and stage it on the device; None
        once ``should_stop`` says so."""
        host_batches = []
        for _, loader in self.train_loaders:
            hb = pull_with_kill(loader, should_stop)
            if hb is None:
                return None
            host_batches.append(hb)
        return stage(self._host_arrays(host_batches), self.device, stream), host_batches

    def start_prefetch(self):
        if not getattr(self.args, "batch_prefetch", True):
            return
        if self._prefetcher is None and self.train_loaders:
            self._prefetcher = BatchPrefetcher(
                lambda stop: self._stage_batch(stop, self._prefetch_stream)).start()

    def stop_prefetch(self):
        if self._prefetcher is not None:
            self._prefetcher.stop()
            self._prefetcher = None

    def _same_in_queue_row(self, device_batch):
        """With a queue axis, the data row's first rank's batch on every rank
        of the row, in place (on this thread, in the order of the step's
        collectives)."""
        mesh = self.mesh
        if mesh is not None and mesh.queue_size > 1:
            for src in device_batch:
                for k in sorted(src):
                    dist.broadcast(src[k], mesh.queue_source_rank(), group=mesh.queue_group)
        return device_batch

    def get_batch(self):
        """(per-source device dicts, their host batches), the device tensors
        ordered before what the current stream runs next."""
        staged, host_batches = (self._stage_batch() if self._prefetcher is None
                                else self._prefetcher.get())
        return self._same_in_queue_row(ready(staged, self.device)), host_batches

    # ----------------------------------------------------------------- queue
    def _embed_batch_keys(self, device_batch):
        """The key encoder's embeddings of one batch and their source tags, on
        the device: train-mode augmentation and forward, as the keys a step
        enqueues. Each call draws anew (its count folded into the seed)."""
        seed = fold_in(self.seed + 1, self._prefill_counter)
        self._prefill_counter += 1
        keys, srcs = [], []
        for i, (spec, src_batch) in enumerate(zip(self.sources, device_batch)):
            emb = self.key_prefill_fns[i](self.state, src_batch["queue_data"], seed)
            keys.append(emb)
            srcs.append(torch.full((len(emb),), spec.source_id, dtype=torch.int32,
                                   device=emb.device))
        return torch.cat(keys), torch.cat(srcs)

    @torch.no_grad()
    def _write_queue(self, bank, sources, tail: int, total: int):
        """The whole bank (the same on every rank: the prefill gathers its
        keys) into the state's queue, in place: on a mesh, the rank's shard."""
        q = self.state.queue
        if self.mesh is not None:
            bank = multihost.local_slice(bank, self.mesh.queue_index, self.mesh.queue_size)
            sources = multihost.local_slice(sources, self.mesh.queue_index,
                                            self.mesh.queue_size)
        q.vectors.copy_(bank)
        q.sources.copy_(sources)
        q.tail.fill_(tail)
        q.total.fill_(total)
        q.inserted = total

    def _host_thumbs(self, host_batches):
        """Per-key thumbnails and source names, in the order the step inserts
        the keys. Copies: a strided view would keep the whole host batch
        alive as long as the ring holds the row."""
        thumbs, names = [], []
        s = self._thumb_stride
        for spec, hb in zip(self.sources, host_batches):
            thumbs.extend(np.ascontiguousarray(hb["queue_data"][:, ::s, ::s]))
            names.extend([spec.name] * len(hb["queue_data"]))
        return thumbs, names

    def fill_queue(self):
        """Prefill the bank from distinct key batches (leaves it marked full)."""
        k = self.cfg.queue_size
        keys, srcs, n = [], [], 0
        thumbs, names = [], []
        print("Filling queue")
        while n < k:
            device_batch, host_batches = self.get_batch()
            e, s = self._embed_batch_keys(device_batch)
            keys.append(e)
            srcs.append(s)
            if not multihost.is_multiprocess():  # no ring with more than one process
                t, nm = self._host_thumbs(host_batches)
                thumbs.extend(t)
                names.extend(nm)
            n += len(e)
        self._write_queue(torch.cat(keys)[:k], torch.cat(srcs)[:k], tail=0, total=k)
        if not multihost.is_multiprocess():
            self.image_ring.fill_repeat(thumbs[:k], names[:k])
        print("Queue filled")

    def fill_queue_repeat(self):
        """Prefill the bank by repeating one key batch (tail 0, not full)."""
        device_batch, host_batches = self.get_batch()
        keys, srcs = self._embed_batch_keys(device_batch)
        k = self.cfg.queue_size
        reps = -(-k // len(keys))
        self._write_queue(keys.repeat(reps, 1)[:k], srcs.repeat(reps)[:k], tail=0, total=0)
        if not multihost.is_multiprocess():
            thumbs, names = self._host_thumbs(host_batches)
            self.image_ring.fill_repeat(thumbs, names)
        print("Queue filled with repeats")

    # ----------------------------------------------------------------- train
    def loss_keys(self):
        keys = ["nce_loss"]
        if self.cfg.self_batch:
            keys.append("nce_loss_self")
        if any(s.use_imagenet_ce for s in self.sources):
            keys += ["imagenet_loss_0", "imagenet_loss_1"]
        return keys

    def metric_keys(self):
        keys = ["nce_accuracy", "softmax_weight", "cosine_sim", "cosine_sim_neg_max"]
        if self.cfg.self_batch:
            keys.append("nce_accuracy_self")
        if any(s.use_imagenet_ce for s in self.sources):
            keys += ["imagenet_accuracy_0", "imagenet_accuracy_1"]
        return keys

    def _profile(self):
        """With ``--profile-dir``, a torch.profiler trace from global step 5 to
        8, written as a Chrome trace into the directory."""
        profile_dir = getattr(self.args, "profile_dir", "")
        if not profile_dir or self._trace_done or not multihost.is_primary():
            return
        first, last = PROFILE_STEPS
        if self.state.step == first and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
        elif self.state.step >= last and self._profiler is not None:
            self._stop_profile()

    def _stop_profile(self):
        profiler, self._profiler = self._profiler, None
        profiler.stop()
        os.makedirs(self.args.profile_dir, exist_ok=True)
        path = os.path.join(self.args.profile_dir, "trace_steps_%d-%d.json" % PROFILE_STEPS)
        profiler.export_chrome_trace(path)
        self._trace_done = True
        print(f"profiler trace written to {path}")

    def select_step(self):
        """The step of this iteration: with the jigsaw, the both-sides step
        (or, with the mix, a plain one on odd steps) for the warm-up steps,
        then a coin from ``RandomState(1234)`` picks the key or the query
        side."""
        if not self.cfg.jigsaw:
            return self.train_step
        if self.global_step < getattr(self.args, "jigsaw_warmup_steps", 0):
            if getattr(self.args, "jigsaw_warmup_mix", False) and self.global_step % 2 == 1:
                return self.train_step
            return self.train_step_jigsaw_both
        return (self.train_step_jigsaw_k if self._np_rng.rand() < 0.5
                else self.train_step_jigsaw_q)

    def run_train_iteration(self):
        self._profile()
        watch = Stopwatch().start()
        # with the prefetch thread on, the wait for its next staged batch
        device_batch, host_batches = self.get_batch()
        self.time_meters["data_cache_time"].update(watch.lap())

        step_fn = self.select_step()
        _, metrics = step_fn(self.state, device_batch, self.seed)
        # the iteration's one wait on the device: this lap times the step
        metrics = metrics_to_host(metrics)
        self.time_meters["step_time"].update(watch.lap())

        self.log_step_metrics(metrics)
        self.time_meters["metrics_time"].update(watch.lap())

        # the thumbnail ring and the panels with one process only: a rank sees
        # its rows of the batch, and the panel's forward is a collective no
        # rank may run alone
        if not multihost.is_multiprocess():
            thumbs, names = self._host_thumbs(host_batches)
            for t, nm in zip(thumbs, names):
                self.image_ring.enqueue([t], nm)
            # panels only where the logger writes images (tensorboardX imports)
            if (self.train_logger is not None and self.train_logger.writer is not None
                    and self.logger_iteration > 0
                    and self.logger_iteration % self.args.image_log_frequency == 0):
                self.log_images(host_batches)

        self.iteration += self.args.batch_size
        self.logger_iteration += 1
        # on the global step, which no epoch resets
        if self.args.save and self.global_step % self.args.save_frequency == 0:
            self.save(num_to_keep=5)
        self.time_meters["log_save_time"].update(watch.lap())
        self.time_meters["total_time"].update(watch.total())
        return metrics

    def log_images(self, host_batches):
        """The image panels: input pairs, nearest neighbours in the batch and
        the queue, ImageNet predictions, attention overlays; from eval-mode
        embeddings of the raw canvases."""
        from vince_tpu_torch.visualizations import panels

        dev = self.device
        queue_vecs = self.state.queue.vectors.cpu().numpy()
        for spec, hb in zip(self.sources, host_batches):
            data, keys = hb["data"], hb["queue_data"]
            grid = panels.input_pair_grid(data, keys, spec.num_frames)
            self.train_logger.image_summary(
                f"{self.full_name}_inputs/{spec.name}", grid, self.iteration)
            q_out = {k: v.cpu().numpy() for k, v in
                     self.panel_fn(self.state, torch.from_numpy(data).to(dev)).items()}
            k_emb, _ = self.key_embed_fn(self.state, torch.from_numpy(keys).to(dev))
            q, k = q_out["embeddings"], k_emb.cpu().numpy()
            sims = q @ np.concatenate([k, queue_vecs]).T
            groups_q = np.arange(len(q)) // spec.num_frames
            mask = np.zeros_like(sims, dtype=bool)
            mask[:, : len(k)] = groups_q[:, None] == groups_q[None, :]
            panel = panels.nearest_neighbor_panel(
                data, keys, sims, mask, self.image_ring.images, self.image_ring.sources,
                temperature=self.cfg.temperature, data_source=spec.name)
            self.train_logger.image_summary(
                f"{self.full_name}_outputs/{spec.name}", panel, self.iteration)
            if spec.use_imagenet_ce and "imagenet_logits_0" in q_out and "imagenet_labels" in hb:
                pred = panels.imagenet_prediction_grid(
                    data, q_out["imagenet_logits_0"],
                    np.asarray(hb["imagenet_labels"], np.int64), rng=self._np_rng)
                self.train_logger.image_summary(
                    f"{self.full_name}_predictions/{spec.name}", pred, self.iteration)
            if "attention_masks" in q_out:
                k_out = self.panel_fn(self.state, torch.from_numpy(keys).to(dev))
                att = panels.attention_panel(
                    data, keys, q_out["attention_masks"],
                    k_out["attention_masks"].cpu().numpy(), rng=self._np_rng)
                self.train_logger.image_summary(
                    f"{self.full_name}_attention/{spec.name}", att, self.iteration)

    # ------------------------------------------------------------------- val
    def run_val(self, max_seconds: float = 300.0, max_batches: Optional[int] = None):
        """The loss terms on each val loader over one epoch-sized pass,
        wall-capped at ``max_seconds``, each batch's index folded into the
        seed; then the CIFAR kNN probe. ``max_batches`` caps the pass."""
        epoch_meters: Dict[str, AverageMeter] = {}
        t_start = time.time()
        n = 0
        cap = getattr(self, "_val_epoch_batches", None) or 1
        if max_batches is not None:
            cap = min(cap, max_batches)
        if multihost.is_multiprocess():
            # the eval step is a collective: every rank runs the same count of
            # batches, so a rank's own clock cannot cut the pass
            max_seconds = float("inf")
        while time.time() - t_start < max_seconds and n < cap:
            host_batches = [loader.get_batch() for _, loader in self.val_loaders]
            device_batch = self._same_in_queue_row(
                ready(stage(self._host_arrays(host_batches), self.device), self.device))
            metrics = metrics_to_host(
                self.eval_step(self.state, device_batch, fold_in(self.seed, n)))
            for k, v in metrics.items():
                epoch_meters.setdefault(k, AverageMeter()).update(v)
            n += 1

        self.last_val_batches = n
        self.last_val_seconds = time.time() - t_start
        results = {k: m.value for k, m in epoch_meters.items()}
        knn_acc = self.run_cifar_knn()
        if knn_acc is not None:
            results["epoch_knn_cifar"] = knn_acc
        if self.val_logger is not None:
            self.val_logger.dict_log(
                {f"epoch/{self.full_name}/{k}": v for k, v in results.items()},
                self.iteration,
            )
        print("val:", {k: round(v, 4) for k, v in results.items()})
        return results

    def run_cifar_knn(self) -> Optional[float]:
        """Embed the probe set; each sample's 10 nearest others (k-d tree,
        Euclidean) vote on its label by their mode."""
        if self.cifar_dataset is None:
            return None
        if multihost.is_multiprocess():
            # a single-process probe: run it from a checkpoint
            if not getattr(self, "_knn_notice_done", False):
                self._knn_notice_done = True
                print("kNN probe skipped under --distributed")
            return None
        import scipy.stats
        from scipy.spatial import cKDTree

        feats = []
        for chunk, _, valid in self.cifar_dataset.iter_batches(self.args.batch_size):
            emb, _ = self.embed_fn(self.state, torch.from_numpy(chunk).to(self.device))
            feats.append(emb[:valid].cpu().numpy())
        feats = np.concatenate(feats)[: len(self.cifar_dataset)]
        labels = self.cifar_dataset.labels
        k = min(11, len(feats))
        neighbors = cKDTree(feats, leafsize=40).query(feats, k=list(range(1, k + 1)))[1][:, 1:]
        preds = scipy.stats.mode(labels[neighbors], axis=1).mode.reshape(-1)
        acc = float(np.mean(preds == labels))
        print(f"CIFAR kNN accuracy: {acc:.4f}")
        return acc

    # ------------------------------------------------------------------ save
    def save(self, num_to_keep: int = 5):
        if not self.args.save:
            return
        self.ckpt.save(self.global_step, self.state)

    def end(self):
        if getattr(self, "_ended", False):
            return
        self._ended = True
        self.stop_prefetch()
        if self._profiler is not None:
            self._stop_profile()
        for _, loader in self.train_loaders + self.val_loaders:
            loader.shutdown()
        self.ckpt.close()
