"""End-task solvers (counterpart of ``vince_tpu/solvers/end_task_solvers.py``):
the ImageNet and SUN-397 probes, the Kinetics-400 LSTM and SiamFC tracking, on
one device or, under ``--distributed``, data-parallel across processes.

- The encoder is restored from a VINCE pretraining checkpoint of the port
  (``--checkpoint-dir``, by default ``<base_logdir>/<title>/checkpoints_
  <description>``, the pretraining run's own): the query encoder, not the
  key encoder. Without one (or with ``--no-restore``) its features are random.
- It is frozen (``--freeze-feature-extractor``: eval-mode forward, no
  gradient, weight decay 0) or fine-tuned (train-mode BatchNorm, its own
  optimizer group, weight decay 1e-4).
- ImageNet: SGD with momentum, the heads at base_lr·(1, 0.01); SUN: Adam,
  equal rates; Kinetics: Adam, an LSTM over each clip's frames (a batch of
  ``--batch-size`` frames is ``batch_size // num_frames`` clips); tracking:
  SGD with momentum, GOT-10k pairs cropped on the host, a dilated ResNet.
- An iteration: wait for the staged batch, the eager step, the metrics
  brought to the host in one copy, meters and log, the save cadence on the
  global step. The end task's checkpoints live under
  ``<base_logdir>/<title>/<ModelName>/checkpoints_<description>``; a
  restore sets ``iteration = step · batch_size``.
- Validation is one exact pass over the val split: its last batch is padded
  by cycling its items, and only the real items' per-sample metrics count.
  ``run_eval`` is that pass on a freshly built val loader; for tracking it
  is OTB-2015's one-pass evaluation of the tracker instead.

Under ``--distributed`` (one process per GPU, ``parallel/multihost.py``)
the step runs on a data axis of every process and a queue axis of one,
whatever ``--mesh-queue-size`` says, as JAX builds it. Each process loads its
shard of the train split, ``batch_size / processes`` items a batch. In the
val pass each process reads its stride slice of the split and runs the same
number of batches, ``ceil(ceil(len / processes) / items)``: a process whose
slice has run dry runs its last batch again with zero weight, as JAX does to
keep its collective step in line; the sums and the sample count are then
added over the processes. The primary writes the checkpoint, and every
process restores the same replicated state. Tracking's OTB evaluation runs
on the primary alone while the others wait for its outcome, broadcast over a
``gloo`` side group whose timeout (``OTB_BARRIER_TIMEOUT``) outlasts the
tracker's run.
"""

import dataclasses
import datetime
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from vince_tpu_torch.data import get_dataset
from vince_tpu_torch.data.loader import PersistentDataLoader
from vince_tpu_torch.data.prefetch import BatchPrefetcher, pull_with_kill, ready, stage
from vince_tpu_torch.device import resolve_device
from vince_tpu_torch.models import backbones
from vince_tpu_torch.parallel import multihost
from vince_tpu_torch.parallel.mesh import Mesh, MeshSpec
from vince_tpu_torch.solvers.base_solver import BaseSolver
from vince_tpu_torch.solvers.end_task_step import (
    EndTaskConfig,
    build_optimizer,
    init_end_task_state,
    make_end_task_train_step,
)
from vince_tpu_torch.solvers.vince_solver import metrics_to_host, open_native_decode
from vince_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    end_task_state_tree,
    load_end_task_state_tree,
    read_pretrain_encoder,
)
from vince_tpu_torch.utils.meters import Stopwatch

LABEL_KEYS = ("classifier_labels", "labels", "imagenet_labels")
# how long the other processes wait for the primary's OTB evaluation
OTB_BARRIER_TIMEOUT = datetime.timedelta(hours=4)


def data_axis_size(args) -> int:
    """The end task's data axis: every process, one GPU each. A larger
    ``--mesh-data-size`` is clamped to them, as JAX clamps it to the devices;
    a smaller one does not divide over them (JAX's check) and raises."""
    pc = multihost.process_count()
    asked = getattr(args, "mesh_data_size", 0)
    if 0 < asked < pc:
        raise ValueError(f"--mesh-data-size {asked} must be divisible by the {pc} processes")
    return pc


class EndTaskBaseSolver(BaseSolver):
    task = "classifier"
    optimizer_kind = "adam"
    head_lr_scales = (1.0, 1.0)
    default_dataset: Optional[str] = None
    default_transform = "BasicImagenetTransform"

    def __init__(self, args, train_logger=None, val_logger=None):
        platform = getattr(args, "platform", "cuda")
        self.device = (multihost.local_device(platform) if dist.is_initialized()
                       else resolve_device(platform))
        open_native_decode(args, self.device)
        # a mesh only under a process group, its queue axis 1 whatever the flags say
        md = data_axis_size(args)
        self.mesh = Mesh(MeshSpec(md, 1)) if dist.is_initialized() else None
        self.seed = getattr(args, "seed", 0)
        self.train_loader: Optional[PersistentDataLoader] = None
        self._prefetcher: Optional[BatchPrefetcher] = None
        super().__init__(args, train_logger, val_logger)

    @property
    def model_name(self):
        return type(self).__name__[: -len("Solver")] + "Model"

    # ------------------------------------------------------------------ data
    def _make_dataset(self, subset: str):
        name = self.args.dataset or self.default_dataset
        kwargs = {}
        if name == "Kinetics400Dataset":
            kwargs["num_images_to_return"] = self.args.num_frames
        return get_dataset(name)(self.args, subset, **kwargs)

    def _items_per_batch(self) -> int:
        return self.args.batch_size // max(self.args.num_frames, 1)

    def setup_dataloader(self):
        if self.args.disable_dataloader:
            return
        items, pc = self._items_per_batch(), multihost.process_count()
        if items % pc:
            raise ValueError(f"{items} items/batch not divisible by {pc} processes — "
                             "raise --batch-size")
        self.train_loader = PersistentDataLoader(
            batch_size=items // pc, num_workers=min(self.args.num_workers, 16),
            never_ending=True, use_processes=getattr(self.args, "loader_processes", False),
            num_shards=pc, shard_id=multihost.process_index())
        self.train_loader.set_dataset(self._make_dataset("train"))
        # val loaders are one-shot, built per pass (_fresh_val_loader)

    # ----------------------------------------------------------------- model
    def _restore_encoder(self) -> Optional[Dict[str, torch.Tensor]]:
        """The pretraining checkpoint's query encoder, or None (random
        features) without one or with ``--no-restore``."""
        if not self.args.restore:
            return None
        # the pretraining run's own directory unless --checkpoint-dir says otherwise
        pdir = self.args.checkpoint_dir or os.path.join(
            self.args.base_logdir, self.args.title, "checkpoints_" + self.args.description)
        tensors = read_pretrain_encoder(pdir)
        if tensors is None:
            print(f"No pretrain checkpoint at {pdir}; using random encoder features")
            return None
        print(f"Restored pretrain encoder from {pdir}")
        return tensors

    def make_config(self) -> EndTaskConfig:
        args = self.args
        return EndTaskConfig(
            task=self.task,
            backbone=args.backbone,
            embed_size=args.vince_embedding_size,
            num_classes=args.end_task_classifier_num_classes or 1000,
            num_frames=max(args.num_frames, 1),
            image_size=args.input_width,
            transform=args.transform or self.default_transform,
            freeze_feature_extractor=args.freeze_feature_extractor,
            use_attention=args.use_attention,
            compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32,
            data_axis_size=1 if self.mesh is None else self.mesh.data_size,
            head_lr_scales=self.head_lr_scales,
            bn_fold=getattr(args, "bn_fold", "none"),
            norm_kind=getattr(args, "norm_kind", "batchnorm"),
        )

    def setup_model(self):
        args = self.args
        self.cfg = self.make_config()
        # every group's rate follows the pretraining solver's schedule (epoch
        # decay and warm-up), times the head's scale
        self.optimizer = build_optimizer(self.cfg, args.base_lr, self.optimizer_kind,
                                         schedule=self.lr_schedule)
        self.state = init_end_task_state(self.seed, self.cfg, self.optimizer,
                                         encoder_tensors=self._restore_encoder(),
                                         device=self.device)
        root = os.path.join(args.base_logdir, args.title, self.model_name)
        self.ckpt = CheckpointManager(
            os.path.join(root, "checkpoints_" + args.description),
            os.path.join(root, "long_checkpoints"), max_to_keep=5,
            long_save_frequency=args.long_save_frequency,
            tree_fn=end_task_state_tree, load_fn=load_end_task_state_tree, mesh=self.mesh)
        # the state is replicated: every process restores the same file
        if args.restore and self.ckpt.restore(self.state) is not None:
            self.iteration = self.state.step * args.batch_size
            print(f"Restored end-task step {self.state.step}")
        self.train_step = make_end_task_train_step(self.cfg, train=True, mesh=self.mesh)
        self.metric_step = make_end_task_train_step(self.cfg, train=False, per_sample=True,
                                                    mesh=self.mesh)
        self._prefetch_stream = (torch.cuda.Stream(self.device)
                                 if self.device.type == "cuda" else None)

    def setup_optimizer(self):
        pass  # built in setup_model

    # ----------------------------------------------------------------- batch
    def _host_arrays(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """A collated host batch → the step's ``data`` and int32 ``labels``
        (one per clip for Kinetics, whose data are frame-major)."""
        data = host_batch["data"]
        labels = host_batch.get("classifier_labels", host_batch.get("labels"))
        if self.task == "kinetics" and labels.shape[0] * self.cfg.num_frames != data.shape[0]:
            raise ValueError(f"{labels.shape[0]} labels for {data.shape[0]} frames of "
                             f"{self.cfg.num_frames}-frame clips")
        return {"data": data, "labels": np.asarray(labels, np.int32)}

    def convert_batch(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A host batch staged on the device, ready for the current stream."""
        return ready(stage([self._host_arrays(host_batch)], self.device), self.device)[0]

    def loss_keys(self):
        return ["classifier_loss_0", "classifier_loss_1"] if self.task == "classifier" else [
            "classifier_loss_0"]

    def metric_keys(self):
        return (["classifier_accuracy_0", "classifier_accuracy_1"]
                if self.task == "classifier" else ["classifier_accuracy_0"])

    # ----------------------------------------------------------------- train
    def _stage_train_batch(self, should_stop=None, stream=None):
        hb = pull_with_kill(self.train_loader, should_stop)
        return None if hb is None else stage([self._host_arrays(hb)], self.device, stream)

    def run_train_iteration(self):
        watch = Stopwatch().start()
        # the staging thread starts at the first iteration: an eval-only run
        # (run_end_task_eval) stages no train batch
        if (self._prefetcher is None and getattr(self.args, "batch_prefetch", True)
                and self.train_loader is not None):
            self._prefetcher = BatchPrefetcher(
                lambda stop: self._stage_train_batch(stop, self._prefetch_stream)).start()
        staged = (self._prefetcher.get() if self._prefetcher is not None
                  else self._stage_train_batch())
        batch = ready(staged, self.device)[0]
        self.time_meters["data_cache_time"].update(watch.lap())
        _, metrics = self.train_step(self.state, batch, self.seed)
        # the iteration's one wait on the device: this lap times the step
        metrics = metrics_to_host(metrics)
        self.time_meters["step_time"].update(watch.lap())
        self.log_step_metrics(metrics)
        self.time_meters["metrics_time"].update(watch.lap())
        self.iteration += self.args.batch_size
        self.logger_iteration += 1
        # on the global step, which no epoch resets
        if self.args.save and self.global_step % self.args.save_frequency == 0:
            self.save()
        self.time_meters["log_save_time"].update(watch.lap())
        self.time_meters["total_time"].update(watch.total())
        return metrics

    # ------------------------------------------------------------------- val
    def _fresh_val_loader(self, dataset=None):
        """A one-shot loader (no cycling, no shuffle) over ``dataset``, by
        default a freshly built val split; with more than one process, this
        process's stride slice of it."""
        dataset = dataset if dataset is not None else self._make_dataset("val")
        pc = multihost.process_count()
        loader = PersistentDataLoader(
            batch_size=self._items_per_batch() // pc, num_workers=min(self.args.num_workers, 8),
            shuffle=False, never_ending=False, num_shards=pc,
            shard_id=multihost.process_index())
        loader.set_dataset(dataset)
        return dataset, loader

    @staticmethod
    def _pad_host_batch(hb: Dict[str, np.ndarray], target_items: int, n_items: int):
        """Pad a partial last batch to the static batch shape by cycling its
        items (rows per item kept: a clip's frames stay together)."""
        if n_items == target_items:
            return hb
        idx = np.arange(target_items) % n_items
        out = {}
        for k, v in hb.items():
            if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] % n_items == 0:
                rows = v.shape[0] // n_items
                vi = v.reshape((n_items, rows) + v.shape[1:])
                out[k] = vi[idx].reshape((target_items * rows,) + v.shape[1:])
            else:
                out[k] = v
        return out

    def run_val(self, max_batches: Optional[int] = None, loader=None, dataset=None):
        """One complete pass over the val split: ``ceil(len / items)``
        batches, the last padded to the static shape, each metric the mean of
        its per-sample values over the real items. ``loader`` and ``dataset``
        replace the fresh val loader and its split; ``max_batches`` caps the
        pass. With more than one process each runs
        ``ceil(ceil(len / processes) / items)`` batches of its slice, a slice
        run dry repeating its last batch with zero weight, and the sums are
        added over the processes."""
        t_start = time.perf_counter()
        own_loader = loader is None
        if own_loader:
            dataset, loader = self._fresh_val_loader()
        pc = multihost.process_count()
        items = self._items_per_batch() // pc  # this process's items a batch
        expected = None
        if dataset is not None:
            per_process = -(-len(dataset) // pc)
            expected = -(-per_process // items)
        if pc > 1:
            # without the count a short slice would stop early while the
            # others run on (JAX's collective step would wait forever)
            if dataset is None:
                raise ValueError("a multi-process val pass needs `dataset` to derive its "
                                 "batch count")
            if len(dataset) < pc:
                raise ValueError(f"val set ({len(dataset)} items) smaller than {pc} processes")
        sums: Dict[str, float] = {}
        n_samples = n_batches = 0
        last_hb = None
        try:
            it = iter(loader)
            while True:
                if max_batches is not None and n_batches >= max_batches:
                    break
                if expected is not None and n_batches >= expected:
                    break
                try:
                    hb = next(it)
                except StopIteration:
                    if pc == 1 or expected is None or last_hb is None:
                        break
                    hb, n_items = last_hb, 0  # filler, zero weight
                else:
                    label_key = next((k for k in LABEL_KEYS if k in hb), None)
                    if label_key is None:
                        raise ValueError(f"val batch has none of the label keys "
                                         f"{LABEL_KEYS}: {sorted(hb)}")
                    n_items = len(hb[label_key])
                    hb = last_hb = self._pad_host_batch(hb, items, n_items)
                per = self.metric_step(self.state, self.convert_batch(hb), self.seed)
                keys = sorted(per)
                totals = torch.stack([per[k][:n_items].double().sum() for k in keys])
                for k, v in zip(keys, totals.cpu().tolist()):
                    sums[k] = sums.get(k, 0.0) + v
                n_samples += n_items
                n_batches += 1
        finally:
            if own_loader:
                loader.shutdown()
        if pc > 1:
            keys = sorted(sums)
            totals = multihost.host_allsum([sums[k] for k in keys] + [n_samples])
            sums = dict(zip(keys, totals[:-1].tolist()))
            n_samples = int(totals[-1])
        if dataset is not None and max_batches is None and (
                n_samples != len(dataset) or n_batches != expected):
            # e.g. unreadable files the loader dropped: reported, not fatal
            print(f"WARNING: val pass covered {n_samples} samples in {n_batches} batches, "
                  f"expected {len(dataset)} in {expected} — some val items were unreadable?")
        self.last_val_batches = n_batches
        self.last_val_samples = n_samples
        self.last_val_seconds = time.perf_counter() - t_start
        results = {k: s / max(n_samples, 1) for k, s in sums.items()}
        if self.val_logger is not None:
            self.val_logger.dict_log(
                {f"epoch/{self.full_name}/{k}": v for k, v in results.items()}, self.iteration)
        print(f"val ({n_samples} samples, {n_batches} batches):",
              {k: round(v, 4) for k, v in results.items()})
        return results

    def run_eval(self):
        """One complete val pass on a freshly built val loader."""
        return self.run_val()

    # ------------------------------------------------------------------ save
    def save(self, num_to_keep: int = 5):
        if self.args.save:
            self.ckpt.save(self.global_step, self.state)

    def end(self):
        if getattr(self, "_ended", False):
            return
        self._ended = True
        if self._prefetcher is not None:
            self._prefetcher.stop()
            self._prefetcher = None
        if self.train_loader is not None:
            self.train_loader.shutdown()
        self.ckpt.close()


class EndTaskImagenetSolver(EndTaskBaseSolver):
    """The ImageNet probe: SGD with momentum, the heads at base_lr·(1, 0.01)."""

    task = "classifier"
    optimizer_kind = "sgd"
    head_lr_scales = (1.0, 0.01)
    default_dataset = "ImagenetDataset"


class EndTaskSunSceneSolver(EndTaskBaseSolver):
    """The SUN-397 probe: Adam, equal head rates."""

    task = "classifier"
    optimizer_kind = "adam"
    head_lr_scales = (1.0, 1.0)
    default_dataset = "SunSceneDataset"
    default_transform = "SunSceneTransform"


class EndTaskKinetics400Solver(EndTaskBaseSolver):
    """Kinetics-400: Adam, an LSTM over each clip's frame features."""

    task = "kinetics"
    optimizer_kind = "adam"
    default_dataset = "Kinetics400Dataset"
    default_transform = "Kinetics400Transform"


class EndTaskTrackingSolver(EndTaskBaseSolver):
    """SiamFC tracking: SGD on GOT-10k pairs (``GOT10kDataset``: exemplar crops
    of 120, search crops of 247, 17×17 labels), a stride-8 dilated ResNet;
    ``run_eval`` is OTB-2015's one-pass evaluation of the tracker (the
    batched one with ``--tracker-slots`` > 1) on ``<data_path>/otb100``, or
    on synthetic sequences without it. The results go to
    ``<base_logdir>/<title>/<ModelName>/results/OTB2015``."""

    task = "tracking"
    optimizer_kind = "sgd"
    default_dataset = "GOT10kDataset"
    default_transform = "GOT10KTransform"

    def make_config(self) -> EndTaskConfig:
        """A plain ResNet becomes its dilated variant (the same parameters:
        dilation changes no weight), as the labels' 17×17 maps need stride-8
        features; any other backbone raises."""
        cfg = super().make_config()
        if not cfg.backbone.endswith("SiamFCDilated"):
            dilated = cfg.backbone + "SiamFCDilated"
            if dilated not in backbones.__all__:
                raise ValueError(
                    f"tracking needs a stride-8 dilated backbone; no dilated variant of "
                    f"{cfg.backbone!r} exists (use ResNet18SiamFCDilated / "
                    f"ResNet50SiamFCDilated)")
            print(f"tracking: using {dilated} (dense stride-8 features) for --backbone "
                  f"{cfg.backbone}")
            cfg = dataclasses.replace(cfg, backbone=dilated)
        return cfg

    def _host_arrays(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {"exemplar": host_batch["exemplar"], "search": host_batch["search"],
                "labels": np.asarray(host_batch["labels"], np.float32)}

    def loss_keys(self):
        return ["siam_tracking_loss"]

    def metric_keys(self):
        return ["dist", "center_dist", "mean_iou"]

    def run_eval(self):
        """The tracker on OTB-2015 (or the synthetic fallback): precision,
        success, speed_fps, and ``synthetic`` and ``num_sequences`` for the
        fallback. With more than one process the primary runs it on its copy
        of the replicated state while the others wait for its outcome, a
        broadcast over a ``gloo`` group whose timeout outlasts the run (an
        NCCL collective's default timeout is shorter than an OTB run), and
        return ``{}``; a timeout or the primary's failure raises on every
        process."""
        if not multihost.is_multiprocess():
            return self._run_otb()
        group = dist.new_group(backend="gloo", timeout=OTB_BARRIER_TIMEOUT)
        outcome, results = ["ok"], {}
        if multihost.is_primary():
            try:
                results = self._run_otb()
            except Exception as e:
                dist.broadcast_object_list([f"{type(e).__name__}: {e}"], src=0, group=group)
                raise
        dist.broadcast_object_list(outcome, src=0, group=group)
        if outcome[0] != "ok":
            raise RuntimeError(f"the primary's OTB evaluation failed: {outcome[0]}")
        return results

    def _run_otb(self):
        from vince_tpu_torch.tracking.experiments import ExperimentOTB
        from vince_tpu_torch.tracking.tracker import BatchedTrackerSiamFC, TrackerSiamFC

        args = self.args
        n_slots = getattr(args, "tracker_slots", 8)
        name = f"SiamFC_{self.model_name}_{args.description}"
        if n_slots > 1:
            tracker = BatchedTrackerSiamFC(name, None, self.cfg, self.state, n_slots=n_slots)
        else:
            tracker = TrackerSiamFC(name, None, self.cfg, self.state)
        root = os.path.join(args.data_path, "otb100") if args.data_path else None
        result_dir = os.path.join(args.base_logdir, args.title, self.model_name, "results",
                                  "OTB2015")
        experiment = ExperimentOTB(root, result_dir=result_dir,
                                   texture=getattr(args, "synthetic_texture", False))
        results = experiment.run(tracker)
        if results.get("synthetic"):
            print("OTB results (SYNTHETIC smoke fallback — not a real OTB score):", results)
        else:
            print("OTB results:", results)
        if self.val_logger is not None:
            self.val_logger.dict_log(
                {f"epoch/{self.full_name}/otb_{k}": float(v) for k, v in results.items()},
                self.iteration)
        return results
