"""The VINCE pretraining step in plain float32 PyTorch, followed from given
weights, queue and frames for a few steps:

    uint8 frames → augmentation with the step's draws → key forward of the
    shuffled batch (no gradient) → query forward → multi-positive InfoNCE of
    the queries against the batch keys and the queue [+ the self-batch term
    of the queries against themselves] → backward → SGD with momentum 0.9 and
    weight decay 1e-4 at the schedule's rate → EMA of the key encoder →
    enqueue of the keys at the ring's tail

Each step's draws are worked out again from the run's seed and the step's
index: a generator seeded ``(seed · 1000003 + step · 16 + stream) mod 2⁶³``
on the frames' device, stream 0 for the augmentation (query, then key) and
stream 1 for the shuffled-BN permutation. With one device the shuffle does
not change the batch statistics; it is kept so that the key rows go through
the same gather and scatter.

``follow`` returns the readings that the benchmark compares with the
program's (``vince_bench/check.py``).
"""

import dataclasses
import math
import types
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from vince_bench.reference import augment

SGD_MOMENTUM = 0.9
WEIGHT_DECAY = 1e-4
WARMUP_ITERATIONS = 500


@dataclasses.dataclass(frozen=True)
class StepConfig:
    backbone: str
    batch_size: int  # frames per step
    num_frames: int  # frames of one video: the positives of each query
    transform: str
    image_size: int
    embed: int
    queue_size: int
    temperature: float
    self_temperature: float
    self_batch: bool
    momentum: float
    base_lr: float
    epochs: int
    iterations_per_epoch: int
    lr_decay_type: str = "cos"
    lr_step_schedule: Tuple[int, ...] = (120, 160)

    @classmethod
    def from_config(cls, c: dict) -> "StepConfig":
        """From a configuration file's keys (the training script's flags)."""
        if c["input_width"] != c["input_height"] or not c["inter_batch_comparison"]:
            raise ValueError("the reference takes square images and inter-batch comparison")
        return cls(backbone=c["backbone"], batch_size=c["batch_size"],
                   num_frames=c["num_frames"], transform=c["transform"],
                   image_size=c["input_width"], embed=c["vince_embedding_size"],
                   queue_size=c["vince_queue_size"], temperature=c["vince_temperature"],
                   self_temperature=c["vince_self_temperature"],
                   self_batch=c.get("self_batch_comparison", False),
                   momentum=c["vince_momentum"], base_lr=c["base_lr"], epochs=c["epochs"],
                   iterations_per_epoch=c["iterations_per_epoch"],
                   lr_decay_type=c.get("lr_decay_type", "cos"),
                   lr_step_schedule=tuple(c.get("lr_step_schedule", (120, 160))))

    def lr(self, step: int) -> float:
        """The script's schedule: cosine or step decay by epoch, times a
        linear warm-up over the first 500 iterations."""
        epoch = math.floor(step / self.iterations_per_epoch)
        if self.lr_decay_type == "cos":
            lr = self.base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / self.epochs))
        else:
            lr = self.base_lr * 0.1 ** sum(epoch >= m for m in self.lr_step_schedule)
        return lr * min(1.0, (step + 1.0) / WARMUP_ITERATIONS)


def generator(device, seed: int, step: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step * 16 + stream) % 2 ** 63)


def infonce(q: torch.Tensor, keys: torch.Tensor, queue: Optional[torch.Tensor],
            pos: torch.Tensor, temperature: float) -> torch.Tensor:
    """The mean over the positives (i, j) of −log(e^{s_ij} / (e^{s_ij} + Σ_n
    e^{s_in})), n over row i's negatives: the batch keys that are not its
    positives and every queue row; s = q·k/τ."""
    logits = q @ keys.T / temperature
    row_max = logits.max(dim=1, keepdim=True).values
    if queue is not None:
        queue_logits = q @ queue.T / temperature
        row_max = torch.maximum(row_max, queue_logits.max(dim=1, keepdim=True).values)
    row_max = row_max.detach()
    neg_sum = (torch.exp(logits - row_max) * ~pos).sum(dim=1, keepdim=True)
    if queue is not None:
        neg_sum = neg_sum + torch.exp(queue_logits - row_max).sum(dim=1, keepdim=True)
    scaled = logits - row_max
    log_p = scaled - torch.log(torch.exp(scaled) + neg_sum)
    return -(log_p * pos).sum() / pos.sum()


def follow(cfg: StepConfig, model: types.ModuleType, params0: Dict[str, torch.Tensor],
           queue0: torch.Tensor, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], seed: int,
           quant: Optional[Callable] = None, half_batch: bool = False,
           remat: bool = False) -> dict:
    """Run ``len(batches)`` steps from ``params0`` (both encoders) and
    ``queue0`` (tail 0) on the (query frames, key frames) of each step, the
    encoder being ``model.forward`` (a file of ``reference/models/``).

    Returns ``losses`` (each step's total loss), ``grad`` (each leaf's
    gradient norm at the first step), ``grad_max`` (its largest over the
    steps), ``change`` (each leaf's change in norm
    after the last step, the key encoder's under ``key.<name>``) and
    ``keys`` (the rows enqueued, in order, on the host). ``half_batch``
    plants a fault: the loss is the mean over the first half of the queries
    alone."""
    # float32 products and convolutions in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = list(params0)
    p = {k: v.detach().clone().float() for k, v in params0.items()}
    kp = {k: v.clone() for k, v in p.items()}
    trace = {k: torch.zeros_like(v) for k, v in p.items()}
    queue = queue0.detach().clone().float()
    tcfg = augment.transform(cfg.transform, cfg.image_size)
    losses, grad0, enqueued = [], None, []
    grad_max = dict.fromkeys(names, 0.0)
    tail = 0
    for step, (data, queue_data) in enumerate(batches):
        dev = data.device
        b, h, w, _ = data.shape
        gen = generator(dev, seed, step, 0)
        dq = augment.draw(gen, b, h, w, tcfg)
        dk = augment.draw(gen, b, h, w, tcfg)
        perm = torch.randperm(b, generator=generator(dev, seed, step, 1), device=dev)
        with torch.no_grad():
            k_img = augment.apply(queue_data, dk, tcfg)
            keys = model.forward(kp, cfg.backbone, k_img[perm], quant)[torch.argsort(perm)]
            q_img = augment.apply(data, dq, tcfg)
        leaves = [p[k].requires_grad_(True) for k in names]
        q = model.forward(p, cfg.backbone, q_img, quant, remat)
        video = torch.arange(b, device=dev) // cfg.num_frames
        pos = video[:, None] == video[None, :]
        rows = b // 2 if half_batch else b
        loss = infonce(q[:rows], keys, queue, pos[:rows], cfg.temperature)
        if cfg.self_batch:
            loss = loss + infonce(q[:rows], q, None, pos[:rows], cfg.self_temperature)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        del q, q_img, loss
        with torch.no_grad():
            norms = {k: float(torch.linalg.vector_norm(g)) for k, g in zip(names, grads)}
            grad0 = norms if grad0 is None else grad0
            grad_max = {k: max(v, norms[k]) for k, v in grad_max.items()}
            lr = cfg.lr(step)
            for k, g in zip(names, grads):
                p[k] = p[k].detach()
                trace[k].mul_(SGD_MOMENTUM).add_(g + WEIGHT_DECAY * p[k])
                p[k] -= lr * trace[k]
                kp[k].mul_(cfg.momentum).add_(p[k], alpha=1.0 - cfg.momentum)
            rows_at = (tail + torch.arange(b, device=dev)) % cfg.queue_size
            queue[rows_at] = keys
            tail = (tail + b) % cfg.queue_size
            enqueued.append(keys.cpu())
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(p[k] - params0[k])) for k in names}
        change.update({f"key.{k}": float(torch.linalg.vector_norm(kp[k] - params0[k]))
                       for k in names})
    return {"losses": losses, "grad": grad0, "grad_max": grad_max, "change": change,
            "keys": torch.cat(enqueued)}
