"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # all phases (needs one CUDA device)
    python3 chip_smoke.py --kernels-only --ptxas   # build + kernel checks only
    python3 chip_smoke.py --end-tasks-only         # build, short pretrainings, phases 10, 11, 15

Phases:
  1. build every CUDA kernel of the port from ``vince_tpu_torch/csrc``;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes of the training step (forward and gradient), and time the kernel,
     the plain version and one PyTorch library call computing the same function
     (K1 also at a queue of 262144); then hold the forward at a few shapes off
     the main path (ragged ones), and K1 at the queue shards of a distributed
     step, timed;
  3. run the VINCE pretraining step (batch 128 = 32 videos x 4 frames, 224x224
     crops of 256x256 uint8 canvases, queue 65536, embeddings 128, bf16, fused
     InfoNCE queue kernel) for 2 warm-up and 5 timed steps, counting each
     kernel's launches, once with a ResNet50 (fused bn2->relu->conv3 kernel)
     and once with an EfficientNet-B0 (depthwise kernel, forward and dgrad);
  4. after each, run one more step from the same state and batch through the
     plain versions and compare the loss and the updated weights (and once
     more through the kernels, to print the eager step's own spread);
  5. for each backbone, the captured train step (one CUDA graph) against the
     eager step from two states made from one seed, over 5 batches (3 eager
     warm-up calls, the call that captures and replays, one replay; cuDNN
     deterministic on both sides), with the launches counted at the capture
     and none at a replay; then a graph captured anew under cuDNN's defaults
     and 5 timed replays, beside the eager timing of phase 3; the same
     comparison with LARS for the ResNet50;
  6. for each backbone, the eval, key-prefill, embed and panel steps once
     each, with their launches counted, the state bit-identical before and
     after each, and the eval step against the eval step through the plain
     versions;
  7. call the stand-alone op ``affine_conv3x3_stats`` (no model uses it),
     forward and backward, at its three shapes;
  8. the heads, ResNet50 at the same shapes in two configurations:
     ``ResNet50-IN+YT-heads`` (an ImageNet source of 64 rows with labels and
     the CE decoders, a video source of 64 rows, the attention pool and
     self-batch InfoNCE) and ``ResNet50-jigsaw`` (one source of 128 rows,
     the jigsaw head): eager steps of each kind (no jigsaw; jigsaw on the
     query, the key, both sides, and the query with the alignment term) with
     their launches (K1 once per source, K2 13 times per train-mode forward)
     and against the plain versions; the captured steps against the eager
     ones under cuDNN deterministic, the jigsaw's query-side and key-side
     graphs on one state alternated by a seeded coin; 5 timed replays of
     each graph; the eval step and the panel once each;
  9. the training CLI: ``vince_tpu_torch.solver_runner.main`` in this process
     (``CLI_ARGV``: the ResNet50 step of phases 3-5 fed by the synthetic
     texture videos) for one epoch of 24 iterations, its val pass and saves,
     with each call's launches counted and the solver's own time meters per
     iteration; the restore of its step-24 checkpoint held bit-identical to
     the files; the resumed run to step 48; 8 iterations of an
     EfficientNet-B0 through the parser and the solver (K4); the loader
     alone, in threads (the loader's worker processes run in phase 14,
     with cv2 reads and with ``--native-decode``);
 10. the end tasks on phase 9's ResNet50 checkpoint, each through
     ``solver_runner.main`` (one epoch: its iterations, a save, the val pass)
     and then ``run_end_task_eval.main`` on the saved state: the frozen
     ImageNet probe (``ResNet50-IN-probe``: batch 256, 1000 classes, SGD at
     30, 12 iterations, a val split of 600 images whose last batch is
     partial), the SUN fine-tune (``ResNet50-SUN-finetune``: batch 256, 397
     classes, Adam at 0.01, 8 iterations) and the frozen Kinetics LSTM
     (``ResNet50-Kinetics``: 6 clips of 10 frames, 400 classes, Adam at 0.01,
     8 iterations, 256 val clips). Each: the encoder bit-identical to the
     checkpoint's query encoder, finite losses, the meters, exact val
     passes, ``EVAL_RESULT`` equal to the run's val pass, the peak memory,
     no launch of any kernel (none is on an end task's path, in JAX either);
     for the two probes one f32 step on the card against the CPU;
 11. the SiamFC tracking end task (``ResNet18-SiamFC-tracking``, the widths of
     ``end_tasks/train_tracking.sh``) on a 2-iteration ResNet18 pretraining
     of phase 9's configuration: ``solver_runner.main`` (frozen
     ``ResNet18SiamFCDilated``, GOT-10k pairs of synthetic sequences cropped
     on the host, batch 256, SGD at 0.01, one epoch of 8 iterations, a save,
     the exact val pass of 200 pairs), then ``run_end_task_eval.main`` on the
     saved state (OTB-2015's one-pass evaluation on the synthetic fallback,
     the batched tracker of 8 slots). Checks: the encoder bit-identical to
     the checkpoint's query encoder, finite losses, the meters, pairs/s, the
     step alone, the host's crop, pair and loader times, the val pass's
     counts, ``EVAL_RESULT`` equal to ``run_eval``'s dict, precision and
     success in [0, 1], the tracker's frames/s, the batched tracker's boxes
     against the serial tracker's (float32, 1e-2 px), one f32 step of 16 pairs
     on the card against the CPU, ``fast_xcorr`` (forward and both gradients)
     at the run's shape on the card against the CPU, the peak memory, no
     launch of any kernel;
 12. multi-GPU pretraining over ``torch.distributed`` at a world of one: an
     NCCL group of one rank (a ``TCPStore`` on 127.0.0.1) and a 1x1 mesh. The
     eager distributed step with sync-BN, 5 steps in ``gather`` mode and 5 in
     ``a2a`` mode (K1 1 and K2 26 launches a step), bit-identical (loss,
     weights, running averages, momentum traces, queue) to phase 3's
     one-device step from the same seed on the same batches under
     deterministic cuDNN: every collective is the identity; the captured
     distributed step against its eager form to phase 5's bounds, in both
     modes, and 5 timed replays beside phase 5's one-device replays; K1 on
     two halves of the queue merged as the queue branch merges shards,
     against the unsharded loss and its gradient; the CLI with
     ``--distributed`` and the three explicit flags, ``--sync-bn
     --shuffle-mode a2a`` on phase 9's configuration, 8 iterations, its val
     pass and a save, then a run without ``--distributed`` that restores the
     checkpoint bit-identically;
 13. remat, the reference's weights and the retrieval probe. For each of
     the ResNet50 and the EfficientNet-B0 of phase 5, the captured step with
     ``remat`` and without from one seed, cuDNN deterministic (3 eager
     warm-up calls, the capture, a replay): the loss within 1e-5 relative,
     the update within 1e-3 of its norm, the running averages after one step
     bit-equal, the launches of each call (K2 13 x 3 per step, K4 12 x 4 and
     its filter gradient 12: the query forward runs again in the backward);
     then a new capture of each under cuDNN's defaults, 5 timed replays, the
     peak reserved lower with remat. The sync-BN step with remat at a world
     of one against the one-device step with remat, bit-identical. A ResNet50
     ``VinceModel`` state dict written by name with seeded values and the
     DataParallel prefixes: into the CLI's solver with
     ``--pretrained-weights-path`` (both encoders equal to the file, 4
     captured iterations), through ``convert_reference_checkpoint`` into the
     frozen ImageNet probe of phase 10 (its encoder equal to the file, 4
     iterations), and ``export_reference_checkpoint`` of the converted
     directory back to the written dict, bit for bit. The retrieval probe
     (64 val-split videos x 6 frames) on phase 9's latest checkpoint and
     with ``--no-restore``;
 14. the file-backed path: trees of JPEGs written from the seed by the
     port's texture generator through ``cv2.imwrite`` (R2V2 256 + 64 videos
     x 6 frames of 480x360, ImageNet 1000 classes x 2 + 600 val of 500x375,
     SUN-397's lists, a Kinetics-400 frame cache with 400 labels, GOT-10k
     and OTB-2015 sequences); phase 9's ResNet50 CLI on the R2V2 tree for 10
     iterations with the cv2 read, 10 with ``--native-decode`` (nvJPEG
     and the fused JPEG kernel on the card in the loader's threads), 10 with
     ``--loader-processes`` (the cv2 read in spawned worker processes) and
     10 with ``--native-decode --loader-processes`` (the card's decode in
     each spawned worker, on its own CUDA context; the JPEG kernels'
     launches and the decodes summed from the workers); K1 1 and K2 26 a
     step at the eager calls and the capture, the JPEG kernel's launches
     (none without ``--native-decode``; none of the two it replaced on any
     run), finite losses, the meters, the
     loader alone (cv2, threads), the peak memory and the card's memory in
     use; with ``--native-decode`` no stream refused, no cv2 read and every
     file decoded by nvJPEG; the loader's first 4 batches of the R2V2 val tree
     (repeatable draws) from one thread and from worker processes,
     bit-equal, with the pool's start-up and the card's memory in use
     before and with it; phase 10's three end tasks on their trees with
     ``--native-decode`` and the ImageNet probe also with
     ``--loader-processes`` (4 iterations and the val pass from phase 9's
     checkpoint, finite losses, no stream refused and no cv2 read);
     tracking on the GOT-10k tree (2 iterations, cv2 reads) and
     ``run_end_task_eval`` on the OTB-2015 tree (its scores, the tracker's
     frames/s); ``tools/extract_embeddings.py`` on the R2V2 val tree with
     both decoders (the rows, their cosines >= 0.999, every file decoded
     by nvJPEG);
 15. the slice across processes, at a world of one over NCCL: the end-task
     train step of phase 10's ImageNet probe and SUN fine-tune (ResNet50,
     batch 256, 224², bf16) on a 1x1 mesh against the one-device step, 3
     steps from one seed under cuDNN deterministic, bit-identical (losses and
     every tensor of the states); ``tools/soak_multichip.py``'s soak, 50
     eager steps of phase 3's ResNet50 step with sync-BN and the a2a shuffle
     on the 1x1 mesh and on one device from one seed and one data stream, at
     the soak's tolerance (K1 1 and K2 26 a step), with the ms/step of each;
     ``tools/audit_collectives.py``'s audit of one profiled eager step (its
     NCCL collectives against the analytic table, no queue bank moved);
     ``tools/dryrun_multichip.py``'s dry run; the ImageNet probe and the
     Kinetics LSTM through ``solver_runner.main`` with ``--distributed`` (the
     explicit flags): 4 iterations, a save and the val pass from phase 9's
     checkpoint, then ``run_end_task_eval`` in one process restores each
     checkpoint, its val pass equal to the distributed one; tracking with
     ``--distributed`` (2 iterations, a save, the val pass), then
     ``run_eval`` on the primary of a world of one; the visualization CLIs:
     the attention grid on a 2-iteration ``--use-attention`` pretraining of
     phase 9's flags, the neighbour grid and the mosaic (``--with-tsne``
     where the host has ``sklearn``) on phase 9's checkpoint, and the
     neighbour grid's embeddings against the embed step through the plain
     versions (row cosine >= 0.9995);
 16. the data-production pipeline: 64 videos written from the seed (MJPG,
     640x360, 90 frames of 2-3 drifting textured scenes between letterbox
     bands) stand in for YouTube's behind a downloader installed for the
     phase (nothing is fetched); ``scrape/cache_video_dataset.py`` caches
     them and 2 ids that fail to download into an R2V2 train split, and 16
     of them into val with ``--only-use-shots`` (the codes, 4 frames a video
     or a shot at 480 a side, a second run downloads nothing); phase 9's
     ResNet50 CLI from that cache (``--dataset R2V2Dataset``), 8 iterations
     and the val pass (K1 1 and K2 26 a step at the eager calls and the
     capture, finite losses, frames/s); ``recreate_r2v2_dataset`` (its
     JPEGs equal to cv2's seek-decode), ``download_kinetics`` (read by
     ``Kinetics400Dataset``), ``download_r2v2`` on a ``file://`` tar of the
     cache (its bytes), and ``download_pretrained_weights --backbone
     ResNet18`` from a scripted Drive into a checkpoint that a solver
     restores on the card (the embed step's embeddings of 8 frames against
     the in-memory model's, cosine >= 1 - 1e-5).

Phase 2 also holds the JPEG path's kernel (``csrc/jpeg_decode.cu``:
``ycc_resize_canvas``, libjpeg's chroma upsampling and YCbCr -> RGB and the
resize in one kernel; the counterpart of host C++, no TPU kernel) to its
plain version and to the two kernels it replaced (bit for bit), and those
two (``ycc_to_rgb``, ``resize_canvas``) to their plain versions, on 160
frames of 480x360 decoded by nvJPEG and on ragged batches, timing the fused
kernel and the pair in one call (also at an R2V2 item's and an ImageNet
image's call); nvJPEG + the fused kernel to cv2 + the plain resize with the
JAX tests' tolerances, on those frames and on ragged streams (257x191,
grayscale, 4:4:4, progressive; a truncated JPEG and a PNG refused). After
phase 7, the pair is called once as stand-alone ops.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.
"""

import argparse
import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# peak rates of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


def log(msg):
    print(msg, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def time_ms(fn, iters=20, warmup=3, flushes=4):
    """Mean device time of ``fn`` with a cold L2: before each timed call a
    256 MB buffer is zeroed ``flushes`` times, which evicts the 50 MB L2 (the
    main path reads the queue and the activations cold) and, at ~0.3 ms for
    four, lets the host enqueue ``fn`` before the start event is reached, so
    that the host's own time per call (allocations, the launch) is not
    counted; with one flush, ~0.1 ms, some of it is
    (``vince_tpu_torch/tools/fold_conv_timers.py`` times both)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        for _ in range(flushes):
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def launch_ms(fn, iters=10, attempts=3):
    """Mean device time of each kernel that ``fn`` launches once per call, by
    kernel name (its first word that ends in ``_kernel``), from a
    torch.profiler trace of ``iters`` calls, each after the flush of
    ``time_ms``. Every call starts with the flush, so the trace's first kernel
    is the flush's, and all launches of that name are left out. A trace that
    lost launches (a name with other than ``iters``, or a flush with other
    than ``4 * iters``) is taken again, up to ``attempts`` traces in all;
    then it raises."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                for _ in range(4):
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        launches = sorted((e for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and not getattr(e, "is_user_annotation", False)),
                          key=lambda e: e.time_range.start)
        spans = {"flush": []}
        for e in launches:
            short = re.search(r"\w+_kernel", e.name)
            name = "flush" if e.name == launches[0].name else short.group(0) if short else e.name
            spans.setdefault(name, []).append((e.time_range.end - e.time_range.start) / 1e3)
        fault = "; ".join(f"{name}: {len(times)} launches in {iters} calls"
                          for name, times in spans.items()
                          if len(times) != (4 * iters if name == "flush" else iters))
        if not fault:
            del spans["flush"]
            return {name: sum(times) / iters for name, times in spans.items()}
        log(f"  (trace {attempt} of {attempts}: {fault})")
    raise RuntimeError(fault)


def bound(bytes_moved, ops, peak_ops):
    """(least time in ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the peak rate of their type."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, ref, rtol, atol_frac):
    """|got - ref| <= rtol*|ref| + atol_frac*max|ref|, elementwise; returns max |err|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    atol = atol_frac * ref.abs().max().item()
    ok = bool((err <= rtol * ref.abs() + atol).all()) and bool(torch.isfinite(got).all())
    max_err = err.max().item()
    log(f"  {name}: max_abs_err={max_err:.3e} (rtol={rtol}, atol={atol_frac}*max|ref|="
        f"{atol:.3e}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_err


def same_bits(name, first, second):
    """Two calls on the same inputs give the same bits (fixed-order sums)."""
    if not all(torch.equal(x, y) for x, y in zip(first, second)):
        fail(f"{name} differs between two calls on the same inputs")
    log(f"  {name}: bit-identical in two calls")


def queue_inputs(g, dev, b, k, d):
    """Unit rows of q [b, d] and of the queue [k, d], as the loss hands them to K1."""
    norm = lambda x: x / x.norm(dim=-1, keepdim=True)
    return (norm(torch.randn(b, d, generator=g, device=dev)),
            norm(torch.randn(k, d, generator=g, device=dev)))


def compare_queue_logsumexp(k1, q, queue, tau):
    """(m, S, W) of the kernel against the plain version; returns the errors."""
    got = k1.queue_logsumexp_forward(q, queue, tau)
    ref = k1._reference_queue_logsumexp(q, queue, tau)
    return [compare(name, x, r, rtol, atol) for name, x, r, rtol, atol in
            zip("mSW", got, ref, (1e-5, 1e-4, 1e-4), (1e-6, 1e-6, 1e-5))]


def time_queue_logsumexp(k1, q, queue, tau, per_launch=True):
    """The kernel (whole and, with ``per_launch``, each launch), its plain
    version, the library call and the bound at one shape, in ms."""
    b, d = q.shape
    k = queue.shape[0]

    def library():
        logits = q @ queue.T / tau
        return torch.logsumexp(logits, -1), torch.softmax(logits, -1) @ queue

    times = {"ms": time_ms(lambda: k1.queue_logsumexp_forward(q, queue, tau)),
             "plain_ms": time_ms(lambda: k1._reference_queue_logsumexp(q, queue, tau)),
             "library_ms": time_ms(library)}
    launches = ""
    if per_launch:
        split = launch_ms(lambda: k1.queue_logsumexp_forward(q, queue, tau))
        times["partial_ms"], times["combine_ms"] = split["qlse_partial_kernel"], split[
            "qlse_combine_kernel"]
        launches = " (launches: partial {partial_ms:.4f}, combine {combine_ms:.4f})".format(
            **times)
    bytes_moved = 4 * (b * d + k * d + 2 * b + b * d)
    ops = 4 * b * k * d + b * k  # two products of 2*b*k*d, plus one exp per logit
    times["bound_ms"], by = bound(bytes_moved, ops, F32_FLOPS)
    log(f"  times (cold L2): kernel {times['ms']:.4f} ms{launches}, plain "
        "{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms".format(**times)
        + f" ({by}, f32), kernel/bound {times['ms'] / times['bound_ms']:.3f}")
    return times, by


def check_queue_logsumexp(dev):
    from vince_tpu_torch.ops.kernels import build
    from vince_tpu_torch.ops.kernels import infonce_kernel as k1

    smem = build.load("queue_logsumexp").vince_queue_logsumexp_smem_bytes
    for d in (64, 72, 128, 256):
        if smem(d) != k1._smem_bytes(d):
            fail(f"K1 shared memory at D={d}: {smem(d)} bytes in the source, "
                 f"{k1._smem_bytes(d)} in the Python schedule")
    b, k, d, tau = 128, 65536, 128, 0.07
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    q, queue = queue_inputs(g, dev, b, k, d)
    log(f"K1 queue_logsumexp: q [{b},{d}] f32, queue [{k},{d}] f32, tau={tau}, "
        f"chunking (row blocks, chunks, tiles a chunk) {k1._chunking(b, k, d, sms)}")
    errs = compare_queue_logsumexp(k1, q, queue, tau)
    same_bits("m, S, W", k1.queue_logsumexp_forward(q, queue, tau),
              k1.queue_logsumexp_forward(q, queue, tau))
    # gradient: the kernel's autograd Function against autograd through the
    # materialised logits (m detached, as in the loss)
    r = torch.rand(b, generator=g, device=dev)
    qk = q.clone().requires_grad_(True)
    (k1.queue_logsumexp(qk, queue, tau)[1] * r).sum().backward()
    qp = q.clone().requires_grad_(True)
    logits = qp @ queue.T / tau
    (torch.exp(logits - logits.max(-1, keepdim=True).values.detach()).sum(-1) * r).sum().backward()
    errs.append(compare("dq", qk.grad, qp.grad, 1e-4, 1e-5))
    times, bound_by = time_queue_logsumexp(k1, q, queue, tau)
    # a queue of 262144, for which the JAX solver turns the kernel on by itself
    k_long = 262144
    q, queue = queue_inputs(g, dev, b, k_long, d)
    log(f"K1 at queue [{k_long},{d}]: chunking {k1._chunking(b, k_long, d, sms)}")
    errs += compare_queue_logsumexp(k1, q, queue, tau)
    long_times, _ = time_queue_logsumexp(k1, q, queue, tau)
    return {"name": "queue_logsumexp", "route": "cuda",
            "source": "vince_tpu_torch/csrc/queue_logsumexp.cu",
            "replaces": "vince_tpu/ops/pallas/infonce_kernel.py:88",
            "max_abs_err": max(errs), **times, "bound_by": bound_by,
            f"at_k_{k_long}": long_times, "check": "ok"}


# the three K2 sites of ResNet50 at batch 128, 224x224: (M, C, F)
K2_SHAPES = [(128 * 28 * 28, 128, 512), (128 * 14 * 14, 256, 1024), (128 * 7 * 7, 512, 2048)]
K2_SITES = [4, 6, 3]  # sites of each shape per forward


def check_k2_forward(k2, y, a, b, w):
    got = k2.affine_relu_dot_moments_forward(y, a, b, w)
    ref = k2._reference(y, a, b, w.bfloat16())
    errs = [compare("out", got[0], ref[0], 1.6e-2, 1e-3),
            compare("s1", got[1], ref[1], 1e-4, 1e-6),
            compare("s2", got[2], ref[2], 1e-4, 1e-6)]
    same_bits("s1, s2", got[1:], k2.affine_relu_dot_moments_forward(y, a, b, w)[1:])
    return errs, got


def k2_inputs(g, dev, m, c, f):
    """y, a, b and W [C, F] f32 as the ResNet hands them to K2: W is the
    transposed view of the 1×1 convolution's [F, C] weight."""
    y = torch.randn(m, c, generator=g, device=dev).bfloat16()
    a = torch.rand(c, generator=g, device=dev) + 0.5
    b = torch.randn(c, generator=g, device=dev) * 0.1
    w = (torch.randn(f, c, generator=g, device=dev) * 0.05).t()
    return y, a, b, w


def k2_library(y, a, b, wb):
    """One PyTorch call per part of K2's function: the affine, the product, the
    two moments."""
    xh = torch.relu(torch.addcmul(b, y, a)).bfloat16()
    return xh @ wb, xh.sum(0, dtype=torch.float32), xh.T @ xh


def check_affine_relu_dot_moments(dev):
    from vince_tpu_torch.ops.kernels import folded_dot_kernel as k2
    from vince_tpu_torch.ops.kernels import plain_versions

    g = torch.Generator(device=dev).manual_seed(1)
    errs, per_site = [], []
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "main_ms", "moments_ms", "reduce_ms",
            "wt_copy_ms")
    total = dict.fromkeys(keys, 0.0)
    bound_share = {"bytes": 0.0, "operations": 0.0}
    for (m, c, f), sites in zip(K2_SHAPES, K2_SITES):
        log(f"K2 affine_relu_dot_moments: y [{m},{c}] bf16, W [{c},{f}] (x{sites} sites), "
            f"plan {k2.plan(m, c, f, torch.cuda.get_device_properties(dev).multi_processor_count)}")
        y, a, b, w = k2_inputs(g, dev, m, c, f)
        e, got = check_k2_forward(k2, y, a, b, w)
        errs += e
        cot = [torch.randn(t.shape, generator=g, device=dev) for t in got]

        def grads():
            ins = [t.clone().requires_grad_(True) for t in (y, a, b, w)]
            outs = k2.affine_relu_dot_moments(*ins)
            sum((o.float() * c_).sum() for o, c_ in zip(outs, cot)).backward()
            return [t.grad for t in ins]

        gk = grads()
        with plain_versions():
            gp = grads()
        for name, x, r in zip(("dy", "da", "db", "dw"), gk, gp):
            errs.append(compare(name, x, r, 1.6e-2 if name == "dy" else 1e-4, 1e-4))

        wb = w.bfloat16()
        times = {"ms": time_ms(lambda: k2.affine_relu_dot_moments_forward(y, a, b, w)),
                 "plain_ms": time_ms(lambda: k2._reference(y, a, b, wb)),
                 "library_ms": time_ms(lambda: k2_library(y, a, b, wb))}
        # each launch's device time in the call, from the profiler; the W^T
        # copy is a cast (W^T is the weight's own layout)
        split = launch_ms(lambda: k2.affine_relu_dot_moments_forward(y, a, b, w))
        for part in ("main", "moments", "reduce"):
            times[f"{part}_ms"] = split.pop(f"ardm_{part}_kernel")
        times["wt_copy_ms"] = sum(split.values())
        bytes_moved = 2 * m * c + 8 * c + 2 * c * f + 2 * m * f + 4 * c + 4 * c * c
        ops = 2 * m * c * f + m * c * (c + 1)  # s2 is symmetric: its upper triangle
        times["bound_ms"], by = bound(bytes_moved, ops, BF16_FLOPS)
        log("  times (cold L2): kernel {ms:.4f} ms (launches: main {main_ms:.4f}, W^T cast "
            "{wt_copy_ms:.4f}, moments {moments_ms:.4f}, reduce {reduce_ms:.4f}), plain "
            "{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms".format(
                **times) + f" ({by}), kernel/library {times['ms'] / times['library_ms']:.3f}, "
            f"kernel/bound {times['ms'] / times['bound_ms']:.3f}")
        per_site.append(dict(times, shape=f"M={m} C={c} F={f}", sites=sites))
        for key in keys:
            total[key] += sites * times[key]
        bound_share[by] += sites * times["bound_ms"]
        del y, got, cot, gk, gp
    bound_by = max(bound_share, key=bound_share.get)  # what bounds most of the sum
    log("K2 per forward (13 sites): kernel {ms:.4f} ms (main {main_ms:.4f}, W^T cast "
        "{wt_copy_ms:.4f}, moments {moments_ms:.4f}, reduce {reduce_ms:.4f}), plain "
        "{plain_ms:.4f} ms, library "
        "{library_ms:.4f} ms, bound {bound_ms:.4f} ms".format(**total)
        + f" (mostly {bound_by}), kernel/library {total['ms'] / total['library_ms']:.3f}, "
        f"kernel/bound {total['ms'] / total['bound_ms']:.3f}")
    # times summed over the 13 sites of one ResNet50 forward
    return {"name": "affine_relu_dot_moments", "route": "cuda",
            "source": "vince_tpu_torch/csrc/affine_relu_dot_moments.cu",
            "replaces": "vince_tpu/ops/pallas/folded_dot_kernel.py:96",
            "max_abs_err": max(errs), **total, "bound_by": bound_by,
            "per": "13 sites of one ResNet50 forward at batch 128, 224x224",
            "per_site": per_site, "check": "ok"}


# the stride-1 depthwise sites of EfficientNet-B0 at batch 128, 224x224:
# (N, H, W, C, k, sites per forward, blocks)
K4_SHAPES = [(128, 112, 112, 32, 3, 1, "block_0"), (128, 56, 56, 144, 3, 1, "block_2"),
             (128, 28, 28, 240, 5, 1, "block_4"), (128, 14, 14, 480, 3, 2, "block_6-7"),
             (128, 14, 14, 480, 5, 1, "block_8"), (128, 14, 14, 672, 5, 2, "block_9-10"),
             (128, 7, 7, 1152, 5, 3, "block_12-14"), (128, 7, 7, 1152, 3, 1, "block_15")]


def wl_lib(w):
    """[k,k,1,C] -> the library's [C,1,k,k] channels-last weight."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def library_depthwise(x, w):
    """The library call: the grouped convolution on the channels-last view."""
    return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), wl_lib(w),
                                      padding=w.shape[0] // 2,
                                      groups=x.shape[-1]).permute(0, 2, 3, 1)


def depthwise_grads(k4, x, w, cot):
    xk, wk = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (k4.depthwise_conv(xk, wk.to(x.dtype)).float() * cot).sum().backward()
    return xk.grad, wk.grad


def check_depthwise_conv(dev):
    from vince_tpu_torch.ops.kernels import depthwise_kernel as k4
    from vince_tpu_torch.ops.kernels import plain_versions

    g = torch.Generator(device=dev).manual_seed(3)
    errs, errs_w, per_site, per_site_w = [], [], [], []
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    total, total_w = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
    share, share_w = ({"bytes": 0.0, "operations": 0.0} for _ in range(2))
    for n, h, wd, c, k, sites, blocks in K4_SHAPES:
        log(f"K4 depthwise_conv: x [{n},{h},{wd},{c}] bf16, k={k} ({blocks}, x{sites} sites)")
        x = torch.randn(n, h, wd, c, generator=g, device=dev).bfloat16()
        w = torch.randn(k, k, 1, c, generator=g, device=dev) * 0.2
        wb = w.bfloat16()
        cot = torch.randn(n, h, wd, c, generator=g, device=dev).bfloat16().float()
        # the plain version's roundings in its order of taps: bit-equal
        errs.append(compare("out", k4.depthwise_conv_forward(x, wb), k4._reference(x, wb), 0, 0))
        dx_k, dw_k = depthwise_grads(k4, x, w, cot)
        with plain_versions():
            dx_p, dw_p = depthwise_grads(k4, x, w, cot)
        errs.append(compare("dx", dx_k, dx_p, 0, 0))
        # dw, rounded to bf16 on both sides from f32 sums of the same rounded
        # products in another order: one bf16 ulp, plus 1e-3 of the largest
        # entry where a sum cancels; the f32 sums themselves to 1e-4 of it
        errs_w.append(compare("dw", dw_k, dw_p, 8e-3, 1e-3))
        cot_b = cot.bfloat16()
        dw_f32 = k4.depthwise_wgrad(x, cot_b, k)
        errs_w.append(compare("dw in f32", dw_f32, k4._reference_wgrad(x, cot_b, k), 1e-4, 1e-4))
        if not torch.equal(dw_f32, k4.depthwise_wgrad(x, cot_b, k)):
            fail("dw differs between two runs on the same inputs")
        # and against autograd through the library convolution, which rounds
        # elsewhere: 2 bf16 ulp plus 2e-2 of the largest entry
        xl, wl = x.clone().requires_grad_(True), wb.clone().requires_grad_(True)
        (library_depthwise(xl, wl).float() * cot).sum().backward()
        compare("dw vs library autograd", dw_k, wl.grad, 1.6e-2, 2e-2)
        t_wl = time_ms(lambda: torch.ops.aten.convolution_backward(
            cot_b.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), wl_lib(wb), None, [1, 1],
            [k // 2, k // 2], [1, 1], False, [0, 0], c, [False, True, False]))
        del xl, dx_k, dx_p

        elems = n * h * wd * c
        # forward (the dgrad is the same kernel at the same shape): x in, out out
        t_b, by = bound(2 * 2 * elems + 2 * k * k * c, 2 * k * k * elems, F32_FLOPS)
        times = (time_ms(lambda: k4.depthwise_conv_forward(x, wb)),
                 time_ms(lambda: k4._reference(x, wb), iters=5, warmup=1),
                 time_ms(lambda: library_depthwise(x, wb)), t_b)
        log("  forward, cold L2: kernel {:.4f} ms, plain {:.4f} ms, library {:.4f} ms, "
            "bound {:.4f} ms ({}), kernel/library {:.3f}".format(*times, by, times[0] / times[2]))
        # wgrad: x and g in, k*k*C f32 out
        t_bw, by_w = bound(2 * 2 * elems + 4 * k * k * c, 2 * k * k * elems, F32_FLOPS)
        times_w = (time_ms(lambda: k4.depthwise_wgrad(x, cot_b, k)),
                   time_ms(lambda: k4._reference_wgrad(x, cot_b, k), iters=5, warmup=1),
                   t_wl, t_bw)
        log("  wgrad, cold L2: kernel {:.4f} ms, plain {:.4f} ms, library {:.4f} ms, "
            "bound {:.4f} ms ({}), kernel/library {:.3f}".format(*times_w, by_w,
                                                                 times_w[0] / times_w[2]))
        for kind, is_wgrad in (("forward", False), ("wgrad", True)):
            log(f"  {kind} tile: {k4._tiling(n, h, wd, c, k, 2, is_wgrad)}")
        shape = f"[{n},{h},{wd},{c}] k={k}"
        per_site.append(dict(zip(keys, times), shape=shape, sites=sites))
        per_site_w.append(dict(zip(keys, times_w), shape=shape, sites=sites))
        for key, t, t_w in zip(keys, times, times_w):
            total[key] += sites * t
            total_w[key] += sites * t_w
        share[by] += sites * t_b
        share_w[by_w] += sites * t_bw
        del x, cot, cot_b
    for name, tot in (("K4 forward or dgrad", total), ("K4 wgrad", total_w)):
        log("{} over the 12 sites: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            "{library_ms:.4f} ms, bound {bound_ms:.4f} ms".format(name, **tot)
            + ", kernel/library {:.3f}, kernel/bound {:.3f}".format(
                tot["ms"] / tot["library_ms"], tot["ms"] / tot["bound_ms"]))
    # times summed over the 12 stride-1 sites of one EfficientNet-B0 forward
    # (depthwise_conv) or backward (depthwise_wgrad)
    per = "12 stride-1 sites of one EfficientNet-B0 {} at batch 128, 224x224"
    return [{"name": "depthwise_conv", "route": "cuda",
             "source": "vince_tpu_torch/csrc/depthwise_conv.cu",
             "replaces": "vince_tpu/ops/pallas/depthwise_kernel.py:127",
             "max_abs_err": max(errs), **total, "bound_by": max(share, key=share.get),
             "per": per.format("forward"), "per_site": per_site, "check": "ok"},
            {"name": "depthwise_wgrad", "route": "cuda",
             "source": "vince_tpu_torch/csrc/depthwise_conv.cu",
             "replaces": "vince_tpu/ops/pallas/depthwise_kernel.py:156",
             "note": "_wgrad there is plain XLA beside the TPU kernel, not a pallas_call",
             "max_abs_err": max(errs_w), **total_w, "bound_by": max(share_w, key=share_w.get),
             "per": per.format("backward"), "per_site": per_site_w, "check": "ok"}]


# the 3x3 sites of ResNet50 stages 2-4 at batch 128, 224x224: (N, H, W, C, F)
K3_SHAPES = [(128, 28, 28, 128, 128), (128, 14, 14, 256, 256), (128, 7, 7, 512, 512)]


def conv_bn_inputs(g, dev, n, h, w, c, f):
    y_prev = torch.randn(n, h, w, c, generator=g, device=dev).bfloat16()
    a = torch.rand(c, generator=g, device=dev) + 0.5
    b = torch.randn(c, generator=g, device=dev) * 0.1
    kernel = torch.randn(3, 3, c, f, generator=g, device=dev) * (1.0 / (3.0 * c ** 0.5))
    return y_prev, a, b, kernel


def k3_library(y_prev, a, b, wl):
    """One PyTorch call per part of K3's function: the affine, cuDNN's
    convolution on the channels-last weight ``wl``, the two sums."""
    xh = torch.relu(torch.addcmul(b, y_prev, a)).bfloat16()
    y = torch.nn.functional.conv2d(xh.permute(0, 3, 1, 2), wl, padding=1)
    return y, y.sum(dim=(0, 2, 3), dtype=torch.float32), y.float().square().sum(dim=(0, 2, 3))


def k3_weight(kernel):
    """[3, 3, C, F] -> cuDNN's [F, C, 3, 3] channels-last bf16 weight."""
    return kernel.bfloat16().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def check_smem_count(k3, n, h, w, f):
    """The Python tiling's shared-memory count equals the source's, for every
    tile it weighs at this shape."""
    from vince_tpu_torch.ops.kernels import build

    count = build.load("affine_conv3x3_stats").vince_affine_conv3x3_stats_smem_bytes
    for _, tile in k3._tiles(n, h, w, f):
        if count(*tile) != k3._smem_bytes(tile):
            fail(f"K3 shared memory of {tile}: {count(*tile)} bytes in the source, "
                 f"{k3._smem_bytes(tile)} in the Python tiling")


def compare_conv_bn_forward(k3, args):
    """y within 2 bf16 ulp of the plain version (cuDNN sums the 9C products in
    another order, so a value now and then rounds to the neighbouring bf16),
    plus 1e-3 of the largest entry where values cancel; s1 and s2, which
    inherit those flips, within 1e-3; and the sums equal to the kernel's own
    stored y summed in float64, to 1e-4 (f32 sums in a fixed order)."""
    got = k3.affine_conv3x3_stats_forward(*args)
    ref = k3._reference(args[0], args[1], args[2], args[3].bfloat16())
    errs = [compare("y", got[0], ref[0], 1.6e-2, 1e-3),
            compare("s1", got[1], ref[1], 1e-3, 1e-3),
            compare("s2", got[2], ref[2], 1e-3, 1e-5)]
    own = got[0].double()
    compare("s1 vs own y", got[1], own.sum(dim=(0, 1, 2)), 1e-4, 1e-5)
    compare("s2 vs own y", got[2], own.square().sum(dim=(0, 1, 2)), 1e-4, 1e-6)
    same_bits("s1, s2", got[1:], k3.affine_conv3x3_stats_forward(*args)[1:])
    return errs, got


def check_affine_conv3x3_stats(dev):
    from vince_tpu_torch.ops.kernels import conv_bn_kernel as k3
    from vince_tpu_torch.ops.kernels import plain_versions

    g = torch.Generator(device=dev).manual_seed(4)
    errs, ms, plain_ms, library_ms, bound_ms, per_site = [], 0.0, 0.0, 0.0, 0.0, []
    bound_share = {"bytes": 0.0, "operations": 0.0}
    for n, h, w, c, f in K3_SHAPES:
        log(f"K3 affine_conv3x3_stats: y_prev [{n},{h},{w},{c}] bf16, kernel [3,3,{c},{f}], "
            f"{k3._tiling(n, h, w, f)}")
        args = conv_bn_inputs(g, dev, n, h, w, c, f)
        check_smem_count(k3, n, h, w, f)
        e, got = compare_conv_bn_forward(k3, args)
        errs += e
        cot = [torch.randn(t.shape, generator=g, device=dev) for t in got]
        cot[2] = cot[2] * 0.1

        def grads():
            ins = [t.clone().requires_grad_(True) for t in args]
            outs = k3.affine_conv3x3_stats(*ins)
            sum((o.float() * c_).sum() for o, c_ in zip(outs, cot)).backward()
            return [t.grad for t in ins]

        # the backward is the same PyTorch code on both sides, fed each side's
        # own stored y (its 2 y g_s2 term): 2 bf16 ulp plus 2e-3 of the largest entry
        gk = grads()
        with plain_versions():
            gp = grads()
        for name, x, r in zip(("dy_prev", "da", "db", "dk"), gk, gp):
            errs.append(compare(name, x, r, 1.6e-2, 2e-3))

        y_prev, a, b, kernel = args
        kb, wl = kernel.bfloat16(), k3_weight(kernel)
        t_k = time_ms(lambda: k3.affine_conv3x3_stats_forward(*args))
        t_p = time_ms(lambda: k3._reference(y_prev, a, b, kb))
        t_l = time_ms(lambda: k3_library(y_prev, a, b, wl))
        # each launch's device time in the call: the filter's cast, main, reduce
        split = launch_ms(lambda: k3.affine_conv3x3_stats_forward(*args))
        main_ms = sum(v for k, v in split.items() if k.startswith("acs_main"))
        reduce_ms = split["acs_reduce_kernel"]
        cast_ms = sum(split.values()) - main_ms - reduce_ms
        pixels = n * h * w
        t_b, by = bound(2 * pixels * (c + f) + 2 * 9 * c * f + 8 * c + 8 * f,
                        2 * 9 * pixels * c * f, BF16_FLOPS)
        log(f"  times (cold L2): kernel {t_k:.4f} ms (launches: filter cast {cast_ms:.4f}, "
            f"main {main_ms:.4f}, reduce {reduce_ms:.4f}), plain {t_p:.4f} ms, library "
            f"{t_l:.4f} ms, bound {t_b:.4f} ms ({by}), kernel/library {t_k / t_l:.3f}")
        per_site.append({"shape": f"[{n},{h},{w},{c}] F={f}", "ms": t_k, "plain_ms": t_p,
                         "library_ms": t_l, "bound_ms": t_b, "main_ms": main_ms,
                         "filter_cast_ms": cast_ms, "reduce_ms": reduce_ms})
        ms, plain_ms, library_ms, bound_ms = ms + t_k, plain_ms + t_p, library_ms + t_l, bound_ms + t_b
        bound_share[by] += t_b
    bound_by = max(bound_share, key=bound_share.get)
    log(f"K3 over its three shapes: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    # a stand-alone op, as in the JAX package: no model calls it, so no train
    # phase launches it (run_conv_bn_op drives it as a path of its own); times
    # summed over one call at each of the three shapes
    return {"name": "affine_conv3x3_stats", "route": "cuda",
            "source": "vince_tpu_torch/csrc/affine_conv3x3_stats.cu",
            "replaces": "vince_tpu/ops/pallas/conv_bn_kernel.py:134",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "per": "one call at each 3x3 shape of ResNet50 stages 2-4 at batch 128, 224x224",
            "per_site": per_site, "check": "ok"}


def check_other_shapes(dev):
    """Shapes off the main path: ragged B, K and D for K1, which masks them
    (one row, two row blocks, fewer keys than a tile, D = 64, 72 and 256);
    rows that are not a multiple of the block, C that is not a power of two,
    C = 1152 and 2048 for K2, and the bottleneck of stage 4 at four times the
    width (C = 2048) through the module; odd N, H != W, C % 8 != 0, odd
    C, f32 and shapes that cross the tile's edges for K4 (forward, dx and dw);
    ragged tiles, two column tiles and F that is no multiple of 8 for K3. K1
    also at the queue shards of a distributed step, timed; returns those
    times."""
    from vince_tpu_torch.models.resnet import Bottleneck
    from vince_tpu_torch.ops.kernels import conv_bn_kernel as k3
    from vince_tpu_torch.ops.kernels import depthwise_kernel as k4
    from vince_tpu_torch.ops.kernels import folded_dot_kernel as k2
    from vince_tpu_torch.ops.kernels import infonce_kernel as k1
    from vince_tpu_torch.ops.kernels import plain_versions

    g = torch.Generator(device=dev).manual_seed(2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # one row; two row blocks; one tile and one key; fewer keys than a tile;
    # one key; D = 64 and 256 (blocks of 64 rows); D that is no multiple of 4
    for b, k, d in [(1, 4096, 128), (200, 65536, 128), (128, 65, 128), (7, 40, 128),
                    (5, 1, 128), (128, 4096, 64), (96, 3000, 256), (37, 1000, 72)]:
        log(f"K1 at q [{b},{d}], queue [{k},{d}]: chunking {k1._chunking(b, k, d, sms)}")
        compare_queue_logsumexp(k1, *queue_inputs(g, dev, b, k, d), 0.07)
    # a rank's rows against its queue shard in a distributed step: data axes
    # of 2 and 4 over 2 and 4 shards of 65536, and one data row over 2 shards
    shard_times = {}
    for b, k in [(64, 32768), (32, 16384), (128, 32768)]:
        log(f"K1 at a queue shard: q [{b},128], queue [{k},128]: chunking "
            f"{k1._chunking(b, k, 128, sms)}")
        q, queue = queue_inputs(g, dev, b, k, 128)
        compare_queue_logsumexp(k1, q, queue, 0.07)
        shard_times[f"q [{b},128], queue [{k},128]"] = time_queue_logsumexp(
            k1, q, queue, 0.07, per_launch=False)[0]
    # rows no multiple of the blocks; C that is no power of two; C above the
    # 512 channels that the main kernel keeps (rebuilt per F chunk); F split
    for m, c, f in [(200, 128, 256), (200, 384, 256), (130, 768, 128), (200, 1152, 384),
                    (130, 2048, 256), (1000, 512, 2048)]:
        log(f"K2 at y [{m},{c}], W [{c},{f}]: {k2.plan(m, c, f)}")
        check_k2_forward(k2, *k2_inputs(g, dev, m, c, f))
    # stage 4 of a ResNet50 of four times the width: C = 2048 launches K2, and
    # the block's output matches the block run through the plain versions
    log("Bottleneck with C = 2048 (stage 4 of ResNet50 x4 width), through the module")
    block = Bottleneck(256, 2048, downsample=True, fold=True, fold_kernel=True,
                       dtype=torch.bfloat16)
    for m in block.modules():
        if m is not block and hasattr(m, "reset_parameters"):
            m.reset_parameters(torch.Generator().manual_seed(0))
    block = block.to(dev).train()
    x = torch.randn(2, 8, 8, 256, generator=g, device=dev).bfloat16()
    before = k2.affine_relu_dot_moments.launches
    with torch.no_grad():
        out = block(x)
        launched = k2.affine_relu_dot_moments.launches - before
        with plain_versions():
            ref = block(x)
    if launched != 1:
        fail(f"the wide bottleneck launched K2 {launched} times, expected 1")
    # bf16 products summed in another order, then BatchNorm from moments that
    # agree to 1e-4: 2 bf16 ulp plus 1e-2 of the largest entry
    compare("block out vs plain versions", out, ref, 1.6e-2, 1e-2)
    for n, h, w, c, k, dtype in [(2, 16, 16, 32, 3, torch.bfloat16),
                                 (2, 12, 12, 144, 3, torch.bfloat16),
                                 (4, 9, 9, 240, 5, torch.bfloat16),
                                 (3, 7, 5, 50, 5, torch.bfloat16),
                                 (2, 6, 5, 51, 3, torch.bfloat16),
                                 (3, 20, 9, 24, 5, torch.float32),
                                 (2, 19, 40, 12, 3, torch.float32),
                                 # across the tile's edges: W no multiple of the columns
                                 # per thread, one vector of channels, a ragged last
                                 # chunk, N no multiple of the images per CTA (nor of
                                 # those side by side), fewer rows than the ring holds,
                                 # one channel a thread over two column tiles
                                 (3, 9, 13, 8, 3, torch.bfloat16),
                                 (5, 9, 9, 72, 5, torch.bfloat16),
                                 (11, 7, 7, 1152, 5, torch.bfloat16),
                                 (37, 14, 14, 200, 3, torch.bfloat16),
                                 (2, 3, 70, 36, 3, torch.bfloat16),
                                 (3, 5, 6, 20, 5, torch.float32),
                                 (1, 5, 300, 7, 5, torch.bfloat16)]:
        log(f"K4 at x [{n},{h},{w},{c}] {str(dtype).split('.')[-1]}, k={k}")
        x = torch.randn(n, h, w, c, generator=g, device=dev).to(dtype)
        wt = torch.randn(k, k, 1, c, generator=g, device=dev) * 0.2
        cot = torch.randn(n, h, w, c, generator=g, device=dev)
        compare("out", k4.depthwise_conv_forward(x, wt), k4._reference(x, wt.to(dtype)), 0, 0)
        dx_k, dw_k = depthwise_grads(k4, x, wt, cot)
        with plain_versions():
            dx_p, dw_p = depthwise_grads(k4, x, wt, cot)
        compare("dx", dx_k, dx_p, 0, 0)
        # f32 sums in another order, then (bf16) one rounding: one ulp of the type
        bf16 = dtype == torch.bfloat16
        compare("dw", dw_k, dw_p, 8e-3 if bf16 else 1e-4, 1e-3 if bf16 else 1e-4)
    for n, h, w, c, f in [(3, 10, 6, 128, 256), (2, 5, 33, 128, 20), (1, 40, 3, 256, 136)]:
        log(f"K3 at y_prev [{n},{h},{w},{c}], kernel [3,3,{c},{f}]")
        check_smem_count(k3, n, h, w, f)
        compare_conv_bn_forward(k3, conv_bn_inputs(g, dev, n, h, w, c, f))
    return shard_times


# the JPEG kernels' check: a batch of 160 frames of 480x360 (R2V2's frames: the
# video cacher's longest side is 480) decoded on the card, to 256x256
RESIZE_BATCH, RESIZE_FRAME, RESIZE_CANVAS = 160, (360, 480), 256
DECODE_ROUNDS = 20  # decodes of the batch held to the first bit for bit
TEXTURE_POOL = 16  # base scenes of the texture generator behind every image of phase 14


def texture_pool(seed, size=512):
    """``TEXTURE_POOL`` scenes of the port's texture generator (the 2x2
    equalised gratings of ``SyntheticTextureVideoDataset``), size x size RGB."""
    from vince_tpu_torch.data.synthetic_dataset import SyntheticTextureVideoDataset as T
    from vince_tpu_torch.data.synthetic_dataset import _texture_scene

    return [_texture_scene(np.random.RandomState(seed + i), size, T.GRID, T.N_ANGLES,
                           T.FREQS, T.C1, T.C2) for i in range(TEXTURE_POOL)]


def texture_image(pool, rng, hw, shift=(0, 0)):
    """An RGB image of ``hw`` from the pool: a scene drawn by ``rng``, rolled
    by a drawn offset (plus ``shift``), cut to ``hw``, a drawn gain."""
    scene = pool[rng.randint(len(pool))]
    dy, dx = rng.randint(0, scene.shape[0], 2) + np.asarray(shift)
    gain = rng.uniform(0.8, 1.1)
    img = np.roll(scene, (int(dy), int(dx)), axis=(0, 1))[: hw[0], : hw[1]]
    return np.clip(img * gain, 0, 255).astype(np.uint8)


def encode_jpeg(rgb, **params):
    import cv2

    flags = []
    for key, value in params.items():
        flags += [getattr(cv2, key), value]
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(rgb[:, :, ::-1]), flags)
    if not ok:
        fail("cv2.imencode failed")
    return enc.tobytes()


def ragged_streams(pool, seed=15):
    """The streams off the frames' shape: (name, bytes, whether the card's
    path takes it)."""
    import cv2

    rng = np.random.RandomState(seed)
    whole = encode_jpeg(texture_image(pool, rng, (360, 480)))
    gray = cv2.cvtColor(texture_image(pool, rng, (240, 320)), cv2.COLOR_RGB2GRAY)
    return [
        ("257x191", encode_jpeg(texture_image(pool, rng, (191, 257))), True),
        ("grayscale", cv2.imencode(".jpg", gray)[1].tobytes(), True),
        ("4:4:4", encode_jpeg(texture_image(pool, rng, (240, 320)),
                              IMWRITE_JPEG_SAMPLING_FACTOR=0x111111), True),
        ("progressive", encode_jpeg(texture_image(pool, rng, (240, 320)),
                                    IMWRITE_JPEG_PROGRESSIVE=1), True),
        ("truncated", whole[: len(whole) // 3], False),
        ("png", cv2.imencode(".png", texture_image(pool, rng, (120, 160)))[1].tobytes(), False),
    ]


def jax_would_scale(h, w, canvas):
    """Whether the JAX package's native decoder (decode.cc:138-152) decodes at
    a DCT scale m/8 < 1 for this image and canvas: then the JAX tests'
    tolerance against cv2 is a mean < 3, else a mean < 1 and a 99th
    percentile <= 4."""
    return any((h * m + 7) // 8 >= canvas and (w * m + 7) // 8 >= canvas for m in range(1, 8))


def decode_against_cv2(what, got, data, canvas):
    """The card's canvas against cv2's decode and the plain resize on the CPU,
    with the JAX tests' tolerances; (mean, p99, max) of |difference|."""
    import cv2

    from vince_tpu_torch.ops.kernels.jpeg_kernels import resize_image_plain

    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    ref = resize_image_plain(torch.from_numpy(np.ascontiguousarray(bgr[:, :, ::-1])),
                             canvas).numpy()
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    stats = (float(d.mean()), float(np.percentile(d, 99)), int(d.max()))
    scaled = jax_would_scale(bgr.shape[0], bgr.shape[1], canvas)
    if not (stats[0] < 3 if scaled else stats[0] < 1 and stats[1] <= 4):
        fail(f"{what}: nvJPEG + the kernel against cv2 + the plain resize: mean "
             f"{stats[0]:.4f}, p99 {stats[1]}, the JAX tests' tolerance "
             f"{'mean < 3' if scaled else 'mean < 1, p99 <= 4'}")
    return stats


def ragged_files_read(dev, ragged):
    """The ragged streams written as files and read by a dataset with
    ``--native-decode`` on the card (canvas 256): the streams the card
    refuses take the cv2 read, one count each in ``native.counts``."""
    import argparse as ap

    from vince_tpu_torch import native
    from vince_tpu_torch.data.base_dataset import BaseDataset

    class Reader(BaseDataset):
        def __len__(self):
            return 0

        def __getitem__(self, idx):
            return None

    reader = Reader(ap.Namespace(input_width=224, native_decode=True, platform=dev.type))
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for name, data, _ in ragged:
            paths.append(os.path.join(d, name.replace(":", "") + (".png" if name == "png"
                                                                   else ".jpg")))
            with open(paths[-1], "wb") as f:
                f.write(data)
        native.reset_counts()
        images = reader.read_images(paths)
    counts = dict(native.counts)
    refused = [name for name, _, takes in ragged if not takes]
    shapes = {name: None if img is None else img.shape for (name, _, _), img in zip(ragged, images)}
    if counts["cv2_reads"] != len(refused) or shapes["png"] != (256, 256, 3) or any(
            shapes[name] != (256, 256, 3) for name, _, takes in ragged if takes):
        fail(f"the ragged files read with --native-decode: {shapes}, counts {counts}")
    log(f"  the ragged files read by a dataset with --native-decode: {counts['cv2_reads']} cv2 "
        f"reads ({', '.join(refused)}); canvases {shapes}")
    return {"cv2_reads": counts["cv2_reads"], "shapes": {k: v and list(v) for k, v in
                                                          shapes.items()}}


def pair_metas(meta):
    """The two old kernels' metas for the fused kernel's ``meta`` (on its
    device): ``ycc_to_rgb``'s [n, 8] with each RGB image's offset, the RGB
    buffer's bytes, the largest image's pixels, ``resize_canvas``'s [n, 3]."""
    from vince_tpu_torch.native import _aligned

    rows = meta.tolist()
    rgb_at, total = [], 0
    for _, h, w, *_ in rows:
        rgb_at.append(total)
        total += _aligned(3 * h * w)
    ycc = torch.cat([meta, torch.tensor(rgb_at, device=meta.device)[:, None]], 1).contiguous()
    return ycc, total, max(h * w for _, h, w, *_ in rows), ycc[:, [7, 1, 2]].contiguous()


def jpeg_pair(planes, metas, canvas):
    """The path's two kernels before the fused one: ``ycc_to_rgb``, then
    ``resize_canvas`` (``metas`` from ``pair_metas``)."""
    from vince_tpu_torch.ops.kernels.jpeg_kernels import resize_canvas, ycc_to_rgb

    ycc, total, pixels, resize_meta = metas
    return resize_canvas(ycc_to_rgb(planes, ycc, total, pixels), resize_meta, canvas)


# random planes packed as the decode packs them: (h, w, hs, vs), hs = 0 for
# grayscale; chroma planes of width <= 2, odd sizes, every subsampling
RAGGED_PLANES = [(360, 480, 2, 2), (375, 500, 2, 2), (191, 257, 2, 1), (37, 53, 1, 2),
                 (36, 48, 1, 1), (240, 320, 0, 0), (6, 3, 2, 2), (5, 4, 2, 1), (1, 1, 2, 2),
                 (3, 2, 1, 2), (400, 20, 2, 2), (10, 700, 2, 2)]
# the fused kernel's canvases on the ragged batches: below every source, the
# path's, above every source (a band with fewer source rows than output rows)
RAGGED_CANVASES = (96, 256, 720)
R2V2_ITEM_FRAMES = 5  # an R2V2 item's distinct frames: 2 x 4 draws of 6 (4.6 on average)


def packed_planes(frames, rng, dev):
    """``RAGGED_PLANES``-like frames as random planes packed as the decode
    packs them, and the fused kernel's meta, on ``dev``."""
    from vince_tpu_torch.native import _aligned

    chunks, meta, at = [], [], 0
    for h, w, hs, vs in frames:
        cw, ch = (-(-w // hs), -(-h // vs)) if hs else (0, 0)
        flat = rng.randint(0, 256, h * w + 2 * cw * ch).astype(np.uint8)
        meta.append([at, h, w, cw, ch, hs, vs])
        chunks += [flat, np.zeros(_aligned(flat.size) - flat.size, np.uint8)]
        at += _aligned(flat.size)
    return (torch.from_numpy(np.concatenate(chunks)).to(dev),
            torch.tensor(meta, dtype=torch.int64, device=dev))


def fused_against(what, planes, meta, c):
    """The fused kernel on (planes, meta) at canvas c against its plain
    version and the old pair on the card, bit for bit; max |difference|."""
    from vince_tpu_torch.ops.kernels.jpeg_kernels import _reference_ycc_resize, ycc_resize_canvas

    got = ycc_resize_canvas(planes, meta, c)
    torch.cuda.synchronize()
    plain = _reference_ycc_resize(planes, meta, c)
    pair = jpeg_pair(planes, pair_metas(meta), c)
    errs = [int((got.int() - ref.int()).abs().max()) for ref in (plain, pair)]
    if errs != [0, 0] or got.shape != (meta.shape[0], c, c, 3):
        fail(f"ycc_resize_canvas on {what} at canvas {c}: {tuple(got.shape)}, max |difference| "
             f"{errs[0]} from the plain version, {errs[1]} from the old pair (bound 0)")
    return max(errs)


def fused_timings(planes, meta, c, frames_pixels, plane_bytes):
    """The fused kernel and the old pair in one call on the same planes: the
    device time with a cold L2 (``time_ms``), the host's time of one call to
    the end of the stream (the launch included: at a small batch it sets the
    time), and the fused kernel's bound (40 operations a source pixel, 18 a
    canvas byte, at the f32 rate; the planes read and the canvas written)."""
    from vince_tpu_torch.ops.kernels.jpeg_kernels import ycc_resize_canvas

    metas = pair_metas(meta)
    n = meta.shape[0]

    def call_ms(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    fused = lambda: ycc_resize_canvas(planes, meta, c)
    pair = lambda: jpeg_pair(planes, metas, c)
    out = {"ms": time_ms(fused), "pair_ms": time_ms(pair), "call_ms": call_ms(fused),
           "pair_call_ms": call_ms(pair)}
    out["bound_ms"], out["bound_by"] = bound(plane_bytes + n * c * c * 3,
                                             40 * frames_pixels + 18 * n * c * c * 3, F32_FLOPS)
    return out


def check_jpeg_kernels(dev):
    """The JPEG path's kernels on 160 frames of 480x360 decoded by nvJPEG:
    the fused ``ycc_resize_canvas`` against its plain version and against
    the old pair on the card (bit-equal), on that batch and on ragged ones
    (streams decoded by nvJPEG, random planes of every layout) below, at and
    above the sources' size; ``ycc_to_rgb`` against its plain version on the
    same planes (bit-equal) and ``resize_canvas`` against its plain version
    on the same RGB pixels (bit-equal; the bytes that differ counted); each
    timed beside its plain version, a library call where one computes the
    same function, and its bound, the fused kernel and the old pair in this
    call at 160 frames and at each path's shape per call (an R2V2 item's
    frames, one ImageNet image); the decoded RGB against cv2's decode;
    nvJPEG + the fused kernel against cv2 + the plain resize on the batch and
    on the ragged streams (the JAX tests' tolerances), the truncated stream
    and the PNG refused; the decode's times on the card and cv2's on this
    host."""
    import cv2
    import torch.nn.functional as F

    from vince_tpu_torch import native
    from vince_tpu_torch.ops.kernels.jpeg_kernels import (
        _reference_resize, _reference_ycc_resize, _reference_ycc_to_rgb, resize_canvas,
        ycc_resize_canvas, ycc_to_rgb)

    n, (h, w), c = RESIZE_BATCH, RESIZE_FRAME, RESIZE_CANVAS
    pool = texture_pool(14)
    rng = np.random.RandomState(14)
    items = [encode_jpeg(texture_image(pool, rng, (h, w))) for _ in range(n)]
    decoder = native.DecodePool(dev)._decoder
    log(f"JPEG path: {n} JPEGs of {w}x{h} (4:2:0, mean {np.mean([len(b) for b in items]):.0f} "
        f"bytes) decoded by nvJPEG, to {c}x{c}")
    native.reset_counts()
    planes, meta, _, rows = decoder.decode_planes(items)
    decoder.stream.synchronize()
    backends = dict(native.counts)
    if rows != list(range(n)):
        fail(f"nvJPEG decoded {len(rows)} of the {n} frames ({backends})")
    ycc_meta, rgb_total, pixels, resize_meta = metas = pair_metas(meta)
    rgb = ycc_to_rgb(planes, ycc_meta, rgb_total, pixels)
    rgb_plain = _reference_ycc_to_rgb(planes, ycc_meta, rgb_total)
    ycc_err = int((rgb.int() - rgb_plain.int()).abs().max())
    log(f"  ycc_to_rgb against the plain version on the same planes: max |difference| {ycc_err} "
        f"(bound 0)")
    if ycc_err:
        fail("ycc_to_rgb disagrees with its plain version")
    frames = rgb[: n * h * w * 3].view(n, h, w, 3)  # 480*360*3 is a multiple of the alignment
    full = np.stack([cv2.cvtColor(cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR),
                                  cv2.COLOR_BGR2RGB) for b in items])
    d = np.abs(frames.cpu().numpy().astype(np.int16) - full.astype(np.int16))
    log(f"  the decoded {w}x{h} RGB against cv2's decode: mean {d.mean():.4f}, p99 "
        f"{np.percentile(d, 99)}, max {d.max()} (nvJPEG's IDCT against libjpeg's)")
    plane_bytes = int(sum(hh * ww + 2 * ch * cw for _, hh, ww, cw, ch, *_ in meta.tolist()))
    ycc_times = {"ms": time_ms(lambda: ycc_to_rgb(planes, ycc_meta, rgb_total, pixels)),
                 "plain_ms": time_ms(lambda: _reference_ycc_to_rgb(planes, ycc_meta, rgb_total),
                                     iters=5),
                 "library_ms": None}
    ycc_times["bound_ms"], ycc_bound_by = bound(plane_bytes + n * h * w * 3, 40 * n * h * w,
                                                F32_FLOPS)
    log(f"  ycc_to_rgb times: kernel {ycc_times['ms']:.4f} ms, plain {ycc_times['plain_ms']:.4f}, "
        f"bound {ycc_times['bound_ms']:.4f} ({ycc_bound_by}; no single library call)")

    got = resize_canvas(rgb, resize_meta, c)
    ref = _reference_resize(rgb, resize_meta, c)
    diff = (got.int() - ref.int()).abs()
    max_err = int(diff.max())
    log(f"  resize_canvas against the plain version on the same pixels: max |difference| "
        f"{max_err}, {int((diff > 0).sum())} of {diff.numel()} bytes differ (bound 0)")
    if max_err:
        fail("resize_canvas disagrees with its plain version")

    def library():
        x = F.interpolate(frames.permute(0, 3, 1, 2).float(), size=(c, c), mode="bilinear",
                          align_corners=False)
        return x.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)

    lib_gap = int((library().int() - got.int()).abs().max())
    times = {"ms": time_ms(lambda: resize_canvas(rgb, resize_meta, c)),
             "plain_ms": time_ms(lambda: _reference_resize(rgb, resize_meta, c), iters=5),
             "library_ms": time_ms(library)}
    times["bound_ms"], bound_by = bound(n * h * w * 3 + n * c * c * 3, 18 * n * c * c * 3,
                                        F32_FLOPS)
    log(f"  resize_canvas times: kernel {times['ms']:.4f} ms, plain {times['plain_ms']:.4f}, "
        f"F.interpolate on a float copy {times['library_ms']:.4f} (its max |difference| from "
        f"the kernel {lib_gap}), bound {times['bound_ms']:.4f} ({bound_by})")

    # the fused kernel: bit-equal to the plain composition and to the old pair
    fused = ycc_resize_canvas(planes, meta, c)
    fused_plain = _reference_ycc_resize(planes, meta, c)
    fused_err = int((fused.int() - fused_plain.int()).abs().max())
    pair_err = int((fused.int() - got.int()).abs().max())
    log(f"  ycc_resize_canvas against its plain version (ycc_to_rgb's, then resize_canvas's) "
        f"on the same planes: max |difference| {fused_err}; against the old pair on the card "
        f"{pair_err} (bound 0)")
    if fused_err or pair_err:
        fail("ycc_resize_canvas disagrees with its plain version or the old pair")
    fused_times = fused_timings(planes, meta, c, n * h * w, plane_bytes)
    fused_times["plain_ms"] = time_ms(lambda: _reference_ycc_resize(planes, meta, c), iters=3,
                                      warmup=1)
    fused_times["library_ms"] = None
    log(f"  ycc_resize_canvas times ({n} frames): kernel {fused_times['ms']:.4f} ms, the old "
        f"pair in this call {fused_times['pair_ms']:.4f} (ycc_to_rgb {ycc_times['ms']:.4f} + "
        f"resize_canvas {times['ms']:.4f}); a call to the stream's end {fused_times['call_ms']:.4f}"
        f" ms against the pair's {fused_times['pair_call_ms']:.4f}; plain "
        f"{fused_times['plain_ms']:.4f}; bound {fused_times['bound_ms']:.4f} "
        f"({fused_times['bound_by']}; share {fused_times['bound_ms'] / fused_times['ms']:.3f}; "
        f"no single library call)")
    del fused, fused_plain, got, ref, rgb, rgb_plain, frames

    # ragged: streams of other shapes and layouts, and random planes of every layout
    streams = [("480x360 4:2:0", encode_jpeg(texture_image(pool, rng, (360, 480)))),
               ("500x375 4:2:0", encode_jpeg(texture_image(pool, rng, (375, 500)))),
               ("257x191 4:2:2", encode_jpeg(texture_image(pool, rng, (191, 257)),
                                             IMWRITE_JPEG_SAMPLING_FACTOR=0x211111)),
               ("320x240 grayscale", cv2.imencode(".jpg", cv2.cvtColor(
                   texture_image(pool, rng, (240, 320)), cv2.COLOR_RGB2GRAY))[1].tobytes())]
    s_planes, s_meta, _, s_rows = decoder.decode_planes([b for _, b in streams])
    decoder.stream.synchronize()
    if s_rows != list(range(len(streams))):
        fail(f"nvJPEG decoded {s_rows} of the ragged streams {[k for k, _ in streams]}")
    r_planes, r_meta = packed_planes(RAGGED_PLANES, np.random.RandomState(19), dev)
    ragged_err = max(max(fused_against("the ragged streams", s_planes, s_meta, cc),
                         fused_against("the random planes", r_planes, r_meta, cc))
                     for cc in RAGGED_CANVASES)
    log(f"  ycc_resize_canvas on the ragged streams ({', '.join(k for k, _ in streams)}: "
        f"{s_meta.tolist()}) and on random planes of {RAGGED_PLANES} (h, w, hs, vs) at canvases "
        f"{RAGGED_CANVASES}: bit-equal to the plain version and to the old pair")
    # each path's shape per call: an R2V2 item's frames, one ImageNet image
    per_call = {}
    for what, hw, k in (("R2V2 item", (360, 480), R2V2_ITEM_FRAMES),
                        ("ImageNet image", (375, 500), 1)):
        p, m, _, got_rows = decoder.decode_planes(
            [encode_jpeg(texture_image(pool, rng, hw)) for _ in range(k)])
        decoder.stream.synchronize()
        if got_rows != list(range(k)):
            fail(f"nvJPEG decoded {got_rows} of the {what}'s {k} frames")
        fused_against(what, p, m, c)
        pb = int(sum(hh * ww + 2 * ch * cw for _, hh, ww, cw, ch, *_ in m.tolist()))
        per_call[what] = dict(frames=k, hw=list(hw), **fused_timings(p, m, c, k * hw[0] * hw[1],
                                                                     pb))
        t = per_call[what]
        log(f"  ycc_resize_canvas at the path's call, {what} ({k} x {hw[1]}x{hw[0]}): kernel "
            f"{t['ms']:.4f} ms, the old pair {t['pair_ms']:.4f}; a call to the stream's end "
            f"{t['call_ms']:.4f} ms against the pair's {t['pair_call_ms']:.4f}; bound "
            f"{t['bound_ms']:.5f} ({t['bound_by']})")

    worst = (0.0, 0.0, 0)
    outs, ok = decoder.decode(items, c)
    for i in range(n):
        stats = decode_against_cv2(f"frame {i}", outs[i], items[i], c)
        worst = tuple(max(a, b) for a, b in zip(worst, stats))
    log(f"  nvJPEG + the fused kernel against cv2 + the plain resize over the {n} frames: worst "
        f"mean {worst[0]:.4f}, p99 {worst[1]}, max {worst[2]} (JAX would decode these at a DCT "
        f"scale: mean < 3; the port decodes at full size); decodes {backends}")
    # a decode state reused before its last image has left the card hands an
    # image another's data now and then (jpeg_decode.cu): decode the batch again
    for r in range(1, DECODE_ROUNDS):
        again, _ = decoder.decode(items, c)
        differ = np.nonzero((again != outs).reshape(n, -1).any(1))[0]
        if len(differ):
            fail(f"decode {r} of the batch differs from the first in frames {differ.tolist()}")
    log(f"  {DECODE_ROUNDS} decodes of the batch bit-equal")
    native.reset_counts()
    ragged = ragged_streams(pool)
    outs, ok = decoder.decode([b for _, b, _ in ragged], c)
    for (name, data, takes), out, good in zip(ragged, outs, ok):
        if bool(good) != takes:
            fail(f"the {name} stream: ok {bool(good)}, expected {takes}")
        if good:
            stats = decode_against_cv2(name, out, data, c)
            log(f"  {name}: against cv2 + the plain resize mean {stats[0]:.4f}, p99 {stats[1]}, "
                f"max {stats[2]}")
    log(f"  ragged streams' decodes {dict(native.counts)}; the truncated stream and the PNG "
        f"refused (ok False)")
    read = ragged_files_read(dev, ragged)

    def decode_only():
        decoder.decode_planes(items)
        decoder.stream.synchronize()

    def wall_ms(fn, reps=5):
        fn()
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    def cv2_batch():
        for data in items:
            rgb_host = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                                    cv2.COLOR_BGR2RGB)
            cv2.resize(rgb_host, (c, c), interpolation=cv2.INTER_LINEAR)

    decode = {"nvjpeg_ms": wall_ms(decode_only),
              "pool_ms": wall_ms(lambda: decoder.decode(items, c)),
              "cv2_one_thread_ms": wall_ms(cv2_batch, reps=3)}
    log(f"  a batch of {n}: nvJPEG's decode {decode['nvjpeg_ms']:.3f} ms (host clock to the "
        f"stream's end), decode + the fused kernel + the copy to pinned host memory "
        f"{decode['pool_ms']:.3f} ms; cv2's decode + resize on one host thread "
        f"{decode['cv2_one_thread_ms']:.3f} ms")
    del planes, meta, metas, ycc_meta, resize_meta, s_planes, r_planes
    torch.cuda.synchronize()
    common = {"route": "cuda", "source": "vince_tpu_torch/csrc/jpeg_decode.cu",
              "decode": decode, "backends": backends, "ragged_files": read, "check": "ok"}
    old = ("the JPEG path's counterpart of host C++ (no TPU kernel); replaced on the path by "
           "ycc_resize_canvas, a stand-alone op")
    return [{"name": "ycc_resize_canvas", "replaces": "vince_tpu/native/decode.cc:151",
             "note": "the JPEG path's counterpart of host C++ (no TPU kernel): libjpeg's "
                     "upsampling and conversion (decode.cc:151) and resize_bilinear_rgb "
                     "(decode.cc:54) in one kernel",
             "max_abs_err": max(fused_err, pair_err, ragged_err), **fused_times,
             "per_call": per_call, **common},
            {"name": "ycc_to_rgb", "replaces": "vince_tpu/native/decode.cc:151",
             "max_abs_err": ycc_err, **ycc_times, "bound_by": ycc_bound_by, "note": old,
             **common},
            {"name": "resize_canvas", "replaces": "vince_tpu/native/decode.cc:54",
             "max_abs_err": max_err, **times, "bound_by": bound_by, "note": old, **common}]


def run_jpeg_pair_ops(dev):
    """The two kernels that ``--native-decode`` launched before the fused
    one, called as stand-alone ops (no path of the port calls them) on an
    R2V2 item's frames decoded by nvJPEG: one launch each, their canvases
    equal to the fused kernel's."""
    from vince_tpu_torch import native
    from vince_tpu_torch.ops.kernels.jpeg_kernels import ycc_resize_canvas

    pool = texture_pool(14)
    rng = np.random.RandomState(20)
    decoder = native.DecodePool(dev)._decoder
    planes, meta, _, _ = decoder.decode_planes(
        [encode_jpeg(texture_image(pool, rng, RESIZE_FRAME)) for _ in range(R2V2_ITEM_FRAMES)])
    decoder.stream.synchronize()
    fused = ycc_resize_canvas(planes, meta, RESIZE_CANVAS)
    metas = pair_metas(meta)
    reset_counts()
    pair = jpeg_pair(planes, metas, RESIZE_CANVAS)
    launches = expect_counts("ycc_to_rgb, then resize_canvas, as stand-alone ops",
                             {"ycc_to_rgb": 1, "resize_canvas": 1})
    if not torch.equal(pair, fused):
        fail("the old JPEG pair as ops differs from ycc_resize_canvas")
    return launches


def profile_step(step, state, batch, path):
    """Trace one step with torch.profiler and write the device-time table."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, 0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device busy time: the union of the kernels' intervals (annotation rows
    # repeat the time of the kernels under them, so they are left out)
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    # the device's idle time before its first kernel (the host's work ahead of
    # it: draws, copies, launches), between kernels, and after its last
    first_host = min(e.time_range.start for e in events)
    last_host = max(e.time_range.end for e in events)
    idle = ((spans[0][0] - first_host) / 1e3, (end - spans[0][0] - busy_us) / 1e3,
            max(0.0, last_host - end) / 1e3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"one step: {wall:.3f} ms wall, {busy_us / 1e3:.3f} ms device busy\n")
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=80))
    log(f"  profile: {wall:.3f} ms wall, {busy_us / 1e3:.3f} ms device busy, "
        f"busy share {busy_us / 1e3 / wall:.3f}, {len(spans)} kernels; device idle "
        "{:.3f} ms before the first kernel, {:.3f} between kernels, {:.3f} after the "
        "last; table in {}".format(*idle, path))
    for e in prof.key_averages():  # the port's own kernels
        own = re.search(r"(ardm|qlse|acs|dw)_\w+", e.key)
        if own and e.device_type == torch.autograd.DeviceType.CUDA:
            log(f"    {own.group(0)}: {e.count} launches, "
                f"{e.self_device_time_total / 1e3:.3f} ms")


# the two train phases: the backbone's options, what the log calls them, and
# each kernel's launches per step
TRAIN_PHASES = {
    "ResNet50": dict(
        options=dict(fold_kernel=True), label="fused InfoNCE + fold kernel",
        per_step={"queue_logsumexp": 1, "affine_relu_dot_moments": 26, "depthwise_conv": 0,
                  "depthwise_wgrad": 0},
        why="1 K1 and 2 x 13 K2 per step"),
    "EfficientNetB0": dict(
        options=dict(dw_kind="kernel", se_kind="mul"),
        label="fused InfoNCE + depthwise kernel",
        per_step={"queue_logsumexp": 1, "affine_relu_dot_moments": 0, "depthwise_conv": 36,
                  "depthwise_wgrad": 12},
        why="1 K1, 12 sites x (key forward + query forward + query dgrad) K4 and 12 K4 wgrad "
            "per step"),
}


BATCH_SIZE, CANVAS = 128, 256


def wrappers():
    """The kernels' wrappers by name; each counts its launches and plain calls."""
    from vince_tpu_torch.ops.kernels.conv_bn_kernel import affine_conv3x3_stats
    from vince_tpu_torch.ops.kernels.depthwise_kernel import depthwise_conv, depthwise_wgrad
    from vince_tpu_torch.ops.kernels.folded_dot_kernel import affine_relu_dot_moments
    from vince_tpu_torch.ops.kernels.infonce_kernel import queue_logsumexp
    from vince_tpu_torch.ops.kernels.jpeg_kernels import (
        resize_canvas, ycc_resize_canvas, ycc_to_rgb)

    return {"queue_logsumexp": queue_logsumexp,
            "affine_relu_dot_moments": affine_relu_dot_moments,
            "depthwise_conv": depthwise_conv, "depthwise_wgrad": depthwise_wgrad,
            "affine_conv3x3_stats": affine_conv3x3_stats,
            "ycc_resize_canvas": ycc_resize_canvas, "ycc_to_rgb": ycc_to_rgb,
            "resize_canvas": resize_canvas}


def reset_counts():
    for w in wrappers().values():
        w.launches = w.plain_calls = 0


def read_counts():
    """(launches by kernel, plain calls in all) since the last reset; kernels
    that did not launch are left out."""
    ws = wrappers()
    return ({name: w.launches for name, w in ws.items() if w.launches},
            sum(w.plain_calls for w in ws.values()))


def expect_counts(what, expected):
    launches, plain = read_counts()
    expected = {k: v for k, v in expected.items() if v}
    log(f"  {what}: launches {launches}, plain calls {plain}")
    if launches != expected or plain != 0:
        fail(f"{what}: launch counts {launches} with {plain} plain calls, expected {expected} "
             f"and none")
    return launches


def train_config(backbone):
    from vince_tpu_torch.solvers.vince_step import SourceSpec, VinceConfig

    return VinceConfig(
        sources=(SourceSpec("YT", batch_size=BATCH_SIZE, num_frames=4,
                            transform="StandardVideoTransform", source_id=1),),
        backbone=backbone, embed_size=128, image_size=224, queue_size=65536,
        temperature=0.07, momentum=0.999, compute_dtype=torch.bfloat16, shuffle_bn=True,
        bn_fold="expand", jitter_order="torchvision", use_fused_infonce=True,
        **TRAIN_PHASES[backbone]["options"])


def make_batch(dev, seed=0):
    """One source's uint8 canvases [128, 256, 256, 3] from ``seed``: ``data``
    and, reversed, ``queue_data``."""
    host = np.random.RandomState(seed).randint(0, 256, (BATCH_SIZE, CANVAS, CANVAS, 3),
                                               np.uint8)
    return ({"data": torch.from_numpy(host).to(dev),
             "queue_data": torch.from_numpy(host[::-1].copy()).to(dev)},)


def time_steps(step, state, batch, steps):
    """Host clock around each of ``steps`` steps, each ending in a
    synchronise; (median ms, every step's ms, the losses, peak GiB). The peak
    is of the memory the allocator holds (reserved), after its cache is
    emptied: a replayed graph takes its intermediates from the graph's pool
    without an allocation, so the peak allocated misses them."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, 0)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss/total_loss"])
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite loss")
    log(f"    peak allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return (float(np.median(step_ms)), step_ms, losses,
            torch.cuda.max_memory_reserved() / 2**30)


def log_times(what, ms_step, step_ms, peak):
    log(f"  {what}: {ms_step:.3f} ms/step (median of {len(step_ms)}; each: "
        f"{', '.join(f'{t:.3f}' for t in step_ms)}), {BATCH_SIZE / ms_step * 1e3:.2f} frames/s, "
        f"peak memory reserved {peak:.3f} GiB")


def run_train(dev, backbone, steps=5, warmup=2, profile_path=None):
    from vince_tpu_torch.solvers.vince_step import (
        build_vince_optimizer, init_vince_state, make_train_step_fn)

    phase = TRAIN_PHASES[backbone]
    cfg = train_config(backbone)
    opt = build_vince_optimizer(0.03)
    log(f"train: {backbone} b=128 (32 videos x 4 frames) 224x224 from 256x256 uint8, "
        f"q=65536, embed 128, bf16, {phase['label']}, SGD lr 0.03")
    state = init_vince_state(0, cfg, opt, device=dev)
    step = make_train_step_fn(cfg, opt)
    batch = make_batch(dev)
    for i in range(warmup):
        state, metrics = step(state, batch, 0)
        log(f"  warm-up step {i}: loss {metrics['loss/total_loss'].item():.6f}")

    reset_counts()
    ms_step, step_ms, losses, peak = time_steps(step, state, batch, steps)
    for i, loss in enumerate(losses):
        log(f"  step {i}: loss {loss:.6f}")
    log_times("eager", ms_step, step_ms, peak)
    launches = expect_counts(f"{steps} eager steps ({phase['why']})",
                             {name: n * steps for name, n in phase["per_step"].items()})
    if profile_path:
        root, ext = os.path.splitext(profile_path)
        profile_step(step, state, batch, f"{root}.{backbone}{ext}")
    qn = state.queue.vectors.norm(dim=-1)
    if not bool(torch.isfinite(qn).all()) or (qn - 1).abs().max().item() > 1e-3:
        fail("queue rows are not unit vectors after the enqueues")

    plain_check(step, state, batch, spread=True)
    return {"ms_per_step": ms_step, "launches": launches, "peak_gib": peak}


def plain_check(step, state, batch, spread=False):
    """One more step from the same state and batch through the kernels and
    through the plain versions: bf16 with sums in another order, so the loss
    within 1e-2 relative and the weight update within 5e-2 relative in norm.
    With ``spread``, the same step once more through the kernels, to print
    the eager step's own spread."""
    from vince_tpu_torch.ops.kernels import plain_versions

    log("plain-version check: one step from the same state through the kernels and "
        "through the plain versions")
    s_kernel, s_plain = copy.deepcopy(state), copy.deepcopy(state)
    before = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    _, m_k = step(s_kernel, batch, 1)
    with plain_versions():
        _, m_p = step(s_plain, batch, 1)
    loss_k, loss_p = m_k["loss/total_loss"].item(), m_p["loss/total_loss"].item()
    upd_err = update_gap(s_plain, s_kernel, before)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"  loss kernel {loss_k:.6f} plain {loss_p:.6f} (rel {loss_rel:.3e}, tol 1e-2); "
        f"|update_kernel - update_plain| / |update_plain| = {upd_err:.3e} (tol 5e-2)")
    if loss_rel > 1e-2 or upd_err > 5e-2:
        fail("the kernel step and the plain-version step disagree")
    del s_plain
    if spread:
        s_again = copy.deepcopy(state)
        step(s_again, batch, 1)
        log(f"  the same step again through the kernels: |update - update_first| / "
            f"|update_first| = {update_gap(s_kernel, s_again, before):.3e} (information: "
            f"cuDNN's default algorithms may sum in no fixed order)")
    return loss_rel, upd_err


def update_gap(ref_state, state, init):
    """|update - update_ref| / |update_ref| over the query encoder's parameters."""
    num = den = 0.0
    ps = dict(state.model.named_parameters())
    for name, p in ref_state.model.named_parameters():
        d, d_ref = ps[name].detach() - init[name], p.detach() - init[name]
        num += float(((d - d_ref) ** 2).sum())
        den += float((d_ref ** 2).sum())
    return math.sqrt(num / max(den, 1e-30))


def captured_calls(dev, step, state, steps, expected_per_step):
    """``steps`` calls of a captured step on batches 0, 1, ... with seeds 0,
    1, ..., each call's launches checked: the kernels' per step at the
    warm-up calls and at the capture, none at a replay. Returns the losses
    and the launches at the capture."""
    from vince_tpu_torch.solvers.vince_step import WARMUP_STEPS

    if steps <= WARMUP_STEPS:
        fail("the captured step would not capture")
    losses = []
    for i in range(steps):
        reset_counts()
        _, metrics = step(state, make_batch(dev, seed=i), i)
        torch.cuda.synchronize()
        what = ("eager warm-up" if i < WARMUP_STEPS else "capture, then replay"
                if i == WARMUP_STEPS else "replay")
        launches = expect_counts(f"call {i} ({what})",
                                 expected_per_step if i <= WARMUP_STEPS else {})
        if i == WARMUP_STEPS:
            capture_launches = launches
        losses.append(metrics["loss/total_loss"].item())
        if not math.isfinite(losses[-1]):
            fail("non-finite loss in the captured step")
    return losses, capture_launches


def run_captured(dev, backbone, kind="sgd", steps=5, timed=5, profile_path=None, cfg=None,
                 mesh=None):
    """The captured step against the eager step from two states made from
    seed 0, over ``steps`` batches (the warm-up calls, the capture, replays),
    with cuDNN held to its deterministic algorithms on both sides so that
    only the capture can part them; then, under the defaults, a step captured
    anew on a new state and ``timed`` replays. Returns the state of the timed
    graph (else of the compared one), its launches at the capture, and the
    times. ``cfg`` and ``mesh`` (phase 12) replace the backbone's config and
    the one-device step."""
    from vince_tpu_torch.solvers.vince_step import (
        WARMUP_STEPS, build_vince_optimizer, init_vince_state, make_train_step,
        make_train_step_fn)

    phase = TRAIN_PHASES[backbone]
    cfg = cfg or train_config(backbone)
    opt = build_vince_optimizer(0.03, kind)
    log(f"captured train step: {backbone}, {kind.upper()} lr 0.03, the same shapes"
        f"{'' if mesh is None else f', {mesh}, shuffle {cfg.shuffle_mode}, sync-BN {cfg.sync_bn}'}"
        f"; {WARMUP_STEPS} eager warm-up calls, then the capture; against the eager step, "
        f"cuDNN deterministic on both sides")
    torch.backends.cudnn.deterministic = True
    s_eager = init_vince_state(0, cfg, opt, device=dev, mesh=mesh)
    s_graph = init_vince_state(0, cfg, opt, device=dev, mesh=mesh)
    init = {k: v.detach().clone() for k, v in s_eager.model.named_parameters()}
    losses_g, capture_launches = captured_calls(dev, make_train_step(cfg, opt, mesh=mesh),
                                                s_graph, steps, phase["per_step"])
    eager = make_train_step_fn(cfg, opt, mesh=mesh)
    loss_gaps = []
    for i, loss_g in enumerate(losses_g):
        _, m_e = eager(s_eager, make_batch(dev, seed=i), i)
        loss_e = m_e["loss/total_loss"].item()
        loss_gaps.append(abs(loss_g - loss_e) / abs(loss_e))
        log(f"    step {i}: loss eager {loss_e:.8f} captured {loss_g:.8f} "
            f"(rel gap {loss_gaps[-1]:.3e})")
    torch.backends.cudnn.deterministic = False
    upd = update_gap(s_eager, s_graph, init)
    log(f"  after {steps} steps: max loss gap {max(loss_gaps):.3e} (tol 1e-2), "
        f"|update_captured - update_eager| / |update_eager| = {upd:.3e} (tol 5e-2)")
    for name in ("tail", "total"):
        if not torch.equal(getattr(s_eager.queue, name), getattr(s_graph.queue, name)):
            fail(f"queue {name}: eager and captured differ")
    if s_graph.queue.inserted != s_eager.queue.inserted or s_graph.step != s_eager.step:
        fail("the captured step's host counts differ from the eager step's")
    if max(loss_gaps) > 1e-2 or upd > 5e-2:
        fail("the captured step and the eager step disagree")
    result = {"capture_launches": capture_launches, "loss_gap": max(loss_gaps),
              "update_gap": upd}
    if not timed:
        return s_graph, result
    del s_eager, s_graph, eager, init

    log(f"captured train step, timed: {backbone}, cuDNN's defaults (as the eager timing), "
        f"a new state and a new capture")
    state = init_vince_state(0, cfg, opt, device=dev, mesh=mesh)
    captured = make_train_step(cfg, opt, mesh=mesh)
    captured_calls(dev, captured, state, WARMUP_STEPS + 1, phase["per_step"])
    batch = make_batch(dev)
    reset_counts()
    ms_step, step_ms, _, peak = time_steps(captured, state, batch, timed)
    log_times("captured", ms_step, step_ms, peak)
    expect_counts(f"{timed} timed replays", {})
    result.update(ms_per_step=ms_step, peak_gib=peak)
    if profile_path:
        root, ext = os.path.splitext(profile_path)
        profile_step(captured, state, batch, f"{root}.{backbone}.captured{ext}")
    return state, result


# launches of each step beside training, per call: eval (key and query
# train-mode forward, the loss), prefill (key train-mode forward), embed with
# either encoder and panel (eval-mode forward: ResNet50's eval-mode BN takes
# the unfused chain, so no K2)
EVAL_COUNTS = {
    "ResNet50": {"eval": {"queue_logsumexp": 1, "affine_relu_dot_moments": 26},
                 "prefill": {"affine_relu_dot_moments": 13}, "embed": {},
                 "embed (key encoder)": {}, "panel": {}},
    "EfficientNetB0": {"eval": {"queue_logsumexp": 1, "depthwise_conv": 24},
                       "prefill": {"depthwise_conv": 12}, "embed": {"depthwise_conv": 12},
                       "embed (key encoder)": {"depthwise_conv": 12},
                       "panel": {"depthwise_conv": 12}},
}


def state_snapshot(state):
    """Every tensor and count of a state, copied."""
    opt = state.optimizer
    return ([v.clone() for v in state.model.state_dict().values()]
            + [v.clone() for v in state.key_model.state_dict().values()]
            + [opt.state[p]["momentum_buffer"].clone() for p in opt.params]
            + [t.clone() for t in (opt.lr, state.queue.vectors, state.queue.sources,
                                   state.queue.tail, state.queue.total)],
            (state.step, state.queue.inserted))


def unit_rows(what, emb):
    norms = emb.float().norm(dim=-1)
    if emb.shape != (BATCH_SIZE, 128) or not bool(torch.isfinite(emb).all()) or \
            (norms - 1).abs().max().item() > 1e-2:
        fail(f"{what}: embeddings of shape {tuple(emb.shape)} with norms "
             f"{norms.min().item():.4f}-{norms.max().item():.4f}")


def run_eval_steps(dev, backbone, state):
    """The eval, prefill, embed and panel steps on ``state`` (trained by the
    captured phase), once each: launches, finite outputs with unit-norm
    embeddings, and the state bit-identical before and after."""
    from vince_tpu_torch.ops.kernels import plain_versions
    from vince_tpu_torch.solvers.vince_step import (
        make_embed_fn, make_eval_step, make_key_prefill_fn, make_panel_fn)

    cfg = train_config(backbone)
    batch = make_batch(dev, seed=10)
    images = batch[0]["data"]
    log(f"eval, prefill, embed and panel: {backbone}, b=128, 224x224 (val path: 256x256 "
        f"canvases, a centre crop)")
    eval_step, prefill = make_eval_step(cfg), make_key_prefill_fn(cfg, 0)
    calls = {"eval": lambda: eval_step(state, batch, 0),
             "prefill": lambda: prefill(state, batch[0]["queue_data"], 0),
             "embed": lambda: make_embed_fn(cfg)(state, images),
             "embed (key encoder)": lambda: make_embed_fn(cfg, True)(state, images),
             "panel": lambda: make_panel_fn(cfg)(state, images)}
    launches = {}
    for name, call in calls.items():
        tensors, counts = state_snapshot(state)
        reset_counts()
        out = call()
        torch.cuda.synchronize()
        launches[name] = expect_counts(name, EVAL_COUNTS[backbone][name])
        after, after_counts = state_snapshot(state)
        if counts != after_counts or not all(torch.equal(x, y) for x, y in zip(tensors, after)):
            fail(f"{name} changed the state")
        del tensors, after
        if name == "eval":
            m_k = out
            if not all(math.isfinite(v.item()) for v in out.values()):
                fail(f"eval: non-finite metrics {out}")
            log("    " + ", ".join(f"{k} {v.item():.6f}" for k, v in out.items()))
        elif name == "prefill":
            unit_rows(name, out)
        elif name.startswith("embed"):
            unit_rows(name, out[0])
            if out[1].shape[0] != BATCH_SIZE or not bool(torch.isfinite(out[1]).all()):
                fail(f"{name}: features of shape {tuple(out[1].shape)} or not finite")
        else:
            unit_rows(name, out["embeddings"])
        log(f"    {name}: state bit-identical before and after")
    with plain_versions():
        m_p = eval_step(state, batch, 0)
    loss_k, loss_p = m_k["loss/nce_loss"].item(), m_p["loss/nce_loss"].item()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"  eval loss through the kernels {loss_k:.6f}, through the plain versions "
        f"{loss_p:.6f} (rel {rel:.3e}, tol 1e-2)")
    if rel > 1e-2:
        fail("the eval step through the kernels and through the plain versions disagree")
    return launches


def run_conv_bn_op(dev):
    """K3's own path: no model calls the op in either package, so its user
    calls ``affine_conv3x3_stats`` itself. One forward and backward at each of
    its three shapes, with the counts set to 0 before and read after."""
    from vince_tpu_torch.ops.kernels.conv_bn_kernel import affine_conv3x3_stats

    g = torch.Generator(device=dev).manual_seed(5)
    affine_conv3x3_stats.launches = affine_conv3x3_stats.plain_calls = 0
    log("stand-alone op: affine_conv3x3_stats forward and backward at its three shapes")
    for shape in K3_SHAPES:
        ins = [t.requires_grad_(True) for t in conv_bn_inputs(g, dev, *shape)]
        y, s1, s2 = affine_conv3x3_stats(*ins)
        n = y[..., 0].numel()
        var = s2 / n - (s1 / n) ** 2  # what a following BatchNorm would take from the sums
        (y.float().square().mean() + var.mean()).backward()
        if not all(bool(torch.isfinite(t).all()) for t in (y, s1, s2, *(i.grad for i in ins))):
            fail(f"affine_conv3x3_stats gave non-finite values at {shape}")
        log(f"  {shape}: mean y^2 {y.float().square().mean().item():.4f}, mean batch "
            f"variance {var.mean().item():.4f}")
    launches, plain = affine_conv3x3_stats.launches, affine_conv3x3_stats.plain_calls
    if launches != len(K3_SHAPES) or plain != 0:
        fail(f"affine_conv3x3_stats: {launches} launches and {plain} plain calls, expected "
             f"{len(K3_SHAPES)} and none")
    return launches


# phase 8: the heads and the step branches that use them, ResNet50 at the
# step's width (128 rows, 224x224 from 256x256, q=65536, embeddings 128, bf16,
# fused InfoNCE, the fold kernel, SGD lr 0.03)
HEAD_CONFIGS = {
    "ResNet50-IN+YT-heads": dict(
        sources=(dict(name="IN", batch_size=64, num_frames=4,
                      transform="RepeatedImagenetTransform", use_imagenet_ce=True,
                      source_id=0),
                 dict(name="YT", batch_size=64, num_frames=4, transform="StandardVideoTransform",
                      source_id=1)),
        options=dict(use_attention=True, self_batch=True)),
    "ResNet50-jigsaw": dict(
        sources=(dict(name="YT", batch_size=128, num_frames=4, transform="JigsawTransform",
                      source_id=1),),
        options=dict(jigsaw=True)),
}
NUM_CLASSES = 1000  # the ImageNet decoders' classes


def heads_config(name, **extra):
    from vince_tpu_torch.solvers.vince_step import SourceSpec, VinceConfig

    spec = HEAD_CONFIGS[name]
    return VinceConfig(
        sources=tuple(SourceSpec(**src) for src in spec["sources"]), backbone="ResNet50",
        embed_size=128, image_size=224, queue_size=65536, temperature=0.07, momentum=0.999,
        compute_dtype=torch.bfloat16, shuffle_bn=True, bn_fold="expand", fold_kernel=True,
        use_fused_infonce=True, jitter_order="torchvision", **spec["options"], **extra)


def heads_per_step(cfg, side=None):
    """K1 once per source; K2 at the 13 sites of each train-mode forward: the
    key's, the query's and, on a one-sided jigsaw step with the alignment
    term, the second query forward's (the 1152 patches of 75x75 of a jigsaw
    forward give M = 115200, 28800 and 10368 at stages 2-4, all taken)."""
    align = cfg.jigsaw_align_weight > 0 and side in ("query", "key")
    return {"queue_logsumexp": len(cfg.sources), "affine_relu_dot_moments": 13 * (2 + align)}


def heads_batch(dev, cfg, seed=0):
    """Per source uint8 canvases from ``seed`` (``queue_data`` the rows
    reversed) and, for a CE source, labels in [0, 1000)."""
    rng = np.random.RandomState(seed)
    batch = []
    for src in cfg.sources:
        host = rng.randint(0, 256, (src.batch_size, CANVAS, CANVAS, 3), np.uint8)
        b = {"data": torch.from_numpy(host).to(dev),
             "queue_data": torch.from_numpy(host[::-1].copy()).to(dev)}
        if src.use_imagenet_ce:
            b["labels"] = torch.from_numpy(rng.randint(0, NUM_CLASSES, src.batch_size)).to(dev)
        batch.append(b)
    return tuple(batch)


def side_name(side):
    return "no jigsaw" if side is None else f"jigsaw {side}"


def heads_eager(dev, cfg, state, side, label, steps=3):
    """An eager step of ``side`` on ``state``: one warm-up step, ``steps``
    timed with their launches asserted, then the plain-version check."""
    from vince_tpu_torch.solvers.vince_step import build_vince_optimizer, make_train_step_fn

    step = make_train_step_fn(cfg, build_vince_optimizer(0.03), side)
    batch = heads_batch(dev, cfg)
    log(f"heads, eager: {label}, {side_name(side)}")
    _, metrics = step(state, batch, 0)
    log("    metrics: " + ", ".join(f"{k} {v.item():.5f}" for k, v in sorted(metrics.items())))
    reset_counts()
    ms_step, step_ms, _, peak = time_steps(step, state, batch, steps)
    log_times("eager", ms_step, step_ms, peak)
    per_step = heads_per_step(cfg, side)
    launches = expect_counts(f"{steps} eager steps", {k: n * steps for k, n in per_step.items()})
    loss_rel, upd_err = plain_check(step, state, batch)
    return launches, {"eager_ms": ms_step, "eager_peak_gib": peak, "plain_loss_gap": loss_rel,
                      "plain_update_gap": upd_err}


def jigsaw_alternation(seed=0):
    """The solver's 50/50 coin of the jigsawed side, seeded, drawn until each
    side has warmed up, captured and replayed once."""
    from vince_tpu_torch.solvers.vince_step import WARMUP_STEPS

    coin, sides = np.random.RandomState(seed), []
    while min(sides.count("query"), sides.count("key")) < WARMUP_STEPS + 2:
        sides.append("key" if coin.rand() < 0.5 else "query")
    return sides


def heads_captured(dev, cfg, sides, label):
    """Captured steps of each side in ``sides`` on one state against eager
    steps of the same sides on another, both from seed 0, call by call in the
    order of ``sides`` on batches 0, 1, ... with cuDNN deterministic; each
    graph warms up, captures and replays on its own, its launches counted at
    the warm-up calls and the capture and none at a replay, and the queue's
    host count advances once per call, whichever graph ran."""
    from vince_tpu_torch.solvers.vince_step import (
        WARMUP_STEPS, build_vince_optimizer, init_vince_state, make_train_step,
        make_train_step_fn)

    opt = build_vince_optimizer(0.03)
    log(f"heads, captured against eager: {label}, calls "
        + " ".join(side_name(side) for side in sides) + "; cuDNN deterministic")
    torch.backends.cudnn.deterministic = True
    s_graph = init_vince_state(0, cfg, opt, device=dev)
    s_eager = init_vince_state(0, cfg, opt, device=dev)
    init = {k: v.detach().clone() for k, v in s_eager.model.named_parameters()}
    graphs = {side: make_train_step(cfg, opt, side) for side in sides}
    eagers = {side: make_train_step_fn(cfg, opt, side) for side in sides}
    gaps, bit_equal, capture_launches = [], True, {}
    for i, side in enumerate(sides):
        graph, batch = graphs[side], heads_batch(dev, cfg, seed=i)
        calls = graph.calls
        what = ("eager warm-up" if calls < WARMUP_STEPS else "capture, then replay"
                if calls == WARMUP_STEPS else "replay")
        reset_counts()
        _, m_g = graph(s_graph, batch, i)
        torch.cuda.synchronize()
        launches = expect_counts(f"call {i} ({side_name(side)}: {what})",
                                 heads_per_step(cfg, side) if calls <= WARMUP_STEPS else {})
        if calls == WARMUP_STEPS:
            capture_launches[side] = launches
        _, m_e = eagers[side](s_eager, batch, i)
        loss_g, loss_e = m_g["loss/total_loss"].item(), m_e["loss/total_loss"].item()
        if not math.isfinite(loss_g):
            fail("non-finite loss in the captured step")
        gaps.append(abs(loss_g - loss_e) / abs(loss_e))
        bit_equal = bit_equal and all(torch.equal(m_g[k], m_e[k]) for k in m_e)
        log(f"    step {i}: loss eager {loss_e:.8f} captured {loss_g:.8f} "
            f"(rel gap {gaps[-1]:.3e})")
    torch.backends.cudnn.deterministic = False
    if any(g.graph is None for g in graphs.values()):
        fail("a captured step did not capture")
    upd = update_gap(s_eager, s_graph, init)
    log(f"  after {len(sides)} steps: max loss gap {max(gaps):.3e} (tol 1e-2), every metric "
        f"bit-equal: {bit_equal}, |update_captured - update_eager| / |update_eager| = "
        f"{upd:.3e} (tol 5e-2)")
    for name in ("tail", "total"):
        if not torch.equal(getattr(s_eager.queue, name), getattr(s_graph.queue, name)):
            fail(f"queue {name}: eager and captured differ")
    if (s_graph.queue.inserted, s_graph.step) != (s_eager.queue.inserted, s_eager.step) or \
            s_graph.queue.inserted != min(len(sides) * BATCH_SIZE, cfg.queue_size):
        fail("the captured steps' host counts differ from the eager steps'")
    if max(gaps) > 1e-2 or upd > 5e-2:
        fail("the captured step and the eager step disagree")
    return capture_launches, {"loss_gap": max(gaps), "update_gap": upd, "bit_equal": bit_equal}


def heads_timed(dev, cfg, sides, label, timed=5, profile_path=None):
    """Under cuDNN's defaults, a new state and a new graph for each side,
    each warmed up and captured, then ``timed`` replays of each (and, with
    ``profile_path``, one traced replay); the peak reserved memory holds
    every graph's pool. Returns the state and the times by side."""
    from vince_tpu_torch.solvers.vince_step import (
        WARMUP_STEPS, build_vince_optimizer, init_vince_state, make_train_step)

    opt = build_vince_optimizer(0.03)
    log(f"heads, captured and timed: {label}, a graph for each of "
        + ", ".join(side_name(side) for side in sides) + " on one state")
    state = init_vince_state(0, cfg, opt, device=dev)
    graphs = {side: make_train_step(cfg, opt, side) for side in sides}
    for i in range(WARMUP_STEPS + 1):
        for graph in graphs.values():
            graph(state, heads_batch(dev, cfg, seed=i), i)
    batch = heads_batch(dev, cfg)
    times = {}
    for side, graph in graphs.items():
        reset_counts()
        ms_step, step_ms, _, peak = time_steps(graph, state, batch, timed)
        log_times(f"captured, {side_name(side)}", ms_step, step_ms, peak)
        expect_counts(f"{timed} timed replays", {})
        times[side] = {"captured_ms": ms_step, "captured_peak_gib": peak}
        if profile_path:
            root, ext = os.path.splitext(profile_path)
            suffix = "" if side is None else f".{side}"
            profile_step(graph, state, batch, f"{root}.{label}{suffix}.captured{ext}")
    return state, times


def heads_eval_and_panel(dev, cfg, state, label):
    """The eval step and the panel once each on ``state``: launches, the
    state bit-identical, finite metrics, unit embeddings; with the attention
    pool, masks that sum to 1 per image; with the decoders, [B, 1000] finite
    logits."""
    from vince_tpu_torch.solvers.vince_step import make_eval_step, make_panel_fn

    batch = heads_batch(dev, cfg, seed=10)
    images = torch.cat([b["data"] for b in batch])  # 128 rows from every source
    log(f"heads, eval and panel: {label}")
    calls = {"eval": (lambda: make_eval_step(cfg)(state, batch, 0),
                      {"queue_logsumexp": len(cfg.sources), "affine_relu_dot_moments": 26}),
             "panel": (lambda: make_panel_fn(cfg)(state, images), {})}
    launches = {}
    for name, (call, expected) in calls.items():
        tensors, counts = state_snapshot(state)
        reset_counts()
        out = call()
        torch.cuda.synchronize()
        launches[name] = expect_counts(name, expected)
        after, after_counts = state_snapshot(state)
        if counts != after_counts or not all(torch.equal(x, y) for x, y in zip(tensors, after)):
            fail(f"{name} changed the state")
        del tensors, after
        log(f"    {name}: state bit-identical before and after")
        if name == "eval":
            if not all(math.isfinite(v.item()) for v in out.values()):
                fail(f"eval: non-finite metrics {out}")
            log("    " + ", ".join(f"{k} {v.item():.5f}" for k, v in sorted(out.items())))
            continue
        rows, keys = images.shape[0], {"embeddings"}
        unit_rows(name, out["embeddings"])
        if cfg.use_attention:
            keys.add("attention_masks")
            masks = out["attention_masks"]
            sums = masks.sum(dim=(1, 2, 3))
            grid = (rows, images.shape[1] // 32, images.shape[2] // 32, 1)  # the raw canvases
            if masks.shape != grid or (sums - 1).abs().max().item() > 1e-5:
                fail(f"panel: attention masks {tuple(masks.shape)} sum to "
                     f"{sums.min().item()}-{sums.max().item()}")
            log(f"    attention masks {tuple(masks.shape)}, sums within "
                f"{(sums - 1).abs().max().item():.2e} of 1")
        if any(src.use_imagenet_ce for src in cfg.sources):
            for di in range(2):
                logits = out[f"imagenet_logits_{di}"]
                keys.add(f"imagenet_logits_{di}")
                if logits.shape != (rows, NUM_CLASSES) or not bool(torch.isfinite(logits).all()):
                    fail(f"panel: logits {di} of shape {tuple(logits.shape)} or not finite")
            log(f"    imagenet logits 2 x {tuple(logits.shape)}, finite")
        if set(out) != keys:
            fail(f"panel: outputs {sorted(out)}, expected {sorted(keys)}")
    return launches


def run_heads(dev, profile_path=None):
    """Phase 8: both head configurations. Returns the launches of each path
    and the times."""
    from vince_tpu_torch.solvers.vince_step import build_vince_optimizer, init_vince_state

    paths, times = {}, {}
    label = "ResNet50-IN+YT-heads"
    cfg = heads_config(label)
    log(f"phase 8, {label}: IN 64 rows (16 images x 4 views, CE, labels from the seed) + YT "
        "64 rows (16 videos x 4 frames), attention pool, self-batch")
    state = init_vince_state(0, cfg, build_vince_optimizer(0.03), device=dev)
    paths[f"{label} eager, 3 steps"], times[label] = heads_eager(dev, cfg, state, None, label)
    del state
    capture, times[f"{label} agreement"] = heads_captured(dev, cfg, [None] * 5, label)
    paths[f"{label} captured (at the capture)"] = capture[None]
    state, t = heads_timed(dev, cfg, [None], label, profile_path=profile_path)
    times[label].update(t[None])
    for name, launches in heads_eval_and_panel(dev, cfg, state, label).items():
        paths[f"{label} {name}"] = launches
    del state

    label = "ResNet50-jigsaw"
    cfg = heads_config(label)
    log(f"phase 8, {label}: YT 128 rows (32 videos x 4 frames), 1152 patches of 75x75 on a "
        "jigsawed side")
    state = init_vince_state(0, cfg, build_vince_optimizer(0.03), device=dev)
    for side in ("query", "key", "both"):
        paths[f"{label} eager {side}, 3 steps"], times[f"{label} {side}"] = heads_eager(
            dev, cfg, state, side, label)
    aligned = heads_config(label, jigsaw_align_weight=0.5)
    paths[f"{label} eager query + align, 3 steps"], times[f"{label} query + align"] = \
        heads_eager(dev, aligned, state, "query", label + ", jigsaw_align_weight 0.5")
    del state
    sides = jigsaw_alternation()
    capture, times[f"{label} agreement"] = heads_captured(dev, cfg, sides, label)
    for side, launches in capture.items():
        paths[f"{label} captured {side} (at the capture)"] = launches
    state, t = heads_timed(dev, cfg, ["query", "key"], label, profile_path=profile_path)
    for side in ("query", "key"):
        times[f"{label} {side}"].update(t[side])
    for name, launches in heads_eval_and_panel(dev, cfg, state, label).items():
        paths[f"{label} {name}"] = launches
    del state
    return paths, times


# phase 9: the training CLI at full width, ``solver_runner.main`` in this
# process: the ResNet50 step of phases 3-5 fed by the synthetic texture videos
# (32 videos x 4 frames of 256x256 canvases a batch, 256 videos a split)
CLI_ARGV = ["--solver", "VinceSolver", "--dataset", "SyntheticTextureVideoDataset",
            "--use-videos", "--inter-batch-comparison", "--num-frames", "4",
            "--batch-size", "128", "--input-width", "224", "--input-height", "224",
            "--vince-queue-size", "65536", "--vince-embedding-size", "128",
            "--compute-dtype", "bfloat16", "--use-fused-infonce", "--fold-kernel",
            "--backbone", "ResNet50", "--base-lr", "0.03", "--iterations-per-epoch", "24",
            "--save-frequency", "12", "--synthetic-num-videos", "256"]
# the pretraining run of phase 9, whose checkpoints phase 10's end tasks read
PRETRAIN_RUN = ["--title", "cli", "--description", "resnet50"]
CLI_METERS = ("data_cache_time", "step_time", "metrics_time", "log_save_time", "total_time")
# beside the meters: the part of step_time until the step returns to the host
LAPS = CLI_METERS + ("step host",)
# launches of each solver call: a train iteration eagerly or at the capture
# (none at a replay), a prefill batch, a val batch
CLI_COUNTS = {
    "ResNet50": {"step": TRAIN_PHASES["ResNet50"]["per_step"],
                 "prefill": EVAL_COUNTS["ResNet50"]["prefill"],
                 "val batch": EVAL_COUNTS["ResNet50"]["eval"]},
    "EfficientNetB0": {"step": TRAIN_PHASES["EfficientNetB0"]["per_step"],
                       "prefill": EVAL_COUNTS["EfficientNetB0"]["prefill"],
                       "val batch": EVAL_COUNTS["EfficientNetB0"]["eval"]},
}


class CliRecord:
    """While active, wraps ``VinceSolver.run_train_iteration``, ``run_val`` and
    ``fill_queue_repeat``: each call's launches and plain calls, and after an
    iteration its meters' laps and its loss, after a val pass its batches
    and seconds."""

    WRAPPED = ("run_train_iteration", "run_val", "fill_queue_repeat", "select_step")

    def __enter__(self):
        from vince_tpu_torch.solvers.vince_solver import VinceSolver

        self.cls, self.calls, self.host_s = VinceSolver, [], []
        self.originals = {name: getattr(VinceSolver, name) for name in self.WRAPPED}
        for name, orig in self.originals.items():
            setattr(VinceSolver, name, self._wrap(name, orig))
        return self

    def _timed_step(self, step):
        """The step, with the host's time to return from it (the draws, the
        copies into the graph's inputs, the replay's launch: the device may
        still be running) kept per call."""
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = step(*args, **kwargs)
            self.host_s.append(time.perf_counter() - t0)
            return out
        return call

    def _wrap(self, name, orig):
        if name == "select_step":
            return lambda solver: self._timed_step(orig(solver))

        def call(solver, *args, **kwargs):
            from vince_tpu_torch.solvers.vince_step import WARMUP_STEPS

            before, plain_before = read_counts()
            if name == "run_train_iteration" and len(self.of(name)) == WARMUP_STEPS + 2:
                out, syncs = with_sync_warnings(lambda: orig(solver, *args, **kwargs))
            else:
                out, syncs = orig(solver, *args, **kwargs), None
            now, plain = read_counts()
            entry = {"kind": name, "plain": plain - plain_before,
                     "launches": {n: v - before.get(n, 0) for n, v in now.items()
                                  if v != before.get(n, 0)}}
            if name == "run_train_iteration":
                entry["laps"] = {m: solver.time_meters[m].values[-1] for m in CLI_METERS}
                entry["laps"]["step host"] = self.host_s[-1]
                entry["syncs"] = syncs
                entry["loss"] = out["loss/total_loss"]
            elif name == "run_val":
                entry["batches"], entry["seconds"] = solver.last_val_batches, solver.last_val_seconds
            self.calls.append(entry)
            return out
        return call

    def __exit__(self, *exc):
        for name, orig in self.originals.items():
            setattr(self.cls, name, orig)

    def of(self, kind):
        return [c for c in self.calls if c["kind"] == kind]


def with_sync_warnings(fn):
    """``fn()`` with torch's warning on every operation that waits for the
    device; (its result, the sites (file:line) and kinds of those waits)."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, [f"{os.path.relpath(w.filename)}:{w.lineno} ({str(w.message).split(',')[0]})"
                 for w in caught if "synchroniz" in str(w.message)]


class Tee(io.StringIO):
    """stdout that is also kept, less the flags that ``parse_args`` prints
    (from its "args" line to its line of dashes)."""

    def __init__(self, out):
        super().__init__()
        self.out, self.line, self.in_args = out, "", False

    def write(self, text):
        self.line += text
        *lines, self.line = self.line.split("\n")
        for line in lines:
            if line == "args":
                self.in_args = True
            elif not self.in_args:
                self.out.write(line + "\n")
            elif line.startswith("-----"):
                self.in_args = False
        return super().write(text)

    def flush(self):
        self.out.flush()


def check_cli_calls(what, rec, backbone, iterations, prefills):
    """Each call's launches against ``CLI_COUNTS`` (the step's at the eager
    warm-up calls and the capture, none at a replay), no plain call, finite
    losses. Returns the launches summed by kernel."""
    from vince_tpu_torch.solvers.vince_step import WARMUP_STEPS

    counts = CLI_COUNTS[backbone]
    its = rec.of("run_train_iteration")
    if len(its) != iterations or len(rec.of("fill_queue_repeat")) != prefills:
        fail(f"{what}: {len(its)} iterations and {len(rec.of('fill_queue_repeat'))} prefills, "
             f"expected {iterations} and {prefills}")
    for c in rec.calls:
        # the JPEG kernels launch on the loader's threads (--native-decode),
        # beside the calls: phase 14 counts them over the whole run
        for name in JPEG_KERNELS + OLD_JPEG_KERNELS:
            c["launches"].pop(name, None)
        if c["kind"] == "run_train_iteration":
            i = its.index(c)
            expected = counts["step"] if i <= WARMUP_STEPS else {}
        elif c["kind"] == "fill_queue_repeat":
            expected = counts["prefill"]
        else:
            expected = {k: v * c["batches"] for k, v in counts["val batch"].items()}
        expected = {k: v for k, v in expected.items() if v}
        if c["launches"] != expected or c["plain"]:
            fail(f"{what}: {c['kind']} launched {c['launches']} with {c['plain']} plain calls, "
                 f"expected {expected} and none")
    losses = [c["loss"] for c in its]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: non-finite losses {losses}")
    log(f"  {what}: launches as expected ({counts['step']} per iteration at the "
        f"{WARMUP_STEPS} eager calls and the capture, none at the {iterations - WARMUP_STEPS - 1} "
        f"replays; {counts['prefill']} per prefill); losses {losses[0]:.4f} ... {losses[-1]:.4f}, "
        f"all finite")
    total = {}
    for c in rec.calls:
        for k, v in c["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def report_laps(what, rec, card):
    """Median and range of each meter over the iterations after the capture."""
    from vince_tpu_torch.solvers.vince_step import WARMUP_STEPS

    after = rec.of("run_train_iteration")[WARMUP_STEPS + 1:]
    out = {}
    for m in LAPS:
        ms = [c["laps"][m] * 1e3 for c in after]
        out[m] = (float(np.median(ms)), min(ms), max(ms))
        log(f"  {what} {m}: median {out[m][0]:.3f} ms (range {out[m][1]:.3f}-{out[m][2]:.3f}) "
            f"over the {len(ms)} iterations after the capture")
    out["frames_per_s"] = BATCH_SIZE / out["total_time"][0] * 1e3
    log(f"  {what}: {out['frames_per_s']:.2f} frames/s (128 / median total_time); card {card}")
    (probed,) = [c for c in after if c["syncs"] is not None]
    out["syncs"] = probed["syncs"]
    log(f"  {what}: the waits on the device in iteration {WARMUP_STEPS + 2} (a replay), by "
        f"torch.cuda.set_sync_debug_mode: {probed['syncs']}")
    return out


def time_loader(batches=16, ds=None, batch_size=32):
    """The train loader alone, with the CLI's default threads, on ``ds`` (by
    default phase 9's: batches of 32 videos x (4 + 4) frames): ms per batch
    over ``batches`` batches, after as many as its workers and its queue
    hold ready at the start (the steady state of a long run)."""
    import argparse as ap
    import multiprocessing

    from vince_tpu_torch.data.loader import PersistentDataLoader
    from vince_tpu_torch.data.synthetic_dataset import SyntheticTextureVideoDataset

    if ds is None:
        ds = SyntheticTextureVideoDataset(ap.Namespace(input_width=224, num_frames=4), "train",
                                          num_videos=256, num_images_to_return=4)
    workers = min(multiprocessing.cpu_count(), 16)
    loader = PersistentDataLoader(batch_size=batch_size, num_workers=workers)
    loader.set_dataset(ds)
    try:
        for _ in range(workers + loader.prefetch + 1):
            loader.get_batch(timeout=300)
        t0 = time.perf_counter()
        for _ in range(batches):
            loader.get_batch(timeout=300)
        return (time.perf_counter() - t0) / batches * 1e3, workers
    finally:
        loader.shutdown()


def time_item():
    """One texture video of phase 9 (a scene and 8 jittered frames) on this
    thread, ms: the median of 16."""
    import argparse as ap

    from vince_tpu_torch.data.synthetic_dataset import SyntheticTextureVideoDataset

    ds = SyntheticTextureVideoDataset(ap.Namespace(input_width=224, num_frames=4), "train",
                                      num_videos=256, num_images_to_return=4)
    ms = []
    for i in range(16):
        t0 = time.perf_counter()
        ds[i]
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def tree_equal(what, got, ref):
    for k, v in ref.items():
        if isinstance(v, dict):
            tree_equal(f"{what}/{k}", got[k], v)
        elif isinstance(v, torch.Tensor):
            if not torch.equal(got[k].detach().cpu(), v):
                fail(f"{what}/{k}: the restored tensor differs from the checkpoint's")
        elif got[k] != v:
            fail(f"{what}/{k}: restored {got[k]}, the checkpoint holds {v}")


def free_cuda():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


class Laps:
    """The seconds of a phase's parts: ``laps(what)`` keeps, under ``what``,
    the time since the last lap (or the start); ``seconds by phase`` prints
    them."""

    def __init__(self):
        self.t0, self.seconds = time.perf_counter(), {}

    def __call__(self, what):
        now = time.perf_counter()
        self.seconds[what] = round(now - self.t0, 1)
        self.t0 = now


def in_use_gib():
    """The card's memory in use by every process on it (``mem_get_info``)."""
    free, total = torch.cuda.mem_get_info()
    return (total - free) / 2**30


def solver_iterations(what, argv, backbone, iterations, tmp):
    """The parser and the solver as ``main`` builds them, ``iterations``
    train iterations, no val, no save; the launches and the record."""
    from vince_tpu_torch import arg_parser
    from vince_tpu_torch.solvers.vince_solver import VinceSolver

    argv = argv + ["--title", "cli", "--base-logdir", tmp, "--epochs", "1", "--no-save",
                   "--no-restore"]
    with CliRecord() as rec, contextlib.redirect_stdout(Tee(sys.stdout)):
        solver = VinceSolver(arg_parser.parse_args(argv))
        try:
            solver.run_n_train_iterations(iterations)
            rec.in_use_gib = in_use_gib()  # the loader's workers still alive
        finally:
            solver.end()
    del solver
    free_cuda()
    return check_cli_calls(what, rec, backbone, iterations, 1), rec


def run_cli(dev, card, tmp):
    """Phase 9: ``solver_runner.main`` for one epoch of 24 iterations and its
    val pass; the restore of its step-24 checkpoint against the files; the
    resumed run to 48; a short run through the parser and the solver with an
    EfficientNet-B0; the loader alone. Logs
    and checkpoints go to ``tmp``, where phase 10 reads the pretraining
    checkpoint. Returns the launches of each path and the numbers."""
    from vince_tpu_torch import arg_parser, solver_runner
    from vince_tpu_torch.solvers.vince_solver import VinceSolver
    from vince_tpu_torch.utils.checkpoint import state_tree

    paths, result = {}, {}
    parts = Laps()
    argv = CLI_ARGV + PRETRAIN_RUN + ["--base-logdir", tmp]
    log(f"phase 9: python -m vince_tpu_torch.solver_runner {' '.join(CLI_ARGV)} "
        f"--epochs 1 (logs and checkpoints in a temporary directory)")
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with CliRecord() as rec, contextlib.redirect_stdout(Tee(sys.stdout)):
        solver = solver_runner.main(argv + ["--epochs", "1"])
    result["wall_s"] = time.perf_counter() - t0
    result["peak_gib"] = torch.cuda.max_memory_reserved() / 2**30
    paths["CLI ResNet50, epoch 1"] = check_cli_calls("epoch 1", rec, "ResNet50", 24, 1)
    result["laps"] = report_laps("epoch 1", rec, card)
    (val,) = rec.of("run_val")
    result["val"] = (val["batches"], val["seconds"])
    result["saves"] = [(t["step"], t["host_copy_s"], t["write_s"])
                       for t in solver.ckpt.timings]
    steps = solver.ckpt.latest_step(), sorted(os.listdir(solver.ckpt.checkpoint_dir))
    log(f"  val pass: {val['batches']} batches in {val['seconds']:.3f} s; saves (step, host "
        f"copy s, disk write s): {result['saves']}; checkpoints {steps[1]}; peak memory "
        f"reserved {result['peak_gib']:.3f} GiB; the run {result['wall_s']:.1f} s wall")
    if steps[1] != ["12", "24"] or val["batches"] != 8:
        fail("phase 9: expected the checkpoints of steps 12 and 24 and a val pass of 8 "
             "batches (256 videos, 32 a batch)")
    del solver, rec
    free_cuda()
    parts("epoch 1")

    log("phase 9, resume: the solver of --epochs 2 restores step 24; its state against "
        "the checkpoint's files")
    with contextlib.redirect_stdout(Tee(sys.stdout)) as out:
        check = VinceSolver(arg_parser.parse_args(argv + ["--epochs", "2"]))
    try:
        if "Restored step 24" not in out.getvalue():
            fail("phase 9: no 'Restored step 24'")
        tree_equal("state", state_tree(check.state), check.ckpt.restore_raw(24))
        if check._prefill_counter or not check._queue_restored:
            fail("phase 9: the restored queue was refilled")
        log(f"  restored state bit-identical to the files of step 24 (step "
            f"{check.state.step}, epoch {check.epoch}, queue rows {check.state.queue.inserted}, "
            f"not refilled)")
    finally:
        check.end()
    del check
    free_cuda()
    parts("restore check")
    with CliRecord() as rec, contextlib.redirect_stdout(Tee(sys.stdout)) as out:
        solver = solver_runner.main(argv + ["--epochs", "2"])
    if "Restored step 24" not in out.getvalue() or solver.state.step != 48:
        fail(f"phase 9: the resumed run ended at step {solver.state.step}, expected 48")
    paths["CLI ResNet50, resumed epoch 2"] = check_cli_calls("resumed epoch 2", rec,
                                                              "ResNet50", 24, 0)
    result["resumed_laps"] = report_laps("resumed epoch 2", rec, card)
    del solver, rec
    free_cuda()
    parts("resumed epoch 2")

    log("phase 9, EfficientNet-B0: the parser and the solver, --dw-kind pallas, 8 "
        "iterations, no val")
    b0_argv = [a for a in CLI_ARGV if a != "--fold-kernel"]
    b0_argv[b0_argv.index("ResNet50")] = "EfficientNetB0"
    paths["CLI EfficientNetB0, 8 iterations"], _ = solver_iterations(
        "B0", b0_argv + ["--dw-kind", "pallas", "--description", "b0"], "EfficientNetB0", 8,
        tmp)
    parts("B0")

    result["item_ms"] = time_item()
    result["loader_ms"] = time_loader()
    log(f"phase 9, loader alone: one texture video (scene + 8 frames) {result['item_ms']:.3f} ms "
        f"on one thread; a batch of 32 videos {result['loader_ms'][0]:.3f} ms with "
        f"{result['loader_ms'][1]} threads")
    parts("loader alone")
    result["seconds"] = parts.seconds
    return paths, result


# phase 10: the end tasks at the widths of ``end_tasks/*.sh`` on the encoder of
# phase 9's ResNet50 run (embeddings 128, bf16, 224x224 crops of 256x256
# canvases), through ``solver_runner.main`` and ``run_end_task_eval.main``
END_TASK_ARGV = ["--backbone", "ResNet50", "--vince-embedding-size", "128",
                 "--compute-dtype", "bfloat16", "--input-width", "224", "--input-height", "224",
                 "--epochs", "1"] + PRETRAIN_RUN
END_TASK_RUNS = {
    # train_imagenet.sh: SGD, base-lr 30, step decay at 60 and 80, frozen
    "ResNet50-IN-probe": dict(
        solver="EndTaskImagenetSolver", iterations=12, frames=1, val_items=600,
        argv=["--dataset", "SyntheticImageDataset", "--batch-size", "256",
              "--end-task-classifier-num-classes", "1000", "--base-lr", "30",
              "--lr-decay-type", "step", "--lr-step-schedule", "60", "80",
              "--freeze-feature-extractor"]),
    # train_sun_scene.sh's Adam at base-lr 0.01, without the freeze flag
    "ResNet50-SUN-finetune": dict(
        solver="EndTaskSunSceneSolver", iterations=8, frames=1, val_items=600,
        argv=["--dataset", "SyntheticImageDataset", "--batch-size", "256",
              "--end-task-classifier-num-classes", "397", "--base-lr", "0.01"]),
    # train_kinetics_400.sh: 64 frames a batch = 6 clips of 10, LSTM 512, Adam 0.01
    "ResNet50-Kinetics": dict(
        solver="EndTaskKinetics400Solver", iterations=8, frames=10, val_items=None,
        argv=["--dataset", "SyntheticClipDataset", "--batch-size", "64", "--num-frames", "10",
              "--end-task-classifier-num-classes", "400", "--base-lr", "0.01",
              "--freeze-feature-extractor"]),
}
END_TASK_LAPS = ("data_cache_time", "step_time", "total_time")
CARD = "cuda"  # the device that the f32 step of a classifier is held against the CPU on


class EndTaskRecord:
    """While active, wraps the end-task solvers' ``setup_model`` (the first
    setup's encoder against the pretraining checkpoint's query encoder),
    ``run_train_iteration`` (its meters' laps and loss), ``run_val`` (its
    counts, seconds and results), ``_make_dataset`` (a val split of
    ``val_items`` images, where given, so that its last batch is partial),
    ``setup_dataloader`` and ``end``; ``spans`` keeps each call's (name,
    start, end) on the host's clock."""

    WRAPPED = ("setup_dataloader", "setup_model", "run_train_iteration", "run_val",
               "_make_dataset", "end")

    def __init__(self, pretrain_encoder, val_items=None):
        self.pretrain, self.val_items = pretrain_encoder, val_items
        self.encoder_checks, self.iterations, self.vals, self.spans = [], [], [], []

    def __enter__(self):
        from vince_tpu_torch.solvers.end_task_solvers import EndTaskBaseSolver

        self.cls = EndTaskBaseSolver
        self.originals = {name: getattr(EndTaskBaseSolver, name) for name in self.WRAPPED}
        for name, orig in self.originals.items():
            setattr(EndTaskBaseSolver, name, self._wrap(name, orig))
        return self

    def _wrap(self, name, orig):
        def call(solver, *args, **kwargs):
            if name == "_make_dataset" and args[0] == "val" and self.val_items:
                from vince_tpu_torch.data.synthetic_dataset import SyntheticImageDataset

                return SyntheticImageDataset(solver.args, "val", num_images=self.val_items)
            t0 = time.perf_counter()
            out = orig(solver, *args, **kwargs)
            self.spans.append((name, t0, time.perf_counter()))
            if name == "setup_model":
                encoder = solver.state.encoder.state_dict()
                self.encoder_checks.append(set(encoder) <= set(self.pretrain) and all(
                    torch.equal(v.cpu(), self.pretrain[k]) for k, v in encoder.items()))
            elif name == "run_train_iteration":
                self.iterations.append(dict(
                    laps={m: solver.time_meters[m].values[-1] for m in END_TASK_LAPS},
                    loss=out["loss/total_loss"]))
            elif name == "run_val":
                self.vals.append(dict(samples=solver.last_val_samples,
                                      batches=solver.last_val_batches,
                                      seconds=solver.last_val_seconds, results=out))
            return out
        return call

    def __exit__(self, *exc):
        for name, orig in self.originals.items():
            setattr(self.cls, name, orig)


def cpu_card_step(solver, batch):
    """One train step of ``solver``'s configuration in float32 from one state
    (the seed's decoder on the pretraining encoder) and one batch on the CPU
    (a classifier's augmented images and labels, or tracking's crops and
    labels), on the card and on the CPU: ((loss on the card, on the CPU),
    ‖Δcard − Δcpu‖ / ‖Δcpu‖ over every updated parameter, the worst
    tensor's ratio)."""
    import dataclasses

    from vince_tpu_torch.solvers import end_task_step as ets

    cfg = dataclasses.replace(solver.cfg, compute_dtype=torch.float32)
    spec = ets.build_optimizer(cfg, solver.args.base_lr, solver.optimizer_kind,
                               schedule=solver.lr_schedule)
    pretrain = read_pretrain(solver.args.checkpoint_dir)
    original = ets.augment_batch
    # both sides take the images as they are: the CPU's and the card's
    # generators draw different numbers
    ets.augment_batch = lambda gen, images, cfg, dtype=torch.float32, **kw: images.to(dtype)
    try:
        losses, deltas = [], []
        for dev in (CARD, "cpu"):
            state = ets.init_end_task_state(0, cfg, spec, encoder_tensors=pretrain, device=dev)
            named = [(n, p) for g, ps in state.optimizer.groups.items()
                     if g not in state.optimizer.frozen for n, p in ps]
            before = {n: p.detach().cpu().clone() for n, p in named}
            step = ets.make_end_task_train_step(cfg)
            _, metrics = step(state, {k: v.to(dev) for k, v in batch.items()})
            losses.append(float(metrics["loss/total_loss"]))
            deltas.append({n: p.detach().cpu() - before[n] for n, p in named})
            del state
    finally:
        ets.augment_batch = original
    card, cpu = deltas
    gap = torch.cat([(card[n] - d).reshape(-1) for n, d in cpu.items()])
    ref = torch.cat([d.reshape(-1) for d in cpu.values()])
    worst = max(((card[n] - d).norm() / d.norm().clamp(min=1e-30)).item()
                for n, d in cpu.items())
    return tuple(losses), (gap.norm() / ref.norm()).item(), worst


def read_pretrain(directory):
    from vince_tpu_torch.utils.checkpoint import read_pretrain_encoder

    tensors = read_pretrain_encoder(directory)
    if tensors is None:
        fail(f"phase 10: no pretraining checkpoint in {directory}")
    return tensors


def train_arrays(solver, items):
    """The first ``items`` items of the run's train split as the solver's
    host batch: uint8 ``data`` and int32 ``labels`` (one per clip)."""
    from vince_tpu_torch.data.loader import collate_video_batch

    ds = solver._make_dataset("train")
    return solver._host_arrays(collate_video_batch([ds[i] for i in range(items)]))


def step_batch(solver, rows=16):
    """``rows`` images of the run's train split, augmented on the CPU by the
    run's train-mode pipeline: float32 images and labels."""
    from vince_tpu_torch.ops.augment import augment_batch
    from vince_tpu_torch.utils.transforms import make_config

    arrays = train_arrays(solver, rows)
    images = augment_batch(torch.Generator().manual_seed(0), torch.from_numpy(arrays["data"]),
                           make_config(solver.cfg.transform, solver.cfg.image_size))
    return images, torch.from_numpy(arrays["labels"])


def step_alone_ms(solver, steps=5):
    """The run's train step with no loader at work (the solver ended): one
    batch of its train split staged once, ``steps`` steps after one, each
    timed on the host clock to a synchronise; median and range, ms."""
    batch = solver.convert_batch(train_arrays(solver, solver._items_per_batch()))
    ms = []
    for _ in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.train_step(solver.state, batch, solver.seed)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms[1:])), min(ms[1:]), max(ms[1:])


def run_end_task(name, spec, tmp, card):
    """One phase-10 run: ``solver_runner.main`` for one epoch (its iterations,
    a save, the val pass), then ``run_end_task_eval.main`` on the saved
    state; the checks; the CPU-card step of a classifier."""
    from vince_tpu_torch import run_end_task_eval, solver_runner

    argv = END_TASK_ARGV + spec["argv"] + [
        "--solver", spec["solver"], "--base-logdir", tmp,
        "--iterations-per-epoch", str(spec["iterations"]),
        "--save-frequency", str(spec["iterations"])]
    pretrain = read_pretrain(os.path.join(tmp, "cli", "checkpoints_resnet50"))
    log(f"phase 10, {name}: python -m vince_tpu_torch.solver_runner {' '.join(argv)}, then "
        f"python -m vince_tpu_torch.run_end_task_eval with the same flags and "
        f"--disable-dataloader")
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with EndTaskRecord(pretrain, spec["val_items"]) as rec, \
            contextlib.redirect_stdout(Tee(sys.stdout)) as out:
        solver = solver_runner.main(argv)
        train_s = time.perf_counter() - t0
        evaluated = run_end_task_eval.main(argv + ["--disable-dataloader"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved() / 2**30
    launches, plain = read_counts()
    printed = out.getvalue()
    result = dict(wall_s=wall, train_s=train_s, peak_gib=peak, launches=launches)

    restored = printed.count("Restored pretrain encoder from")
    if restored != 2 or not rec.encoder_checks or not rec.encoder_checks[0]:
        fail(f"{name}: 'Restored pretrain encoder' printed {restored} times (expected 2: the "
             f"run and the eval), encoder bit-identical to the checkpoint's query encoder: "
             f"{rec.encoder_checks[:1]}")
    if f"Restored end-task step {spec['iterations']}" not in printed:
        fail(f"{name}: the eval did not restore the run's end-task step {spec['iterations']}")
    losses = [it["loss"] for it in rec.iterations]
    if len(losses) != spec["iterations"] or not all(math.isfinite(x) for x in losses):
        fail(f"{name}: {len(losses)} iterations, losses {losses}")
    if launches or plain:
        fail(f"{name}: the kernels launched {launches} with {plain} plain calls; no end task "
             f"reaches them, in JAX either")
    log(f"  encoder bit-identical to the pretraining checkpoint's query encoder; losses "
        f"{losses[0]:.4f} ... {losses[-1]:.4f}, all finite; launches of "
        f"{', '.join(wrappers())}: 0 each, plain calls 0")

    laps = {}
    for m in END_TASK_LAPS:
        ms = [it["laps"][m] * 1e3 for it in rec.iterations[2:]]
        laps[m] = (float(np.median(ms)), min(ms), max(ms))
    frames = solver.args.batch_size // spec["frames"] * spec["frames"]
    laps["frames_per_s"] = frames / laps["total_time"][0] * 1e3
    result["laps"] = laps
    log(f"  meters over iterations 3-{spec['iterations']}: " + ", ".join(
        f"{m} {laps[m][0]:.3f} ms ({laps[m][1]:.3f}-{laps[m][2]:.3f})" for m in END_TASK_LAPS)
        + f"; {laps['frames_per_s']:.2f} frames/s ({frames} frames / median total_time); "
        f"card {card}")

    if len(rec.vals) != 2:
        fail(f"{name}: {len(rec.vals)} val passes, expected the run's and the eval's")
    items = solver.args.batch_size // spec["frames"]
    expected = spec["val_items"] or len(solver._make_dataset("val"))
    for v in rec.vals:
        if (v["samples"], v["batches"]) != (expected, -(-expected // items)):
            fail(f"{name}: a val pass of {v['samples']} samples in {v['batches']} batches, "
                 f"expected {expected} in {-(-expected // items)} ({items} a batch)")
    run_val, eval_val = rec.vals
    line = [x for x in printed.splitlines() if x.startswith("EVAL_RESULT ")]
    if len(line) != 1:
        fail(f"{name}: {len(line)} EVAL_RESULT lines")
    printed_result = json.loads(line[0][len("EVAL_RESULT "):])
    for k, ref in run_val["results"].items():
        for got in (printed_result[k], evaluated[k]):
            if not math.isclose(got, ref, rel_tol=1e-6):
                fail(f"{name}: EVAL_RESULT {k} {got} against the run's val pass {ref}")
    result["val"] = [(v["samples"], v["batches"], v["seconds"]) for v in rec.vals]
    result["eval"] = printed_result
    log(f"  val passes (run, eval): {result['val']} (samples, batches, s), the last batch "
        f"{expected - (-(-expected // items) - 1) * items} of {items}; EVAL_RESULT equals the "
        f"run's val pass (rtol 1e-6): {printed_result}; peak reserved {peak:.3f} GiB; "
        f"{wall:.1f} s wall")

    result["step_alone"] = step_alone_ms(solver)
    log(f"  the step alone (loader stopped, one staged batch, 5 steps after 1): median "
        f"{result['step_alone'][0]:.3f} ms ({result['step_alone'][1]:.3f}-"
        f"{result['step_alone'][2]:.3f}) against the run's step_time {laps['step_time'][0]:.3f}")

    if spec["frames"] == 1:
        images, labels = step_batch(solver)
        step_losses, gap, worst = cpu_card_step(solver, {"data": images, "labels": labels})
        result["cpu_card"] = (step_losses, gap, worst)
        ok = math.isclose(*step_losses, rel_tol=1e-3) and gap <= 5e-2
        log(f"  one f32 step of {len(labels)} images, card against CPU: loss "
            f"{step_losses[0]:.6f} / {step_losses[1]:.6f} (rtol 1e-3), update gap "
            f"{gap:.3e} of its norm (5e-2; worst tensor {worst:.3e})")
        if not ok:
            fail(f"{name}: the card's f32 step disagrees with the CPU's")
    del solver
    free_cuda()
    return result


def run_end_tasks(card, tmp):
    """Phase 10: each end-task run on phase 9's pretraining checkpoint; the
    launches of each path (none) and the numbers."""
    paths, results = {}, {}
    for name, spec in END_TASK_RUNS.items():
        results[name] = run_end_task(name, spec, tmp, card)
        paths[f"end task {name}"] = results[name]["launches"]
    return paths, results


def pretrain_for_end_tasks(tmp):
    """``--end-tasks-only``: a 2-iteration pretraining run of phase 9's
    configuration, saved, in place of phase 9's."""
    from vince_tpu_torch import solver_runner

    with contextlib.redirect_stdout(Tee(sys.stdout)):
        solver_runner.main(CLI_ARGV + PRETRAIN_RUN + [
            "--base-logdir", tmp, "--epochs", "1", "--iterations-per-epoch", "2",
            "--save-frequency", "2", "--synthetic-num-videos", "64"])
    free_cuda()


# phase 11: the SiamFC tracking end task at ``end_tasks/train_tracking.sh``'s
# widths on a ResNet18 pretrained for 2 iterations with phase 9's flags
TRACKING_NAME = "ResNet18-SiamFC-tracking"
TRACKING_PRETRAIN_ARGV = CLI_ARGV + ["--backbone", "ResNet18", "--title", "trk",
                                     "--description", "resnet18", "--epochs", "1",
                                     "--iterations-per-epoch", "2", "--save-frequency", "2",
                                     "--synthetic-num-videos", "64"]
TRACKING_ARGV = ["--solver", "EndTaskTrackingSolver", "--backbone", "ResNet18SiamFCDilated",
                 "--dataset", "GOT10kDataset", "--batch-size", "256", "--base-lr", "0.01",
                 "--freeze-feature-extractor", "--input-width", "224", "--input-height", "224",
                 "--vince-embedding-size", "128", "--compute-dtype", "bfloat16", "--epochs", "1",
                 "--iterations-per-epoch", "8", "--save-frequency", "8", "--tracker-slots", "8",
                 "--title", "trk", "--description", "resnet18"]
TRACKING_VAL_PAIRS = 200  # 8 synthetic sequences x 25 pairs: one partial batch of 256


def tracking_host_ms(solver, pairs=16, reps=16):
    """The tracking epoch's host side on this host's CPU, ms: one crop of a
    frame of the run's train split to 120 and to 247 and the frame's mean
    colour (medians of ``reps``), one pair (two crops, the label, the flips;
    the median of ``pairs``), and the loader alone at the run's shape (a
    batch of 256 pairs with phase 9's workers, ``time_loader``)."""
    from vince_tpu_torch.tracking.ops import get_cropped_input

    def median_ms(fn, n):
        ms = []
        for i in range(n):
            t0 = time.perf_counter()
            fn(i)
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    ds = solver._make_dataset("train")
    frame = ds.seqs[0][0][0]
    h, w = frame.shape[:2]
    side = 0.6 * min(h, w)
    box = [w / 2 - side / 2, h / 2 - side / 2, w / 2 + side / 2, h / 2 + side / 2]
    pad = frame.mean(axis=(0, 1))
    out = {f"crop to {size}": median_ms(
        lambda i: get_cropped_input(frame, box, 1.0, size, pad_color=pad), reps)
        for size in (120, 247)}
    out["mean colour"] = median_ms(lambda i: np.mean(frame, axis=(0, 1), dtype=float), reps)
    out["pair"] = median_ms(lambda i: ds[i], pairs)
    out["loader batch"], workers = time_loader(batches=6, ds=ds,
                                               batch_size=solver.args.batch_size)
    out["loader pairs/s"] = solver.args.batch_size / out["loader batch"] * 1e3
    return out, (h, w), workers


def xcorr_card_cpu(batch, hz=15, hx=31, channels=256, steps=5):
    """``fast_xcorr`` at the run's shape in float32 (``batch`` exemplars of
    hz×hz against as many searches of hx×hx, ``channels`` channels): the
    response and both gradients of a seeded upstream gradient on the card
    against the CPU, each as its largest difference over the sum of
    |products| behind that value (the same call on |z|, |x| and |g|: a
    response sums 57600 products that cancel, so its values are ~1/30 of
    that sum and their f32 error is set by the sum); and the card's forward
    and backward, median of ``steps`` after one, ms."""
    from vince_tpu_torch.ops.xcorr import fast_xcorr

    def value_and_grads(dev, z, x, g):
        zd, xd = (t.to(dev, copy=True).requires_grad_() for t in (z, x))
        r = fast_xcorr(zd, xd)
        r.backward(g.to(dev))
        return [t.detach().cpu() for t in (r, zd.grad, xd.grad)]

    gen = torch.Generator().manual_seed(11)
    z = torch.randn(batch, hz, hz, channels, generator=gen)
    x = torch.randn(batch, hx, hx, channels, generator=gen)
    g = torch.randn(batch, hx - hz + 1, hx - hz + 1, 1, generator=gen)
    cpu, card = (value_and_grads(dev, z, x, g) for dev in ("cpu", CARD))
    sums = value_and_grads("cpu", z.abs(), x.abs(), g.abs())
    errs = {k: ((c - d).abs() / a).max().item()
            for k, d, c, a in zip(("response", "grad z", "grad x"), cpu, card, sums)}
    zd, xd = (t.to(CARD).requires_grad_() for t in (z, x))
    gd = g.to(CARD)
    ms = []
    for _ in range(steps + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fast_xcorr(zd, xd).backward(gd)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return errs, float(np.median(ms[1:]))


def batched_against_serial(solver, num_seqs=3, num_frames=12):
    """The batched tracker (8 slots) and the serial one on the run's saved
    weights in float32 on the card, over synthetic sequences: the largest
    box difference, px, and the batched tracker's frames/s."""
    import dataclasses

    from vince_tpu_torch.solvers import end_task_step as ets
    from vince_tpu_torch.tracking.sequences import SyntheticSequences
    from vince_tpu_torch.tracking.tracker import BatchedTrackerSiamFC, TrackerSiamFC

    cfg = dataclasses.replace(solver.cfg, compute_dtype=torch.float32)
    state = ets.init_end_task_state(0, cfg, ets.build_optimizer(cfg, 0.01, "sgd"), device=CARD)
    state.encoder.load_state_dict(solver.state.encoder.state_dict())
    state.decoder.load_state_dict(solver.state.decoder.state_dict())
    seqs = SyntheticSequences(num_seqs=num_seqs, num_frames=num_frames, seed=3)
    sequences = [(seqs[i][0], seqs[i][1][0]) for i in range(num_seqs)]
    serial = TrackerSiamFC("serial", None, cfg, state)
    want = [serial.track(frames, box)[0] for frames, box in sequences]
    t0 = time.perf_counter()
    got = BatchedTrackerSiamFC("batched", None, cfg, state, n_slots=8).track_all(sequences)
    fps = num_seqs * num_frames / (time.perf_counter() - t0)
    return max(float(np.abs(b - w).max()) for (b, _), w in zip(got, want)), fps


def run_tracking(card, tmp, profile_path=None):
    """Phase 11: the 2-iteration ResNet18 pretraining, then the tracking end
    task through ``solver_runner.main`` (8 iterations, a save, the exact val
    pass) and ``run_end_task_eval.main`` (the OTB fallback, the batched
    tracker); the checks; with ``profile_path``, one traced step alone.
    Returns the launches of the path and the numbers."""
    from vince_tpu_torch import run_end_task_eval, solver_runner

    name = TRACKING_NAME
    with contextlib.redirect_stdout(Tee(sys.stdout)):
        solver_runner.main(TRACKING_PRETRAIN_ARGV + ["--base-logdir", tmp])
    free_cuda()
    argv = TRACKING_ARGV + ["--base-logdir", tmp]
    iterations = int(argv[argv.index("--iterations-per-epoch") + 1])
    pretrain = read_pretrain(os.path.join(tmp, "trk", "checkpoints_resnet18"))
    log(f"phase 11, {name}: python -m vince_tpu_torch.solver_runner {' '.join(argv)}, then "
        f"python -m vince_tpu_torch.run_end_task_eval with the same flags and "
        f"--disable-dataloader")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with EndTaskRecord(pretrain) as rec, contextlib.redirect_stdout(Tee(sys.stdout)) as out:
        solver = solver_runner.main(argv)
        train_s = time.perf_counter() - t0
        evaluated = run_end_task_eval.main(argv + ["--disable-dataloader"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved() / 2**30
    launches, plain = read_counts()
    printed = out.getvalue()
    result = dict(wall_s=wall, train_s=train_s, peak_gib=peak, launches=launches)

    restored = printed.count("Restored pretrain encoder from")
    if restored != 2 or not rec.encoder_checks or not rec.encoder_checks[0]:
        fail(f"{name}: 'Restored pretrain encoder' printed {restored} times (expected 2), "
             f"encoder bit-identical to the query encoder: {rec.encoder_checks[:1]}")
    if f"Restored end-task step {iterations}" not in printed:
        fail(f"{name}: the eval did not restore the run's end-task step {iterations}")
    losses = [it["loss"] for it in rec.iterations]
    if len(losses) != iterations or not all(math.isfinite(x) for x in losses):
        fail(f"{name}: {len(losses)} iterations, losses {losses}")
    if launches or plain:
        fail(f"{name}: the kernels launched {launches} with {plain} plain calls; tracking "
             f"reaches none of them, in JAX either")
    log(f"  encoder bit-identical to the pretraining checkpoint's query encoder; losses "
        f"{losses[0]:.4f} ... {losses[-1]:.4f}, all finite; launches of "
        f"{', '.join(wrappers())}: 0 each, plain calls 0")

    laps = {}
    for m in END_TASK_LAPS:
        ms = [it["laps"][m] * 1e3 for it in rec.iterations[2:]]
        laps[m] = (float(np.median(ms)), min(ms), max(ms))
    laps["pairs_per_s"] = solver.args.batch_size / laps["total_time"][0] * 1e3
    result["laps"] = laps
    log(f"  meters over iterations 3-{iterations}: " + ", ".join(
        f"{m} {laps[m][0]:.3f} ms ({laps[m][1]:.3f}-{laps[m][2]:.3f})" for m in END_TASK_LAPS)
        + f"; {laps['pairs_per_s']:.2f} pairs/s ({solver.args.batch_size} pairs / median "
        f"total_time); card {card}")

    items = solver.args.batch_size
    want = (TRACKING_VAL_PAIRS, -(-TRACKING_VAL_PAIRS // items))
    if len(rec.vals) != 1 or (rec.vals[0]["samples"], rec.vals[0]["batches"]) != want:
        fail(f"{name}: val passes {[(v['samples'], v['batches']) for v in rec.vals]}, "
             f"expected one of {want}")
    result["val"] = (rec.vals[0]["samples"], rec.vals[0]["batches"], rec.vals[0]["seconds"])
    line = [x for x in printed.splitlines() if x.startswith("EVAL_RESULT ")]
    if len(line) != 1:
        fail(f"{name}: {len(line)} EVAL_RESULT lines")
    printed_result = json.loads(line[0][len("EVAL_RESULT "):])
    if printed_result != {k: float(v) for k, v in evaluated.items()}:
        fail(f"{name}: EVAL_RESULT {printed_result} against run_eval's {evaluated}")
    if not (evaluated.get("synthetic") and evaluated.get("num_sequences") == 3
            and 0 <= evaluated["precision"] <= 1 and 0 <= evaluated["success"] <= 1):
        fail(f"{name}: the OTB fallback's result {evaluated}")
    fps = re.findall(r"= ([0-9.]+) aggregate fps", printed)
    if len(fps) != 1:
        fail(f"{name}: {len(fps)} lines of the batched tracker's aggregate frames/s")
    result["eval"], result["tracker_fps"] = printed_result, float(fps[0])
    log(f"  val pass {result['val']} (samples, batches, s); EVAL_RESULT equals run_eval's "
        f"dict: {printed_result}; the tracker {result['tracker_fps']:.1f} frames/s (3 "
        f"sequences x 12 frames, 8 slots); peak reserved {peak:.3f} GiB; {wall:.1f} s wall")

    result["step_alone"] = step_alone_ms(solver)
    result["host_ms"], frame_hw, workers = tracking_host_ms(solver)
    log(f"  the step alone (loader stopped, one staged batch, 5 steps after 1): median "
        f"{result['step_alone'][0]:.3f} ms ({result['step_alone'][1]:.3f}-"
        f"{result['step_alone'][2]:.3f}) against the run's step_time "
        f"{laps['step_time'][0]:.3f}; the host, one thread, a {frame_hw[0]}x{frame_hw[1]} "
        f"frame: " + ", ".join(f"{k} {v:.3f} ms" for k, v in result["host_ms"].items()
                              if k.startswith(("crop", "mean", "pair")))
        + f"; the loader alone ({workers} threads) {result['host_ms']['loader batch']:.3f} ms "
        f"a batch of {solver.args.batch_size} pairs, "
        f"{result['host_ms']['loader pairs/s']:.2f} pairs/s")
    if profile_path:
        root, ext = os.path.splitext(profile_path)
        batch = solver.convert_batch(train_arrays(solver, solver._items_per_batch()))
        profile_step(solver.train_step, solver.state, batch, f"{root}.{TRACKING_NAME}{ext}")

    gap_px, f32_fps = batched_against_serial(solver)
    result["batched_gap_px"], result["f32_tracker_fps"] = gap_px, f32_fps
    log(f"  batched (8 slots) against serial tracker, float32 on the card: largest box "
        f"difference {gap_px:.3e} px (1e-2); batched {f32_fps:.1f} frames/s")
    if not gap_px <= 1e-2:
        fail(f"{name}: the batched tracker's boxes differ from the serial one's by {gap_px} px")

    step_losses, gap, worst = cpu_card_step(
        solver, {k: torch.from_numpy(v) for k, v in train_arrays(solver, 16).items()})
    result["cpu_card"] = (step_losses, gap, worst)
    log(f"  one f32 step of 16 pairs, card against CPU: loss {step_losses[0]:.6f} / "
        f"{step_losses[1]:.6f} (rtol 1e-3), update gap {gap:.3e} of its norm (5e-2; worst "
        f"tensor {worst:.3e})")
    if not (math.isclose(*step_losses, rel_tol=1e-3) and gap <= 5e-2):
        fail(f"{name}: the card's f32 step disagrees with the CPU's")
    errs, xcorr_ms = xcorr_card_cpu(solver.args.batch_size)
    result["xcorr"] = (errs, xcorr_ms)
    log(f"  fast_xcorr at the run's shape ({solver.args.batch_size} x 15x15 against 31x31, "
        f"256 channels, f32), card against CPU, largest difference over the sum of "
        f"|products| behind it (1e-5): " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; forward and backward on the card {xcorr_ms:.3f} ms")
    if not max(errs.values()) <= 1e-5:
        fail(f"{name}: the card's fast_xcorr disagrees with the CPU's: {errs}")
    del solver
    free_cuda()
    return {f"end task {name}": launches}, result


# phase 12: multi-GPU pretraining over torch.distributed at a world of one
# process: an NCCL group of one rank, a 1x1 (data, queue) mesh, the ResNet50
# step of phases 3-5 with sync-BN, every collective over the one rank
DIST_TRAIN_STEPS = 5
DIST_CLI_ITERATIONS = 8
DIST_BACKEND = "nccl"  # the backend of CUDA tensors


def dist_flags():
    """The CLI's flags of a world of one on a free port of 127.0.0.1."""
    from vince_tpu_torch.parallel.launch import free_port

    return ["--distributed", "--coordinator-address", f"127.0.0.1:{free_port()}",
            "--num-processes", "1", "--process-id", "0"]


def start_world_of_one(dev):
    """A process group of rank 0 in a world of 1 (NCCL on the card, gloo on
    the CPU; a ``TCPStore`` on 127.0.0.1) and its 1x1 mesh."""
    from vince_tpu_torch.parallel.launch import start_world_of_one as start
    from vince_tpu_torch.parallel.mesh import Mesh, MeshSpec

    start(dev)
    return Mesh(MeshSpec(1, 1))


def dist_config(mode):
    return dataclasses.replace(train_config("ResNet50"), sync_bn=True, shuffle_mode=mode)


def first_difference(dist_state, single_state):
    """The name of the first tensor in which two states differ, or None."""
    from vince_tpu_torch.utils.checkpoint import state_tree

    def walk(prefix, a, b):
        for k, v in b.items():
            if isinstance(v, dict):
                found = walk(f"{prefix}{k}/", a[k], v)
                if found:
                    return found
            elif isinstance(v, torch.Tensor) and not torch.equal(a[k], v):
                return prefix + k
            elif not isinstance(v, torch.Tensor) and a[k] != v:
                return prefix + k
        return None

    return walk("", state_tree(dist_state), state_tree(single_state))


def run_distributed_eager(dev, mesh, steps=DIST_TRAIN_STEPS):
    """The eager distributed step (sync-BN, then in ``gather`` and in ``a2a``
    mode) against phase 3's one-device step from the same seed on the same
    batches, cuDNN deterministic on both sides: at a world of one every
    collective is the identity, so the losses, the weights, the running
    averages, the momentum traces and the queue are bit-identical. Returns
    the launches and the ms per step of each mode and of the one-device step."""
    from vince_tpu_torch.solvers.vince_step import (
        build_vince_optimizer, init_vince_state, make_train_step_fn)

    opt = build_vince_optimizer(0.03)
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for mode in ("gather", "a2a"):
            cfg = dist_config(mode)
            log(f"phase 12, eager: {mesh}, NCCL, sync-BN, shuffle {mode}: {steps} steps against "
                f"phase 3's one-device step (ResNet50 b=128 224x224, q=65536, bf16, fused "
                f"InfoNCE + fold kernel), the same seed and batches, cuDNN deterministic")
            s_dist = init_vince_state(0, cfg, opt, device=dev, mesh=mesh)
            s_one = init_vince_state(0, train_config("ResNet50"), opt, device=dev)
            step_dist = make_train_step_fn(cfg, opt, mesh=mesh)
            step_one = make_train_step_fn(train_config("ResNet50"), opt)
            # a first step each, outside the timing (the communicators' first use)
            step_dist(s_dist, make_batch(dev, seed=100), 100)
            step_one(s_one, make_batch(dev, seed=100), 100)

            batches = [make_batch(dev, seed=i) for i in range(steps)]

            def run(step, state):
                times, losses = [], []
                for i in range(steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, m = step(state, batches[i], i)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    losses.append(m["loss/total_loss"].item())
                return times, losses

            reset_counts()
            ms, losses = {}, {}
            ms["dist"], losses["dist"] = run(step_dist, s_dist)
            launches = expect_counts(
                f"{steps} distributed steps ({TRAIN_PHASES['ResNet50']['why']})",
                {n: v * steps for n, v in TRAIN_PHASES["ResNet50"]["per_step"].items()})
            ms["one"], losses["one"] = run(step_one, s_one)
            for i, (a, b) in enumerate(zip(losses["dist"], losses["one"])):
                log(f"    step {i}: loss distributed {a!r}, one device {b!r}")
            differs = first_difference(s_dist, s_one)
            if losses["dist"] != losses["one"] or differs:
                fail(f"phase 12, {mode}: the world-of-one distributed step is not bit-identical "
                     f"to the one-device step: losses {losses}, first differing tensor "
                     f"{differs}")
            med = {k: float(np.median(v)) for k, v in ms.items()}
            each = ", ".join(f"{t:.3f}" for t in ms["dist"])
            log(f"  {mode}: losses, weights, running averages, momentum traces and queue "
                f"bit-identical to the one-device step after {steps} steps; eager ms/step "
                f"distributed {med['dist']:.3f} (each {each}), one device {med['one']:.3f}")
            out[mode] = {"launches": launches, "ms": med}
            del s_dist, s_one
            free_cuda()
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def run_queue_shards(dev):
    """K1 on the two halves of the queue ([128, 32768] twice), given to
    ``sharded_multi_pair_infonce`` as two shards of one process: its merge of
    the shards' partials (a max of their maxes, a sum of their exp sums, then
    the queue group's pmax and psum, here of one member) is the one the ranks
    of a queue axis run. Against the unsharded loss and its gradient w.r.t.
    q: loss at rtol 1e-5, gradient at 1e-4. Returns the launches."""
    from vince_tpu_torch.ops.sharded_infonce import sharded_multi_pair_infonce

    tau = 0.07
    g = torch.Generator(device=dev).manual_seed(12)
    q, queue = queue_inputs(g, dev, BATCH_SIZE, 65536, 128)
    keys, _ = queue_inputs(g, dev, BATCH_SIZE, 1, 128)
    groups = torch.arange(BATCH_SIZE, device=dev) // 4
    mask = groups[:, None] == groups[None, :]
    log("phase 12, two queue shards in one process: K1 on q [128,128] x queue [32768,128] "
        "twice, merged by a max and a sum, against the unsharded fused loss")
    q_one = q.clone().requires_grad_(True)
    ref = sharded_multi_pair_infonce(q_one, keys, mask, tau, queue_shard=queue,
                                     use_fused_queue_kernel=True)["dist"]
    ref.backward()
    reset_counts()
    q_two = q.clone().requires_grad_(True)
    loss = sharded_multi_pair_infonce(q_two, keys, mask, tau, queue_shard=list(queue.chunk(2)),
                                      use_fused_queue_kernel=True)["dist"]
    loss.backward()
    torch.cuda.synchronize()
    launches = expect_counts("two queue shards", {"queue_logsumexp": 2})
    compare("two-shard loss", loss.detach().reshape(1), ref.detach().reshape(1), 1e-5, 0)
    compare("two-shard dL/dq", q_two.grad, q_one.grad, 1e-4, 1e-5)
    return launches


def run_distributed_cli(card, tmp):
    """``solver_runner.main`` with ``--distributed`` (the three explicit flags,
    one process), sync-BN and the a2a shuffle on phase 9's configuration, for
    8 iterations, its val pass and a save; then a run without
    ``--distributed`` restores the checkpoint, bit-identical to the file."""
    from vince_tpu_torch import arg_parser, solver_runner
    from vince_tpu_torch.solvers.vince_solver import VinceSolver
    from vince_tpu_torch.utils.checkpoint import state_tree

    base = CLI_ARGV + ["--title", "dist", "--description", "resnet50", "--base-logdir", tmp,
                       "--epochs", "1", "--iterations-per-epoch", str(DIST_CLI_ITERATIONS),
                       "--save-frequency", str(DIST_CLI_ITERATIONS), "--sync-bn",
                       "--shuffle-mode", "a2a"]
    flags = dist_flags()
    log(f"phase 12, CLI: python -m vince_tpu_torch.solver_runner {' '.join(base[:-4])} "
        f"{' '.join(base[-4:])} {' '.join(flags)}")
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with CliRecord() as rec, contextlib.redirect_stdout(Tee(sys.stdout)) as out:
        solver = solver_runner.main(base + flags)
    result = {"wall_s": time.perf_counter() - t0,
              "peak_gib": torch.cuda.max_memory_reserved() / 2**30}
    if f"distributed: process 0/1, backend {DIST_BACKEND}" not in out.getvalue():
        fail(f"phase 12: the CLI did not start its {DIST_BACKEND} group")
    if (solver.cfg.data_axis_size, solver.cfg.queue_axis_size, solver.cfg.sync_bn,
            solver.cfg.shuffle_mode) != (1, 1, True, "a2a") or solver.mesh is None:
        fail(f"phase 12: the CLI built {solver.cfg} on {solver.mesh}")
    launches = check_cli_calls("distributed CLI", rec, "ResNet50", DIST_CLI_ITERATIONS, 1)
    result["laps"] = report_laps("distributed CLI", rec, card)
    (val,) = rec.of("run_val")
    result["val"] = (val["batches"], val["seconds"])
    steps = sorted(os.listdir(solver.ckpt.checkpoint_dir))
    log(f"  val pass: {val['batches']} batches in {val['seconds']:.3f} s; checkpoints {steps}; "
        f"peak memory reserved {result['peak_gib']:.3f} GiB; the run {result['wall_s']:.1f} s "
        f"wall; card {card}")
    if steps != [str(DIST_CLI_ITERATIONS)]:
        fail(f"phase 12: expected the checkpoint of step {DIST_CLI_ITERATIONS}, found {steps}")
    del solver, rec
    free_cuda()
    log("phase 12, restore: the solver without --distributed restores the distributed "
        "run's checkpoint; its state against the file")
    with contextlib.redirect_stdout(Tee(sys.stdout)) as out:
        check = VinceSolver(arg_parser.parse_args(base + ["--epochs", "2"]))
    try:
        if f"Restored step {DIST_CLI_ITERATIONS}" not in out.getvalue() or check.mesh is not None:
            fail(f"phase 12: no 'Restored step {DIST_CLI_ITERATIONS}' on one device")
        tree_equal("state", state_tree(check.state), check.ckpt.restore_raw(DIST_CLI_ITERATIONS))
        log("  restored state bit-identical to the file")
    finally:
        check.end()
    del check
    free_cuda()
    return launches, result


def run_distributed(dev, card, tmp, captured_ms):
    """Phase 12: the world-of-one NCCL group, the eager and captured
    distributed steps, two queue shards in one process, then the
    ``--distributed`` CLI (which starts and ends its own group)."""
    import torch.distributed as dist

    paths, result = {}, {}
    mesh = start_world_of_one(dev)
    try:
        eager = run_distributed_eager(dev, mesh)
        for mode, r in eager.items():
            paths[f"phase 12 eager {mode}, {DIST_TRAIN_STEPS} steps"] = r["launches"]
        result["eager"] = {mode: r["ms"] for mode, r in eager.items()}
        # a failed capture raises (naming ROADMAP.md §1 item 8c) and fails the phase;
        # the states go at once: their gradients hold their graph's memory pool
        gather = run_captured(dev, "ResNet50", timed=0, cfg=dist_config("gather"), mesh=mesh)[1]
        free_cuda()
        a2a = run_captured(dev, "ResNet50", cfg=dist_config("a2a"), mesh=mesh)[1]
        free_cuda()
        paths["phase 12 captured gather (at the capture)"] = gather["capture_launches"]
        paths["phase 12 captured a2a (at the capture)"] = a2a["capture_launches"]
        result["captured"] = {"ms_per_step": a2a["ms_per_step"], "peak_gib": a2a["peak_gib"],
                              "loss_gap": max(gather["loss_gap"], a2a["loss_gap"]),
                              "update_gap": max(gather["update_gap"], a2a["update_gap"])}
        log(f"phase 12, captured a2a + sync-BN: {a2a['ms_per_step']:.3f} ms/step against "
            f"phase 5's one-device {captured_ms:.3f} in this call: the collectives at a "
            f"world of one cost {a2a['ms_per_step'] - captured_ms:.3f} ms/step; card {card}")
        paths["phase 12 two queue shards"] = run_queue_shards(dev)
    finally:
        dist.destroy_process_group()
    paths["phase 12 CLI --distributed"], result["cli"] = run_distributed_cli(card, tmp)
    return paths, result


# phase 13: remat through K2 and K4 (the captured step with and without it),
# the reference's PyTorch weights into the CLI, through the conversion tool into
# an end task and back out, and the retrieval probe on phase 9's checkpoint
REMAT_TIMED = 5
# each kernel's launches per step with remat: the query forward runs again in
# the backward, so K2 13 x 3 (key, query, recompute) and K4 12 x 4 (key,
# query, recompute, dgrad)
REMAT_PER_STEP = {
    "ResNet50": {"queue_logsumexp": 1, "affine_relu_dot_moments": 39, "depthwise_conv": 0,
                 "depthwise_wgrad": 0},
    "EfficientNetB0": {"queue_logsumexp": 1, "affine_relu_dot_moments": 0, "depthwise_conv": 48,
                       "depthwise_wgrad": 12},
}
WEIGHTS_ITERATIONS = 4
REFERENCE_PREFIX = "feature_extractor.module.model."
RETRIEVAL_ARGV = ["--retrieval-videos", "64", "--retrieval-frames", "6"]


def remat_config(backbone, remat):
    return dataclasses.replace(train_config(backbone), remat=remat)


def per_step(backbone, remat):
    return (REMAT_PER_STEP if remat else {b: p["per_step"] for b, p in TRAIN_PHASES.items()})[
        backbone]


def running_averages(state):
    """Both encoders' BatchNorm running averages, copied."""
    return {f"{which}.{k}": v.detach().clone()
            for which, model in (("query", state.model), ("key", state.key_model))
            for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}


def remat_against_plain(dev, backbone):
    """The captured step with and without remat from one seed over the same
    batches, cuDNN deterministic: 3 eager warm-up calls, the capture and one
    replay, the launches of each call. Returns the largest relative loss gap
    over the calls, the update gap of the query encoder after them, whether
    the running averages after the first step are bit-equal, and the
    launches at the remat step's capture."""
    from vince_tpu_torch.solvers.vince_step import (
        WARMUP_STEPS, build_vince_optimizer, init_vince_state, make_train_step)

    opt = build_vince_optimizer(0.03)
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            state = init_vince_state(0, remat_config(backbone, remat), opt, device=dev)
            init = {k: v.detach().clone() for k, v in state.model.named_parameters()}
            step = make_train_step(remat_config(backbone, remat), opt)
            losses, stats = [], None
            for i in range(WARMUP_STEPS + 2):
                reset_counts()
                _, m = step(state, make_batch(dev, seed=i), i)
                torch.cuda.synchronize()
                what = ("eager warm-up" if i < WARMUP_STEPS else "capture, then replay"
                        if i == WARMUP_STEPS else "replay")
                launches = expect_counts(f"{backbone}, remat {remat}, call {i} ({what})",
                                         per_step(backbone, remat) if i <= WARMUP_STEPS else {})
                if i == WARMUP_STEPS:
                    capture_launches = launches
                losses.append(m["loss/total_loss"].item())
                if i == 0:
                    stats = running_averages(state)
            runs[remat] = dict(state=state, init=init, losses=losses, stats=stats,
                               capture_launches=capture_launches, step=step)
    finally:
        torch.backends.cudnn.deterministic = False
    plain, remat = runs[False], runs[True]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(remat["losses"], plain["losses"]))
    upd = update_gap(plain["state"], remat["state"], plain["init"])
    stats_equal = all(torch.equal(v, remat["stats"][k]) for k, v in plain["stats"].items())
    for i, (a, b) in enumerate(zip(plain["losses"], remat["losses"])):
        log(f"    call {i}: loss without remat {a!r}, with remat {b!r}")
    log(f"  {backbone}: remat against no remat over {len(plain['losses'])} calls, cuDNN "
        f"deterministic: max loss gap {loss_gap:.3e} (tol 1e-5), |update_remat - update| / "
        f"|update| = {upd:.3e} (tol 1e-3), running averages after one step bit-equal: "
        f"{stats_equal}")
    if loss_gap > 1e-5 or upd > 1e-3 or not stats_equal:
        fail(f"phase 13, {backbone}: the remat step departs from the step without remat")
    result = dict(loss_gap=loss_gap, update_gap=upd, stats_equal=stats_equal,
                  capture_launches=remat["capture_launches"])
    del runs, plain, remat
    free_cuda()
    return result


def remat_timed(dev, backbone, card):
    """For each of no remat and remat, a new state and capture under cuDNN's
    defaults, then ``REMAT_TIMED`` timed replays: ms/step and the peak
    reserved (the graph's pool included), remat's required to be lower."""
    from vince_tpu_torch.solvers.vince_step import (
        WARMUP_STEPS, build_vince_optimizer, init_vince_state, make_train_step)

    opt = build_vince_optimizer(0.03)
    out = {}
    for remat in (False, True):
        free_cuda()
        cfg = remat_config(backbone, remat)
        state = init_vince_state(0, cfg, opt, device=dev)
        step = make_train_step(cfg, opt)
        captured_calls(dev, step, state, WARMUP_STEPS + 1, per_step(backbone, remat))
        reset_counts()
        ms, step_ms, _, peak = time_steps(step, state, make_batch(dev), REMAT_TIMED)
        log_times(f"{backbone} captured, remat {remat}", ms, step_ms, peak)
        expect_counts(f"{REMAT_TIMED} timed replays", {})
        out[remat] = {"ms_per_step": ms, "peak_gib": peak}
        del state, step
    free_cuda()
    log(f"  {backbone}: captured ms/step {out[False]['ms_per_step']:.3f} without remat, "
        f"{out[True]['ms_per_step']:.3f} with; peak reserved {out[False]['peak_gib']:.3f} "
        f"GiB without, {out[True]['peak_gib']:.3f} with; card {card}")
    if out[True]["peak_gib"] >= out[False]["peak_gib"]:
        fail(f"phase 13, {backbone}: remat reserves no less memory than the step without it")
    return out


def remat_sync_bn(dev, steps=2):
    """A world-of-one NCCL group: the eager sync-BN step with remat (its
    recompute's psums run again in the backward) against the one-device step
    with remat, from one seed over the same batches, cuDNN deterministic:
    bit-identical. Returns the launches."""
    import torch.distributed as dist

    from vince_tpu_torch.solvers.vince_step import (
        build_vince_optimizer, init_vince_state, make_train_step_fn)

    opt = build_vince_optimizer(0.03)
    mesh = start_world_of_one(dev)
    torch.backends.cudnn.deterministic = True
    try:
        cfg_d = dataclasses.replace(dist_config("gather"), remat=True)
        cfg_one = remat_config("ResNet50", True)
        s_dist = init_vince_state(0, cfg_d, opt, device=dev, mesh=mesh)
        s_one = init_vince_state(0, cfg_one, opt, device=dev)
        step_d = make_train_step_fn(cfg_d, opt, mesh=mesh)
        step_one = make_train_step_fn(cfg_one, opt)
        losses = {"dist": [], "one": []}
        reset_counts()
        for i in range(steps):
            losses["dist"].append(step_d(s_dist, make_batch(dev, seed=i), i)[1]
                                  ["loss/total_loss"].item())
        torch.cuda.synchronize()
        launches = expect_counts(f"{steps} sync-BN steps with remat",
                                 {k: v * steps for k, v in per_step("ResNet50", True).items()})
        for i in range(steps):
            losses["one"].append(step_one(s_one, make_batch(dev, seed=i), i)[1]
                                 ["loss/total_loss"].item())
        differs = first_difference(s_dist, s_one)
        if losses["dist"] != losses["one"] or differs:
            fail(f"phase 13: the world-of-one sync-BN step with remat is not bit-identical to "
                 f"the one-device step with remat: losses {losses}, first differing tensor "
                 f"{differs}")
        log(f"  sync-BN with remat, {mesh}: losses {losses['dist']}, weights, running averages, "
            f"momentum traces and queue bit-identical to the one-device remat step after "
            f"{steps} steps")
        del s_dist, s_one
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    free_cuda()
    return launches


def reference_resnet50_dict(seed=13):
    """A reference ``VinceModel`` state dict of a ResNet50 with the 128-wide
    projection, written by name as torchvision and the reference name it:
    the backbone under the DataParallel prefixes, ``embedding.{0,2}``, seeded
    values (weights scaled by the fan-in, BatchNorm scales near 1, positive
    running variances) and a zero ``num_batches_tracked`` per BatchNorm."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def randn(*shape):
        return torch.randn(*shape, generator=g)

    def conv(name, o, i, k):
        sd[REFERENCE_PREFIX + name + ".weight"] = randn(o, i, k, k) / math.sqrt(i * k * k)

    def bn(name, c):
        p = REFERENCE_PREFIX + name
        sd[p + ".weight"], sd[p + ".bias"] = 1 + 0.2 * randn(c), 0.1 * randn(c)
        sd[p + ".running_mean"] = 0.1 * randn(c)
        sd[p + ".running_var"] = 0.5 + torch.rand(c, generator=g)
        sd[p + ".num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for layer, (blocks, f) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512)), start=1):
        for b in range(blocks):
            p = f"layer{layer}.{b}."
            conv(p + "conv1", f, cin, 1)
            bn(p + "bn1", f)
            conv(p + "conv2", f, f, 3)
            bn(p + "bn2", f)
            conv(p + "conv3", 4 * f, f, 1)
            bn(p + "bn3", 4 * f)
            if b == 0:
                conv(p + "downsample.0", 4 * f, cin, 1)
                bn(p + "downsample.1", 4 * f)
            cin = 4 * f
    for name, o, i in (("embedding.0", 2048, 2048), ("embedding.2", 128, 2048)):
        sd[name + ".weight"], sd[name + ".bias"] = randn(o, i) / math.sqrt(i), 0.1 * randn(o)
    return sd


def same_tensors(what, got, want):
    """``got`` holds every tensor of ``want`` with its bits (on any device)."""
    bad = [k for k, v in want.items() if k not in got or not torch.equal(got[k].cpu(), v)]
    if bad:
        fail(f"{what}: {len(bad)} tensors differ from the file's, first {bad[:3]}")


def run_weights(tmp):
    """The reference's weights: a written ResNet50 ``VinceModel`` file into
    the CLI's solver with ``--pretrained-weights-path`` (both encoders equal
    to the file, then ``WEIGHTS_ITERATIONS`` captured iterations), through
    ``convert_reference_checkpoint`` into the frozen ImageNet probe of phase
    10 (its encoder equal to the file, ``WEIGHTS_ITERATIONS`` iterations, no
    kernel), and ``export_reference_checkpoint`` of the converted directory
    back to the written dict, bit for bit. Returns the launches and the
    numbers."""
    from vince_tpu_torch import arg_parser, solver_runner
    from vince_tpu_torch.solvers.vince_solver import VinceSolver
    from vince_tpu_torch.tools import convert_reference_checkpoint, export_reference_checkpoint
    from vince_tpu_torch.utils.torch_convert import convert_vince_state_dict

    root = os.path.join(tmp, "weights")
    os.makedirs(root, exist_ok=True)
    sd = reference_resnet50_dict()
    pt = os.path.join(root, "vince_weights_resnet50.pt")
    torch.save(sd, pt)
    want = convert_vince_state_dict(sd)
    result, paths = {}, {}

    argv = CLI_ARGV + ["--title", "weights", "--description", "resnet50", "--base-logdir", tmp,
                       "--epochs", "1", "--no-save", "--pretrained-weights-path", pt]
    log(f"phase 13, weights: the parser and the solver with --pretrained-weights-path (a "
        f"ResNet50 VinceModel state dict of {len(sd)} tensors written with seeded values), "
        f"{WEIGHTS_ITERATIONS} iterations")
    free_cuda()
    t0 = time.perf_counter()
    with CliRecord() as rec, contextlib.redirect_stdout(Tee(sys.stdout)) as out:
        solver = VinceSolver(arg_parser.parse_args(argv))
        try:
            if f"Initialized backbone from torch weights: {pt}" not in out.getvalue():
                fail("phase 13: the solver did not load --pretrained-weights-path")
            for which, model in (("query", solver.state.model), ("key", solver.state.key_model)):
                own = model.state_dict()
                if set(own) != set(want):
                    fail(f"phase 13: the {which} encoder's tensors are not the file's: "
                         f"{sorted(set(own) ^ set(want))[:5]}")
                same_tensors(f"phase 13, the {which} encoder after --pretrained-weights-path",
                             own, want)
            solver.run_n_train_iterations(WEIGHTS_ITERATIONS)
        finally:
            solver.end()
    del solver
    free_cuda()
    result["cli_s"] = time.perf_counter() - t0
    paths["phase 13 --pretrained-weights-path CLI"] = check_cli_calls(
        "--pretrained-weights-path", rec, "ResNet50", WEIGHTS_ITERATIONS, 1)
    log(f"  query and key encoders bit-identical to the file; {WEIGHTS_ITERATIONS} iterations "
        f"in {result['cli_s']:.1f} s wall with the setup")

    conv_dir = os.path.join(root, "converted")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(Tee(sys.stdout)):
        convert_reference_checkpoint.main(["--torch-checkpoint", pt, "--output-dir", conv_dir,
                                           "--backbone", "ResNet50", "--embed-size", "128",
                                           "--queue-size", "65536", "--image-size", "224"])
    result["convert_s"] = time.perf_counter() - t0
    spec = END_TASK_RUNS["ResNet50-IN-probe"]
    probe_argv = END_TASK_ARGV[:-len(PRETRAIN_RUN)] + spec["argv"] + [
        "--title", "weights", "--description", "in_probe", "--solver", spec["solver"],
        "--base-logdir", tmp, "--checkpoint-dir", conv_dir, "--no-save",
        "--iterations-per-epoch", str(WEIGHTS_ITERATIONS)]
    log(f"phase 13, convert_reference_checkpoint ({result['convert_s']:.1f} s), then the "
        f"ResNet50-IN-probe restored from it: the parser and the solver, {WEIGHTS_ITERATIONS} "
        f"iterations")
    reset_counts()
    with contextlib.redirect_stdout(Tee(sys.stdout)) as out:
        probe = solver_runner.get_solver_class(spec["solver"])(
            arg_parser.parse_args(probe_argv))
        try:
            if f"Restored pretrain encoder from {conv_dir}" not in out.getvalue():
                fail("phase 13: the probe did not restore the converted checkpoint")
            encoder = probe.state.encoder.state_dict()
            same_tensors("phase 13, the probe's encoder", encoder,
                         {k: v for k, v in want.items() if k in encoder})
            probe.reset_epoch()
            losses = [probe.run_train_iteration()["loss/total_loss"]
                      for _ in range(WEIGHTS_ITERATIONS)]
        finally:
            probe.end()
    del probe
    free_cuda()
    launches, plain = read_counts()
    if not all(math.isfinite(x) for x in losses) or launches or plain:
        fail(f"phase 13: the probe's losses {losses}, launches {launches}, plain calls {plain}")
    paths["phase 13 IN probe from the converted checkpoint"] = launches
    result["probe_losses"] = losses
    log(f"  the probe's encoder bit-identical to the file; losses {losses}; no kernel launch")

    exported = os.path.join(root, "exported.pt")
    with contextlib.redirect_stdout(Tee(sys.stdout)):
        export_reference_checkpoint.main(["--checkpoint-dir", conv_dir, "--output", exported])
    back = torch.load(exported, weights_only=True)
    if set(back) != set(sd) or any(back[k].dtype != v.dtype for k, v in sd.items()):
        fail(f"phase 13: the export's names or types differ from the written dict's: "
             f"{sorted(set(back) ^ set(sd))[:5]}")
    same_tensors("phase 13, the export of the converted checkpoint", back, sd)
    log(f"  export_reference_checkpoint of the converted directory: the written dict, "
        f"{len(sd)} tensors, bit for bit")
    return paths, result


def run_retrieval(tmp):
    """The retrieval probe (``vince_tpu_torch/tools/eval_retrieval.py``) on
    phase 9's latest checkpoint and with ``--no-restore``: ``retrieval_at_1``,
    ``chance`` and the seconds of each, the launches (the eval-mode forward
    takes no kernel)."""
    from vince_tpu_torch.tools import eval_retrieval
    from vince_tpu_torch.utils.checkpoint import CheckpointManager

    directory = os.path.join(tmp, "cli", "checkpoints_resnet50")
    latest = CheckpointManager(directory).latest_step()
    argv = CLI_ARGV + PRETRAIN_RUN + ["--base-logdir", tmp] + RETRIEVAL_ARGV
    paths, result = {}, {}
    for label, extra, step in ((f"step {latest}", [], latest), ("--no-restore",
                                                               ["--no-restore"], 0)):
        log(f"phase 13, retrieval: python vince_tpu_torch/tools/eval_retrieval.py "
            f"{' '.join(RETRIEVAL_ARGV)} with phase 9's flags{' ' if extra else ''}"
            f"{' '.join(extra)}")
        free_cuda()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(Tee(sys.stdout)):
            r = eval_retrieval.main(argv + extra)
        seconds = time.perf_counter() - t0
        launches, plain = read_counts()
        f, n = r["frames"], r["num_videos"]
        if (r["restored_step"] != step or r["chance"] != round((f - 1) / (n * f - 1), 4)
                or not 0 <= r["retrieval_at_1"] <= 1 or launches or plain):
            fail(f"phase 13, retrieval {label}: {r}, launches {launches}, plain calls {plain}")
        paths[f"phase 13 retrieval, {label}"] = launches
        result[label] = (r["retrieval_at_1"], r["chance"], seconds)
        log(f"  {label}: retrieval@1 {r['retrieval_at_1']}, chance {r['chance']}, "
            f"{seconds:.1f} s")
    return paths, result


def run_phase13(dev, card, tmp):
    """Phase 13: remat (both backbones, then sync-BN at a world of one), the
    reference's weights in and out, the retrieval probe."""
    paths, result = {}, {"remat": {}}
    t0 = time.perf_counter()
    for backbone in TRAIN_PHASES:
        log(f"phase 13, remat: {backbone} at phase 5's shapes and flags, the captured step "
            f"with remat and without")
        r = remat_against_plain(dev, backbone)
        r["timed"] = remat_timed(dev, backbone, card)
        paths[f"phase 13 {backbone} captured remat (at the capture)"] = r["capture_launches"]
        result["remat"][backbone] = r
    log(f"phase 13, remat with sync-BN at a world of one ({DIST_BACKEND})")
    paths["phase 13 sync-BN remat, 2 eager steps"] = remat_sync_bn(dev)
    weight_paths, result["weights"] = run_weights(tmp)
    paths.update(weight_paths)
    retrieval_paths, result["retrieval"] = run_retrieval(tmp)
    paths.update(retrieval_paths)
    result["seconds"] = time.perf_counter() - t0
    return paths, result


def log_phase13(result, card):
    for backbone, r in result["remat"].items():
        t = r["timed"]
        log(f"phase 13 {backbone} remat: captured {t[True]['ms_per_step']:.3f} ms/step against "
            f"{t[False]['ms_per_step']:.3f} without; peak reserved {t[True]['peak_gib']:.3f} "
            f"GiB against {t[False]['peak_gib']:.3f}; launches at the capture "
            f"{r['capture_launches']}; against no remat: loss gap {r['loss_gap']:.3e}, update "
            f"gap {r['update_gap']:.3e}, running averages after one step bit-equal "
            f"{r['stats_equal']}; card {card}")
    w = result["weights"]
    log(f"phase 13 weights: --pretrained-weights-path encoders bit-identical to the file, "
        f"{WEIGHTS_ITERATIONS} iterations {w['cli_s']:.1f} s; converted in {w['convert_s']:.1f} s; "
        f"IN probe losses {w['probe_losses']}; export bit-identical to the written dict")
    log("phase 13 retrieval (retrieval@1, chance, s): " + ", ".join(
        f"{label} {r}" for label, r in result["retrieval"].items())
        + f"; phase 13 took {result['seconds']:.1f} s; card {card}")


# phase 14: the file-backed path. Trees of JPEGs written from the seed by the
# port's texture generator through cv2.imwrite, in a temporary directory
FILE_TREES = dict(
    r2v2_videos=(256, 64), r2v2_frames=6, frame_hw=(360, 480),  # the cacher's longest side 480
    imagenet_classes=1000, imagenet_train=2, imagenet_val=600, image_hw=(375, 500),
    sun_categories=397, sun_train=2, sun_test=600,
    kinetics_clips=(64, 48), kinetics_frames=11, kinetics_labels=400,
    tracking_seqs=(3, 3, 2), tracking_frames=12, tracking_size=360, seed=14)
FILE_ITERATIONS = 10  # pretraining iterations from files, with each decoder
JPEG_KERNELS = ("ycc_resize_canvas",)  # the kernel of --native-decode
OLD_JPEG_KERNELS = ("ycc_to_rgb", "resize_canvas")  # the two it replaced: on no path
FILE_END_TASK_ITERATIONS = 4
# phase 10's runs on the trees: (the dataset's flags, the tree they read)
FILE_END_TASKS = {
    "ResNet50-IN-probe": (["--dataset", "ImagenetDataset", "--imagenet-data-path"], "imagenet"),
    "ResNet50-SUN-finetune": (["--dataset", "SunSceneDataset", "--data-path"], "sun"),
    "ResNet50-Kinetics": (["--dataset", "Kinetics400Dataset", "--data-path"], "kinetics"),
}


def write_file_trees(root):
    """R2V2, ImageNet, SUN-397, Kinetics-400, GOT-10k + OTB-2015 trees under
    ``root`` (``FILE_TREES``): every image a scene of the texture pool,
    rolled and scaled by draws from the seed (a video's frames drift by 4
    pixels a frame), written by cv2 from 8 threads. Returns the trees'
    directories and the count of files."""
    import concurrent.futures
    import json as js

    import cv2

    from vince_tpu_torch.tracking.sequences import TextureSequences

    t = FILE_TREES
    pool = texture_pool(t["seed"])
    rng = np.random.RandomState(t["seed"])
    jobs = []  # (path, rgb image or (drawn image args))
    dirs = {k: os.path.join(root, k) for k in ("r2v2", "imagenet", "sun", "kinetics", "tracking")}

    def video(path_of, frames, hw):
        state = rng.randint(2 ** 31)
        for f in range(frames):
            jobs.append((path_of(f), (state, hw, (0, 4 * f))))

    for split, count in zip(("train", "val"), t["r2v2_videos"]):
        for v in range(count):
            vid = f"{'ABCDEFGH'[v % 8]}{'xyz'[v % 3]}{split}{v:07d}"
            video(lambda f, vid=vid, split=split: os.path.join(
                dirs["r2v2"], split, vid[:2], f"{vid}_{f:06d}.jpg"), t["r2v2_frames"],
                t["frame_hw"])
    wnids = [f"n{c:08d}" for c in range(t["imagenet_classes"])]
    for c, wnid in enumerate(wnids):
        for i in range(t["imagenet_train"]):
            jobs.append((os.path.join(dirs["imagenet"], "train", wnid, f"{wnid}_{i}.JPEG"),
                         (rng.randint(2 ** 31), t["image_hw"], (0, 0))))
        os.makedirs(os.path.join(dirs["imagenet"], "val", wnid), exist_ok=True)
    for i in range(t["imagenet_val"]):
        wnid = wnids[i % len(wnids)]
        jobs.append((os.path.join(dirs["imagenet"], "val", wnid, f"val_{i:08d}.JPEG"),
                     (rng.randint(2 ** 31), t["image_hw"], (0, 0))))
    categories = [f"/{chr(97 + c % 26)}/scene{c:03d}" for c in range(t["sun_categories"])]
    lists = {"Training_01.txt": [], "Testing_01.txt": []}
    for c, cat in enumerate(categories):
        for i in range(t["sun_train"]):
            lists["Training_01.txt"].append(f"{cat}/sun_train_{c:03d}_{i}.jpg")
    for i in range(t["sun_test"]):
        lists["Testing_01.txt"].append(f"{categories[i % len(categories)]}/sun_test_{i:04d}.jpg")
    for name, rels in lists.items():
        os.makedirs(dirs["sun"], exist_ok=True)
        with open(os.path.join(dirs["sun"], name), "w") as f:
            f.write("\n".join(rels) + "\n")
        for rel in rels:
            jobs.append((dirs["sun"] + rel, (rng.randint(2 ** 31), t["image_hw"], (0, 0))))
    labels = [f"action_{i:03d}" for i in range(t["kinetics_labels"])]
    os.makedirs(os.path.join(dirs["kinetics"], "annotations"))
    for s, (split, count) in enumerate(zip(("train", "val"), t["kinetics_clips"])):
        ann = {}
        for v in range(count):
            vid = f"{'ABCD'[v % 4]}k{split}{v:07d}"
            ann[vid] = {"annotations": {"label": labels[(7 * v + s) % len(labels)]}}
            video(lambda f, vid=vid, split=split: os.path.join(
                dirs["kinetics"], split, vid[:2], f"{vid}_{f:06d}.jpg"), t["kinetics_frames"],
                t["frame_hw"])
        # the label map spans every class, as Kinetics' annotation files do
        ann.update({f"ZZ{split}absent{i:04d}": {"annotations": {"label": label}}
                    for i, label in enumerate(labels)})
        with open(os.path.join(dirs["kinetics"], "annotations", f"{split}.json"), "w") as f:
            js.dump(ann, f)
    otb, got_train, got_val = t["tracking_seqs"]
    for kind, num, seed in (("otb100", otb, 14), ("train", got_train, 15), ("val", got_val, 16)):
        seqs = TextureSequences(num_seqs=num, num_frames=t["tracking_frames"],
                                size=t["tracking_size"], seed=seed)
        base = os.path.join(dirs["tracking"], kind)
        for i, name in enumerate(seqs.seq_names):
            frames, anno = seqs[i]
            seq = os.path.join(base, name)
            img_dir = os.path.join(seq, "img") if kind == "otb100" else seq
            for f, frame in enumerate(frames):
                jobs.append((os.path.join(img_dir, f"{f + 1:04d}.jpg" if kind == "otb100"
                                          else f"{f + 1:08d}.jpg"), frame))
            os.makedirs(img_dir, exist_ok=True)
            np.savetxt(os.path.join(seq, "groundtruth_rect.txt" if kind == "otb100"
                                    else "groundtruth.txt"), anno, fmt="%.2f", delimiter=",")
        if kind != "otb100":
            with open(os.path.join(base, "list.txt"), "w") as f:
                f.write("\n".join(seqs.seq_names) + "\n")

    def write(job):
        path, image = job
        if not isinstance(image, np.ndarray):
            state, hw, shift = image
            image = texture_image(pool, np.random.RandomState(state), hw, shift)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not cv2.imwrite(path, np.ascontiguousarray(image[:, :, ::-1])):
            raise RuntimeError(f"cv2.imwrite failed for {path}")

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        list(ex.map(write, jobs))
    return dirs, len(jobs)


def file_cli_run(what, argv, card, tmp):
    """``FILE_ITERATIONS`` iterations of the ResNet50 CLI through the parser
    and the solver (no val, no save) on the R2V2 tree: the launches of the
    step (K1 1, K2 26 at the eager calls and the capture) and of the JPEG
    kernels, the meters, the peak reserved."""
    from vince_tpu_torch import native

    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    native.reset_counts()
    launches, rec = solver_iterations(what, argv, "ResNet50", FILE_ITERATIONS, tmp)
    jpeg = {k: v for k, v in read_counts()[0].items() if k in JPEG_KERNELS + OLD_JPEG_KERNELS}
    out = {"launches": {**launches, **jpeg}, "laps": report_laps(what, rec, card),
           "peak_gib": torch.cuda.max_memory_reserved() / 2**30, "decodes": dict(native.counts),
           "in_use_gib": rec.in_use_gib}
    log(f"  {what}: peak reserved {out['peak_gib']:.3f} GiB; the card's memory in use after "
        f"the iterations {out['in_use_gib']:.3f} GiB; decodes {out['decodes']}; the JPEG "
        f"kernels' launches {jpeg}")
    clean_tree_decodes(what, out["decodes"])
    return out


def clean_tree_decodes(what, decodes):
    """A run on a tree of clean JPEGs: no stream refused, no cv2 read in
    place of the card's decode, every file handed to the decode decoded."""
    if (decodes["cv2_reads"] or decodes["failed"]
            or decodes["files"] != decodes["nvjpeg"] + decodes["plain"]):
        fail(f"phase 14 {what}: {decodes['failed']} streams refused, {decodes['cv2_reads']} "
             f"cv2 reads, {decodes['files']} files for {decodes['nvjpeg'] + decodes['plain']} "
             f"decodes on a tree of clean JPEGs ({decodes})")


def r2v2_loader_ms(tree):
    """The loader alone on the R2V2 tree (batches of 32 videos x (4 + 4)
    frames, the CLI's threads, cv2 reads), ms per batch."""
    import argparse as ap

    from vince_tpu_torch.data.r2v2_dataset import R2V2Dataset

    args = ap.Namespace(input_width=224, num_frames=4, data_path=tree, seed=0,
                        platform="cuda")
    return time_loader(ds=R2V2Dataset(args, "train", num_images_to_return=4))


def file_end_task(name, tmp, dirs, card, extra=()):
    """Phase 10's run ``name`` on its tree with ``--native-decode`` and the
    flags ``extra``: 4 iterations and the val pass from phase 9's step-48
    checkpoint, no save; finite losses, the val pass's counts, the JPEG
    kernels' launches."""
    from vince_tpu_torch import native, solver_runner

    spec = END_TASK_RUNS[name]
    flags, tree = FILE_END_TASKS[name]
    argv = [a for a in spec["argv"]]
    argv[argv.index("--dataset"):argv.index("--dataset") + 2] = flags + [dirs[tree]]
    pretrain_dir = os.path.join(tmp, "cli", "checkpoints_resnet50")
    argv = END_TASK_ARGV[:-len(PRETRAIN_RUN)] + argv + [
        "--solver", spec["solver"], "--title", "files", "--description", tree,
        "--base-logdir", tmp, "--checkpoint-dir", pretrain_dir, "--native-decode", "--no-save",
        "--iterations-per-epoch", str(FILE_END_TASK_ITERATIONS), *extra]
    log(f"phase 14, {name} from files: python -m vince_tpu_torch.solver_runner "
        f"{' '.join(argv)}")
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    native.reset_counts()
    t0 = time.perf_counter()
    with EndTaskRecord(read_pretrain(pretrain_dir)) as rec, \
            contextlib.redirect_stdout(Tee(sys.stdout)):
        solver = solver_runner.main(argv)
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    losses = [it["loss"] for it in rec.iterations]
    if (len(losses) != FILE_END_TASK_ITERATIONS or not all(map(math.isfinite, losses))
            or not rec.encoder_checks or not rec.encoder_checks[0]):
        fail(f"phase 14 {name}: losses {losses}, encoder from the checkpoint "
             f"{rec.encoder_checks[:1]}")
    (val,) = rec.vals
    expected = len(solver._make_dataset("val"))
    items = solver.args.batch_size // spec["frames"]
    if (val["samples"], val["batches"]) != (expected, -(-expected // items)) or not all(
            math.isfinite(v) for v in val["results"].values()):
        fail(f"phase 14 {name}: a val pass of {val['samples']} samples in {val['batches']} "
             f"batches with {val['results']}, expected {expected} in {-(-expected // items)}")
    if set(launches) != set(JPEG_KERNELS) or plain:
        fail(f"phase 14 {name}: launches {launches}, plain calls {plain}; the JPEG kernels only")
    clean_tree_decodes(name, native.counts)
    laps = {m: float(np.median([it["laps"][m] * 1e3 for it in rec.iterations[1:]]))
            for m in END_TASK_LAPS}
    # the first iteration's wait for its batch: the loader's start and its first batch
    first_wait_s = rec.iterations[0]["laps"]["data_cache_time"]
    its = [sp for sp in rec.spans if sp[0] == "run_train_iteration"]

    def spent(name):
        return sum(e - b for n, b, e in rec.spans if n == name)

    parts = {"loaders": spent("setup_dataloader"), "model": spent("setup_model")}
    parts["else to the first iteration"] = its[0][1] - t0 - sum(parts.values())
    parts.update({"iterations": its[-1][2] - its[0][1], "val": spent("run_val"),
                  "end": spent("end")})
    parts["other"] = wall - sum(parts.values())
    result = dict(losses=losses, val=(val["samples"], val["batches"], val["seconds"]),
                  laps=laps, first_wait_s=first_wait_s, wall_parts=parts, launches=launches,
                  decodes=dict(native.counts), wall_s=wall,
                  frames_per_s=items * spec["frames"] / laps["total_time"] * 1e3,
                  peak_gib=torch.cuda.max_memory_reserved() / 2**30)
    log(f"  losses {losses[0]:.4f} ... {losses[-1]:.4f}, all finite; val pass (samples, "
        f"batches, s) {result['val']}: {val['results']}; median total_time "
        f"{laps['total_time']:.3f} ms, data_cache_time {laps['data_cache_time']:.3f} over "
        f"iterations 2-{FILE_END_TASK_ITERATIONS} ({result['frames_per_s']:.2f} frames/s), "
        f"{first_wait_s:.3f} s at the first; decodes {result['decodes']}; launches {launches}; "
        f"{wall:.1f} s wall (" + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
        + f"); card {card}")
    del solver
    free_cuda()
    return result


def file_tracking(tmp, dirs, card):
    """Tracking from files: the frozen ResNet18SiamFCDilated on phase 11's
    pretraining, 2 iterations on the GOT-10k tree's pairs (cv2 reads, host
    crops) with its val pass and a save, then ``run_end_task_eval`` on the
    OTB-2015 tree: its scores and the tracker's frames/s."""
    from vince_tpu_torch import run_end_task_eval, solver_runner

    argv = [a for a in TRACKING_ARGV]
    for flag, value in (("--title", "trk_files"), ("--iterations-per-epoch", "2"),
                        ("--save-frequency", "2")):
        argv[argv.index(flag) + 1] = value
    argv += ["--base-logdir", tmp, "--data-path", dirs["tracking"], "--checkpoint-dir",
             os.path.join(tmp, "trk", "checkpoints_resnet18")]
    log(f"phase 14, tracking from files: python -m vince_tpu_torch.solver_runner "
        f"{' '.join(argv)}, then run_end_task_eval with --disable-dataloader")
    free_cuda()
    reset_counts()
    t0 = time.perf_counter()
    with EndTaskRecord(read_pretrain(os.path.join(tmp, "trk", "checkpoints_resnet18"))) as rec, \
            contextlib.redirect_stdout(Tee(sys.stdout)) as out:
        solver_runner.main(argv)
        evaluated = run_end_task_eval.main(argv + ["--disable-dataloader"])
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    losses = [it["loss"] for it in rec.iterations]
    printed = out.getvalue()
    scores = (evaluated.get("precision"), evaluated.get("success"))
    if (len(losses) != 2 or not all(map(math.isfinite, losses)) or evaluated.get("synthetic")
            or "OTB results:" not in printed or not all(0 <= x <= 1 for x in scores)
            or launches or plain):
        fail(f"phase 14 tracking: losses {losses}, eval {evaluated}, launches {launches}")
    result = dict(losses=losses, eval=evaluated, val=[(v["samples"], v["batches"])
                                                       for v in rec.vals], wall_s=wall)
    log(f"  losses {losses}, all finite; val pass (samples, batches) {result['val']}; OTB-2015 "
        f"from the tree: precision {scores[0]:.4f}, success {scores[1]:.4f}, tracker "
        f"{evaluated['speed_fps']:.1f} frames/s, {FILE_TREES['tracking_seqs'][0]} sequences; "
        f"{wall:.1f} s wall; card {card}")
    return result


def file_embeddings(tmp, dirs, card):
    """``vince_tpu_torch/tools/extract_embeddings.py`` on the R2V2 val tree with
    phase 9's flags and latest checkpoint, with cv2 and with ``--native-decode``:
    the rows, their cosines, the JPEG kernels' launches, seconds."""
    from vince_tpu_torch import native
    from vince_tpu_torch.tools import extract_embeddings

    input_dir = os.path.join(dirs["r2v2"], "val")
    expected = FILE_TREES["r2v2_videos"][1] * FILE_TREES["r2v2_frames"]
    out, paths = {}, {}
    for label, extra in (("cv2", []), ("--native-decode", ["--native-decode"])):
        free_cuda()
        reset_counts()
        native.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(Tee(sys.stdout)):
            emb, names = extract_embeddings.main(
                CLI_ARGV + PRETRAIN_RUN + ["--base-logdir", tmp, "--input-dir", input_dir,
                                           "--output", os.path.join(tmp, f"emb_{label}.npz")]
                + extra)
        launches, plain = read_counts()
        out[label] = (emb, names, time.perf_counter() - t0)
        paths[f"phase 14 extract_embeddings {label}"] = launches
        if len(names) != expected or emb.shape != (expected, 128) or plain or (
                set(launches) != (set(JPEG_KERNELS) if extra else set())):
            fail(f"phase 14 extract_embeddings {label}: {emb.shape} rows of {len(names)} "
                 f"paths (expected {expected}), launches {launches}, plain calls {plain}")
        if extra and native.counts["nvjpeg"] != expected:
            fail(f"phase 14 extract_embeddings {label}: {native.counts['nvjpeg']} of {expected} "
                 f"files decoded by nvJPEG ({native.counts})")
        clean_tree_decodes(f"extract_embeddings {label}", native.counts)
    (a, na, ta), (b, nb, tb) = out.values()
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    if na != nb or cos.min() < 0.999:
        fail(f"phase 14 extract_embeddings: cosine between the decoders min {cos.min()}")
    log(f"  extract_embeddings: {expected} rows each; cosine cv2 / --native-decode row-wise min "
        f"{cos.min():.6f}, median {np.median(cos):.6f}; {ta:.1f} s and {tb:.1f} s; card {card}")
    return paths, dict(rows=expected, cos_min=float(cos.min()), seconds=(ta, tb))


PROCESSES = "--native-decode --loader-processes"  # the label of phase 14's runs in processes
# phase 14's pretraining runs from files: cv2 reads and the card's decode, in
# the loader's threads and in its worker processes
RUNS_FROM_FILES = (("cv2", []), ("--native-decode", ["--native-decode"]),
                   ("--loader-processes", ["--loader-processes"]),
                   (PROCESSES, ["--native-decode", "--loader-processes"]))
LOADER_CHECK_BATCHES = 4  # the loader's first batches, from threads and from processes


def loader_threads_against_processes(tree, card):
    """The loader's first ``LOADER_CHECK_BATCHES`` batches of the R2V2 val
    tree with ``repeatable`` draws (32 videos x (4 + 4) frames), from one
    thread and from the CLI's default count of worker processes, held
    bit-equal: both decode with nvJPEG on this card. Beside them: each
    pool's start-up (``set_dataset`` to its first batch), the card's memory
    in use by every process (``mem_get_info``) before the loader and with
    it, and the JPEG kernels' launches and decodes (the workers' summed
    here)."""
    import argparse as ap
    import multiprocessing

    from vince_tpu_torch import native
    from vince_tpu_torch.data.loader import PersistentDataLoader
    from vince_tpu_torch.data.r2v2_dataset import R2V2Dataset

    args = ap.Namespace(input_width=224, num_frames=4, data_path=tree, seed=0,
                        native_decode=True, platform=CARD)
    workers = min(multiprocessing.cpu_count(), 16)

    def first_batches(processes):
        free_cuda()
        reset_counts()
        native.reset_counts()
        before = in_use_gib()
        loader = PersistentDataLoader(batch_size=32, num_workers=workers if processes else 1,
                                      use_processes=processes)
        t0 = time.perf_counter()
        loader.set_dataset(R2V2Dataset(args, "val", num_images_to_return=4, repeatable=True))
        try:
            batches = [loader.get_batch(timeout=300)]
            start_s = time.perf_counter() - t0
            batches += [loader.get_batch(timeout=300) for _ in range(LOADER_CHECK_BATCHES - 1)]
            with_gib = in_use_gib()
        finally:
            loader.shutdown()
        launches, plain = read_counts()
        if set(launches) != set(JPEG_KERNELS) or plain:
            fail(f"phase 14 loader, processes={processes}: launches {launches}, plain calls "
                 f"{plain}; the JPEG kernels only")
        clean_tree_decodes(f"loader, processes={processes}", native.counts)
        return batches, dict(start_s=start_s, before_gib=before, with_gib=with_gib,
                             launches=launches, decodes=dict(native.counts))

    threads, one = first_batches(False)
    processes, pool = first_batches(True)
    for b, (got, ref) in enumerate(zip(processes, threads, strict=True)):
        for k, v in ref.items():
            same = np.array_equal(got[k], v) if isinstance(v, np.ndarray) else got[k] == v
            if not same:
                fail(f"phase 14 loader: batch {b}'s {k} from {workers} worker processes differs "
                     f"from one thread's")
    pool["workers"] = workers
    frames = threads[0]["data"].shape[0] + threads[0]["queue_data"].shape[0]
    log(f"  loader, threads against processes: the first {LOADER_CHECK_BATCHES} batches of the "
        f"val tree ({frames} frames each, repeatable draws) bit-equal; first batch after "
        f"{pool['start_s']:.3f} s from {workers} worker processes, {one['start_s']:.3f} s from "
        f"one thread; the card's memory in use {pool['before_gib']:.3f} GiB before the pool, "
        f"{pool['with_gib']:.3f} with it ({(pool['with_gib'] - pool['before_gib']) / workers:.3f}"
        f" a worker; one thread {one['before_gib']:.3f} -> {one['with_gib']:.3f}); the JPEG "
        f"kernels' launches in the workers, summed here, {pool['launches']}, decodes "
        f"{pool['decodes']}; card {card}")
    return {"processes": pool, "thread": one}


def run_phase14(card, tmp):
    """Phase 14: the trees, pretraining from files (cv2, --native-decode in
    the loader's threads, then in its worker processes, with the loader's
    batches from both held bit-equal) with the loader alone, the end tasks
    and tracking from files (the ImageNet probe also with worker processes),
    the embedding tool with both decoders."""
    paths, result = {}, {}
    t0 = time.perf_counter()
    parts = Laps()
    root = os.path.join(tmp, "files")
    dirs, files = write_file_trees(root)
    result["trees_s"] = time.perf_counter() - t0
    log(f"phase 14: {files} files written in {result['trees_s']:.1f} s under a temporary "
        f"directory ({FILE_TREES})")
    parts("trees")
    base = [a for a in CLI_ARGV]
    base[base.index("--dataset") + 1] = "R2V2Dataset"
    base += ["--data-path", dirs["r2v2"]]
    for n, (label, extra) in enumerate(RUNS_FROM_FILES):
        what = f"R2V2 files, {label}"
        log(f"phase 14, pretraining from files: the parser and the solver, {' '.join(base)} "
            f"{' '.join(extra)}, {FILE_ITERATIONS} iterations, no val, no save")
        r = file_cli_run(what, base + extra + ["--description", f"files{n}"], card, tmp)
        native_decode = "--native-decode" in extra
        if native_decode and not all(r["launches"].get(k) for k in JPEG_KERNELS):
            fail(f"phase 14 {what}: a JPEG kernel was not launched ({r['launches']})")
        if any(r["launches"].get(k) for k in OLD_JPEG_KERNELS):
            fail(f"phase 14 {what}: a kernel that the fused one replaced was launched "
                 f"({r['launches']})")
        if not native_decode and (any(r["launches"].get(k) for k in JPEG_KERNELS)
                                  or any(r["decodes"].values())):
            fail(f"phase 14 {what}: the card's decode ran without --native-decode "
                 f"({r['launches']}, {r['decodes']})")
        paths[f"phase 14 CLI ResNet50 {what}, {FILE_ITERATIONS} iterations"] = r["launches"]
        if label == PROCESSES:
            r["loader"] = loader_threads_against_processes(dirs["r2v2"], card)
        elif label == "cv2":
            # the threads' loader alone with nvJPEG is cut: the bit-equal
            # check above times its first batches from one thread
            r["loader_ms"] = r2v2_loader_ms(dirs["r2v2"])
            log(f"  {what}: the loader alone {r['loader_ms'][0]:.3f} ms a batch of 32 videos "
                f"with {r['loader_ms'][1]} threads; card {card}")
        result[label] = r
        parts(label)
    result["end_tasks"] = {}
    for name in FILE_END_TASKS:
        r = file_end_task(name, tmp, dirs, card)
        paths[f"phase 14 end task {name} from files"] = r["launches"]
        result["end_tasks"][name] = r
    parts("end tasks")
    r = file_end_task("ResNet50-IN-probe", tmp, dirs, card, ["--loader-processes"])
    paths["phase 14 end task ResNet50-IN-probe from files, --loader-processes"] = r["launches"]
    result["end_task_processes"] = r
    parts("IN-probe --loader-processes")
    result["tracking"] = file_tracking(tmp, dirs, card)
    paths["phase 14 tracking from files"] = {}
    parts("tracking")
    embed_paths, result["embeddings"] = file_embeddings(tmp, dirs, card)
    paths.update(embed_paths)
    parts("embeddings")
    result["parts"] = parts.seconds
    result["seconds"] = time.perf_counter() - t0
    return paths, result


def log_phase14(result, card):
    for label, _ in RUNS_FROM_FILES:
        r = result[label]
        laps = r["laps"]
        loader = ""
        if "loader_ms" in r:
            loader = f"; the loader alone {r['loader_ms'][0]:.3f} ms a batch of 32 videos"
        elif "loader" in r:
            pool = r["loader"]["processes"]
            loader = (f"; the pool's first batch after {pool['start_s']:.3f} s, "
                      f"{pool['with_gib'] - pool['before_gib']:.3f} GiB more in use on the card "
                      f"with its {pool['workers']} workers")
        log(f"phase 14 pretraining from R2V2 files, {label}: " + ", ".join(
            f"{m} {laps[m][0]:.3f} ms ({laps[m][1]:.3f}-{laps[m][2]:.3f})" for m in LAPS)
            + f", {laps['frames_per_s']:.2f} frames/s{loader}; peak reserved "
            f"{r['peak_gib']:.3f} GiB, in use on the card {r['in_use_gib']:.3f} GiB; decodes "
            f"{r['decodes']}; card {card}")
    for name, r in [*result["end_tasks"].items(),
                    ("ResNet50-IN-probe --loader-processes", result["end_task_processes"])]:
        log(f"phase 14 {name} from files (--native-decode): total_time "
            f"{r['laps']['total_time']:.3f} ms, data_cache_time {r['laps']['data_cache_time']:.3f}"
            f" ({r['first_wait_s']:.3f} s at the first iteration), {r['frames_per_s']:.2f} "
            f"frames/s, val (samples, batches, s) {r['val']}, peak reserved "
            f"{r['peak_gib']:.3f} GiB, {r['wall_s']:.1f} s wall ("
            + ", ".join(f"{k} {v:.1f}" for k, v in r["wall_parts"].items()) + f"); card {card}")
    t = result["tracking"]
    log(f"phase 14 tracking from files: OTB-2015 tree precision {t['eval']['precision']:.4f}, "
        f"success {t['eval']['success']:.4f}, tracker {t['eval']['speed_fps']:.1f} frames/s; "
        f"card {card}")
    e = result["embeddings"]
    log(f"phase 14 extract_embeddings: {e['rows']} rows, cosine min {e['cos_min']:.6f}, "
        f"{e['seconds'][0]:.1f} / {e['seconds'][1]:.1f} s; trees {result['trees_s']:.1f} s; "
        f"phase 14 {result['seconds']:.1f} s; card {card}")


# phase 15: the end tasks across processes, the multi-rank soak, the audit of
# the collectives, the dry run and the visualization CLIs, at a world of one
END_TASK_STEPS = 3  # the end-task step on a 1x1 mesh against the one-device step
SOAK_STEPS = 50
DIST_END_TASK_ITERATIONS = 4
DIST_TRACKING_ITERATIONS = 2
VIZ_IMAGES = 128  # the neighbour grid's images (a batch of phase 9's 128)


def end_task_step_config(name):
    """Phase 10's run ``name`` as the step's ``EndTaskConfig`` (the solver's
    own ``make_config`` on its flags, one process), the solver's class and
    the flags."""
    from vince_tpu_torch import arg_parser
    from vince_tpu_torch.solvers import end_task_solvers

    spec = END_TASK_RUNS[name]
    with contextlib.redirect_stdout(io.StringIO()):
        args = arg_parser.parse_args(END_TASK_ARGV + spec["argv"] + ["--solver", spec["solver"]])
    solver_cls = getattr(end_task_solvers, spec["solver"])
    unbuilt = solver_cls.__new__(solver_cls)  # make_config reads only the flags and the mesh
    unbuilt.args, unbuilt.mesh = args, None
    return solver_cls.make_config(unbuilt), solver_cls, args


def end_task_states_differ(a, b):
    """The first tensor (or count) in which two end-task states differ, or
    None."""
    from vince_tpu_torch.utils.checkpoint import end_task_state_tree

    def walk(prefix, x, y):
        for k, v in y.items():
            if isinstance(v, dict):
                found = walk(f"{prefix}{k}/", x[k], v)
                if found:
                    return found
            elif isinstance(v, torch.Tensor) and not torch.equal(x[k], v):
                return prefix + k
            elif not isinstance(v, torch.Tensor) and x[k] != v:
                return prefix + k
        return None

    return walk("", end_task_state_tree(a), end_task_state_tree(b))


def run_end_task_mesh_steps(dev, mesh):
    """The end-task train step of phase 10's ImageNet probe and SUN fine-tune
    (ResNet50, 224², bf16, batch 256, 1000 and 397 classes) on a 1x1 mesh
    against the one-device step: the same seed, the same batches of the
    run's train split, cuDNN deterministic, 3 steps; at a world of one every
    collective is the identity, so the losses and every tensor of the states
    are bit-identical. Returns each run's ms/step (mesh, one device)."""
    from vince_tpu_torch.data.synthetic_dataset import SyntheticImageDataset
    from vince_tpu_torch.solvers import end_task_step as ets

    out, batches = {}, None
    torch.backends.cudnn.deterministic = True
    try:
        # SUN's first: its 397 classes' labels serve the probe's 1000 too
        for name in ("ResNet50-SUN-finetune", "ResNet50-IN-probe"):
            cfg, solver_cls, args = end_task_step_config(name)
            spec = ets.build_optimizer(cfg, args.base_lr, solver_cls.optimizer_kind)
            if batches is None:
                ds = SyntheticImageDataset(args, "train")
                batches = [synthetic_image_batch(ds, i, args.batch_size, dev)
                           for i in range(END_TASK_STEPS)]
            log(f"phase 15, the end-task step on {mesh} against one device: {name} "
                f"({cfg.backbone}, batch {args.batch_size}, {cfg.image_size}², "
                f"{str(cfg.compute_dtype).replace('torch.', '')}, "
                f"{cfg.num_classes} classes, frozen {cfg.freeze_feature_extractor}), "
                f"{END_TASK_STEPS} steps, cuDNN deterministic")
            runs = {}
            for label, m in (("mesh", mesh), ("one", None)):
                state = ets.init_end_task_state(0, cfg, spec, device=dev)
                step = ets.make_end_task_train_step(cfg, train=True, mesh=m)
                losses, ms = [], []
                for batch in batches:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, metrics = step(state, batch, 0)
                    losses.append(metrics["loss/total_loss"].item())
                    ms.append((time.perf_counter() - t0) * 1e3)
                runs[label] = (state, losses, float(np.median(ms)))
            differs = end_task_states_differ(runs["mesh"][0], runs["one"][0])
            if runs["mesh"][1] != runs["one"][1] or differs:
                fail(f"phase 15, {name}: the end-task step on a 1x1 mesh is not bit-identical "
                     f"to the one-device step: losses {runs['mesh'][1]} / {runs['one'][1]}, "
                     f"first differing tensor {differs}")
            log(f"  losses {runs['mesh'][1]} bit-identical, and every tensor of the states "
                f"(encoder, decoder, optimizer buffers, counts); ms/step mesh "
                f"{runs['mesh'][2]:.3f}, one device {runs['one'][2]:.3f}")
            out[name] = (runs["mesh"][2], runs["one"][2])
            del runs
            free_cuda()
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def synthetic_image_batch(ds, seed, items, dev):
    """``items`` items of ``ds`` from index ``seed·items`` as the step's
    batch on ``dev``: uint8 ``data`` and int32 ``labels``."""
    from vince_tpu_torch.data.loader import collate_video_batch

    hb = collate_video_batch([ds[(seed * items + i) % len(ds)] for i in range(items)])
    labels = hb.get("classifier_labels", hb.get("labels"))
    return {"data": torch.from_numpy(hb["data"]).to(dev),
            "labels": torch.from_numpy(np.asarray(labels, np.int32)).to(dev)}


def soak_options():
    """Phase 3's ResNet50 step (b = 128 = 32 videos x 4 frames, 224² from
    256², q = 65536, embeddings 128, bf16, fused InfoNCE, fold kernel) with
    sync-BN and the a2a shuffle, for ``SOAK_STEPS`` steps."""
    from vince_tpu_torch.tools.soak_multichip import SoakOptions

    return SoakOptions(steps=SOAK_STEPS, image=224, queue=65536, batch=BATCH_SIZE, num_frames=4,
                       embed=128, backbone="ResNet50", compute_dtype="bfloat16",
                       use_fused_infonce=True, fold_kernel=True, shuffle_mode="a2a")


def profile_soak_step(dev, mesh, opts, path):
    """Two warm-up steps, then one traced step, of the soak's step on
    ``mesh`` (None: one device); the table to ``path``."""
    from vince_tpu_torch.solvers.vince_step import (
        build_vince_optimizer, init_vince_state, make_train_step_fn)
    from vince_tpu_torch.tools import soak_multichip as soak

    cfg = soak.soak_config(opts)
    opt = build_vince_optimizer(soak.LR)
    state = init_vince_state(soak.SEED, cfg, opt, device=dev, mesh=mesh)
    step = make_train_step_fn(cfg, opt, mesh=mesh)
    batches = [(soak.global_batch(opts, i, dev),) for i in range(3)]
    for batch in batches[:2]:
        step(state, batch, 1)
    profile_step(step, state, batches[2], path)


def run_soak(dev, mesh, profile_path=None):
    """``tools/soak_multichip.py`` on the 1x1 mesh and on one device from one
    seed and one data stream, at the soak's tolerance; K1 1 and K2 26 a
    step; with ``profile_path``, one traced step of each. Returns the
    launches of the mesh's run and both runs' results."""
    from vince_tpu_torch.tools import soak_multichip

    opts = soak_options()
    log(f"phase 15, the soak: {SOAK_STEPS} eager steps of phase 3's ResNet50 step with "
        f"sync-BN and the a2a shuffle on {mesh}, then on one device, the same seed and data "
        f"(tools/soak_multichip.py)")
    results, launches = [], {}
    for m in (mesh, None):
        reset_counts()
        results.append(soak_multichip.run_mesh(opts, dev, m))
        counts = expect_counts(
            f"{SOAK_STEPS} soak steps ({'1x1' if m else 'one device'})",
            {n: v * SOAK_STEPS for n, v in TRAIN_PHASES["ResNet50"]["per_step"].items()})
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
        if profile_path:
            root, ext = os.path.splitext(profile_path)
            log(f"  the traced soak step ({'1x1' if m else 'one device'}):")
            profile_soak_step(dev, m, opts, f"{root}.soak_{'1x1' if m else 'one_device'}{ext}")
        free_cuda()
    if not soak_multichip.parity(results):
        fail("phase 15: the soak's trajectories part beyond the tolerance")
    log(f"  PARITY OK; ms/step 1x1 {results[0]['ms_per_step']:.3f}, one device "
        f"{results[1]['ms_per_step']:.3f}; losses {results[0]['losses'][0]:.5f} -> "
        f"{results[0]['losses'][-1]:.5f}")
    return launches, results


def run_audit(dev):
    """``tools/audit_collectives.py`` at a world of one: one warm-up and one
    profiled eager step of phase 3's ResNet50 step (a2a shuffle); its NCCL
    collectives against the analytic table, no queue bank moved. Returns the
    launches of the two steps and the result."""
    from vince_tpu_torch.tools import audit_collectives

    opts = audit_collectives.audit_options(False, use_fused_infonce=True, fold_kernel=True,
                                           shuffle_mode="a2a")
    log("phase 15, the audit: one eager step of phase 3's ResNet50 step (a2a) under "
        "torch.profiler on a 1x1 NCCL mesh (tools/audit_collectives.py)")
    reset_counts()
    result = audit_collectives.audit_rank(0, 1, 1, 1, opts, "cuda", device=dev)
    launches = expect_counts(
        "the audit's 2 steps",
        {n: v * 2 for n, v in TRAIN_PHASES["ResNet50"]["per_step"].items()})
    for line in audit_collectives.summary(result):
        log("  " + line)
    if result["problems"]:
        fail(f"phase 15: the audit found {result['problems']}")
    return launches, result


def viz_argv(tmp, *extra):
    """Phase 9's run's flags, for a visualization CLI with ``extra``: 2 loader
    workers, since a CLI reads its images from the dataset itself and its
    solver's loaders would only compete with it for the host."""
    return CLI_ARGV + PRETRAIN_RUN + ["--base-logdir", tmp, "--num-workers", "2", *extra]


def run_visualizations(card, tmp):
    """The three visualization CLIs at phase 9's flags: the attention grid on
    a 2-iteration ``--use-attention`` pretraining, the neighbour grid and the
    mosaic (with ``--with-tsne`` where the host has ``sklearn``) on phase 9's
    checkpoint; the neighbour grid's embeddings held to the embed step
    through the plain versions. Returns the launches and the numbers."""
    import importlib.util

    from vince_tpu_torch import arg_parser, solver_runner
    from vince_tpu_torch.data import get_dataset
    from vince_tpu_torch.ops.kernels import plain_versions
    from vince_tpu_torch.solvers.vince_solver import VinceSolver
    from vince_tpu_torch.visualizations import attention, dataset_mosaic, view_nearest_neighbors

    result, paths = {}, {}
    att = os.path.join(tmp, "phase15")
    att_argv = CLI_ARGV + ["--use-attention", "--title", "att", "--description", "resnet50",
                           "--base-logdir", att, "--epochs", "1", "--iterations-per-epoch", "2",
                           "--save-frequency", "2", "--synthetic-num-videos", "64"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(Tee(sys.stdout)):
        solver_runner.main(att_argv)
        free_cuda()
        written = [attention.main(att_argv + ["--num-images", "64", "--num-workers", "2",
                                              "--output-dir", os.path.join(tmp, "viz")])]
        free_cuda()
        out = ["--num-images", str(VIZ_IMAGES), "--output-dir", os.path.join(tmp, "viz")]
        written.append(view_nearest_neighbors.main(viz_argv(tmp, *out)))
        free_cuda()
        tsne = importlib.util.find_spec("sklearn") is not None
        written += dataset_mosaic.main(viz_argv(tmp, *out, *(["--with-tsne"] if tsne else [])))
    free_cuda()
    sizes = {os.path.basename(p): os.path.getsize(p) for p in written}
    if len(written) != 3 + int(tsne) or not all(sizes.values()):
        fail(f"phase 15: the visualization CLIs wrote {sizes}")
    log(f"phase 15, the visualization CLIs: wrote {sizes}; the mosaic "
        f"{'with' if tsne else 'without'} --with-tsne (sklearn "
        f"{'present' if tsne else 'absent on this host'}); {time.perf_counter() - t0:.1f} s")
    result["files"], result["tsne"] = sizes, tsne

    with contextlib.redirect_stdout(io.StringIO()):
        args = arg_parser.parse_args(viz_argv(tmp))
        solver = VinceSolver(args)
    try:
        ds = get_dataset(args.dataset)(args, "val")
        items = [ds[i] for i in range(VIZ_IMAGES)]  # read once: frames are drawn per read
        reset_counts()
        images, emb = view_nearest_neighbors.embed_dataset(solver, items, VIZ_IMAGES,
                                                           args.batch_size)
        torch.cuda.synchronize()
        launches, plain = read_counts()
        with plain_versions():
            _, ref = view_nearest_neighbors.embed_dataset(solver, items, VIZ_IMAGES,
                                                          args.batch_size)
    finally:
        solver.end()
    cos = (emb * ref).sum(1) / np.maximum(np.linalg.norm(emb, axis=1)
                                          * np.linalg.norm(ref, axis=1), 1e-12)
    log(f"  the neighbour grid's {len(emb)} embeddings (phase 9's checkpoint) against the "
        f"embed step through the plain versions: row cosine min {cos.min():.6f} (>= 0.9995); "
        f"launches {launches}, plain calls {plain} (eval-mode BN takes the unfused chain)")
    if cos.min() < 0.9995 or plain:
        fail("phase 15: the neighbour grid's embeddings disagree with the plain versions")
    paths["phase 15 visualizations, embed"] = launches
    result["cos_min"] = float(cos.min())
    return paths, result


def dist_end_task_argv(tmp, name):
    """Phase 10's run ``name`` for ``DIST_END_TASK_ITERATIONS`` iterations
    under ``tmp/phase15``, from phase 9's checkpoint."""
    spec = END_TASK_RUNS[name]
    return END_TASK_ARGV + spec["argv"] + [
        "--solver", spec["solver"], "--base-logdir", os.path.join(tmp, "phase15"),
        "--checkpoint-dir", os.path.join(tmp, "cli", "checkpoints_resnet50"),
        "--iterations-per-epoch", str(DIST_END_TASK_ITERATIONS),
        "--save-frequency", str(DIST_END_TASK_ITERATIONS)]


def run_dist_end_tasks(card, tmp):
    """The ImageNet probe and the Kinetics LSTM through ``solver_runner.main``
    with ``--distributed`` (the three explicit flags, a world of one over
    NCCL): 4 iterations, a save and the val pass from phase 9's checkpoint;
    then ``run_end_task_eval`` in one process restores each checkpoint and
    its val pass equals the distributed one. Returns the numbers."""
    from vince_tpu_torch import run_end_task_eval, solver_runner

    out = {}
    for name in ("ResNet50-IN-probe", "ResNet50-Kinetics"):
        spec = END_TASK_RUNS[name]
        argv = dist_end_task_argv(tmp, name)
        log(f"phase 15, {name} with --distributed: python -m vince_tpu_torch.solver_runner "
            f"{' '.join(argv)} {' '.join(dist_flags())}; then run_end_task_eval in one process")
        pretrain = read_pretrain(os.path.join(tmp, "cli", "checkpoints_resnet50"))
        reset_counts()
        t0 = time.perf_counter()
        with EndTaskRecord(pretrain, spec["val_items"]) as rec, \
                contextlib.redirect_stdout(Tee(sys.stdout)) as printed:
            solver = solver_runner.main(argv + dist_flags())
            train_s = time.perf_counter() - t0
            mesh = (solver.cfg.data_axis_size, solver.mesh is not None)
            del solver
            free_cuda()
            evaluated = run_end_task_eval.main(argv + ["--disable-dataloader"])
        launches, plain = read_counts()
        text = printed.getvalue()
        if f"distributed: process 0/1, backend {DIST_BACKEND}" not in text or mesh != (1, True):
            fail(f"phase 15, {name}: the run did not start its {DIST_BACKEND} group or built "
                 f"no mesh ({mesh})")
        if f"Restored end-task step {DIST_END_TASK_ITERATIONS}" not in text:
            fail(f"phase 15, {name}: run_end_task_eval did not restore the distributed run's "
                 f"step {DIST_END_TASK_ITERATIONS}")
        if len(rec.vals) != 2 or not rec.encoder_checks or not rec.encoder_checks[0]:
            fail(f"phase 15, {name}: {len(rec.vals)} val passes, encoder checks "
                 f"{rec.encoder_checks[:1]}")
        losses = [it["loss"] for it in rec.iterations]
        if len(losses) != DIST_END_TASK_ITERATIONS or not all(map(math.isfinite, losses)):
            fail(f"phase 15, {name}: losses {losses}")
        if launches or plain:
            fail(f"phase 15, {name}: launches {launches}, plain calls {plain}; none expected")
        dist_val, one_val = rec.vals
        if (dist_val["samples"], dist_val["batches"]) != (one_val["samples"], one_val["batches"]):
            fail(f"phase 15, {name}: val passes {dist_val} / {one_val}")
        for k, v in dist_val["results"].items():
            for got in (one_val["results"][k], evaluated[k]):
                if abs(got - v) > 5e-5 + 1e-5 * abs(v):
                    fail(f"phase 15, {name}: the one-process val pass's {k} {got} against the "
                         f"distributed one's {v}")
        log(f"  losses {losses[0]:.4f} ... {losses[-1]:.4f}; val passes (samples, batches, s) "
            f"distributed {dist_val['samples']}, {dist_val['batches']}, "
            f"{dist_val['seconds']:.2f}; one process after the restore "
            f"{one_val['samples']}, {one_val['batches']}, {one_val['seconds']:.2f}; results "
            f"equal (5e-5 + 1e-5·|v|): {dist_val['results']}; train {train_s:.1f} s; no launch; "
            f"card {card}")
        out[name] = dict(val=dist_val["results"], train_s=train_s,
                         seconds=time.perf_counter() - t0)
        free_cuda()
    return out


def run_dist_tracking(dev, card, tmp):
    """Tracking with ``--distributed`` (the explicit flags): 2 iterations, a
    save, the val pass; then, under a world of one, ``run_eval`` on the
    primary (the OTB fallback) of the restored state. Returns the numbers."""
    from vince_tpu_torch import arg_parser, solver_runner
    from vince_tpu_torch.solvers.end_task_solvers import EndTaskTrackingSolver

    import torch.distributed as dist

    argv = TRACKING_ARGV + ["--base-logdir", os.path.join(tmp, "phase15"), "--checkpoint-dir",
                            os.path.join(tmp, "trk", "checkpoints_resnet18")]
    for flag, value in (("--iterations-per-epoch", DIST_TRACKING_ITERATIONS),
                        ("--save-frequency", DIST_TRACKING_ITERATIONS)):
        argv[argv.index(flag) + 1] = str(value)
    log(f"phase 15, tracking with --distributed: python -m vince_tpu_torch.solver_runner "
        f"{' '.join(argv)} {' '.join(dist_flags())}; then run_eval on the primary of a world "
        f"of one")
    t0 = time.perf_counter()
    with EndTaskRecord(read_pretrain(os.path.join(tmp, "trk", "checkpoints_resnet18"))) as rec, \
            contextlib.redirect_stdout(Tee(sys.stdout)):
        solver = solver_runner.main(argv + dist_flags())
        val, mesh = (solver.last_val_samples, solver.last_val_batches), solver.mesh
        del solver
        free_cuda()
        start_world_of_one(dev)
        try:
            tracker = EndTaskTrackingSolver(arg_parser.parse_args(argv + ["--disable-dataloader"]))
            try:
                otb = tracker.run_eval()
            finally:
                tracker.end()
        finally:
            dist.destroy_process_group()
    losses = [it["loss"] for it in rec.iterations]
    if len(losses) != DIST_TRACKING_ITERATIONS or not all(map(math.isfinite, losses)):
        fail(f"phase 15, tracking: losses {losses}")
    batch = int(argv[argv.index("--batch-size") + 1])
    if mesh is None or val != (TRACKING_VAL_PAIRS, -(-TRACKING_VAL_PAIRS // batch)):
        fail(f"phase 15, tracking: mesh {mesh}, val pass (samples, batches) {val}")
    if not otb or not (0 <= otb["precision"] <= 1 and 0 <= otb["success"] <= 1):
        fail(f"phase 15, tracking: run_eval on the primary gave {otb}")
    log(f"  losses {losses}; val pass (samples, batches) {val}; run_eval on the primary: {otb}; "
        f"{time.perf_counter() - t0:.1f} s; card {card}")
    free_cuda()
    return dict(val=val, otb=otb, seconds=time.perf_counter() - t0)


def run_phase15(dev, card, tmp, profile_path=None):
    """Phase 15: at a world of one over NCCL the end-task step on a 1x1 mesh,
    the soak, the audit and the dry run; then the end tasks through the CLI
    with ``--distributed`` and their one-process restores, tracking's
    ``run_eval`` on the primary, and the visualization CLIs."""
    import torch.distributed as dist

    from vince_tpu_torch.tools import dryrun_multichip

    paths, result = {}, {}
    t0 = time.perf_counter()
    lap = Laps()
    result["laps"] = lap.seconds
    mesh = start_world_of_one(dev)
    try:
        result["steps"] = run_end_task_mesh_steps(dev, mesh)
        paths["phase 15 end-task step"] = {}
        lap("end-task step")
        soak_launches, soak = run_soak(dev, mesh, profile_path)
        paths[f"phase 15 soak 1x1 + one device, {SOAK_STEPS} steps each"] = soak_launches
        result["soak"] = {r["mesh"]: r["ms_per_step"] for r in soak}
        lap("soak")
        paths["phase 15 audit, 2 steps"], audit = run_audit(dev)
        result["audit"] = {}
        for c in audit["collectives"]:
            result["audit"][c["role"]] = result["audit"].get(c["role"], 0) + c["bytes"]
        reset_counts()
        line = dryrun_multichip.dryrun_multichip(1, device=dev)
        log(f"phase 15, the dry run at a world of one: {line}")
        if not line.endswith(" OK"):
            fail(f"phase 15: the dry run printed {line!r}")
        paths["phase 15 dry run"] = read_counts()[0]
        lap("audit, dry run")
    finally:
        dist.destroy_process_group()
    free_cuda()
    result["end_tasks"] = run_dist_end_tasks(card, tmp)
    paths["phase 15 end tasks --distributed"] = {}
    lap("end tasks --distributed")
    result["tracking"] = run_dist_tracking(dev, card, tmp)
    lap("tracking --distributed")
    viz_paths, result["viz"] = run_visualizations(card, tmp)
    paths.update(viz_paths)
    lap("visualizations")
    result["seconds"] = time.perf_counter() - t0
    return paths, result


def log_phase15(result, card):
    steps = ", ".join(f"{k} {m:.3f} / {o:.3f}" for k, (m, o) in result["steps"].items())
    log(f"phase 15 (world of one, NCCL): the end-task step 1x1 / one device ms/step: {steps}; "
        f"the soak ms/step {result['soak']}; audit bytes by role {result['audit']}; end tasks "
        f"--distributed " + ", ".join(f"{k} train {v['train_s']:.1f} s, {v['seconds']:.1f} s "
                                      f"with the eval" for k, v in result["end_tasks"].items())
        + f"; tracking {result['tracking']['seconds']:.1f} s, OTB {result['tracking']['otb']}; "
        f"visualizations {result['viz']['files']}, cosine min {result['viz']['cos_min']:.6f}; "
        f"phase 15 {result['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in result["laps"].items()) + f"); card {card}")


# phase 16: the data-production pipeline feeding pretraining. Videos written
# from the seed (MJPG, 640x360, what ``download_video`` fetches at
# ``max_height=360``) stand in for YouTube's: a downloader installed here
# copies one; nothing is fetched
PIPELINE = dict(videos=64, val_videos=16, missing=2, frames=90, hw=(360, 640), band=30,
                fps=30, seed=16, workers=8)
PIPELINE_ITERATIONS = 8
PIPELINE_MIN_CACHED = 48  # of the 64 train videos; the others filtered out (code 2 or 3)
SEEK_FRAMES = (3, 17, 42, 88)  # the frames that recreate_r2v2_dataset seek-decodes
KINETICS_SEGMENT = (0.5, 2.5)  # seconds of each clip, at download_kinetics' 10 fps
WEIGHTS_EMBED = 64  # ResNet18's released embedding size
DRIVE_PAGE = ('<!DOCTYPE html><html><body><form id="download-form" '
              'action="https://drive.usercontent.google.com/download" method="get">'
              '<input type="hidden" name="id" value="{id}"/>'
              '<input type="hidden" name="export" value="download"/>'
              '<input type="hidden" name="confirm" value="t"/></form></body></html>')


def scene_video(seed, frames, hw, band, speed=3):
    """RGB frames of a video of 2-3 scenes: each a tinted texture (blobs and
    pixel noise, blurred at sigma 0.8, sharp enough for the Laplacian filter)
    drifting 1-3 pixels a frame between black letterbox bands; the scenes'
    colour histograms part at each cut."""
    import cv2

    rng = np.random.RandomState(seed)
    h, w = hw
    scenes = 2 + rng.randint(2)
    cuts = sorted(rng.choice(np.arange(frames // 5, frames - frames // 5), scenes - 1,
                             replace=False))
    bounds = [0, *cuts, frames]
    inner, margin = h - 2 * band, frames * speed + 8
    out = []
    for s in range(scenes):
        tex = np.zeros((inner + margin, w + margin, 3), np.float32)
        for scale, amp in ((32, 1.0), (8, 0.6)):
            small = rng.rand((inner + margin) // scale + 2, (w + margin) // scale + 2, 3)
            big = cv2.resize(small.astype(np.float32), (w + margin + 2 * scale,
                                                        inner + margin + 2 * scale),
                             interpolation=cv2.INTER_CUBIC)
            tex += amp * big[scale:scale + inner + margin, scale:scale + w + margin]
        tex = (tex - tex.min()) / (tex.max() - tex.min())
        tex = 0.6 * tex + 0.4 * rng.rand(inner + margin, w + margin, 1).astype(np.float32)
        tint = rng.rand(3).astype(np.float32) * 0.6 + 0.4
        dy, dx = rng.randint(1, speed + 1, 2)
        for k in range(bounds[s + 1] - bounds[s]):
            img = np.zeros((h, w, 3), np.uint8)
            crop = tex[k * dy: k * dy + inner, k * dx: k * dx + w] * tint * 255
            img[band:band + inner] = np.clip(crop, 0, 255).astype(np.uint8)
            out.append(cv2.GaussianBlur(img, (0, 0), 0.8))
    return out


def write_video(path, frames, fps):
    """RGB frames into an MJPG ``.avi`` at ``fps``; returns ``path``."""
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    for frame in frames:
        writer.write(np.ascontiguousarray(frame[:, :, ::-1]))
    writer.release()
    if not os.path.getsize(path):
        raise RuntimeError(f"cv2.VideoWriter wrote nothing to {path}")
    return str(path)


def write_pipeline_videos(root):
    """``PIPELINE['videos']`` videos with 11-character ids, written by
    ``cv2.VideoWriter`` from a pool of threads; {id: path}."""
    import concurrent.futures

    p = PIPELINE
    os.makedirs(root, exist_ok=True)
    ids = [f"{'ABCDEFGH'[v % 8]}{'pqrs'[v % 4]}pipe{v:05d}" for v in range(p["videos"])]

    def write(v):
        return write_video(os.path.join(root, f"{ids[v]}.avi"), scene_video(
            p["seed"] * 1000 + v, p["frames"], p["hw"], p["band"]), p["fps"])

    with concurrent.futures.ThreadPoolExecutor(p["workers"]) as ex:
        return dict(zip(ids, ex.map(write, range(len(ids)))))


class LocalDownloads:
    """``youtube_utils.download_video`` while active: a fresh copy of the
    library's video (the tools remove what they are given), None for an id
    the library lacks; the ids asked for."""

    def __init__(self, library, root):
        import itertools

        self.library, self.root, self.asked = library, root, []
        self.serial = itertools.count()

    def __call__(self, video_id, *args, **kwargs):
        self.asked.append(video_id)
        if video_id not in self.library:
            return None
        dest = os.path.join(self.root, f"{next(self.serial)}_{video_id}.avi")
        return shutil.copy(self.library[video_id], dest)

    def __enter__(self):
        from vince_tpu_torch.utils import youtube_utils

        os.makedirs(self.root, exist_ok=True)
        self.original = youtube_utils.download_video
        youtube_utils.download_video = self
        return self

    def __exit__(self, *exc):
        from vince_tpu_torch.utils import youtube_utils

        youtube_utils.download_video = self.original


def cached_frames(split_dir):
    """{video id: frame count} of a cache split, from its shard directories."""
    counts = {}
    for shard in os.listdir(split_dir):
        sd = os.path.join(split_dir, shard)
        if len(shard) == 2 and os.path.isdir(sd):
            for name in os.listdir(sd):
                vid = name.rsplit("_", 1)[0]
                counts[vid] = counts.get(vid, 0) + 1
    return counts


def run_cacher(downloads, ids, missing, out, extra):
    """``cache_video_dataset.main`` on ``ids`` + ``missing`` into ``out``: the
    missing ids fail to download (code 1), each cached video has its 4
    frames (or 4 a shot) of at most 480 pixels a side, and a second run
    downloads nothing. Returns (cached {id: frames}, filtered-out ids, s)."""
    import cv2

    from vince_tpu_torch.scrape import cache_video_dataset

    csv_path = out + "_ids.csv"
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(csv_path, "w") as f:
        f.write("".join(f"{v}\n" for v in list(ids) + list(missing)))
    argv = ["--csv-path", csv_path, "--output-path", out, "--num-workers",
            str(PIPELINE["workers"])] + extra
    log(f"phase 16: python -m vince_tpu_torch.scrape.cache_video_dataset {' '.join(argv)}")
    t0 = time.perf_counter()
    failed, no_images = cache_video_dataset.main(argv)
    seconds = time.perf_counter() - t0
    cached = cached_frames(out)
    with open(os.path.join(out, "failed_video_ids.txt")) as f:
        failed_file = f.read().split()
    if sorted(failed) != sorted(missing) or sorted(failed_file) != sorted(missing):
        fail(f"phase 16: the failed downloads {failed} ({failed_file} in the file), expected "
             f"{missing}")
    if set(cached) | set(no_images) != set(ids) or set(cached) & set(no_images):
        fail(f"phase 16: {len(cached)} cached and {len(no_images)} filtered out of {len(ids)}")
    if not cached or any(n % 4 or (n != 4 and not extra) for n in cached.values()):
        fail(f"phase 16: frames per cached video {sorted(set(cached.values()))}")
    first = os.path.join(out, next(iter(cached))[:2])
    shape = cv2.imread(os.path.join(first, sorted(os.listdir(first))[0])).shape
    if max(shape[:2]) != 480:
        fail(f"phase 16: a cached frame of {shape}, expected a longer side of 480")
    downloads.asked.clear()
    again = cache_video_dataset.main(argv)
    if again != ([], []) or downloads.asked or cached_frames(out) != cached:
        fail(f"phase 16: the second run gave {again} and downloaded {downloads.asked}")
    log(f"  {len(cached)} of {len(ids)} cached ({sum(cached.values())} frames of {shape}), "
        f"{len(no_images)} filtered out, {len(failed)} failed downloads in {seconds:.1f} s; "
        f"the second run downloaded nothing")
    return cached, no_images, seconds


def pipeline_pretraining(card, tmp, data_path):
    """Phase 9's ResNet50 CLI from the cache: ``PIPELINE_ITERATIONS``
    iterations and the val pass through ``solver_runner.main``; the
    launches of each call (K1 1, K2 26 at the eager calls and the capture),
    finite losses, the meters."""
    from vince_tpu_torch import solver_runner

    argv = [a for a in CLI_ARGV]
    argv[argv.index("--dataset") + 1] = "R2V2Dataset"
    argv[argv.index("--iterations-per-epoch") + 1] = str(PIPELINE_ITERATIONS)
    argv += ["--data-path", data_path, "--title", "pipeline", "--description", "cache",
             "--base-logdir", tmp, "--epochs", "1", "--no-save"]
    log(f"phase 16, pretraining from the cache: python -m vince_tpu_torch.solver_runner "
        f"{' '.join(argv)}")
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with CliRecord() as rec, contextlib.redirect_stdout(Tee(sys.stdout)):
        solver_runner.main(argv)
    wall = time.perf_counter() - t0
    what = "pretraining from the cache"
    launches = check_cli_calls(what, rec, "ResNet50", PIPELINE_ITERATIONS, 1)
    (val,) = rec.of("run_val")
    out = dict(launches=launches, laps=report_laps(what, rec, card), wall_s=wall,
               val=(val["batches"], val["seconds"]),
               peak_gib=torch.cuda.max_memory_reserved() / 2**30)
    per_step = TRAIN_PHASES["ResNet50"]["per_step"]
    log(f"  {what}: launches {launches} ({per_step['queue_logsumexp']} K1 and "
        f"{per_step['affine_relu_dot_moments']} K2 a step at the eager calls and the capture, "
        f"the prefill's and the val pass's beside them); val pass {val['batches']} batches in "
        f"{val['seconds']:.3f} s; peak reserved {out['peak_gib']:.3f} GiB; {wall:.1f} s wall; "
        f"card {card}")
    free_cuda()
    return out


def seek_decoded(library, vid, frame, path):
    """cv2's seek-decode of ``frame``, scaled to 480 pixels a side, written by
    cv2.imwrite to ``path`` and read back (BGR)."""
    import cv2

    cap = cv2.VideoCapture(library[vid])
    cap.set(cv2.CAP_PROP_POS_FRAMES, frame)
    ok, image = cap.read()
    cap.release()
    if not ok:
        fail(f"phase 16: cv2 could not seek {vid} to frame {frame}")
    h, w = image.shape[:2]
    scale = 480 / max(h, w)
    cv2.imwrite(path, cv2.resize(image, (int(round(w * scale)), int(round(h * scale)))))
    return cv2.imread(path)


def run_other_tools(root, library, vids):
    """``recreate_r2v2_dataset``, ``download_kinetics`` and ``download_r2v2``
    on a few of the videos and on the cache: their files against cv2's
    seek-decode, the Kinetics reader, and the cache's bytes."""
    import argparse as ap
    import json as js
    import pathlib
    import tarfile

    import cv2

    from vince_tpu_torch.data.kinetics_dataset import Kinetics400Dataset
    from vince_tpu_torch.scrape import download_kinetics, download_r2v2, recreate_r2v2_dataset

    out = {}
    ids_file = os.path.join(root, "r2v2_ids.txt")
    with open(ids_file, "w") as f:
        f.write("".join(f"{v},{','.join(map(str, SEEK_FRAMES))}\n" for v in vids))
    rec_dir = os.path.join(root, "recreated")
    t0 = time.perf_counter()
    ok = recreate_r2v2_dataset.main(["--ids-file", ids_file, "--output-path", rec_dir,
                                     "--num-workers", "4"])
    for v in vids:
        for frame in SEEK_FRAMES:
            got = cv2.imread(os.path.join(rec_dir, v[:2], f"{v}_{frame:06d}.jpg"))
            if ok != len(vids) or got is None or not np.array_equal(
                    got, seek_decoded(library, v, frame, os.path.join(root, "seek.jpg"))):
                fail(f"phase 16: recreate_r2v2_dataset's {v} frame {frame} is not cv2's "
                     f"seek-decode of it ({ok} videos recreated)")
    out["recreate_s"] = time.perf_counter() - t0
    log(f"  recreate_r2v2_dataset: {len(vids)} videos x {len(SEEK_FRAMES)} frames, each equal "
        f"to cv2's seek-decode written by cv2.imwrite; {out['recreate_s']:.1f} s")

    kin = os.path.join(root, "kinetics")
    os.makedirs(os.path.join(kin, "annotations"))
    ann = {v: {"annotations": {"label": f"action_{i % 2}", "segment": list(KINETICS_SEGMENT)}}
           for i, v in enumerate(vids)}
    with open(os.path.join(kin, "annotations", "train.json"), "w") as f:
        js.dump(ann, f)
    t0 = time.perf_counter()
    ok = download_kinetics.main(["--annotation-json", os.path.join(kin, "annotations",
                                                                   "train.json"),
                                 "--output-path", os.path.join(kin, "train"),
                                 "--num-workers", "4"])
    frames = cached_frames(os.path.join(kin, "train"))
    ds = Kinetics400Dataset(ap.Namespace(data_path=kin, num_frames=4, input_width=224, seed=0),
                            "train", check_for_new_data=True)
    item = ds[0]
    clip = round((KINETICS_SEGMENT[1] - KINETICS_SEGMENT[0]) * 10)
    if ok != len(vids) or frames != {v: clip for v in vids} or len(ds) != len(vids) or \
            item is None or item["data"].shape != (4, CANVAS, CANVAS, 3):
        fail(f"phase 16: download_kinetics wrote {frames} ({ok} clips); the reader has "
             f"{len(ds)} clips, an item {None if item is None else item['data'].shape}")
    out["kinetics_s"] = time.perf_counter() - t0
    log(f"  download_kinetics: {len(vids)} clips x {clip} frames; Kinetics400Dataset reads "
        f"{len(ds)} clips, an item {item['data'].shape}; {out['kinetics_s']:.1f} s")

    t0 = time.perf_counter()
    tree = os.path.join(root, "r2v2", "train")
    tar_path = os.path.join(root, "r2v2_shard.tar")
    with tarfile.open(tar_path, "w") as tf:
        tf.add(tree, arcname="train")
    urls = os.path.join(root, "urls.txt")
    with open(urls, "w") as f:
        f.write(f"0000 {pathlib.Path(tar_path).resolve().as_uri()}\n")
    copy = os.path.join(root, "r2v2_copy")
    failed = download_r2v2.main(["--urls-file", urls, "--output-path", copy])
    want, got = tree_bytes(tree), tree_bytes(os.path.join(copy, "train"))
    if failed or got != want or sorted(os.listdir(copy)) != ["train"]:
        fail(f"phase 16: download_r2v2 failed {failed}; {len(got)} of {len(want)} files equal "
             f"to the cache's: {sorted(os.listdir(copy))}")
    out["r2v2_s"] = time.perf_counter() - t0
    log(f"  download_r2v2: a file:// tar of the cache ({os.path.getsize(tar_path) / 2**20:.1f} "
        f"MiB) extracted to {len(got)} files equal to the cache's; {out['r2v2_s']:.1f} s")
    return out


def tree_bytes(root):
    out = {}
    for dp, _, fs in os.walk(root):
        for name in fs:
            with open(os.path.join(dp, name), "rb") as f:
                out[os.path.relpath(os.path.join(dp, name), root)] = f.read()
    return out


class ScriptedOpener:
    """An opener for ``drive``: serves the payloads in order, records the URLs."""

    def __init__(self, payloads):
        self.payloads, self.urls = list(payloads), []

    def open(self, url):
        self.urls.append(url)
        return io.BytesIO(self.payloads.pop(0))


def run_weights_tool(dev, root, frames_dir, card):
    """``download_pretrained_weights --backbone ResNet18`` from a scripted
    Drive (the interstitial page, then a tar of a ResNet18 ``VinceModel``
    state dict from seed 0), converted into a checkpoint directory; a solver
    restores it on the card and its embed step's embeddings of 8 cached
    frames are held to the in-memory model's (cosine >= 1 - 1e-5)."""
    import tarfile
    import types

    import cv2

    from vince_tpu_torch import arg_parser
    from vince_tpu_torch.models.vince_model import VinceEncoder
    from vince_tpu_torch.scrape import download_pretrained_weights, drive
    from vince_tpu_torch.solvers.vince_solver import VinceSolver
    from vince_tpu_torch.solvers.vince_step import make_embed_fn
    from vince_tpu_torch.utils.torch_convert import export_vince_state_dict

    t0 = time.perf_counter()
    encoder = VinceEncoder("ResNet18", WEIGHTS_EMBED)
    encoder.reset_parameters(torch.Generator().manual_seed(0))
    weights = io.BytesIO()
    torch.save(export_vince_state_dict(encoder.state_dict()), weights)
    tar = io.BytesIO()
    with tarfile.open(fileobj=tar, mode="w") as tf:
        info = tarfile.TarInfo("vince_resnet18/vince_weights.pt")
        info.size = len(weights.getvalue())
        tf.addfile(info, io.BytesIO(weights.getvalue()))
    file_id = download_pretrained_weights.DRIVE_IDS["ResNet18"]
    opener = ScriptedOpener([DRIVE_PAGE.format(id=file_id).encode(), tar.getvalue()])
    original = drive._default_opener
    drive._default_opener = lambda: opener
    out_dir = os.path.join(root, "pretrained")
    try:
        with contextlib.redirect_stdout(Tee(sys.stdout)):
            ckpt = download_pretrained_weights.main(["--backbone", "ResNet18", "--output-path",
                                                     out_dir])
    finally:
        drive._default_opener = original
    if len(opener.urls) != 2 or not opener.urls[1].startswith(
            "https://drive.usercontent.google.com/download?") or file_id not in opener.urls[1]:
        fail(f"phase 16: download_pretrained_weights requested {opener.urls}")
    argv = ["--solver", "VinceSolver", "--backbone", "ResNet18", "--vince-embedding-size",
            str(WEIGHTS_EMBED), "--vince-queue-size", "65536", "--batch-size", "8",
            "--input-width", "224", "--input-height", "224", "--title", "weights",
            "--description", "resnet18", "--base-logdir", root, "--checkpoint-dir", ckpt]
    with contextlib.redirect_stdout(Tee(sys.stdout)) as printed:
        args = arg_parser.parse_args(argv)
        args.disable_dataloader = True
        solver = VinceSolver(args)
    try:
        if "Restored step 0" not in printed.getvalue():
            fail("phase 16: the solver did not restore the converted checkpoint")
        paths = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(frames_dir) for f in fs
                       if f.endswith(".jpg"))[:8]
        images = np.stack([cv2.resize(cv2.imread(p)[:, :, ::-1], (224, 224)) for p in paths])
        images = torch.from_numpy(images).to(dev)
        reset_counts()
        got, _ = solver.embed_fn(solver.state, images)
        launches, plain = read_counts()
        want, _ = make_embed_fn(solver.cfg)(types.SimpleNamespace(model=encoder.to(dev)),
                                            images)
    finally:
        solver.end()
    cos = torch.nn.functional.cosine_similarity(got.float(), want.float(), dim=1).cpu().numpy()
    if got.shape != (8, WEIGHTS_EMBED) or cos.min() < 1 - 1e-5 or plain:
        fail(f"phase 16: the restored embeddings {tuple(got.shape)} against the in-memory "
             f"model's: cosine min {cos.min()}, plain calls {plain}")
    seconds = time.perf_counter() - t0
    log(f"  download_pretrained_weights --backbone ResNet18: Drive's page, then a "
        f"{len(tar.getvalue()) / 2**20:.1f} MiB tar; converted into {os.path.basename(ckpt)}; "
        f"restored on the card, the embed step's embeddings of 8 cached frames against the "
        f"in-memory model's: cosine min {cos.min():.8f}; launches {launches}; {seconds:.1f} s; "
        f"card {card}")
    return launches, dict(cos_min=float(cos.min()), seconds=seconds)


def run_phase16(dev, card, tmp):
    """Phase 16: the videos, the cacher tool into an R2V2 tree (train, and val
    with ``--only-use-shots``), pretraining from it, then the other tools."""
    p = PIPELINE
    paths, result = {}, {}
    t0 = time.perf_counter()
    lap = Laps()
    laps = result["laps"] = lap.seconds
    root = os.path.join(tmp, "pipeline")
    library = write_pipeline_videos(os.path.join(root, "library"))
    lap("videos")
    log(f"phase 16: {len(library)} videos of {p['frames']} frames, {p['hw'][1]}x{p['hw'][0]} "
        f"MJPG at {p['fps']} fps, written from the seed in {laps['videos']:.1f} s")
    ids = sorted(library)
    missing = [f"Zzmissing{i:02d}" for i in range(p["missing"])]
    r2v2 = os.path.join(root, "r2v2")
    with LocalDownloads(library, os.path.join(root, "downloads")) as downloads:
        cached, no_images, _ = run_cacher(downloads, ids, missing, os.path.join(r2v2, "train"),
                                          [])
        if len(cached) < PIPELINE_MIN_CACHED:
            fail(f"phase 16: {len(cached)} of {len(ids)} videos cached, expected at least "
                 f"{PIPELINE_MIN_CACHED}")
        val_cached, val_out, _ = run_cacher(downloads, ids[:p["val_videos"]], [],
                                            os.path.join(r2v2, "val"), ["--only-use-shots"])
        result["cached"] = (len(cached), len(no_images), len(val_cached), len(val_out))
        lap("cacher")
        result["pretraining"] = pipeline_pretraining(card, tmp, r2v2)
        paths[f"phase 16 CLI ResNet50 from the cache, {PIPELINE_ITERATIONS} iterations"] = \
            result["pretraining"]["launches"]
        lap("pretraining")
        result["tools"] = run_other_tools(root, library, sorted(cached)[:4])
        lap("recreate, kinetics, r2v2")
    paths["phase 16 download_pretrained_weights, embed"], result["weights"] = run_weights_tool(
        dev, root, os.path.join(r2v2, "val"), card)
    lap("weights")
    if os.listdir(os.path.join(root, "downloads")):
        fail(f"phase 16: downloads left behind {os.listdir(os.path.join(root, 'downloads'))}")
    result["seconds"] = time.perf_counter() - t0
    return paths, result


def log_phase16(result, card):
    pre = result["pretraining"]
    laps = pre["laps"]
    log(f"phase 16 the pipeline: cached (train, filtered out, val, filtered out) "
        f"{result['cached']}; pretraining from the cache " + ", ".join(
            f"{m} {laps[m][0]:.3f} ms ({laps[m][1]:.3f}-{laps[m][2]:.3f})" for m in LAPS)
        + f", {laps['frames_per_s']:.2f} frames/s, launches {pre['launches']}, val (batches, s) "
        f"{pre['val']}, peak reserved {pre['peak_gib']:.3f} GiB; weights cosine min "
        f"{result['weights']['cos_min']:.8f}; phase 16 {result['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in result["laps"].items()) + f"); card {card}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the build and the kernel checks")
    parser.add_argument("--ptxas", action="store_true",
                        help="print ptxas register and shared-memory use")
    parser.add_argument("--profile", metavar="PATH",
                        help="after each phase's timed steps, trace one step and write "
                             "the device-time table to PATH with the backbone's (or the "
                             "head configuration's) name before its extension")
    parser.add_argument("--end-tasks-only", action="store_true",
                        help="build, a 2-iteration pretraining run in place of phase 9's, "
                             "then phases 10, 11 and 15 (no kernel checks, no result line)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from vince_tpu_torch.device import full_f32_products
    from vince_tpu_torch.ops.kernels import build

    full_f32_products()
    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    times = build.build_all(["queue_logsumexp", "affine_relu_dot_moments", "depthwise_conv",
                             "affine_conv3x3_stats", "jpeg_decode"], verbose=args.ptxas)
    log(f"build: {time.perf_counter() - t0:.1f} s wall ({times})")
    # phase 9's logs and checkpoints, kept until phase 10 has read them
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        if args.end_tasks_only:
            pretrain_for_end_tasks(tmp)
            for name, r in run_end_tasks(card, tmp)[1].items():
                log(f"phase 10 {name}: {r}; card {card}")
            log(f"phase 11 {TRACKING_NAME}: {run_tracking(card, tmp, args.profile)[1]}; "
                f"card {card}")
            log_phase15(run_phase15(dev, card, tmp, args.profile)[1], card)
            return
        run_phases(args, dev, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_phases(args, dev, card, tmp):
    """Phases 2-16, then the result lines."""
    lap = Laps()
    seconds = lap.seconds  # of each part, for the time limit of the whole script
    kernels = [check_queue_logsumexp(dev), check_affine_relu_dot_moments(dev),
               check_affine_conv3x3_stats(dev), *check_depthwise_conv(dev),
               *check_jpeg_kernels(dev)]
    kernels[0]["at_queue_shards"] = check_other_shapes(dev)
    lap("2 kernels")
    if not args.kernels_only:
        # each path is driven with the counts set to 0 just before its timed
        # steps and read just after; a kernel's launches are summed over the paths
        paths = {}  # launches of each path, by kernel
        times = {}
        for b in TRAIN_PHASES:
            eager = run_train(dev, b, profile_path=args.profile)
            paths[f"{b} eager, 5 steps"] = eager["launches"]
            state, captured = run_captured(dev, b, profile_path=args.profile)
            paths[f"{b} captured (at the capture)"] = captured["capture_launches"]
            for name, launches in run_eval_steps(dev, b, state).items():
                paths[f"{b} {name}"] = launches
            del state
            times[b] = (eager, captured)
            lap(f"3-6 {b}")
        _, lars = run_captured(dev, "ResNet50", kind="lars", timed=0)
        paths["ResNet50 captured LARS (at the capture)"] = lars["capture_launches"]
        paths["stand-alone op"] = {"affine_conv3x3_stats": run_conv_bn_op(dev)}
        paths["the old JPEG pair as stand-alone ops"] = run_jpeg_pair_ops(dev)
        lap("5 LARS, 7 K3's op, the old JPEG pair")
        head_paths, head_times = run_heads(dev, profile_path=args.profile)
        paths.update(head_paths)
        lap("8 heads")
        cli_paths, cli = run_cli(dev, card, tmp)
        paths.update(cli_paths)
        lap("9 CLI")
        end_paths, end_tasks = run_end_tasks(card, tmp)
        paths.update(end_paths)
        lap("10 end tasks")
        tracking_paths, tracking = run_tracking(card, tmp, args.profile)
        paths.update(tracking_paths)
        lap("11 tracking")
        dist_paths, distributed = run_distributed(dev, card, tmp,
                                                  times["ResNet50"][1]["ms_per_step"])
        paths.update(dist_paths)
        lap("12 distributed")
        phase13_paths, phase13 = run_phase13(dev, card, tmp)
        paths.update(phase13_paths)
        lap("13 remat, weights, retrieval")
        phase14_paths, phase14 = run_phase14(card, tmp)
        paths.update(phase14_paths)
        lap("14 files")
        phase15_paths, phase15 = run_phase15(dev, card, tmp, args.profile)
        paths.update(phase15_paths)
        lap("15 across processes")
        phase16_paths, phase16 = run_phase16(dev, card, tmp)
        paths.update(phase16_paths)
        lap("16 pipeline")
        for k in kernels:
            k["launches_by_path"] = {p: n[k["name"]] for p, n in paths.items() if k["name"] in n}
            k["launches"] = sum(k["launches_by_path"].values())
        for b, (eager, captured) in times.items():
            log(f"ms/step {b}: eager {eager['ms_per_step']:.3f} (peak {eager['peak_gib']:.3f} "
                f"GiB), captured {captured['ms_per_step']:.3f} (peak "
                f"{captured['peak_gib']:.3f} GiB); card {card}")
        for what, t in head_times.items():
            log(f"phase 8 {what}: " + ", ".join(
                f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}" for k, v in t.items())
                + f"; card {card}")
        for what, laps in (("epoch 1", cli["laps"]), ("resumed epoch 2", cli["resumed_laps"])):
            log(f"phase 9 {what}: " + ", ".join(
                f"{m} {laps[m][0]:.3f} ms ({laps[m][1]:.3f}-{laps[m][2]:.3f})" for m in LAPS)
                + f", {laps['frames_per_s']:.2f} frames/s; phase 5's captured ResNet50 step "
                f"{times['ResNet50'][1]['ms_per_step']:.3f} ms/step; card {card}")
        log(f"phase 9 val pass: {cli['val'][0]} batches, {cli['val'][1]:.3f} s; saves (step, host "
            f"copy s, disk write s) {cli['saves']}; peak reserved {cli['peak_gib']:.3f} GiB; "
            f"loader alone {cli['loader_ms']}, one video {cli['item_ms']:.3f} ms; card {card}")
        for name, r in end_tasks.items():
            laps = r["laps"]
            log(f"phase 10 {name}: " + ", ".join(
                f"{m} {laps[m][0]:.3f} ms ({laps[m][1]:.3f}-{laps[m][2]:.3f})"
                for m in END_TASK_LAPS)
                + f", {laps['frames_per_s']:.2f} frames/s; the step alone "
                f"{r['step_alone'][0]:.3f} ms; val passes (samples, batches, s) "
                f"{r['val']}; peak reserved {r['peak_gib']:.3f} GiB; train {r['train_s']:.1f} s, "
                f"with the eval {r['wall_s']:.1f} s wall; kernel launches {r['launches']}"
                + (f"; f32 step card/CPU loss {r['cpu_card'][0]}, update gap "
                   f"{r['cpu_card'][1]:.3e} (worst tensor {r['cpu_card'][2]:.3e})"
                   if "cpu_card" in r else "") + f"; card {card}")
        laps = tracking["laps"]
        log(f"phase 11 {TRACKING_NAME}: " + ", ".join(
            f"{m} {laps[m][0]:.3f} ms ({laps[m][1]:.3f}-{laps[m][2]:.3f})" for m in END_TASK_LAPS)
            + f", {laps['pairs_per_s']:.2f} pairs/s; the step alone "
            f"{tracking['step_alone'][0]:.3f} ms; one pair's crops "
            f"{tracking['host_ms']['pair']:.3f} ms; the loader alone "
            f"{tracking['host_ms']['loader pairs/s']:.2f} pairs/s; "
            f"val pass (samples, batches, s) {tracking['val']}; tracker "
            f"{tracking['tracker_fps']:.1f} frames/s; OTB fallback {tracking['eval']}; batched "
            f"against serial {tracking['batched_gap_px']:.3e} px; f32 step card/CPU loss "
            f"{tracking['cpu_card'][0]}, update gap {tracking['cpu_card'][1]:.3e}; fast_xcorr "
            f"card/CPU at the run's shape {tracking['xcorr'][0]}; peak reserved "
            f"{tracking['peak_gib']:.3f} GiB; train {tracking['train_s']:.1f} s, with the eval "
            f"{tracking['wall_s']:.1f} s wall; kernel launches {tracking['launches']}; card {card}")
        captured = distributed["captured"]
        laps = distributed["cli"]["laps"]
        log("phase 12 (world of one, NCCL, sync-BN): eager ms/step " + ", ".join(
            f"{mode} {r['dist']:.3f} against one device {r['one']:.3f}"
            for mode, r in distributed["eager"].items())
            + f"; captured a2a {captured['ms_per_step']:.3f} ms/step (peak "
            f"{captured['peak_gib']:.3f} GiB) against phase 5's "
            f"{times['ResNet50'][1]['ms_per_step']:.3f}; captured against eager: loss gap "
            f"{captured['loss_gap']:.3e}, update gap {captured['update_gap']:.3e}"
            + "; CLI " + ", ".join(
                f"{m} {laps[m][0]:.3f} ms ({laps[m][1]:.3f}-{laps[m][2]:.3f})" for m in LAPS)
            + f", {laps['frames_per_s']:.2f} frames/s, peak reserved "
            f"{distributed['cli']['peak_gib']:.3f} GiB, val (batches, s) "
            f"{distributed['cli']['val']}; card {card}")
        log_phase13(phase13, card)
        log_phase14(phase14, card)
        log_phase15(phase15, card)
        log_phase16(phase16, card)
    parts = {} if args.kernels_only else {"9": cli["seconds"], "14": phase14["parts"],
                                           "15": phase15["laps"]}
    log(f"seconds by phase: {seconds}, {sum(seconds.values()):.1f} in all after the build; "
        f"parts of phases 9, 14 and 15: {parts}; card {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
