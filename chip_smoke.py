"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # all phases (needs one CUDA device)
    python3 chip_smoke.py --kernels-only --ptxas   # build + kernel checks only

Phases:
  1. build every CUDA kernel of the port from ``vince_tpu_torch/csrc``;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes of the training step (forward and gradient), and time the kernel,
     the plain version and one PyTorch library call computing the same function;
     then hold the forward at a few shapes off the main path (ragged ones);
  3. run the VINCE pretraining step (ResNet50, batch 128 = 32 videos x 4 frames,
     224x224 crops of 256x256 uint8 canvases, queue 65536, embeddings 128,
     bf16, fused InfoNCE queue kernel and fused bn2->relu->conv3 kernel) for
     2 warm-up and 5 timed steps, counting each kernel's launches;
  4. run one more step from the same state and batch through the plain
     versions and compare the loss and the updated weights.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.
"""

import argparse
import copy
import json
import math
import os
import re
import subprocess
import sys
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


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` with a cold L2: before each timed call a
    256 MB buffer is zeroed, which evicts the 50 MB L2 (the main path reads
    the queue and the activations cold) and, at ~0.1 ms, lets the host enqueue
    ``fn`` before the start event is reached."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


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


def check_queue_logsumexp(dev):
    from vince_tpu_torch.ops.kernels import infonce_kernel as k1

    b, k, d, tau = 128, 65536, 128, 0.07
    g = torch.Generator(device=dev).manual_seed(0)
    norm = lambda x: x / x.norm(dim=-1, keepdim=True)
    q = norm(torch.randn(b, d, generator=g, device=dev))
    queue = norm(torch.randn(k, d, generator=g, device=dev))
    log(f"K1 queue_logsumexp: q [{b},{d}] f32, queue [{k},{d}] f32, tau={tau}")
    m, s, w = k1.queue_logsumexp_forward(q, queue, tau)
    m_r, s_r, w_r = k1._reference_queue_logsumexp(q, queue, tau)
    errs = [compare("m", m, m_r, 1e-5, 1e-6), compare("S", s, s_r, 1e-4, 1e-6),
            compare("W", w, w_r, 1e-4, 1e-5)]
    # gradient: the kernel's autograd Function against autograd through the
    # materialised logits (m detached, as in the loss)
    r = torch.rand(b, generator=g, device=dev)
    qk = q.clone().requires_grad_(True)
    (k1.queue_logsumexp(qk, queue, tau)[1] * r).sum().backward()
    qp = q.clone().requires_grad_(True)
    logits = qp @ queue.T / tau
    (torch.exp(logits - logits.max(-1, keepdim=True).values.detach()).sum(-1) * r).sum().backward()
    errs.append(compare("dq", qk.grad, qp.grad, 1e-4, 1e-5))

    def library():
        logits = q @ queue.T / tau
        return torch.logsumexp(logits, -1), torch.softmax(logits, -1) @ queue

    ms = time_ms(lambda: k1.queue_logsumexp_forward(q, queue, tau))
    plain_ms = time_ms(lambda: k1._reference_queue_logsumexp(q, queue, tau))
    library_ms = time_ms(library)
    bytes_moved = 4 * (b * d + k * d + 2 * b + b * d)
    ops = 4 * b * k * d + b * k  # two products of 2*b*k*d, plus one exp per logit
    bound_ms, bound_by = bound(bytes_moved, ops, F32_FLOPS)
    log(f"  times (cold L2): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, f32)")
    return {"name": "queue_logsumexp", "route": "cuda",
            "source": "vince_tpu_torch/csrc/queue_logsumexp.cu",
            "replaces": "vince_tpu/ops/pallas/infonce_kernel.py:88",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "check": "ok"}


# the three K2 sites of ResNet50 at batch 128, 224x224: (M, C, F)
K2_SHAPES = [(128 * 28 * 28, 128, 512), (128 * 14 * 14, 256, 1024), (128 * 7 * 7, 512, 2048)]
K2_SITES = [4, 6, 3]  # sites of each shape per forward


def check_affine_relu_dot_moments(dev):
    from vince_tpu_torch.ops.kernels import folded_dot_kernel as k2
    from vince_tpu_torch.ops.kernels import plain_versions

    g = torch.Generator(device=dev).manual_seed(1)
    errs, ms, plain_ms, library_ms, bound_ms = [], 0.0, 0.0, 0.0, 0.0
    bound_share = {"bytes": 0.0, "operations": 0.0}
    for (m, c, f), sites in zip(K2_SHAPES, K2_SITES):
        log(f"K2 affine_relu_dot_moments: y [{m},{c}] bf16, W [{c},{f}] (x{sites} sites)")
        y = torch.randn(m, c, generator=g, device=dev).bfloat16()
        a = torch.rand(c, generator=g, device=dev) + 0.5
        b = torch.randn(c, generator=g, device=dev) * 0.1
        w = torch.randn(c, f, generator=g, device=dev) * 0.05
        got = k2.affine_relu_dot_moments_forward(y, a, b, w)
        ref = k2._reference(y, a, b, w.bfloat16())
        errs += [compare("out", got[0], ref[0], 1.6e-2, 1e-3),
                 compare("s1", got[1], ref[1], 1e-4, 1e-6),
                 compare("s2", got[2], ref[2], 1e-4, 1e-6)]
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

        def library():
            xh = torch.relu(torch.addcmul(b, y, a)).bfloat16()
            return xh @ wb, xh.sum(0, dtype=torch.float32), xh.T @ xh

        t_k = time_ms(lambda: k2.affine_relu_dot_moments_forward(y, a, b, w))
        t_p = time_ms(lambda: k2._reference(y, a, b, wb))
        t_l = time_ms(library)
        bytes_moved = 2 * m * c + 8 * c + 2 * c * f + 2 * m * f + 4 * c + 4 * c * c
        ops = 2 * m * c * f + m * c * (c + 1)  # s2 is symmetric: its upper triangle
        t_b, by = bound(bytes_moved, ops, BF16_FLOPS)
        log(f"  times (cold L2): kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library "
            f"{t_l:.4f} ms, bound {t_b:.4f} ms ({by})")
        ms += sites * t_k
        plain_ms += sites * t_p
        library_ms += sites * t_l
        bound_ms += sites * t_b
        bound_share[by] += sites * t_b
    bound_by = max(bound_share, key=bound_share.get)  # what bounds most of the sum
    log(f"K2 per forward (13 sites): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms (mostly {bound_by})")
    # times summed over the 13 sites of one ResNet50 forward
    return {"name": "affine_relu_dot_moments", "route": "cuda",
            "source": "vince_tpu_torch/csrc/affine_relu_dot_moments.cu",
            "replaces": "vince_tpu/ops/pallas/folded_dot_kernel.py:96",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "per": "13 sites of one ResNet50 forward at batch 128, 224x224",
            "check": "ok"}


def check_other_shapes(dev):
    """Shapes off the main path, forward only: ragged B, K and D for K1, which
    masks them; rows that are not a multiple of the block and C that is not a
    power of two for K2."""
    from vince_tpu_torch.ops.kernels import folded_dot_kernel as k2
    from vince_tpu_torch.ops.kernels import infonce_kernel as k1

    g = torch.Generator(device=dev).manual_seed(2)
    for b, k, d in [(37, 1000, 72)]:
        log(f"K1 at q [{b},{d}], queue [{k},{d}]")
        q = torch.nn.functional.normalize(torch.randn(b, d, generator=g, device=dev), dim=-1)
        queue = torch.nn.functional.normalize(torch.randn(k, d, generator=g, device=dev), dim=-1)
        for name, x, r in zip("mSW", k1.queue_logsumexp_forward(q, queue, 0.07),
                              k1._reference_queue_logsumexp(q, queue, 0.07)):
            compare(name, x, r, 1e-4, 1e-5)
    for m, c, f in [(200, 128, 256), (200, 384, 256), (130, 768, 128)]:
        log(f"K2 at y [{m},{c}], W [{c},{f}]")
        y = torch.randn(m, c, generator=g, device=dev).bfloat16()
        a = torch.rand(c, generator=g, device=dev) + 0.5
        b = torch.randn(c, generator=g, device=dev) * 0.1
        w = torch.randn(c, f, generator=g, device=dev) * 0.05
        got = k2.affine_relu_dot_moments_forward(y, a, b, w)
        ref = k2._reference(y, a, b, w.bfloat16())
        compare("out", got[0], ref[0], 1.6e-2, 1e-3)
        compare("s1", got[1], ref[1], 1e-4, 1e-6)
        compare("s2", got[2], ref[2], 1e-4, 1e-6)


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
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"one step: {wall:.3f} ms wall, {busy_us / 1e3:.3f} ms device busy\n")
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=80))
    log(f"  profile: {wall:.3f} ms wall, {busy_us / 1e3:.3f} ms device busy, "
        f"busy share {busy_us / 1e3 / wall:.3f}, {len(spans)} kernels; table in {path}")
    for e in prof.key_averages():  # the port's own kernels
        own = re.search(r"(ardm|qlse)_\w+", e.key)
        if own and e.device_type == torch.autograd.DeviceType.CUDA:
            log(f"    {own.group(0)}: {e.count} launches, "
                f"{e.self_device_time_total / 1e3:.3f} ms")


def run_train(dev, steps=5, warmup=2, profile_path=None):
    from vince_tpu_torch.ops.kernels import plain_versions
    from vince_tpu_torch.ops.kernels.folded_dot_kernel import affine_relu_dot_moments
    from vince_tpu_torch.ops.kernels.infonce_kernel import queue_logsumexp
    from vince_tpu_torch.solvers.vince_step import (
        SourceSpec, VinceConfig, build_vince_optimizer, init_vince_state, make_train_step_fn)

    batch_size, canvas = 128, 256
    cfg = VinceConfig(
        sources=(SourceSpec("YT", batch_size=batch_size, num_frames=4,
                            transform="StandardVideoTransform", source_id=1),),
        backbone="ResNet50", embed_size=128, image_size=224, queue_size=65536,
        temperature=0.07, momentum=0.999, compute_dtype=torch.bfloat16, shuffle_bn=True,
        bn_fold="expand", jitter_order="torchvision", use_fused_infonce=True,
        fold_kernel=True)
    opt = build_vince_optimizer(0.03)
    log("train: ResNet50 b=128 (32 videos x 4 frames) 224x224 from 256x256 uint8, "
        "q=65536, embed 128, bf16, fused InfoNCE + fold kernel, SGD lr 0.03")
    state = init_vince_state(0, cfg, opt, device=dev)
    step = make_train_step_fn(cfg, opt)
    host = np.random.RandomState(0).randint(0, 256, (batch_size, canvas, canvas, 3), np.uint8)
    batch = ({"data": torch.from_numpy(host).to(dev),
              "queue_data": torch.from_numpy(host[::-1].copy()).to(dev)},)
    for i in range(warmup):
        state, metrics = step(state, batch, 0)
        log(f"  warm-up step {i}: loss {metrics['loss/total_loss'].item():.6f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    queue_logsumexp.launches = 0
    affine_relu_dot_moments.launches = 0
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, 0)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss/total_loss"])
    launches = {"queue_logsumexp": queue_logsumexp.launches,
                "affine_relu_dot_moments": affine_relu_dot_moments.launches}
    losses = [float(x) for x in losses]
    for i, loss in enumerate(losses):
        log(f"  step {i}: loss {loss:.6f}")
    ms_step = float(np.median(step_ms))
    log(f"  {ms_step:.3f} ms/step (median of {steps}; each: "
        f"{', '.join(f'{t:.3f}' for t in step_ms)}), {batch_size / ms_step * 1e3:.2f} frames/s, "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    log(f"  launches in {steps} steps: {launches}")
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite loss")
    expected = {"queue_logsumexp": steps, "affine_relu_dot_moments": 26 * steps}
    if launches != expected:
        fail(f"launch counts {launches}, expected {expected} (1 K1 and 2 x 13 K2 per step)")
    if profile_path:
        profile_step(step, state, batch, profile_path)
    qn = state.queue.vectors.norm(dim=-1)
    if not bool(torch.isfinite(qn).all()) or (qn - 1).abs().max().item() > 1e-3:
        fail("queue rows are not unit vectors after the enqueues")

    # one more step from the same state and batch: kernels vs plain versions
    log("plain-version check: one step from the same state through the kernels and "
        "through the plain versions")
    s_kernel, s_plain = copy.deepcopy(state), copy.deepcopy(state)
    before = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    _, m_k = step(s_kernel, batch, 1)
    with plain_versions():
        _, m_p = step(s_plain, batch, 1)
    loss_k, loss_p = m_k["loss/total_loss"].item(), m_p["loss/total_loss"].item()
    num = den = 0.0
    pk = dict(s_kernel.model.named_parameters())
    for name, p in s_plain.model.named_parameters():
        dk, dp = pk[name] - before[name], p - before[name]
        num += float(((dk - dp) ** 2).sum().detach())
        den += float((dp ** 2).sum().detach())
    upd_err = math.sqrt(num / max(den, 1e-30))
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"  loss kernel {loss_k:.6f} plain {loss_p:.6f} (rel {loss_rel:.3e}, tol 1e-2); "
        f"|update_kernel - update_plain| / |update_plain| = {upd_err:.3e} (tol 5e-2)")
    if loss_rel > 1e-2 or upd_err > 5e-2:
        fail("the kernel step and the plain-version step disagree")
    return {"ms_per_step": ms_step, "launches": launches}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the build and the kernel checks")
    parser.add_argument("--ptxas", action="store_true",
                        help="print ptxas register and shared-memory use")
    parser.add_argument("--profile", metavar="PATH",
                        help="after the timed steps, trace one step and write the "
                             "device-time table to PATH")
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
    times = build.build_all(["queue_logsumexp", "affine_relu_dot_moments"], verbose=args.ptxas)
    log(f"build: {time.perf_counter() - t0:.1f} s wall ({times})")

    kernels = [check_queue_logsumexp(dev), check_affine_relu_dot_moments(dev)]
    check_other_shapes(dev)
    if not args.kernels_only:
        train = run_train(dev, profile_path=args.profile)
        for k in kernels:
            k["launches"] = train["launches"][k["name"]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
