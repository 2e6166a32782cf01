"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # all phases (needs one CUDA device)
    python3 chip_smoke.py --kernels-only --ptxas   # build + kernel checks only

Phases:
  1. build every CUDA kernel of the port from ``vince_tpu_torch/csrc``;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes of the training step (forward and gradient), and time the kernel,
     the plain version and one PyTorch library call computing the same function;
     then hold the forward at a few shapes off the main path (ragged ones);
  3. run the VINCE pretraining step (batch 128 = 32 videos x 4 frames, 224x224
     crops of 256x256 uint8 canvases, queue 65536, embeddings 128, bf16, fused
     InfoNCE queue kernel) for 2 warm-up and 5 timed steps, counting each
     kernel's launches, once with a ResNet50 (fused bn2->relu->conv3 kernel)
     and once with an EfficientNet-B0 (depthwise kernel, forward and dgrad);
  4. after each, run one more step from the same state and batch through the
     plain versions and compare the loss and the updated weights;
  5. call the stand-alone op ``affine_conv3x3_stats`` (no model uses it),
     forward and backward, at its three shapes.

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


def launch_ms(fn, iters=10):
    """Mean device time of each kernel that ``fn`` launches once per call, by
    kernel name (its first word that ends in ``_kernel``), from a
    torch.profiler trace of ``iters`` calls, each after the flush of
    ``time_ms``; the flush's own kernels are left out by name. Raises if a
    kernel's launches in the trace are not ``iters``."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(prof):
        return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        flush.zero_()
        torch.cuda.synchronize()
    flush_names = {e.name for e in kernels(prof)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            for _ in range(4):
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    spans = {}
    for e in kernels(prof):
        if e.name not in flush_names:
            short = re.search(r"\w+_kernel", e.name)
            spans.setdefault(short.group(0) if short else e.name, []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    for name, times in spans.items():
        if len(times) != iters:
            raise RuntimeError(f"{name}: {len(times)} launches in {iters} calls")
    return {name: sum(times) / iters for name, times in spans.items()}


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


def same_bits(name, first, second):
    """Two calls on the same inputs give the same bits (fixed-order sums)."""
    if not all(torch.equal(x, y) for x, y in zip(first, second)):
        fail(f"{name} differs between two calls on the same inputs")
    log(f"  {name}: bit-identical in two calls")


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
    """Shapes off the main path: ragged B, K and D for K1, which masks them;
    rows that are not a multiple of the block, C that is not a power of two,
    C = 1152 and 2048 for K2, and the bottleneck of stage 4 at four times the
    width (C = 2048) through the module; odd N, H != W, C % 8 != 0, odd
    C, f32 and shapes that cross the tile's edges for K4 (forward, dx and dw);
    ragged tiles, two column tiles and F that is no multiple of 8 for K3."""
    from vince_tpu_torch.models.resnet import Bottleneck
    from vince_tpu_torch.ops.kernels import conv_bn_kernel as k3
    from vince_tpu_torch.ops.kernels import depthwise_kernel as k4
    from vince_tpu_torch.ops.kernels import folded_dot_kernel as k2
    from vince_tpu_torch.ops.kernels import infonce_kernel as k1
    from vince_tpu_torch.ops.kernels import plain_versions

    g = torch.Generator(device=dev).manual_seed(2)
    for b, k, d in [(37, 1000, 72)]:
        log(f"K1 at q [{b},{d}], queue [{k},{d}]")
        q = torch.nn.functional.normalize(torch.randn(b, d, generator=g, device=dev), dim=-1)
        queue = torch.nn.functional.normalize(torch.randn(k, d, generator=g, device=dev), dim=-1)
        for name, x, r in zip("mSW", k1.queue_logsumexp_forward(q, queue, 0.07),
                              k1._reference_queue_logsumexp(q, queue, 0.07)):
            compare(name, x, r, 1e-4, 1e-5)
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


def run_train(dev, backbone, steps=5, warmup=2, profile_path=None):
    from vince_tpu_torch.ops.kernels import plain_versions
    from vince_tpu_torch.ops.kernels.conv_bn_kernel import affine_conv3x3_stats
    from vince_tpu_torch.ops.kernels.depthwise_kernel import depthwise_conv, depthwise_wgrad
    from vince_tpu_torch.ops.kernels.folded_dot_kernel import affine_relu_dot_moments
    from vince_tpu_torch.ops.kernels.infonce_kernel import queue_logsumexp
    from vince_tpu_torch.solvers.vince_step import (
        SourceSpec, VinceConfig, build_vince_optimizer, init_vince_state, make_train_step_fn)

    phase = TRAIN_PHASES[backbone]
    wrappers = {"queue_logsumexp": queue_logsumexp,
                "affine_relu_dot_moments": affine_relu_dot_moments,
                "depthwise_conv": depthwise_conv, "depthwise_wgrad": depthwise_wgrad}
    batch_size, canvas = 128, 256
    cfg = VinceConfig(
        sources=(SourceSpec("YT", batch_size=batch_size, num_frames=4,
                            transform="StandardVideoTransform", source_id=1),),
        backbone=backbone, embed_size=128, image_size=224, queue_size=65536,
        temperature=0.07, momentum=0.999, compute_dtype=torch.bfloat16, shuffle_bn=True,
        bn_fold="expand", jitter_order="torchvision", use_fused_infonce=True,
        **phase["options"])
    opt = build_vince_optimizer(0.03)
    log(f"train: {backbone} b=128 (32 videos x 4 frames) 224x224 from 256x256 uint8, "
        f"q=65536, embed 128, bf16, {phase['label']}, SGD lr 0.03")
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

    for w in (*wrappers.values(), affine_conv3x3_stats):
        w.launches = w.plain_calls = 0
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, 0)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss/total_loss"])
    launches = {name: w.launches for name, w in wrappers.items()}
    plain_calls = sum(w.plain_calls for w in wrappers.values())
    losses = [float(x) for x in losses]
    for i, loss in enumerate(losses):
        log(f"  step {i}: loss {loss:.6f}")
    ms_step = float(np.median(step_ms))
    log(f"  {ms_step:.3f} ms/step (median of {steps}; each: "
        f"{', '.join(f'{t:.3f}' for t in step_ms)}), {batch_size / ms_step * 1e3:.2f} frames/s, "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    log(f"  launches in {steps} steps: {launches}; plain calls: {plain_calls}")
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite loss")
    expected = {name: n * steps for name, n in phase["per_step"].items()}
    if launches != expected or plain_calls != 0:
        fail(f"launch counts {launches} with {plain_calls} plain calls, expected {expected} "
             f"and none ({phase['why']})")
    if profile_path:
        root, ext = os.path.splitext(profile_path)
        profile_step(step, state, batch, f"{root}.{backbone}{ext}")
    qn = state.queue.vectors.norm(dim=-1)
    if not bool(torch.isfinite(qn).all()) or (qn - 1).abs().max().item() > 1e-3:
        fail("queue rows are not unit vectors after the enqueues")

    # one more step from the same state and batch: kernels vs plain versions.
    # bf16 with sums in another order: loss within 1e-2 relative, weight update
    # within 5e-2 relative in norm
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


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the build and the kernel checks")
    parser.add_argument("--ptxas", action="store_true",
                        help="print ptxas register and shared-memory use")
    parser.add_argument("--profile", metavar="PATH",
                        help="after each phase's timed steps, trace one step and write "
                             "the device-time table to PATH with the backbone's name "
                             "before its extension")
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
                             "affine_conv3x3_stats"], verbose=args.ptxas)
    log(f"build: {time.perf_counter() - t0:.1f} s wall ({times})")

    kernels = [check_queue_logsumexp(dev), check_affine_relu_dot_moments(dev),
               check_affine_conv3x3_stats(dev), *check_depthwise_conv(dev)]
    check_other_shapes(dev)
    if not args.kernels_only:
        # each path is driven with the counts set to 0 just before its timed
        # steps and read just after; a kernel's launches are summed over the paths
        trains = {b: run_train(dev, b, profile_path=args.profile) for b in TRAIN_PHASES}
        op_launches = run_conv_bn_op(dev)
        for k in kernels:
            by_path = {b: t["launches"].get(k["name"], 0) for b, t in trains.items()}
            if k["name"] == "affine_conv3x3_stats":
                by_path["stand-alone op"] = op_launches
            k["launches"] = sum(by_path.values())
            k["launches_by_path"] = by_path
        log("ms/step: " + ", ".join(f"{b} {t['ms_per_step']:.3f}" for b, t in trains.items()))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
