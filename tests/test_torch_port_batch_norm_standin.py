"""``vince_tpu_torch/csrc/batch_norm.cu`` on the host: the whole source (the
kernels and their C entry points) compiled by ``g++`` under
``torch_port_jpeg_standin_src/emulate.h`` (one thread per CUDA thread, the
blocks in turn), each ``<<<...>>>`` launch rewritten as an emulated one, and
loaded in place of ``build.load("batch_norm")``. So the wrapper's card path
(``ops/kernels/batch_norm_kernel.py``: layouts, vector widths, the
autograd function, the launches) runs on CPU tensors and is held to the plain
version, as ``chip_smoke.py`` holds the card's build."""

import ctypes
import functools
import os
import re
import shutil
import subprocess
import tempfile
import types

import numpy as np
import pytest
import torch

from vince_tpu_torch.ops.kernels import batch_norm_kernel as bnk
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, os.pardir, "vince_tpu_torch", "csrc", "batch_norm.cu")
EMULATE = os.path.join(HERE, "torch_port_jpeg_standin_src")
SMS = 4  # the stand-in card's SMs: a handful of slabs a grid
PRELUDE = r"""
#include "emulate.h"
#include <math.h>
#undef __shared__
#define __shared__ static  // one buffer for the block's threads; blocks run in turn
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class K>
static cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 4;
  return cudaSuccess;
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
template <class F>
static void launch_cfg(dim3 grid, unsigned threads, int, cudaStream_t, F body) {
  launch(grid.x, grid.y, threads, body);
}
static inline long long min(long long a, long long b) { return a < b ? a : b; }
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
struct __nv_bfloat16 {
  uint16_t bits;
};
static inline float __bfloat162float(__nv_bfloat16 v) {
  uint32_t u = (uint32_t)v.bits << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
static inline __nv_bfloat16 __float2bfloat16_rn(float f) {  // round to nearest even
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
"""


def _emulated_launches(text: str) -> str:
    """Each ``kernel<<<config>>>(args);`` as ``launch_cfg(config, [&] { kernel(args); });``."""
    out, i = [], 0
    while (j := text.find("<<<", i)) >= 0:
        start = text.rfind("\n", 0, j) + 1
        start += len(text[start:j]) - len(text[start:j].lstrip())
        end = text.index(">>>", j)
        depth, k = 0, end + 3
        while True:
            depth += {"(": 1, ")": -1}.get(text[k], 0)
            k += 1
            if depth == 0:
                break
        assert text[k] == ";", text[start:k + 1]
        out.append(text[i:start] + f"launch_cfg({text[j + 3:end]}, [&] "
                   f"{{ {text[start:j]}{text[end + 3:k]}; }});")
        i = k + 1
    return "".join(out) + text[i:]


@functools.lru_cache(maxsize=None)
def _standin():
    """The source built for the host and loaded, or None without ``g++``."""
    if shutil.which("g++") is None:
        return None
    text = open(SOURCE).read()
    text = re.sub(r"#include <cuda[_a-z0-9]*\.h>\n", "", text)
    out = tempfile.mkdtemp(prefix="bn_standin_")
    cpp, lib = os.path.join(out, "standin.cpp"), os.path.join(out, "libstandin.so")
    with open(cpp, "w") as f:
        f.write(PRELUDE + _emulated_launches(text))
    done = subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                           "-pthread", "-I", EMULATE, "-o", lib, cpp],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"g++ failed on the stand-in:\n{done.stderr}")
    return ctypes.CDLL(lib)


@pytest.fixture
def card(monkeypatch):
    """The wrapper's card path on CPU tensors, through the stand-in."""
    lib = _standin()
    if lib is None:
        pytest.skip("no g++ here to build the stand-in of batch_norm.cu")
    monkeypatch.setattr(bnk.build, "load", lambda name: lib)
    monkeypatch.setattr(bnk, "use_kernel", lambda t: True)
    monkeypatch.setattr(bnk, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    bnk._entries.cache_clear()
    bnk._ctas_per_sm.cache_clear()
    yield
    bnk._entries.cache_clear()
    bnk._ctas_per_sm.cache_clear()


def _inputs(m, c, dtype, residual, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(m, c, generator=g) * (torch.rand(c, generator=g) + 0.5)
         + torch.randn(c, generator=g)).to(dtype)
    res = torch.randn(m, c, generator=g).to(dtype) if residual else None
    w = torch.rand(c, generator=g) + 0.5
    b = torch.randn(c, generator=g) * 0.1
    cot = torch.randn(m, c, generator=g)
    running = (torch.randn(c, generator=g) * 0.1, torch.rand(c, generator=g) + 0.5)
    return x, res, w, b, cot, running


def _call(x, res, w, b, relu, running, dtype, cot, group=None):
    """(out, mean, var) and the gradients of x, w, b and the residual."""
    leaves = [t.clone().requires_grad_(True) if t is not None else None for t in (x, w, b, res)]
    y, mean, var = bnk.batch_norm(leaves[0], leaves[1], leaves[2], 1e-5, running=running,
                                  group=group, relu=relu, residual=leaves[3], dtype=dtype)
    y.backward(cot.to(y.dtype))
    return (y.detach(), mean, var), [t.grad if t is not None else None for t in leaves]


def _close(got, ref, rtol, atol_frac):
    got, ref = got.detach().float().numpy(), ref.detach().float().numpy()
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_frac * np.abs(ref).max())


CASES = {  # (M, C, input dtype, output dtype): the vector widths 8, 4 and 1
    "bf16-c64": (200, 64, torch.bfloat16, None),
    "f32-to-bf16-c64": (150, 64, torch.float32, torch.bfloat16),
    "f32-c48": (130, 48, torch.float32, None),
    "bf16-c20": (90, 20, torch.bfloat16, None),
    "f32-c13": (70, 13, torch.float32, None),
    "bf16-c520": (40, 520, torch.bfloat16, None),  # two channel tiles
}


# every case with each epilogue, but a residual only where the output keeps x's dtype
PARAMS = [(case, epilogue) for case, (_, _, _, out) in CASES.items()
          for epilogue in ("none", "relu", "residual_relu")
          if epilogue != "residual_relu" or out is None]


def _f64_grads(x, res, w, b, running, cot):
    """The gradients of x, w, b and the residual in float64, of BatchNorm (+
    residual) without the ReLU, for the cotangent ``cot`` (the ReLU's mask in
    it): the reference of the backward, which in float32 composed ops (the
    plain version's) can miss by a few bf16 ulps where its terms cancel."""
    leaves = [t.double().requires_grad_(True) if t is not None else None for t in (x, w, b, res)]
    x64, w64, b64, r64 = leaves
    if running is None:
        mean = x64.mean(0)
        var = torch.clamp((x64 * x64).mean(0) - mean * mean, min=0.0)
    else:
        mean, var = (t.double() for t in running)
    y = (x64 - mean) * (torch.rsqrt(var + 1e-5) * w64) + b64
    (y if r64 is None else y + r64).backward(cot.double())
    return [t.grad if t is not None else None for t in leaves]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case,epilogue", PARAMS)
def test_the_kernels_against_the_plain_version(card, case, epilogue, train):
    """The launches, forward and backward: the moments at rtol 1e-5 and y
    within one ulp of its type against the plain version; dx within one ulp of
    its type (1e-4 in f32), dweight and dbias at 1e-4 against float64, given
    the kernels' ReLU mask (a value within an ulp of 0 may round to either
    side); the residual's gradient is the masked cotangent, bit for bit."""
    m, c, dtype, out = CASES[case]
    relu, residual = epilogue != "none", epilogue == "residual_relu"
    x, res, w, b, cot, stats = _inputs(m, c, dtype, residual)
    running = None if train else stats
    before = bnk.batch_norm.launches, bnk.batch_norm.plain_calls
    (y, mean, var), grads = _call(x, res, w, b, relu, running, out, cot)
    assert bnk.batch_norm.plain_calls == before[1]
    assert bnk.batch_norm.launches - before[0] == (3 if train else 1) + 3
    yp, mp, vp = bnk._plain(x, w, b, 1e-5, running, None, relu, res, out or x.dtype)
    ulp = 2.0 ** -7 if y.dtype == torch.bfloat16 else 1e-5
    _close(mean, mp, 1e-5, 1e-6)
    _close(var + mean * mean, vp + mp * mp, 1e-5, 1e-6)
    if residual:
        err = (y.float() - yp.float()).abs()
        assert bool((err <= ulp * ((yp.float() - res.float()).abs() + yp.float().abs())
                     + 1e-6).all())
    else:
        _close(y, yp, ulp, 1e-6)
    g = cot.to(y.dtype).float() * ((y > 0) if relu else 1)
    ref = _f64_grads(x, res, w, b, running, g)
    _close(grads[0], ref[0], 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4, 1e-5)
    _close(grads[1], ref[1], 1e-4, 1e-5)
    _close(grads[2], ref[2], 1e-4, 1e-5)
    if residual:
        assert torch.equal(grads[3], g.to(res.dtype))


def test_sync_bn_at_a_world_of_one_is_the_single_device_call(card, monkeypatch):
    """With a group (its sum the identity, of one member) the moments and the
    gradient sums take a second finishing launch each way, bit for bit the
    call without one."""
    monkeypatch.setattr(bnk, "psum", lambda t, group: t.clone())
    monkeypatch.setattr(bnk, "group_size", lambda group: 1)
    x, res, w, b, cot, _ = _inputs(120, 64, torch.bfloat16, True, seed=3)
    alone = _call(x, res, w, b, True, None, None, cot)
    before = bnk.batch_norm.launches
    synced = _call(x, res, w, b, True, None, None, cot, group=object())
    assert bnk.batch_norm.launches - before == 8
    for a, s in zip([*alone[0], *alone[1]], [*synced[0], *synced[1]]):
        assert torch.equal(a, s)


def test_two_calls_give_the_same_bits(card):
    x, res, w, b, cot, _ = _inputs(300, 64, torch.bfloat16, True, seed=5)
    first, second = (_call(x, res, w, b, True, None, None, cot) for _ in range(2))
    for a, s in zip([*first[0], *first[1]], [*second[0], *second[1]]):
        assert torch.equal(a, s)


def test_an_odd_address_takes_scalar_loads(card):
    x, _, w, b, cot, _ = _inputs(65, 64, torch.bfloat16, False, seed=7)
    shifted = x.view(-1)[1:1 + 64 * 64].view(64, 64)
    assert bnk._vec(64, shifted) == 1
    (y, mean, _), _ = _call(shifted, None, w, b, True, None, None, cot[:64])
    yp, mp, _ = bnk._plain(shifted, w, b, 1e-5, None, None, True, None, shifted.dtype)
    _close(mean, mp, 1e-5, 1e-6)
    _close(y, yp, 2.0 ** -7, 1e-6)
