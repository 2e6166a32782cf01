"""The port's BatchNorm (``ops/kernels/batch_norm_kernel.py``, through
``models/resnet.py::BatchNorm``) against flax's ``nn.BatchNorm`` followed by
``+ residual`` and ``relu``, and the blocks' fused calls against the
composition they replaced, bit for bit. On the CPU the wrapper runs its plain
version (``chip_smoke.py`` holds the CUDA kernels against it on a card)."""

import copy

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vince_tpu_torch.models.resnet import (
    BasicBlock, BatchNorm, Bottleneck, GroupNorm, ResNet18, folded_dot_bn)
from vince_tpu_torch.ops.kernels import batch_norm_kernel as bnk
from vince_tpu_torch.ops.kernels import plain_versions
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16}
# (rtol, atol as a share of max|ref|): float32 rounding; bf16 one ulp and a bit
TOL = {"f32": (1e-5, 1e-6), "bf16": (1.6e-2, 4e-3)}
GRAD_TOL = {"f32": (1e-4, 1e-5), "bf16": (2e-2, 8e-3)}
EPILOGUES = {"none": (False, False), "relu": (True, False), "residual": (False, True),
             "residual_relu": (True, True)}


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    rtol, atol = tol
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * max(np.abs(ref).max(), 1e-30))


def _data(c, dtype, seed=0):
    """x [2, 4, 4, C] (a shifted, scaled batch), the residual, the affine, the
    running averages and the cotangent, as numpy float32 rounded to ``dtype``."""
    rng = np.random.RandomState(seed)
    rounded = lambda a: torch.from_numpy(a.astype(np.float32)).to(dtype).float().numpy()
    x = rounded(rng.randn(2, 4, 4, c) * 1.7 + 0.3)
    res = rounded(rng.randn(2, 4, 4, c))
    cot = rounded(rng.randn(2, 4, 4, c))
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = (rng.randn(c) * 0.2).astype(np.float32)
    mean = (rng.randn(c) * 0.1).astype(np.float32)
    var = (rng.rand(c) + 0.5).astype(np.float32)
    return x, res, cot, scale, bias, mean, var


def _flax(x, res, cot, scale, bias, mean, var, train, relu, residual, dtype):
    """flax's BatchNorm, then + residual and relu: (out, running mean, running
    var, (dx, dscale, dbias, dres))."""
    bn = nn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                      dtype=JAX[dtype])
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def f(x, scale, bias, r):
        variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": stats}
        if train:
            y, upd = bn.apply(variables, x, mutable=["batch_stats"])
        else:
            y, upd = bn.apply(variables, x), {"batch_stats": stats}
        if residual:
            y = y + r
        if relu:
            y = nn.relu(y)
        return y, upd["batch_stats"]

    args = (jnp.asarray(x, JAX[dtype]), jnp.asarray(scale), jnp.asarray(bias),
            jnp.asarray(res, JAX[dtype]))
    y, vjp, upd = jax.vjp(f, *args, has_aux=True)
    grads = vjp(jnp.asarray(cot, y.dtype))
    return y, upd["mean"], upd["var"], grads


def _port(x, res, cot, scale, bias, mean, var, train, relu, residual, dtype):
    """The port's module, the same way: (out, running mean, running var,
    (dx, dweight, dbias, dres))."""
    c = x.shape[-1]
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    bn.train(train)
    xt = torch.from_numpy(x).to(TORCH[dtype]).requires_grad_(True)
    rt = torch.from_numpy(res).to(TORCH[dtype]).requires_grad_(True)
    y = bn(xt, relu=relu, residual=rt if residual else None)
    y.backward(torch.from_numpy(cot).to(y.dtype))
    return (y.detach(), bn.running_mean, bn.running_var,
            (xt.grad, bn.weight.grad, bn.bias.grad, rt.grad))


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", [64, 256, 2048])
def test_plain_version_matches_flax(c, dtype, train, epilogue):
    """Forward, running averages and the VJP (dx, dweight, dbias, d residual)."""
    relu, residual = EPILOGUES[epilogue]
    data = _data(c, TORCH[dtype], seed=c)
    before = bnk.batch_norm.plain_calls
    got = _port(*data, train, relu, residual, dtype)
    assert bnk.batch_norm.plain_calls == before + 1
    ref = _flax(*data, train, relu, residual, dtype)
    assert got[0].dtype == TORCH[dtype]
    _close(got[0].float(), ref[0], TOL[dtype])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-5, atol=1e-6)
    names = ("dx", "dweight", "dbias", "dres")
    for name, g, r in zip(names, got[3], ref[3]):
        if name == "dres" and not residual:
            assert g is None
            continue
        assert g is not None, name
        _close(g.float(), r, GRAD_TOL[dtype])


# --- the blocks' fused calls against the composition they replaced ---


def _old_bn(bn, x):
    """``BatchNorm.forward`` as the port composed it before the fused call."""
    if bn.training:
        x32 = x.float()
        dims = tuple(range(x.dim() - 1))
        moments = torch.stack([x32.mean(dim=dims), (x32 * x32).mean(dim=dims)])
        mean, mean2 = moments.unbind()
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mean, var = bn.batch_stats(mean, var)
    else:
        mean, var = bn.batch_stats(None, None)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((x.float() - mean) * mul + bn.bias).to(x.dtype)


def _old_basic(block, x):
    residual = x
    y = torch.relu(_old_bn(block.bn1, block.conv1(x)))
    y = _old_bn(block.bn2, block.conv2(y))
    if block.downsample is not None:
        conv, bn = block.downsample
        if block.fold:
            residual = folded_dot_bn(residual, conv, bn, block.dtype)
        else:
            residual = _old_bn(bn, conv(residual))
    return torch.relu(y + residual)


def _old_bottleneck(block, x):
    residual = x
    y = torch.relu(_old_bn(block.bn1, block.conv1(x)))
    y = block.conv2(y)
    if block.fold:
        if block.downsample is not None:
            residual = folded_dot_bn(residual, *block.downsample, block.dtype)
        y = torch.relu(_old_bn(block.bn2, y))
        return folded_dot_bn(y, block.conv3, block.bn3, block.dtype, act=torch.relu,
                             residual=residual)
    y = torch.relu(_old_bn(block.bn2, y))
    y = _old_bn(block.bn3, block.conv3(y))
    if block.downsample is not None:
        conv, bn = block.downsample
        residual = _old_bn(bn, conv(residual))
    return torch.relu(y + residual)


def _old_resnet(model, x):
    x = torch.relu(_old_bn(model.bn1, model.conv1(x.to(model.dtype))).to(model.dtype))
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
    for stage in range(model.num_stages):
        for block in getattr(model, f"layer{stage + 1}"):
            x = _old_basic(block, x)
    return x


def _randomised(module, seed):
    """``module`` with seeded weights, every norm's scale nonzero."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
    return module


def _same_step(new, old_forward, x):
    """Forward and backward of ``new`` and of a copy through ``old_forward``:
    outputs, input and parameter gradients and running averages bit-equal."""
    old = copy.deepcopy(new)
    outs, grads = [], []
    for module, fwd in ((new, lambda m, t: m(t)), (old, old_forward)):
        xt = x.clone().requires_grad_(True)
        y = fwd(module, xt)
        cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(7)).to(y.dtype)
        y.backward(cot)
        outs.append(y.detach())
        grads.append([xt.grad] + [p.grad for p in module.parameters()]
                     + list(module.buffers()))
    assert outs[0].dtype == outs[1].dtype and torch.equal(outs[0], outs[1])
    assert len(grads[0]) == len(grads[1])
    for i, (a, b) in enumerate(zip(*grads)):
        assert (a is None) == (b is None), i
        assert a is None or torch.equal(a, b), i


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["identity", "downsample", "downsample_folded"])
def test_basic_block_fused_calls_are_bit_equal(kind, dtype):
    down = kind != "identity"
    block = _randomised(BasicBlock(16 if down else 8, 8, stride=2 if down else 1,
                                   downsample=down, fold=kind == "downsample_folded",
                                   dtype=TORCH[dtype]), seed=1)
    x = torch.randn(2, 8, 8, 16 if down else 8).to(TORCH[dtype])
    _same_step(block, _old_basic, x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bn_fold", ["none", "expand"])
@pytest.mark.parametrize("down", [False, True], ids=["identity", "downsample"])
def test_bottleneck_fused_calls_are_bit_equal(down, bn_fold, dtype):
    cin = 16 if down else 32
    block = _randomised(Bottleneck(cin, 8, stride=2 if down else 1, downsample=down,
                                   fold=bn_fold == "expand", dtype=TORCH[dtype]), seed=2)
    x = torch.randn(2, 8, 8, cin).to(TORCH[dtype])
    _same_step(block, _old_bottleneck, x)


@pytest.mark.parametrize("stem_kind", ["s2d", "conv7"])
def test_resnet18_stem_writes_the_compute_dtype_bit_equal(stem_kind):
    """The stem's BatchNorm writes bf16 itself (f32 in with ``conv7``)."""
    model = _randomised(ResNet18(dtype=torch.bfloat16, stem_kind=stem_kind, bn_fold="expand",
                                 num_filters=16), seed=3)
    _same_step(model, _old_resnet, torch.rand(2, 32, 32, 3))


@pytest.mark.parametrize("relu", [False, True])
def test_group_norm_takes_the_same_epilogue(relu):
    gn = GroupNorm(64)
    with torch.no_grad():
        gn.weight.uniform_(0.5, 1.5)
        gn.bias.normal_()
    x = torch.randn(2, 4, 4, 64).bfloat16()
    r = torch.randn(2, 4, 4, 64).bfloat16()
    want = gn(x) + r
    want = torch.relu(want) if relu else want
    assert torch.equal(gn(x, relu=relu, residual=r), want)
    assert gn(x.float(), dtype=torch.bfloat16).dtype == torch.bfloat16


def test_eval_mode_and_unrecorded_statistics_leave_the_running_averages():
    from vince_tpu_torch.models.resnet import unrecorded_batch_stats

    bn = BatchNorm(64)
    bn.reset_parameters()
    x = torch.randn(64, 64) * 2 + 1
    with unrecorded_batch_stats(bn):
        bn(x, relu=True)
    assert torch.equal(bn.running_mean, torch.zeros(64))
    bn(x, relu=True)
    assert torch.allclose(bn.running_mean, 0.1 * x.mean(0), rtol=1e-5, atol=1e-6)
    recorded = bn.running_mean.clone()
    bn.eval()
    bn(x)
    assert torch.equal(bn.running_mean, recorded)


# --- the kernels' schedule and their refusals ---


@pytest.mark.parametrize("m,c,vec", [(448 * 112 * 112, 64, 8), (21952, 512, 8), (100, 2048, 8),
                                     (37, 40, 8), (130, 24, 4), (77, 3, 1), (5, 1000, 4)])
def test_layout_is_about_four_ctas_an_sm(m, c, vec):
    lay = bnk.layout(m, c, vec)
    assert lay.slabs * lay.ctiles <= 4 * bnk.H100_SMS + lay.ctiles
    assert lay.slabs * lay.slab_rows >= m > (lay.slabs - 1) * lay.slab_rows
    assert lay.tile * lay.ctiles >= c // vec > lay.tile * (lay.ctiles - 1)


@pytest.mark.parametrize("m,c,vec", [(1000, 64, 8), (37, 40, 8), (130, 24, 4), (77, 3, 1),
                                     (300, 520, 8), (9, 2048, 8)])
def test_layout_reads_every_vector_once(m, c, vec):
    lay = bnk.layout(m, c, vec, sms=4)
    seen = list(bnk.elements(m, c, lay))
    assert len(seen) == len(set(seen)) == m * (c // vec)
    assert set(seen) == {(r, ch) for r in range(m) for ch in range(0, c, vec)}


def test_vector_width_follows_channels_types_and_addresses():
    bf, f32 = torch.zeros(64, 16, dtype=torch.bfloat16), torch.zeros(64, 16)
    assert bnk._vec(16, bf, bf) == 8
    assert bnk._vec(16, f32, bf) == 4
    assert bnk._vec(12, bf) == 4
    assert bnk._vec(6, bf) == 1
    flat = torch.zeros(2048, dtype=torch.bfloat16)
    assert bnk._vec(16, flat[1:1025].view(64, 16)) == 1  # a 2-byte offset
    assert bnk._vec(16, flat[4:1028].view(64, 16)) == 4  # an 8-byte offset


def test_plain_versions_count_a_plain_call_and_no_launch():
    x = torch.randn(32, 64)
    w, b = torch.ones(64), torch.zeros(64)
    before = bnk.batch_norm.plain_calls, bnk.batch_norm.launches
    with plain_versions():
        bnk.batch_norm(x, w, b, 1e-5, relu=True)
    assert bnk.batch_norm.plain_calls == before[0] + 1
    assert bnk.batch_norm.launches == before[1]


def test_cuda_tensor_never_takes_the_plain_version_silently(monkeypatch):
    """A tensor the wrapper takes for a CUDA one goes to the kernels, which
    cannot run here, and raises: nothing falls back to the plain version."""
    monkeypatch.setattr(bnk, "use_kernel", lambda t: True)
    x = torch.randn(32, 64)
    before = bnk.batch_norm.plain_calls
    with pytest.raises((RuntimeError, AssertionError)):
        bnk.batch_norm(x, torch.ones(64), torch.zeros(64), 1e-5, relu=True)
    assert bnk.batch_norm.plain_calls == before


def test_a_residual_with_another_output_dtype_is_refused():
    x = torch.randn(8, 16)
    with pytest.raises(ValueError):
        bnk.batch_norm(x, torch.ones(16), torch.zeros(16), 1e-5, residual=x.bfloat16(),
                       dtype=torch.bfloat16)
