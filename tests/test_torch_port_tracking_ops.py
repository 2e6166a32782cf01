"""The tracking ops of the port against the JAX package's on the CPU: the
numpy crop against ``cv2.warpAffine`` (the JAX crop), the ×16 bicubic
upsample against ``jax.image.resize``, the cross-correlations, the losses,
``prediction_to_box``, ``tracking_losses``, ``iou_xyxy`` and
``compute_metrics``.

Tolerances: the crop within 1 of 255 on at most 1e-3 of the pixels (cv2
rounds its own float32 sums; the replica's order of operations differs);
the upsample atol 1e-5; the correlations and losses rtol 1e-5; boxes
exactly."""

import pathlib
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.models import tracking_model as jtm
from vince_tpu.ops import xcorr as jxc
from vince_tpu.tracking import experiments as jexp
from vince_tpu.tracking import losses as jlo
from vince_tpu.tracking import ops as jops
from vince_tpu_torch.models import tracking_model as ttm
from vince_tpu_torch.ops import xcorr as txc
from vince_tpu_torch.tracking import experiments as texp
from vince_tpu_torch.tracking import losses as tlo
from vince_tpu_torch.tracking import ops as tops
from vince_tpu_torch.tracking.tracker import bicubic_resize_matrix
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-5
CROP_MAX, CROP_FRACTION = 1, 1e-3


def _boxes(rng, h, w, inside):
    """Ten square-ish crops of the image: inside it, or reaching past it."""
    out = []
    for _ in range(10):
        s = rng.uniform(20, 0.8 * min(h, w)) if inside else rng.uniform(50, 2.5 * max(h, w))
        if inside:
            cx, cy = rng.uniform(s / 2, w - s / 2), rng.uniform(s / 2, h - s / 2)
        else:
            cx, cy = rng.uniform(-s / 4, w + s / 4), rng.uniform(-s / 4, h + s / 4)
        r = rng.uniform(0.8, 1.0)
        out.append([cx - s / 2, cy - s * r / 2, cx + s / 2, cy + s * r / 2])
    return out


@pytest.mark.parametrize("inside", [True, False], ids=["inside", "outside"])
@pytest.mark.parametrize("out_size", [120, 127, 247, 255])
def test_crop_matches_cv2_warp_affine(out_size, inside):
    rng = np.random.RandomState(out_size + inside)
    h, w = 240, 320
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    worst, differing, total = 0, 0, 0
    for xyxy in _boxes(rng, h, w, inside):
        ref, m_ref = jops.get_cropped_input(img, xyxy, 1.0, out_size)
        got, m = tops.get_cropped_input(img, xyxy, 1.0, out_size)
        np.testing.assert_array_equal(m, m_ref)
        assert got.shape == ref.shape == (out_size, out_size, 3) and got.dtype == np.uint8
        d = np.abs(got.astype(int) - ref.astype(int))
        worst, differing, total = max(worst, d.max()), differing + (d > 0).sum(), total + d.size
    assert worst <= CROP_MAX and differing <= CROP_FRACTION * total, (worst, differing / total)


def test_crop_fully_outside_is_the_rounded_border():
    img = np.full((50, 60, 3), 7, np.uint8)
    got, _ = tops.get_cropped_input(img, [200, 200, 260, 260], 1.0, 31,
                                    pad_color=(10.4, 20.6, 30.5))
    ref = cv2.warpAffine(img, np.float32([[0.5, 0, -100], [0, 0.5, -100]]), (31, 31),
                         borderMode=cv2.BORDER_CONSTANT, borderValue=(10.4, 20.6, 30.5))
    np.testing.assert_array_equal(got, np.broadcast_to(ref[0, 0], got.shape))


@pytest.mark.parametrize("size", [17, 18])
def test_bicubic_upsample_matches_jax_image_resize(size):
    r = np.random.RandomState(size).randn(3, size, size).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(r), (3, 272, 272), method="bicubic"))
    m = torch.from_numpy(bicubic_resize_matrix(size, 272))
    got = (m @ torch.from_numpy(r) @ m.T).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    for a, b in zip(got, ref):  # the tracker reads its box off the argmax
        assert a.argmax() == b.argmax()


def test_fast_xcorr_matches():
    rng = np.random.RandomState(0)
    z = rng.randn(3, 4, 5, 8).astype(np.float32)
    x = rng.randn(3, 9, 11, 8).astype(np.float32)
    ref = np.asarray(jxc.fast_xcorr(jnp.asarray(z), jnp.asarray(x), out_scale=1e-3))
    got = txc.fast_xcorr(torch.from_numpy(z), torch.from_numpy(x), out_scale=1e-3).numpy()
    assert got.shape == ref.shape == (3, 6, 7, 1)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-8)


@pytest.mark.parametrize("n", [1, 3])
def test_multi_scale_xcorr_matches(n):
    """One exemplar against its scales as the serial tracker calls it, and N
    as the batched tracker's ``vmap`` of it."""
    rng = np.random.RandomState(n)
    z = rng.randn(n, 5, 5, 8).astype(np.float32)
    x = rng.randn(n, 3, 12, 12, 8).astype(np.float32)
    ref = np.stack([np.asarray(jxc.multi_scale_xcorr(jnp.asarray(zi), jnp.asarray(xi),
                                                     out_scale=1e-3)) for zi, xi in zip(z, x)])
    got = txc.multi_scale_xcorr(torch.from_numpy(z), torch.from_numpy(x), 1e-3).numpy()
    assert got.shape == ref.shape == (n, 3, 8, 8)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-8)


def _maps(seed=0, n=4, size=17):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(n, size, size)).astype(np.float32)
    labels = (rng.rand(n, size, size) < 0.1).astype(np.float32)
    return logits, labels


LOSSES = {
    "focal": (lambda f, lo, la: f.focal_loss(lo, la)),
    "focal_per_sample": (lambda f, lo, la: f.focal_loss(lo, la, reduce=False)),
    "balanced": (lambda f, lo, la: f.balanced_loss(lo, la, neg_weight=2.0)),
    "ohnm": (lambda f, lo, la: f.ohnm_loss(lo, la)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches(name):
    logits, labels = _maps()
    ref = np.asarray(LOSSES[name](jlo, jnp.asarray(logits), jnp.asarray(labels)))
    got = LOSSES[name](tlo, torch.from_numpy(logits), torch.from_numpy(labels)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_ghmc_loss_matches_over_two_calls_of_state():
    acc_j = acc_t = None
    for seed in (0, 1):
        logits, labels = _maps(seed)
        ref, acc_j = jlo.ghmc_loss(jnp.asarray(logits), jnp.asarray(labels), acc_j)
        got, acc_t = tlo.ghmc_loss(torch.from_numpy(logits), torch.from_numpy(labels), acc_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
        np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=RTOL)


def test_prediction_to_box_takes_the_first_maximum():
    logits, _ = _maps(2)
    logits[1] = 0.0  # every cell ties
    logits[2, 3, 4] = logits[2, 9, 1] = logits[2].max() + 1  # two tie for the maximum
    ref = np.asarray(jtm.prediction_to_box(jnp.asarray(logits)))
    got = ttm.prediction_to_box(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("reduce", [True, False], ids=["reduced", "per_sample"])
def test_tracking_losses_match(reduce):
    logits, labels = _maps(3)
    ref = jtm.tracking_losses(jnp.asarray(logits), jnp.asarray(labels), reduce=reduce)
    got = ttm.tracking_losses(torch.from_numpy(logits), torch.from_numpy(labels), reduce=reduce)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=RTOL, err_msg=k)


def test_iou_and_compute_metrics_match():
    rng = np.random.RandomState(4)
    gt = np.c_[rng.uniform(0, 100, (12, 2)), rng.uniform(10, 50, (12, 2))]
    pred = gt + rng.randn(12, 4) * [8, 8, 4, 4]
    pred[3] = [500, 500, 10, 10]  # no overlap
    for a, b in zip(pred, gt):
        ja, jb = jops.xywh_to_xyxy(a), jops.xywh_to_xyxy(b)
        np.testing.assert_array_equal(tops.xywh_to_xyxy(a), ja)
        assert tops.iou_xyxy(ja, jb) == jops.iou_xyxy(ja, jb)
    ref, got = jexp.compute_metrics(pred, gt), texp.compute_metrics(pred, gt)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    assert got["ious"][3] == 0.0


def test_read_image_without_cv2_names_the_roadmap_item():
    """On a machine without cv2 a frame file cannot be read; the error says
    so (the sequences held in memory need no read)."""
    code = ("import sys; sys.modules['cv2'] = None\n"
            "from vince_tpu_torch.tracking.ops import read_image\n"
            "try:\n    read_image('x.jpg')\nexcept RuntimeError as e:\n    print(e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=ROOT)
    assert "ROADMAP.md §1 item 6" in out.stdout, out.stdout + out.stderr


if __name__ == "__main__":
    # the gaps behind the tolerances above, printed:
    #   JAX_PLATFORMS=cpu python -m tests.test_torch_port_tracking_ops
    jax.config.update("jax_platforms", "cpu")
    rng = np.random.RandomState(0)
    worst, differing, total = 0, 0, 0
    for trial in range(200):  # random frames, sizes and boxes, in and out of bounds
        h, w = rng.randint(100, 400, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        s = rng.uniform(20, 600)
        cx, cy = rng.uniform(-80, w + 80), rng.uniform(-80, h + 80)
        xyxy = [cx - s / 2, cy - s / 2 * rng.uniform(0.8, 1.2), cx + s / 2, cy + s / 2]
        size = (120, 127, 247, 255)[trial % 4]
        d = np.abs(tops.get_cropped_input(img, xyxy, 1.0, size)[0].astype(int)
                   - jops.get_cropped_input(img, xyxy, 1.0, size)[0].astype(int))
        worst, differing, total = max(worst, d.max()), differing + (d > 0).sum(), total + d.size
    print(f"crop against cv2.warpAffine, 200 crops: max {worst}, share of pixels "
          f"{differing / total:.3e}")
    for size in (17, 18):
        r = np.random.RandomState(size).randn(3, size, size).astype(np.float32)
        m = bicubic_resize_matrix(size, 272)
        exact = m.astype(np.float64) @ r.astype(np.float64) @ m.T.astype(np.float64)
        ref = np.asarray(jax.image.resize(jnp.asarray(r), (3, 272, 272), method="bicubic"))
        got = (torch.from_numpy(m) @ torch.from_numpy(r) @ torch.from_numpy(m).T).numpy()
        print(f"upsample {size}->272: port against jax.image.resize {np.abs(got - ref).max():.2e}"
              f", against the f64 product {np.abs(got - exact).max():.2e}; jax against it "
              f"{np.abs(ref - exact).max():.2e}")
