"""The reference's augmentation: each operation against values worked out by
hand, and the whole train path against the port's on the same draws. The
reference shares only the order of the draws with the port; its arithmetic
is its own, so a fault in either shows here as a gap."""

import math

import pytest
import torch

from vince_bench.reference import augment

CPU = torch.device("cpu")


def _one(x):
    return torch.tensor([x], dtype=torch.float32)


def test_an_identity_box_returns_the_frame_and_a_flip_mirrors_it():
    img = torch.rand(2, 5, 7, 3, generator=torch.Generator().manual_seed(1))
    box = [torch.zeros(2), torch.zeros(2), torch.full((2,), 5.0), torch.full((2,), 7.0)]
    out = augment.resized_crop(img, *box, (5, 7), torch.tensor([False, True]))
    assert torch.equal(out[0], img[0])
    assert torch.equal(out[1], img[1].flip(1))


def test_a_box_doubled_samples_between_pixels():
    # a 2x2 box at (1, 1) of a 4x4 ramp, out 4x4: output i samples 1 + (i + .5)/2 - .5,
    # i.e. 0.75, 1.25, 1.75, 2.25 along each side
    ramp = torch.arange(4.0)[None, :, None, None].expand(1, 4, 4, 1)
    out = augment.resized_crop(ramp, _one(1), _one(1), _one(2), _one(2), (4, 4),
                               torch.tensor([False]))
    assert out[0, :, 0, 0].tolist() == [0.75, 1.25, 1.75, 2.25]
    # the first point of a box at the frame's edge is held to the first pixel
    out = augment.resized_crop(ramp, _one(0), _one(0), _one(2), _one(2), (4, 4),
                               torch.tensor([False]))
    assert out[0, :, 0, 0].tolist() == [0.0, 0.25, 0.75, 1.25]


def test_the_blends():
    img = torch.tensor([[[[0.2, 0.4, 0.8], [0.6, 0.6, 0.0]]]])  # 1x1x2 pixels
    gray = [0.299 * 0.2 + 0.587 * 0.4 + 0.114 * 0.8, 0.299 * 0.6 + 0.587 * 0.6]
    assert augment.grayscale(img)[0, 0, :, 0].tolist() == pytest.approx(gray, abs=1e-7)
    assert augment.adjust_brightness(img, _one(1.5))[0, 0, 0].tolist() == pytest.approx(
        [0.3, 0.6, 1.0], abs=1e-7)  # 1.2 clamped
    mean = sum(gray) / 2
    contrast = augment.adjust_contrast(img, _one(0.0))
    assert contrast.flatten().tolist() == pytest.approx([mean] * 6, abs=1e-7)
    saturation = augment.adjust_saturation(img, _one(0.5))
    assert saturation[0, 0, 0].tolist() == pytest.approx(
        [0.5 * 0.2 + 0.5 * gray[0], 0.5 * 0.4 + 0.5 * gray[0], 0.5 * 0.8 + 0.5 * gray[0]],
        abs=1e-7)


@pytest.mark.parametrize("shift, want", [(1 / 3, (0.0, 1.0, 0.0)), (2 / 3, (0.0, 0.0, 1.0)),
                                         (1 / 6, (1.0, 1.0, 0.0)), (-1 / 6, (1.0, 0.0, 1.0))])
def test_a_hue_shift_turns_red(shift, want):
    red = torch.tensor([1.0, 0.0, 0.0]).view(1, 1, 1, 3)
    assert augment.adjust_hue(red, _one(shift)).flatten().tolist() == pytest.approx(
        want, abs=1e-6)


def test_hsv_round_trip_and_gray_pixels():
    img = torch.rand(3, 6, 6, 3, generator=torch.Generator().manual_seed(2))
    img[0, 0, 0] = 0.5  # a gray pixel: hue and saturation 0
    hsv = augment.rgb_to_hsv(img)
    assert hsv[0, 0, 0].tolist() == [0.0, 0.0, 0.5]
    assert torch.allclose(augment.hsv_to_rgb(hsv), img, atol=1e-6)


def test_the_blur_keeps_a_constant_and_spreads_an_impulse():
    sigma = _one(1.0)
    flat = torch.full((1, 9, 9, 3), 0.25)
    assert torch.allclose(augment.gaussian_blur(flat, sigma, 5), flat, atol=1e-7)
    impulse = torch.zeros(1, 9, 9, 1)
    impulse[0, 4, 4] = 1.0
    taps = [math.exp(-0.5 * d * d) for d in (-2, -1, 0, 1, 2)]
    row = [t / sum(taps) for t in taps]
    out = augment.gaussian_blur(impulse, sigma, 5)[0, :, :, 0]
    assert out[4, 2:7].tolist() == pytest.approx([r * row[2] for r in row], abs=1e-7)
    assert out[4, :2].abs().max() == 0.0
    # at the edge the taps inside the frame are renormalised
    edge = torch.zeros(1, 1, 9, 1)
    edge[0, 0, 0] = 1.0
    got = augment.gaussian_blur(edge, sigma, 5)[0, 0, :3, 0].tolist()
    assert got == pytest.approx([taps[2] / sum(taps[2:]), taps[1] / sum(taps[1:]),
                                 taps[0] / sum(taps)], abs=1e-7)


@pytest.mark.parametrize("name", ["StandardVideoTransform", "SimCLRTransform"])
def test_the_train_path_against_the_port(name):
    """The same draws (the reference's and the port's generators agree), the
    same uint8 frames: the two augmentations agree to float32's rounding."""
    from vince_tpu_torch.ops.augment import apply_augment, draw_augment_params
    from vince_tpu_torch.utils.transforms import make_config

    size, canvas, batch = 64, 80, 24
    cfg = augment.transform(name, size)
    port_cfg = make_config(name, (size, size))
    frames = torch.randint(0, 256, (batch, canvas, canvas, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    d = augment.draw(torch.Generator(CPU).manual_seed(11), batch, canvas, canvas, cfg)
    port_d = draw_augment_params(torch.Generator(CPU).manual_seed(11), batch, canvas, canvas,
                                 port_cfg)
    for k, v in d.items():
        assert torch.equal(v, getattr(port_d, k)), k
    assert d["jitter"].all() and d["gray"].any() and not d["gray"].all()
    if name == "SimCLRTransform":
        assert d["blur"].any() and not d["blur"].all()
    want = apply_augment(frames, port_d, port_cfg)
    got = augment.apply(frames, d, cfg)
    assert (got - want).abs().max() < 2e-5
