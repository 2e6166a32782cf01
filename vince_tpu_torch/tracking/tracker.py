"""The SiamFC tracker (counterpart of ``vince_tpu/tracking/tracker.py``).

``init`` crops the exemplar with its context margin and keeps its features;
``update`` crops a 3-scale search pyramid on the host, runs one device
forward (normalise → the encoder's spatial features in eval mode → the two
projections → cross-correlation → the ×16 bicubic upsample → the scale
penalty), then, on the host, smooths the response with a Hann window and
reads the box's displacement and scale off its argmax.

The upsample is ``jax.image.resize``'s bicubic: the Keys kernel with
a = −0.5 at half-pixel centres, taps outside the map dropped and each
output's weights renormalised. ``torch.nn.functional.interpolate`` uses
a = −0.75 and clamps the border, which moves the argmax; so the weights are
built here on the host, once, as a [out, in] matrix M, and the upsample is
M · r · Mᵀ on the device.

``BatchedTrackerSiamFC`` tracks N sequences in lockstep through one
[N·3, 255, 255, 3] forward per frame, refilling a slot with the next
sequence when its sequence ends; each slot is a ``TrackerSiamFC`` sharing
the forward, so the boxes are the serial tracker's.
"""

import time
from typing import Dict, Optional

import numpy as np
import torch

from vince_tpu_torch.data.got10k_dataset import TRACKER_CFG
from vince_tpu_torch.ops.augment import AugmentConfig, _finalize
from vince_tpu_torch.ops.xcorr import multi_scale_xcorr
from vince_tpu_torch.tracking.ops import get_cropped_input, load_frame


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel with a = −0.5, float32, at |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def bicubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float32 weights of ``jax.image.resize(...,
    method="bicubic")`` along one axis (``compute_weight_mat`` of
    ``jax.image``, with scale out/in and no translation)."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.float32(max(inv_scale, 1.0))  # antialias: only when shrinking
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale \
        - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32).T


def _scale_penalty(cfg) -> np.ndarray:
    s = cfg["scale_num"]
    penalty = np.full((s,), cfg["scale_penalty"], np.float32)
    penalty[s // 2] = 1.0
    return penalty


class _Forward:
    """The tracker's device forward on an end-task state: the exemplar's
    features, and the penalised, upsampled responses of search crops."""

    def __init__(self, cfg, encoder_cfg, state):
        self.state, self.dtype = state, encoder_cfg.compute_dtype
        self.device = next(state.encoder.parameters()).device
        self.out_scale = cfg["out_scale"]
        self.upscale_sz = cfg["response_up"] * cfg["response_sz"]
        self.penalty = torch.from_numpy(_scale_penalty(cfg)).to(self.device)
        self._resize: Dict[int, torch.Tensor] = {}  # response size → [up, size]
        self._augment = AugmentConfig()

    def _matrix(self, size: int) -> torch.Tensor:
        if size not in self._resize:
            self._resize[size] = torch.from_numpy(
                bicubic_resize_matrix(size, self.upscale_sz)).to(self.device)
        return self._resize[size]

    @torch.no_grad()
    def features(self, imgs_u8: np.ndarray) -> torch.Tensor:
        """uint8 [N, H, W, 3] → the encoder's spatial features, eval mode."""
        x = torch.from_numpy(np.ascontiguousarray(imgs_u8)).to(self.device)
        x = _finalize(x.float() / 255.0, self._augment).to(self.dtype)
        encoder = self.state.encoder
        encoder.eval()
        return encoder.extract_features(x)["spatial_features"]

    @torch.no_grad()
    def responses(self, kernels: torch.Tensor, x_imgs: np.ndarray) -> np.ndarray:
        """kernels [N, hz, wz, C] (the exemplars' features); x_imgs uint8
        [N, S, iz, iz, 3] → the penalised, upsampled responses [N, S, up, up]
        on the host, float32."""
        n, s = x_imgs.shape[:2]
        xf = self.features(x_imgs.reshape((n * s,) + x_imgs.shape[2:]))
        decoder = self.state.decoder
        z = decoder.project(exemplar_features=kernels)["z"]  # [N, hz, wz, P]
        x = decoder.project(search_features=xf)["x"]  # [N·S, hx, wx, P]
        resp = multi_scale_xcorr(z, x.reshape((n, s) + x.shape[1:]), out_scale=self.out_scale)
        mh, mw = self._matrix(resp.shape[2]), self._matrix(resp.shape[3])
        up = mh @ resp @ mw.T
        return (up * self.penalty[None, :, None, None]).cpu().numpy()


class TrackerSiamFC:
    def __init__(self, name, cfg, encoder_cfg, state, share_forward_from=None):
        """``state``: an ``EndTaskState`` of the tracking task (encoder and
        SiamFC head, on their device); ``encoder_cfg``: its
        ``EndTaskConfig``; ``cfg``: overrides of ``TRACKER_CFG``;
        ``share_forward_from``: a tracker whose device forward this one uses."""
        self.name = name
        self.cfg = dict(TRACKER_CFG)
        if cfg:
            self.cfg.update(cfg)
        self.upscale_sz = self.cfg["response_up"] * self.cfg["response_sz"]
        self.hann_window = np.outer(np.hanning(self.upscale_sz), np.hanning(self.upscale_sz))
        self.hann_window /= self.hann_window.sum()
        self.scale_factors = self.cfg["scale_step"] ** np.linspace(
            -(self.cfg["scale_num"] // 2), self.cfg["scale_num"] // 2, self.cfg["scale_num"])
        self.forward = (share_forward_from.forward if share_forward_from is not None
                        else _Forward(self.cfg, encoder_cfg, state))

    def _crop(self, img, center, size, out_size):
        cy, cx = center
        xyxy = [cx - size / 2, cy - size / 2, cx + size / 2, cy + size / 2]
        crop, _ = get_cropped_input(img, xyxy, 1.0, out_size, pad_color=self.avg_color)
        return crop

    def init(self, img: np.ndarray, box):
        """box: 1-indexed [x, y, w, h]."""
        box = np.array([box[1] - 1 + (box[3] - 1) / 2, box[0] - 1 + (box[2] - 1) / 2,
                        box[3], box[2]], dtype=np.float32)
        self.center, self.target_sz = box[:2], box[2:]
        context = self.cfg["context"] * np.sum(self.target_sz)
        self.z_sz = float(np.sqrt(np.prod(self.target_sz + context)))
        self.x_sz = self.z_sz * self.cfg["instance_sz"] / self.cfg["exemplar_sz"]
        self.avg_color = np.mean(img, axis=(0, 1))
        z = self._crop(img, self.center, self.z_sz, self.cfg["exemplar_sz"])
        self.kernel = self.forward.features(z[None].astype(np.uint8))

    def _apply_response(self, responses: np.ndarray):
        """One frame's 3-scale responses → the Hann-smoothed argmax →
        displacement and scale; updates the centre, the target size and the
        crop sizes, and returns the 1-indexed [x, y, w, h] box."""
        scale_id = int(np.argmax(np.amax(responses, axis=(1, 2))))
        response = responses[scale_id].copy()
        response -= response.min()
        response /= response.sum() + 1e-16
        response = ((1 - self.cfg["window_influence"]) * response
                    + self.cfg["window_influence"] * self.hann_window)
        loc = np.unravel_index(response.argmax(), response.shape)

        disp_in_response = np.array(loc) - (self.upscale_sz - 1) / 2
        disp_in_instance = disp_in_response * self.cfg["total_stride"] / self.cfg["response_up"]
        disp_in_image = (disp_in_instance * self.x_sz * self.scale_factors[scale_id]
                         / self.cfg["instance_sz"])
        self.center += disp_in_image

        scale = (1 - self.cfg["scale_lr"]) + self.cfg["scale_lr"] * self.scale_factors[scale_id]
        self.target_sz *= scale
        self.z_sz *= scale
        self.x_sz *= scale
        return np.array([self.center[1] + 1 - (self.target_sz[1] - 1) / 2,
                         self.center[0] + 1 - (self.target_sz[0] - 1) / 2,
                         self.target_sz[1], self.target_sz[0]])

    def _scale_crops(self, img: np.ndarray) -> np.ndarray:
        return np.stack([self._crop(img, self.center, self.x_sz * f, self.cfg["instance_sz"])
                         for f in self.scale_factors]).astype(np.uint8)

    def update(self, img: np.ndarray):
        responses = self.forward.responses(self.kernel, self._scale_crops(img)[None])[0]
        return self._apply_response(responses)

    def track(self, frames, box):
        """One sequence: frames (uint8 arrays or paths), the first frame's box
        → (boxes [T, 4], seconds per frame [T])."""
        boxes = np.zeros((len(frames), 4))
        boxes[0] = box
        times = np.zeros(len(frames))
        for f, frame in enumerate(frames):
            img = load_frame(frame)
            t0 = time.time()
            if f == 0:
                self.init(img, box)
            else:
                boxes[f] = self.update(img)
            times[f] = time.time() - t0
        return boxes, times


class BatchedTrackerSiamFC:
    """N sequences in lockstep through one forward per frame. A finished
    sequence's slot takes the next one; idle slots are fed zeros."""

    def __init__(self, name, cfg, encoder_cfg, state, n_slots: int = 8):
        self.name = name
        self.n_slots = n_slots
        self.encoder_cfg = encoder_cfg
        self.state = state
        self._cfg_overrides = cfg
        self._proto = TrackerSiamFC(name, cfg, encoder_cfg, state)
        self.cfg = self._proto.cfg

    def track_all(self, sequences):
        """sequences: a list of (frames, first box) → the list of (boxes
        [T, 4], seconds per frame [T]), in order: N ``track`` calls' results."""
        n_seq = len(sequences)
        results: list = [None] * n_seq
        slots: list = [None] * self.n_slots
        next_seq = 0
        iz, s_num = self.cfg["instance_sz"], self.cfg["scale_num"]
        x_batch: Optional[np.ndarray] = None
        kernels: Optional[torch.Tensor] = None
        while True:
            for si in range(self.n_slots):  # refill the idle slots
                if slots[si] is None and next_seq < n_seq:
                    frames, box = sequences[next_seq]
                    t0 = time.time()
                    trk = TrackerSiamFC(self.name, self._cfg_overrides, self.encoder_cfg,
                                        self.state, share_forward_from=self._proto)
                    trk.init(load_frame(frames[0]), box)
                    boxes = np.zeros((len(frames), 4))
                    boxes[0] = box
                    times = np.zeros(len(frames))
                    times[0] = time.time() - t0
                    slots[si] = {"trk": trk, "seq_id": next_seq, "frame": 1, "frames": frames,
                                 "boxes": boxes, "times": times}
                    next_seq += 1
            active = [si for si in range(self.n_slots) if slots[si] is not None]
            if not active:
                break
            t0 = time.time()
            if x_batch is None:
                k0 = slots[active[0]]["trk"].kernel
                kernels = torch.zeros((self.n_slots,) + k0.shape[1:], dtype=k0.dtype,
                                      device=k0.device)
                x_batch = np.zeros((self.n_slots, s_num, iz, iz, 3), np.uint8)
            kernels.zero_()
            for si in active:
                sl = slots[si]
                kernels[si] = sl["trk"].kernel[0]
                x_batch[si] = sl["trk"]._scale_crops(load_frame(sl["frames"][sl["frame"]]))
            responses = self._proto.forward.responses(kernels, x_batch)
            dt = (time.time() - t0) / len(active)
            for si in active:
                sl = slots[si]
                sl["boxes"][sl["frame"]] = sl["trk"]._apply_response(responses[si])
                sl["times"][sl["frame"]] = dt
                sl["frame"] += 1
                if sl["frame"] >= len(sl["frames"]):
                    results[sl["seq_id"]] = (sl["boxes"], sl["times"])
                    slots[si] = None
        return results
