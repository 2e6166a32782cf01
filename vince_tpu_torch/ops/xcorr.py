"""SiamFC cross-correlation (counterpart of ``vince_tpu/ops/xcorr.py``), NHWC
in and out, in float32, scaled by ``out_scale``.

``fast_xcorr`` correlates each exemplar with its own search region by the
reference's grouped-convolution trick: the batch folds into the channels and
each item is one group. ``multi_scale_xcorr`` correlates each of N
exemplars with its own S search scales by the same trick: the scales are the
batch, the N exemplars the groups (JAX's serial tracker calls it on one
exemplar, its batched tracker ``vmap``s it).
"""

import torch
import torch.nn.functional as F


def fast_xcorr(z: torch.Tensor, x: torch.Tensor, out_scale: float = 1e-3) -> torch.Tensor:
    """z: [B, hz, wz, C] exemplar features; x: [B, hx, wx, C] search features
    → responses [B, hx-hz+1, wx-wz+1, 1]."""
    b, hx, wx, c = x.shape
    xs = x.float().permute(0, 3, 1, 2).reshape(1, b * c, hx, wx)
    out = F.conv2d(xs, z.float().permute(0, 3, 1, 2), groups=b)  # [1, B, hy, wy]
    return out.reshape(b, *out.shape[2:], 1) * out_scale


def multi_scale_xcorr(z: torch.Tensor, x_scales: torch.Tensor,
                      out_scale: float = 1e-3) -> torch.Tensor:
    """Each exemplar against its S search scales: z [N, hz, wz, C], x_scales
    [N, S, hx, wx, C] → [N, S, hx-hz+1, wx-wz+1]."""
    n, s, hx, wx, c = x_scales.shape
    xs = x_scales.float().permute(1, 0, 4, 2, 3).reshape(s, n * c, hx, wx)
    out = F.conv2d(xs, z.float().permute(0, 3, 1, 2), groups=n)  # [S, N, hy, wy]
    return out.transpose(0, 1) * out_scale
