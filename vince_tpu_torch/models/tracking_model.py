"""SiamFC tracking head (counterpart of ``vince_tpu/models/tracking_model.py``):
biased 1×1 projections of the exemplar and search features to 256 channels
(``exemplar_decoder``, ``search_patch_decoder``), their batched
cross-correlation scaled by 1e-3, and the loss and metrics of a response map.

The projections run in float32 on float32 weights whatever the features'
type, as flax's ``nn.Conv`` promotes bf16 features to its f32 kernel.
"""

from typing import Dict, Optional

import torch
from torch import nn

from vince_tpu_torch.models.resnet import Conv1x1
from vince_tpu_torch.ops.xcorr import fast_xcorr
from vince_tpu_torch.tracking import losses as track_losses


class SiamFCTrackingModel(nn.Module):
    def __init__(self, in_channels: int, proj_channels: int = 256, out_scale: float = 1e-3):
        super().__init__()
        self.exemplar_decoder = Conv1x1(in_channels, proj_channels, bias=True)
        self.search_patch_decoder = Conv1x1(in_channels, proj_channels, bias=True)
        self.out_scale = out_scale

    def reset_parameters(self, generator=None):
        self.exemplar_decoder.reset_parameters(generator)
        self.search_patch_decoder.reset_parameters(generator)

    def forward(self, exemplar_features, search_features):
        """NHWC spatial features → response logits [B, hy, wy, 1]."""
        p = self.project(exemplar_features, search_features)
        return fast_xcorr(p["z"], p["x"], out_scale=self.out_scale)

    def project(self, exemplar_features: Optional[torch.Tensor] = None,
                search_features: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Each projection on its own (the tracker projects its exemplar once)."""
        out = {}
        if exemplar_features is not None:
            out["z"] = self.exemplar_decoder(exemplar_features.float())
        if search_features is not None:
            out["x"] = self.search_patch_decoder(search_features.float())
        return out


def prediction_to_box(responses: torch.Tensor) -> torch.Tensor:
    """The argmax of each response map [B, H, W] (the first on ties) →
    normalised boxes [4, B]: (cx, cy, 0.5, 0.5)."""
    b, h, w = responses.shape
    idx = torch.argmax(responses.reshape(b, -1), dim=-1)
    row = torch.div(idx, w, rounding_mode="floor").float() + 0.5
    col = (idx % w).float() + 0.5
    half = torch.full((b,), 0.5, device=responses.device)
    return torch.stack([col / w, row / h, half, half])


def _xywh_to_xyxy(box):
    cx, cy, w, h = box[0], box[1], box[2], box[3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])


def tracking_losses(responses: torch.Tensor, labels: torch.Tensor,
                    reduce: bool = True) -> Dict[str, torch.Tensor]:
    """The focal loss of response maps [B, H, W] (or [B, H, W, 1]) against
    their labels, and the metrics: ``dist`` (mean |σ(r) − label|),
    ``center_dist`` (of the argmax from the centre) and ``mean_iou`` (of the
    argmax box with the centred one). ``reduce=False`` gives [B] tensors."""
    if responses.dim() == 4:
        responses = responses[..., 0]
    labels = labels.float()
    loss = track_losses.focal_loss(responses, labels, reduce=reduce)
    err = torch.abs(torch.sigmoid(responses) - labels)
    dist = err.mean() if reduce else err.mean(dim=(1, 2))
    pred_boxes = prediction_to_box(responses)
    off = torch.abs(pred_boxes[:2] - 0.5)
    center_dist = off.mean() if reduce else off.mean(dim=0)
    gt = _xywh_to_xyxy(torch.tensor([0.5, 0.5, 0.5, 0.5], device=responses.device))
    pred = _xywh_to_xyxy(pred_boxes)
    inter = (torch.clamp(torch.minimum(pred[2], gt[2]) - torch.maximum(pred[0], gt[0]), min=0)
             * torch.clamp(torch.minimum(pred[3], gt[3]) - torch.maximum(pred[1], gt[1]), min=0))
    area_p = (pred[2] - pred[0]) * (pred[3] - pred[1])
    area_g = (gt[2] - gt[0]) * (gt[3] - gt[1])
    iou = inter / torch.clamp(area_p + area_g - inter, min=1e-12)
    return {"loss/siam_tracking_loss": loss, "dist": dist, "center_dist": center_dist,
            "mean_iou": iou.mean() if reduce else iou}
