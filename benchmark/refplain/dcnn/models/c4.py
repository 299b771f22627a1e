"""Mask R-CNN R-C4 at inference: the trunk to res4, a single-level RPN on
res4 and res5 as the ROI head.

Counterpart of the JAX reference's ``dcnn/models/c4.py``, detectron2's
``mask_rcnn_R_{50,101}_C4_3x.yaml`` (``Base-RCNN-C4.yaml``: ``Res5ROIHeads``).
The RPN runs on the one res4 map (stride 16) with every anchor size on it.
Each proposal is pooled by ROIAlign (14 x 14, scale 1/16) on res4 and goes
through res5 (its first block at stride 2); the box predictor reads the 7 x 7
mean of res5's 2048 channels.  The mask head (a 2 x 2 transposed convolution
2048 -> 256, a 1 x 1 predictor, no 3 x 3 convolutions) reads res5 rerun on
the detection boxes.  Module names are detectron2's (``backbone.res2`` ..
``backbone.res4``, ``proposal_generator.rpn_head``, ``roi_heads.res5``,
``roi_heads.box_predictor``, ``roi_heads.mask_head``), so a zoo C4 state
dict loads key for key.

Departures from detectron2, as the JAX package and the measured program
have them: the pooler is ROIAlign with ``aligned=False`` (torchvision's
legacy rule, ROIs at least 1 texel) where detectron2's default is the
aligned ROIAlignV2, with a static sampling ratio; proposals and detections
are fixed budgets with validity masks.
"""

from __future__ import annotations

import torch
from torch import nn

from refplain.dcnn.config import ModelConfig
from refplain.dcnn.models.mask_rcnn import compute_dtypes
from refplain.dcnn.models.resnet import ResNet, memory_format, stage_blocks
from refplain.dcnn.models.roi_heads import BoxPredictor, MaskHead, box_inference
from refplain.dcnn.models.rpn import RPNHead, select_proposals
from refplain.dcnn.ops.roi_align import sample_grid

RPN_LEVELS = ("res4",)
STRIDE = 16
RES5_CHANNELS = 2048
RPN_CHANNELS = 1024


def roi_align_hwc(feat_hwc: torch.Tensor, boxes: torch.Tensor, resolution: int, spatial_scale: float,
                  sampling_ratio: int) -> torch.Tensor:
    """ROIAlign with ``aligned=False`` of one image: feat (H, W, C), boxes (N, 4)
    xyxy in image coordinates -> (N, C, R, R).  Each bin averages
    ``sampling_ratio**2`` bilinear samples; a ROI is at least 1 texel wide and
    tall; samples with y or x in [-1, H] / [-1, W] are clamped to the border,
    samples outside that band are 0 (torchvision's rules)."""
    h, w, c = feat_hwc.shape
    n = boxes.shape[0]
    s = max(int(sampling_ratio), 1)
    x1 = boxes[:, 0] * spatial_scale
    y1 = boxes[:, 1] * spatial_scale
    rw = (boxes[:, 2] * spatial_scale - x1).clamp(min=1.0)
    rh = (boxes[:, 3] * spatial_scale - y1).clamp(min=1.0)
    grid = sample_grid(resolution, s, boxes.device)[None, :]
    ys = y1[:, None] + grid * (rh / resolution)[:, None]  # (N, R*s)
    xs = x1[:, None] + grid * (rw / resolution)[:, None]
    m = resolution * s
    yy = ys[:, :, None].expand(n, m, m).reshape(-1)
    xx = xs[:, None, :].expand(n, m, m).reshape(-1)
    outside = (yy < -1.0) | (yy > h * 1.0) | (xx < -1.0) | (xx > w * 1.0)
    y = yy.clamp(0.0, h - 1.0)
    x = xx.clamp(0.0, w - 1.0)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1f = torch.clamp(y0 + 1, max=h - 1.0)
    x1f = torch.clamp(x0 + 1, max=w - 1.0)
    ly = y - y0
    lx = x - x0
    y0i, x0i, y1i, x1i = (t.to(torch.int64) for t in (y0, x0, y1f, x1f))
    flat = feat_hwc.reshape(h * w, c)
    val = flat[y0i * w + x0i] * ((1 - ly) * (1 - lx))[:, None]
    val = val + flat[y0i * w + x1i] * ((1 - ly) * lx)[:, None]
    val = val + flat[y1i * w + x0i] * (ly * (1 - lx))[:, None]
    val = val + flat[y1i * w + x1i] * (ly * lx)[:, None]
    val = torch.where(outside[:, None], torch.zeros((), dtype=val.dtype, device=val.device), val)
    return val.reshape(n, resolution, s, resolution, s, c).mean(dim=(2, 4)).permute(0, 3, 1, 2)


class Res5ROIHeads(nn.Module):
    """res5, the box predictor over its pooled 2048 channels and (with masks)
    the mask head (detectron2 ``roi_heads.*`` of a C4 model)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        head_dtype = compute_dtypes(cfg)[1]
        self.res5 = stage_blocks(cfg.depth, 3, cfg.stride_in_1x1)
        self.box_predictor = BoxPredictor(RES5_CHANNELS, cfg.roi.num_classes)
        if cfg.mask_on:
            self.mask_head = MaskHead(cfg.roi.num_classes, RES5_CHANNELS, cfg.roi.mask_conv_dim, 0, head_dtype)


class MaskRCNNC4(nn.Module):
    """Mask R-CNN R-C4 for inference.

    Example:
        model = MaskRCNNC4(cfg).to("cuda").eval()
        weights.load_detectron2(model, state_dict)
        dets, feats = model.inference(images)   # images (B, H, W, 3) f32 BGR; feats res2..res4
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.architecture != "c4":
            raise ValueError(f"architecture={cfg.architecture!r}: this model is 'c4'")
        self.cfg = cfg
        self.dtype, head_dtype = compute_dtypes(cfg)
        self.backbone = ResNet(cfg.depth, cfg.stride_in_1x1, max_stage=4)
        anchors = len(cfg.anchors.sizes[0]) * len(cfg.anchors.aspect_ratios)
        self.proposal_generator = nn.ModuleDict({"rpn_head": RPNHead(anchors, RPN_CHANNELS, head_dtype)})
        self.roi_heads = Res5ROIHeads(cfg)
        self.register_buffer("pixel_mean", torch.tensor(cfg.input.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.input.pixel_std, dtype=torch.float32), persistent=False)

    def features(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """images (B, H, W, 3) float in the configured channel order -> NHWC res2..res4."""
        x = ((images - self.pixel_mean) / self.pixel_std).permute(0, 3, 1, 2).to(self.dtype)
        res = self.backbone(x.contiguous(memory_format=memory_format(self.dtype)))
        return {k: v.permute(0, 2, 3, 1) for k, v in res.items()}

    def proposals(self, feats: dict[str, torch.Tensor], image_hw: tuple[int, int]):
        """The RPN head on res4 (outputs in float32) and proposal selection ->
        (boxes (B, P, 4), scores (B, P), valid (B, P))."""
        logits, deltas = self.proposal_generator["rpn_head"]({n: feats[n] for n in RPN_LEVELS})
        return select_proposals({k: v.float() for k, v in logits.items()}, {k: v.float() for k, v in deltas.items()},
                                {n: tuple(feats[n].shape[1:3]) for n in RPN_LEVELS}, image_hw, self.cfg.anchors,
                                self.cfg.rpn)

    def roi_transform(self, res4: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """ROIAlign of each image's boxes on its res4 map, then res5: res4 (B,
        H, W, 1024), boxes (B, N, 4) -> (B * N, 2048, 7, 7)."""
        roi = self.cfg.roi
        pooled = torch.cat([roi_align_hwc(res4[i], boxes[i], roi.box_pooler_resolution, 1.0 / STRIDE,
                                          roi.pooler_sampling_ratio) for i in range(boxes.shape[0])])
        return self.roi_heads.res5(pooled.to(self.dtype).contiguous(memory_format=memory_format(self.dtype)))

    def box_outputs(self, x5: torch.Tensor, nb: int, n: int):
        """The box predictor on the 7 x 7 mean of res5 (float32): (B, N, K + 1), (B, N, K, 4)."""
        cls_logits, box_deltas = self.roi_heads.box_predictor(x5.mean(dim=(2, 3)).float())
        return cls_logits.float().reshape(nb, n, -1), box_deltas.float().reshape(nb, n, self.cfg.roi.num_classes, 4)

    def detect(self, feats: dict[str, torch.Tensor], boxes: torch.Tensor, valid: torch.Tensor,
               image_hw: tuple[int, int]) -> dict[str, torch.Tensor]:
        """ROI heads on the proposals: boxes (B, D, 4), scores, classes, valid
        and (with masks) masks (B, D, 14, 14), the sigmoid of each detection's
        own class channel, from res5 rerun on the detection boxes."""
        roi = self.cfg.roi
        nb, p = boxes.shape[:2]
        cls_logits, box_deltas = self.box_outputs(self.roi_transform(feats["res4"], boxes), nb, p)
        det = box_inference(cls_logits, box_deltas, boxes, valid, image_hw, roi)
        if self.cfg.mask_on:
            d = det["boxes"].shape[1]
            logits = self.roi_heads.mask_head(self.roi_transform(feats["res4"], det["boxes"])).float()
            cls = det["classes"].clamp(0, roi.num_classes - 1).reshape(nb * d)
            sel = logits[torch.arange(nb * d, device=logits.device), cls]
            det["masks"] = torch.sigmoid(sel).reshape(nb, d, *sel.shape[1:])
        return det

    @torch.no_grad()
    def inference(self, images: torch.Tensor):
        """images (B, H, W, 3) -> (detections, backbone maps res2..res4)."""
        image_hw = tuple(images.shape[1:3])
        feats = self.features(images)
        boxes, _, valid = self.proposals(feats, image_hw)
        return self.detect(feats, boxes, valid, image_hw), feats
