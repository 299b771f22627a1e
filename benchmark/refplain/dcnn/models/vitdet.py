"""Mask R-CNN ViTDet at inference: a plain ViT, its simple feature pyramid
and detectron2's conv-norm heads, around the R-FPN proposal selection and
ROI inference of :mod:`refplain.dcnn.models.mask_rcnn`.

Written from Li, Mao, Girshick and He, "Exploring Plain Vision Transformer
Backbones for Object Detection" (arXiv:2203.16527) and detectron2's
description of ``mask_rcnn_vitdet_b_100ep.py`` (over
``common/models/mask_rcnn_vitdet.py`` and ``mask_rcnn_fpn.py``), not from the
measured program:

* the input: RGB, normalised by the ImageNet mean and std, then padded with
  zeros at the bottom and right to a square of ``img_size`` (the padding of
  ``ImageList.from_tensors`` with ``square_pad``);
* the trunk: a ``patch_size`` x ``patch_size`` convolution at stride
  ``patch_size`` to ``embed_dim`` channels, plus the absolute position table
  learned on the pre-training grid (224 / 16 a side after a cls slot),
  bicubically resampled (``align_corners=False``) to the token grid; then
  ``depth`` blocks, each ``x + attn(norm1(x))`` and ``x + mlp(norm2(x))``
  with LayerNorm (eps 1e-6) and an MLP of ``mlp_ratio`` x width with exact
  GELU;
* attention: ``num_heads`` heads of ``embed_dim / num_heads``, a joint qkv
  projection with bias; scores ``(q * d^-0.5) k^T`` plus the decomposed
  relative positions ``rel_h[q, k] = q . R_h[row(q) - row(k) + S - 1]`` and
  ``rel_w`` alike over columns, with the unscaled query; softmax; times v;
  the output projection.  The blocks in ``window_block_indexes`` attend
  inside ``window_size`` x ``window_size`` windows: the normalised token
  grid is zero-padded to a multiple of the window first (the padded tokens
  are keys like any other), their tables have ``2 window_size - 1`` rows;
  the others attend over the whole grid with tables of ``2 grid - 1`` rows;
* the pyramid from the last, stride-16 map: scale 4 a 2 x 2 / 2 transposed
  convolution to ``dim / 2``, channel LayerNorm, GELU, another to ``dim /
  4``; scale 2 one transposed convolution to ``dim / 2``; scale 1 the map;
  scale 1/2 a 2 x 2 / 2 max pool; then at each scale a bias-free 1 x 1
  convolution to 256 and a bias-free 3 x 3, each followed by channel
  LayerNorm; p6 is p5 subsampled by a 1 x 1 max pool at stride 2
  (``LastLevelMaxPool``);
* channel LayerNorm (detectron2 ``LayerNorm``): per pixel, the channels'
  mean ``u``, ``s`` the mean of ``(x - u)^2``, ``(x - u) / sqrt(s + 1e-6)``,
  then the per-channel affine;
* the RPN head: two 3 x 3 ReLU convolutions (``conv_dims=[-1, -1]``), then
  the 1 x 1 objectness and deltas, as R-FPN's;
* the box head: four 3 x 3 ReLU convolutions of 256 on each box's 7 x 7
  features, bias-free with channel LayerNorm, then one FC of 1024 with
  ReLU (``4conv1fc``), then R-FPN's predictor;
* the mask head: four 3 x 3 convolutions of 256, bias-free with channel
  LayerNorm and ReLU, the 2 x 2 / 2 transposed convolution with ReLU and
  the 1 x 1 predictor.

Departures: drop-path (0.1 in training) is inactive at inference and left
out; the relative-position tables are used at their trained size only (the
input is always the ``img_size`` square); proposals and detections are
selected by the R-FPN reference's fixed-capacity functions (static pooler
sampling ratio, exact fixed-point NMS); boxes are clipped to the resized
image before the pad, as detectron2 clips to the image size.  Module names
are detectron2's (``backbone.net.blocks.2.attn.rel_pos_h``,
``backbone.simfp_2.4.norm.weight``, ``proposal_generator.rpn_head.conv.conv1``,
``roi_heads.box_head.conv4.norm.bias``), so a zoo ViTDet state dict loads
key for key.  Everything computes in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from refplain.dcnn.config import ModelConfig
from refplain.dcnn.models.mask_rcnn import MaskRCNN
from refplain.dcnn.models.resnet import conv
from refplain.dcnn.models.roi_heads import BoxPredictor

# mask_rcnn_vitdet.py's fixed settings: qkv with a bias, LayerNorm eps 1e-6, relative positions in every
# block, the position table of 224 / 16 pre-training patches a side plus a cls slot, the pyramid's scales.
LN_EPS = 1e-6
PRETRAIN_SIDE = 224 // 16
SCALES = (4.0, 2.0, 1.0, 0.5)


class ChannelLN(nn.Module):
    """LayerNorm over the channels of an NCHW map."""

    def __init__(self, ch: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class NormConv(nn.Conv2d):
    """A bias-free k x k convolution, then :class:`ChannelLN`."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.norm = ChannelLN(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(F.conv2d(x, self.weight, None, self.stride, self.padding))


def relative_table(size_q: int, size_k: int, table: torch.Tensor) -> torch.Tensor:
    """(size_q, size_k, d): the table's row for each query-key offset."""
    qc = torch.arange(size_q)[:, None] * max(size_k / size_q, 1.0)
    kc = torch.arange(size_k)[None, :] * max(size_q / size_k, 1.0)
    offset = (qc - kc) + (size_k - 1) * max(size_q / size_k, 1.0)
    return table[offset.long()]


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, rel_size: int):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * rel_size - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * rel_size - 1, dim // heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        qkv = self.qkv(x).reshape(b, h * w, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * self.heads, h * w, -1).unbind(0)
        scores = (q * self.scale) @ k.transpose(-2, -1)
        grid_q = q.reshape(b * self.heads, h, w, -1)
        rel_h = torch.einsum("bhwc,hkc->bhwk", grid_q, relative_table(h, h, self.rel_pos_h))
        rel_w = torch.einsum("bhwc,wkc->bhwk", grid_q, relative_table(w, w, self.rel_pos_w))
        scores = (scores.view(b * self.heads, h, w, h, w) + rel_h[:, :, :, :, None]
                  + rel_w[:, :, :, None, :]).view(b * self.heads, h * w, h * w)
        scores = scores.softmax(dim=-1)
        out = (scores @ v).view(b, self.heads, h, w, -1).permute(0, 2, 3, 1, 4).reshape(b, h, w, -1)
        return self.proj(out)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class TransformerBlock(nn.Module):
    def __init__(self, vit: dict, window: int, grid: int):
        super().__init__()
        dim = vit["embed_dim"]
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = SelfAttention(dim, vit["num_heads"], window or grid)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = FeedForward(dim, int(dim * vit["mlp_ratio"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        if self.window:
            b, h, w, c = y.shape
            s = self.window
            ph, pw = (s - h % s) % s, (s - w % s) % s
            if ph or pw:
                y = F.pad(y, (0, 0, 0, pw, 0, ph))
            hp, wp = h + ph, w + pw
            y = y.view(b, hp // s, s, wp // s, s, c).permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, s, s, c)
            y = self.attn(y)
            y = y.view(b, hp // s, wp // s, s, s, -1).permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
            if hp > h or wp > w:
                y = y[:, :h, :w, :].contiguous()
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchProjection(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class PlainViT(nn.Module):
    """NCHW normalised square images -> the NCHW stride-16 map."""

    def __init__(self, vit: dict):
        super().__init__()
        self.patch_embed = PatchProjection(vit["patch_size"], vit["embed_dim"])
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + PRETRAIN_SIDE ** 2, vit["embed_dim"]))
        grid = vit["img_size"] // vit["patch_size"]
        self.blocks = nn.ModuleList(
            TransformerBlock(vit, vit["window_size"] if i in vit["window_block_indexes"] else 0, grid)
            for i in range(vit["depth"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        table = self.pos_embed[:, 1:]
        side = int(math.sqrt(table.shape[1]))
        table = table.reshape(1, side, side, -1)
        if (side, side) != (x.shape[1], x.shape[2]):
            table = F.interpolate(table.permute(0, 3, 1, 2), size=(x.shape[1], x.shape[2]), mode="bicubic",
                                  align_corners=False).permute(0, 2, 3, 1)
        x = x + table
        for blk in self.blocks:
            x = blk(x)
        return x.permute(0, 3, 1, 2)


class SimplePyramid(nn.Module):
    """``net`` (a :class:`PlainViT`) and its pyramid: NHWC -> NHWC p2..p6."""

    def __init__(self, vit: dict, out_ch: int):
        super().__init__()
        self.net = PlainViT(vit)
        d = vit["embed_dim"]
        self.names = []
        for scale in SCALES:
            level = int(math.log2(vit["patch_size"] / scale))
            if scale == 4.0:
                pre, width = [nn.ConvTranspose2d(d, d // 2, 2, stride=2), ChannelLN(d // 2), nn.GELU(),
                              nn.ConvTranspose2d(d // 2, d // 4, 2, stride=2)], d // 4
            elif scale == 2.0:
                pre, width = [nn.ConvTranspose2d(d, d // 2, 2, stride=2)], d // 2
            elif scale == 1.0:
                pre, width = [], d
            else:
                pre, width = [nn.MaxPool2d(kernel_size=2, stride=2)], d
            self.add_module(f"simfp_{level}", nn.Sequential(*pre, NormConv(width, out_ch, 1),
                                                             NormConv(out_ch, out_ch, 3)))
            self.names.append(level)

    def forward(self, x_nhwc: torch.Tensor) -> dict[str, torch.Tensor]:
        top = self.net(x_nhwc.permute(0, 3, 1, 2).contiguous())
        maps = {f"p{lv}": getattr(self, f"simfp_{lv}")(top) for lv in self.names}
        maps["p6"] = maps["p5"][:, :, ::2, ::2]
        return {k: v.permute(0, 2, 3, 1) for k, v in maps.items()}


class TwoConvRPNHead(nn.Module):
    """StandardRPNHead with ``conv_dims=[-1] * n``: ``conv.conv0`` ... then the 1 x 1s."""

    def __init__(self, anchors: int, ch: int, n: int):
        super().__init__()
        self.anchors = anchors
        self.conv = nn.Sequential()
        for k in range(n):
            self.conv.add_module(f"conv{k}", nn.Conv2d(ch, ch, 3, padding=1))
        self.objectness_logits = nn.Conv2d(ch, anchors, 1)
        self.anchor_deltas = nn.Conv2d(ch, anchors * 4, 1)

    def forward(self, feats: dict[str, torch.Tensor]):
        logits, deltas = {}, {}
        for name, x in feats.items():
            t = x.permute(0, 3, 1, 2)
            for layer in self.conv:
                t = F.relu(conv(layer, t))
            b, _, h, w = t.shape
            logits[name] = conv(self.objectness_logits, t).permute(0, 2, 3, 1).reshape(b, h * w * self.anchors)
            deltas[name] = conv(self.anchor_deltas, t).permute(0, 2, 3, 1).reshape(b, h * w * self.anchors, 4)
        return logits, deltas


class ConvFCHead(nn.Module):
    """``4conv1fc`` (``conv_dims=[256] * 4``, the pooled width): pooled
    features, flat (N, C * R * R) -> (N, fc) float32."""

    def __init__(self, ch: int, res: int, n_conv: int, fc_dim: int):
        super().__init__()
        self.ch, self.res, self.n_conv = ch, res, n_conv
        for i in range(n_conv):
            self.add_module(f"conv{i + 1}", NormConv(ch, ch, 3))
        self.fc1 = nn.Linear(ch * res * res, fc_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], self.ch, self.res, self.res)
        for i in range(self.n_conv):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        return F.relu(self.fc1(torch.flatten(x, 1)))


class NormMaskHead(nn.Module):
    """MaskRCNNConvUpsampleHead with ``conv_norm="LN"``: (N, C, R, R) -> (N, K, 2R, 2R) logits."""

    def __init__(self, classes: int, ch: int, dim: int, n_conv: int):
        super().__init__()
        self.n_conv = n_conv
        for i in range(n_conv):
            self.add_module(f"mask_fcn{i + 1}", NormConv(ch if i == 0 else dim, dim, 3))
        self.deconv = nn.ConvTranspose2d(dim, dim, 2, stride=2)
        self.predictor = nn.Conv2d(dim, classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_conv):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return self.predictor(F.relu(self.deconv(x)))


class MaskRCNNViTDet(MaskRCNN):
    """Mask R-CNN ViTDet for inference: :class:`MaskRCNN`'s ``proposals``,
    ``detect`` and ``inference`` on the modules above.  ``features`` takes
    the resized (B, h, w, 3) RGB image before any pad and pads it itself, so
    ``inference`` clips boxes to the image.  ``vit`` and ``heads`` are the
    configuration file's ``model["vit"]`` and the head settings
    (``rpn_num_conv``, ``num_box_conv``).

    Example:
        model = MaskRCNNViTDet(cfg, model["vit"], {"rpn_num_conv": 2, ...}).to("cuda").eval()
        weights.load_detectron2(model, state_dict)
        dets, feats = model.inference(images)   # (B, 576, 1024, 3) f32 RGB
    """

    def __init__(self, cfg: ModelConfig, vit: dict, heads: dict):
        nn.Module.__init__(self)
        if cfg.compute_dtype != "float32" or cfg.head_compute_dtype not in ("", "float32"):
            raise ValueError("the ViTDet reference computes in float32 only")
        self.cfg = cfg
        self.side = vit["img_size"]
        roi = cfg.roi
        self.backbone = SimplePyramid(vit, cfg.fpn_channels)
        self.proposal_generator = nn.ModuleDict(
            {"rpn_head": TwoConvRPNHead(len(cfg.anchors.aspect_ratios), cfg.fpn_channels, heads["rpn_num_conv"])})
        self.roi_heads = nn.Module()
        self.roi_heads.box_head = ConvFCHead(cfg.fpn_channels, roi.box_pooler_resolution, heads["num_box_conv"],
                                             roi.box_fc_dim)
        self.roi_heads.box_predictor = BoxPredictor(roi.box_fc_dim, roi.num_classes)
        self.roi_heads.mask_head = NormMaskHead(roi.num_classes, cfg.fpn_channels, roi.mask_conv_dim,
                                                roi.num_mask_conv)
        self.register_buffer("pixel_mean", torch.tensor(cfg.input.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.input.pixel_std, dtype=torch.float32), persistent=False)

    def features(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """Resized (B, h, w, 3) RGB images -> NHWC p2..p6: normalised, zero-padded to the square, the pyramid."""
        x = (images - self.pixel_mean) / self.pixel_std
        x = F.pad(x, (0, 0, 0, self.side - x.shape[2], 0, self.side - x.shape[1]))
        return self.backbone(x)
