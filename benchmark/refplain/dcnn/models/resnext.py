"""Mask R-CNN X-FPN at inference: the R-FPN model of
:mod:`refplain.dcnn.models.mask_rcnn` on a ResNeXt trunk.

Written from detectron2's description of its ``build_resnet_backbone`` and
``BottleneckBlock`` (``mask_rcnn_X_101_32x8d_FPN_3x.yaml``: ``NUM_GROUPS``
32, ``WIDTH_PER_GROUP`` 8, ``STRIDE_IN_1X1`` False), not from the measured
program.  A bottleneck is a 1 x 1 convolution to the bottleneck width, a
3 x 3 convolution in ``num_groups`` groups (each group sees only its own
``width / num_groups`` input channels), and a 1 x 1 back to the stage's
output width, each followed by frozen BN, ReLU after the first two and
after the residual add; the shortcut is a 1 x 1 convolution with frozen BN
in each stage's first block.  The bottleneck width is ``num_groups *
width_per_group`` in res2 and doubles with each stage (256, 512, 1024, 2048
for 32x8d), as the output width does (256 ... 2048).  With
``stride_in_1x1`` False the first block's stride (2 from res3 on) sits on
the 3 x 3 convolution.  Module names are detectron2's, so a zoo X-FPN state
dict loads key for key.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from refplain.dcnn.config import ModelConfig
from refplain.dcnn.models.mask_rcnn import MaskRCNN, ROIHeads, check_supported, compute_dtypes
from refplain.dcnn.models.resnet import FPN, STAGE_BLOCKS, FrozenBN, Stem, memory_format
from refplain.dcnn.models.rpn import RPNHead


class ConvBN(nn.Conv2d):
    """A bias-free convolution in ``groups`` groups, then frozen BN (detectron2 ``Conv2d`` with ``norm``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, groups: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2, groups=groups, bias=False)
        self.norm = FrozenBN(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        return self.norm(F.conv2d(x, w, None, self.stride, self.padding, self.dilation, self.groups))


class ResNeXtBlock(nn.Module):
    """detectron2 BottleneckBlock with a grouped 3 x 3."""

    def __init__(self, in_ch: int, out_ch: int, width: int, stride: int, groups: int, stride_in_1x1: bool):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvBN(in_ch, width, 1, s1)
        self.conv2 = ConvBN(width, width, 3, s3, groups)
        self.conv3 = ConvBN(width, out_ch, 1)
        self.shortcut = ConvBN(in_ch, out_ch, 1, stride) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        y = self.conv3(y)
        return F.relu(y + (x if self.shortcut is None else self.shortcut(x)))


class ResNeXt(nn.Module):
    """Bottom-up trunk: NCHW input -> {"res2": (B, 256, H/4, W/4), ..., "res5": (B, 2048, H/32, W/32)}."""

    def __init__(self, depth: int, num_groups: int, width_per_group: int, stride_in_1x1: bool):
        super().__init__()
        self.stem = Stem()
        self.names = []
        in_ch, out_ch, width = 64, 256, num_groups * width_per_group
        for i, n in enumerate(STAGE_BLOCKS[depth]):
            blocks = [ResNeXtBlock(in_ch if b == 0 else out_ch, out_ch, width, 2 if b == 0 and i > 0 else 1,
                                   num_groups, stride_in_1x1) for b in range(n)]
            self.names.append(f"res{i + 2}")
            self.add_module(self.names[-1], nn.Sequential(*blocks))
            in_ch, out_ch, width = out_ch, 2 * out_ch, 2 * width

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = self.stem(x)
        outs = {}
        for name in self.names:
            x = getattr(self, name)(x)
            outs[name] = x
        return outs


class ResNeXtFPN(FPN):
    """The backbone: NHWC normalised images -> NHWC res2..res5 and p2..p6."""

    def __init__(self, depth: int, num_groups: int, width_per_group: int, channels: int = 256,
                 stride_in_1x1: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(channels)
        self.bottom_up = ResNeXt(depth, num_groups, width_per_group, stride_in_1x1)
        self.dtype = dtype

    def forward(self, x_nhwc: torch.Tensor) -> dict[str, torch.Tensor]:
        x = x_nhwc.permute(0, 3, 1, 2).to(self.dtype)
        res = self.bottom_up(x.contiguous(memory_format=memory_format(self.dtype)))
        maps = {**res, **self.pyramid(res)}
        return {k: v.permute(0, 2, 3, 1) for k, v in maps.items()}


class MaskRCNNX(MaskRCNN):
    """Mask R-CNN X-FPN for inference: :class:`MaskRCNN` (its ``features``,
    ``proposals``, ``detect``, ``inference``) on :class:`ResNeXtFPN`.

    Example:
        model = MaskRCNNX(cfg, 32, 8).to("cuda").eval()
        weights.load_detectron2(model, state_dict)
        dets, feats = model.inference(images)   # images (B, H, W, 3) f32 BGR
    """

    def __init__(self, cfg: ModelConfig, num_groups: int, width_per_group: int):
        nn.Module.__init__(self)
        check_supported(cfg)
        self.cfg = cfg
        dtype, head_dtype = compute_dtypes(cfg)
        self.backbone = ResNeXtFPN(cfg.depth, num_groups, width_per_group, cfg.fpn_channels, cfg.stride_in_1x1,
                                   dtype)
        self.proposal_generator = nn.ModuleDict(
            {"rpn_head": RPNHead(len(cfg.anchors.aspect_ratios), cfg.fpn_channels, head_dtype)})
        self.roi_heads = ROIHeads(cfg)
        self.register_buffer("pixel_mean", torch.tensor(cfg.input.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.input.pixel_std, dtype=torch.float32), persistent=False)
