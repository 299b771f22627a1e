"""ResNet-50/101 and ResNeXt + FPN backbone (detectron2's ``build_resnet_fpn_backbone``).

Counterpart of the JAX reference's ``dcnn/models/resnet.py``.  Module and
parameter names are detectron2's, so the state dict of
:class:`ResNetFPN` is the ``backbone.*`` part of a detectron2 GeneralizedRCNN
checkpoint, key for key (``bottom_up.stem.conv1.weight``,
``bottom_up.res2.0.conv1.norm.running_var``, ``fpn_lateral2.bias``, ...).

Layout: the public maps are NHWC (B, H, W, C), as in the reference: views of
the NCHW tensors the convolutions run on (cuDNN's float32 kernels take
NCHW; ``channels_last`` input made it transpose around every convolution).
The convolutions are library calls (cuDNN on the card), but for a ResNeXt
bottleneck's grouped 3x3 in float32 inference on the card, which is a
hand-written kernel (``csrc/gconv.cu``); frozen batch norm is an explicit
per-channel affine, computed as the reference does.

``dtype`` is the compute dtype (the config's ``compute_dtype``): the input is
cast to it, parameters stay float32 and are cast at use (:func:`conv`), and
every map comes out in it.  In bfloat16 the convolutions run on
``channels_last`` tensors, the layout of the card's bf16 tensor-core kernels.

ResNeXt (``num_groups`` > 1, detectron2's ``RESNETS.NUM_GROUPS`` and
``WIDTH_PER_GROUP``): each bottleneck's 3x3 convolution runs in
``num_groups`` groups and the bottleneck is ``num_groups * width_per_group *
2**stage`` channels wide (X101-32x8d: 256 in res2 ... 2048 in res5).  Only
such a grouped convolution is traced (``utils/profiling.py``): the
convolution alone is the span ``track.gconv``, and its FLOPs count under
``x101.gconv_flops``, from the shapes (no sync).  A plain ResNet's blocks
open no span and count nothing.

:class:`LayerNorm2d` and :class:`ConvLN` are detectron2's ``LayerNorm``
(over the channels of an NCHW map) and its bias-free ``Conv2d`` with
``norm="LN"``, the layers of ViTDet's feature pyramid and heads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from apse_uav_torch.dcnn import cuda_gconv
from apse_uav_torch.utils import profiling

STAGE_BLOCKS = {
    # depth 26 = one bottleneck per stage: the smallest config with the same topology.
    26: (1, 1, 1, 1),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


def conv(m: nn.Conv2d | nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """The convolution ``m`` computed in x's dtype, as a flax layer with
    ``dtype=`` computes it: the float32 parameters cast at use and, in a
    reduced dtype, the bias added after the product is rounded."""
    same = x.dtype == m.weight.dtype
    w = m.weight if same else m.weight.to(x.dtype)
    b = m.bias if same else None
    if isinstance(m, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, w, b, m.stride, m.padding, m.output_padding, m.groups, m.dilation)
    else:
        y = F.conv2d(x, w, b, m.stride, m.padding, m.dilation, m.groups)
    return y if same or m.bias is None else y + m.bias.to(x.dtype)[:, None, None]


class FrozenBN(nn.Module):
    """BatchNorm with frozen statistics: y = x * (scale / sqrt(var + eps)) + (bias - mean * scale / sqrt(var + eps)).

    detectron2's FrozenBatchNorm2d buffers (weight, bias, running_mean,
    running_var) on (B, C, H, W) inputs."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        mult = self.weight * inv
        add = self.bias - self.running_mean * self.weight * inv
        return x * mult[None, :, None, None].to(x.dtype) + add[None, :, None, None].to(x.dtype)


class ConvNorm(nn.Conv2d):
    """Bias-free convolution followed by FrozenBN (detectron2 ``Conv2d`` with ``norm``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, groups: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2, groups=groups, bias=False)
        self.norm = FrozenBN(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(conv(self, x))


class LayerNorm2d(nn.Module):
    """detectron2 ``LayerNorm``: each pixel of an NCHW map normalised over its
    channels (mean, then the mean of the squared deviations; eps 1e-6),
    then a per-channel affine."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class ConvLN(nn.Conv2d):
    """Bias-free convolution followed by :class:`LayerNorm2d` (detectron2
    ``Conv2d`` with ``norm="LN"``), float32."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__(in_ch, out_ch, kernel, padding=kernel // 2, bias=False)
        self.norm = LayerNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(F.conv2d(x, self.weight, None, self.stride, self.padding))


class GroupedConvNorm(ConvNorm):
    """A :class:`ConvNorm` in more than one group (a ResNeXt bottleneck's
    3x3): the convolution alone is the span ``track.gconv``, and each call
    counts 2 x N x C_out x H_out x W_out x (C_in / groups) x k x k FLOPs
    under ``x101.gconv_flops``.

    On a CUDA float32 input with no gradient to record, the convolution runs
    the hand-written kernel (:mod:`apse_uav_torch.dcnn.cuda_gconv`, one
    launch), which raises on a shape it does not take; otherwise (the CPU,
    bfloat16, autograd) :func:`conv`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with profiling.span("track.gconv"):
            if self._on_kernel(x):
                y = cuda_gconv.conv(x, self.weight, self.stride, self.groups)
            else:
                y = conv(self, x)
        profiling.count("x101.gconv_flops", 2 * y.numel() * math.prod(self.weight.shape[1:]))
        return self.norm(y)

    def _on_kernel(self, x: torch.Tensor) -> bool:
        grad = torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad)
        return x.is_cuda and x.dtype == torch.float32 and not grad


class Bottleneck(nn.Module):
    """detectron2 BottleneckBlock; ``stride_in_1x1`` puts the stride on conv1
    (the MSRA / caffe-style weights of the model zoo), else on conv2;
    ``groups`` > 1 splits conv2 into that many groups (ResNeXt)."""

    def __init__(self, in_ch: int, out_ch: int, bottleneck_ch: int, stride: int = 1, stride_in_1x1: bool = True,
                 groups: int = 1):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvNorm(in_ch, bottleneck_ch, 1, s1)
        self.conv2 = (GroupedConvNorm if groups > 1 else ConvNorm)(bottleneck_ch, bottleneck_ch, 3, s3, groups)
        self.conv3 = ConvNorm(bottleneck_ch, out_ch, 1)
        self.shortcut = ConvNorm(in_ch, out_ch, 1, stride) if (in_ch != out_ch or stride != 1) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = self.shortcut(x) if self.shortcut is not None else x
        return F.relu(out + sc)


class Stem(nn.Module):
    """7x7/2 convolution + FrozenBN + ReLU + 3x3/2 max pool (padding 1)."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvNorm(3, 64, 7, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(F.relu(self.conv1(x)), 3, 2, 1)


def stage_blocks(depth: int, stage: int, stride_in_1x1: bool, num_groups: int = 1,
                 width_per_group: int = 64) -> nn.Sequential:
    """ResNet stage ``stage`` (0 = res2 ... 3 = res5): its bottlenecks, the
    first with the shortcut and (from res3 on) stride 2, each
    ``num_groups * width_per_group * 2**stage`` wide inside."""
    out_ch, mid_ch = 256 * 2**stage, num_groups * width_per_group * 2**stage
    in_ch = 64 if stage == 0 else out_ch // 2
    return nn.Sequential(*[Bottleneck(in_ch if b == 0 else out_ch, out_ch, mid_ch,
                                      (1 if stage == 0 else 2) if b == 0 else 1, stride_in_1x1, num_groups)
                           for b in range(STAGE_BLOCKS[depth][stage])])


class ResNet(nn.Module):
    """Bottom-up trunk: NCHW input -> {"res2": (B, 256, H/4, W/4), ..., "res5": (B, 2048, H/32, W/32)}.

    ``max_stage`` truncates the trunk: the C4 backbone (Base-RCNN-C4.yaml)
    ends at res4 and runs res5 in its ROI head (:class:`Res5Stage`).
    ``num_groups`` and ``width_per_group`` make it a ResNeXt."""

    def __init__(self, depth: int = 50, stride_in_1x1: bool = True, max_stage: int = 5, num_groups: int = 1,
                 width_per_group: int = 64):
        super().__init__()
        self.stem = Stem()
        self.names = [f"res{stage + 2}" for stage in range(max_stage - 1)]
        for stage, name in enumerate(self.names):
            self.add_module(name, stage_blocks(depth, stage, stride_in_1x1, num_groups, width_per_group))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = self.stem(x)
        outs = {}
        for name in self.names:
            x = getattr(self, name)(x)
            outs[name] = x
        return outs


class Res5Stage(nn.Sequential):
    """The res5 stage alone, the C4 ROI head's shared transform (detectron2
    ``Res5ROIHeads.res5``): pooled (N, 1024, 14, 14) ROI features -> (N,
    2048, 7, 7) through the stride-2 first block, computed in ``dtype`` (the
    backbone's compute dtype, as in the reference)."""

    def __init__(self, depth: int = 50, stride_in_1x1: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(*stage_blocks(depth, 3, stride_in_1x1))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return super().forward(x.contiguous(memory_format=memory_format(self.dtype)))


def memory_format(dtype: torch.dtype) -> torch.memory_format:
    """``channels_last`` in bfloat16 (the layout of the card's bf16
    tensor-core convolutions), else NCHW (cuDNN's float32 kernels take it;
    ``channels_last`` made them transpose around every convolution)."""
    return torch.channels_last if dtype == torch.bfloat16 else torch.contiguous_format


class FPN(nn.Module):
    """P2..P6 over res2..res5 (detectron2 semantics): 1x1 laterals, nearest x2
    top-down upsampling cropped to odd lateral sizes, 3x3 outputs, and P6 =
    P5 taken at stride 2."""

    def __init__(self, channels: int = 256, in_channels=(256, 512, 1024, 2048)):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"fpn_lateral{i + 2}", nn.Conv2d(c, channels, 1))
            self.add_module(f"fpn_output{i + 2}", nn.Conv2d(channels, channels, 3, padding=1))

    def pyramid(self, feats: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """NCHW res2..res5 -> NCHW p2..p6."""
        laterals = [conv(getattr(self, f"fpn_lateral{i + 2}"), feats[f"res{i + 2}"]) for i in range(4)]
        td = [None, None, None, laterals[3]]
        for i in (2, 1, 0):
            up = F.interpolate(td[i + 1], scale_factor=2.0, mode="nearest")
            lh, lw = laterals[i].shape[2:]
            td[i] = laterals[i] + up[:, :, :lh, :lw]
        outs = {f"p{i + 2}": conv(getattr(self, f"fpn_output{i + 2}"), td[i]) for i in range(4)}
        outs["p6"] = outs["p5"][:, :, ::2, ::2]
        return outs


class ResNetFPN(FPN):
    """The backbone: NHWC normalised images -> NHWC res2..res5 and p2..p6
    maps (the tracker reads p2 for its re-ID embeddings)."""

    def __init__(self, depth: int = 50, channels: int = 256, stride_in_1x1: bool = True,
                 dtype: torch.dtype = torch.float32, num_groups: int = 1, width_per_group: int = 64):
        super().__init__(channels)
        self.bottom_up = ResNet(depth, stride_in_1x1, num_groups=num_groups, width_per_group=width_per_group)
        self.dtype = dtype

    def forward(self, x_nhwc: torch.Tensor) -> dict[str, torch.Tensor]:
        x = x_nhwc.permute(0, 3, 1, 2).to(self.dtype)
        res = self.bottom_up(x.contiguous(memory_format=memory_format(self.dtype)))
        maps = {**res, **self.pyramid(res)}
        return {k: v.permute(0, 2, 3, 1) for k, v in maps.items()}
