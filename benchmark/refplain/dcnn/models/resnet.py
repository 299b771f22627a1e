"""ResNet-50/101 + FPN backbone (detectron2's ``build_resnet_fpn_backbone``).

Counterpart of the JAX reference's ``dcnn/models/resnet.py``.  Module and
parameter names are detectron2's, so the state dict of
:class:`ResNetFPN` is the ``backbone.*`` part of a detectron2 GeneralizedRCNN
checkpoint, key for key (``bottom_up.stem.conv1.weight``,
``bottom_up.res2.0.conv1.norm.running_var``, ``fpn_lateral2.bias``, ...).

Layout: the public maps are NHWC (B, H, W, C), as in the reference: views of
the NCHW tensors the convolutions run on (cuDNN's float32 kernels take
NCHW; ``channels_last`` input made it transpose around every convolution).
The convolutions are library calls (cuDNN on the card); frozen batch norm is
an explicit per-channel affine, computed as the reference does.

``dtype`` is the compute dtype (the config's ``compute_dtype``): the input is
cast to it, parameters stay float32 and are cast at use (:func:`conv`), and
every map comes out in it.  In bfloat16 the convolutions run on
``channels_last`` tensors, the layout of the card's bf16 tensor-core kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2, bias=False)
        self.norm = FrozenBN(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(conv(self, x))


class Bottleneck(nn.Module):
    """detectron2 BottleneckBlock; ``stride_in_1x1`` puts the stride on conv1
    (the MSRA / caffe-style weights of the model zoo), else on conv2."""

    def __init__(self, in_ch: int, out_ch: int, bottleneck_ch: int, stride: int = 1, stride_in_1x1: bool = True):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvNorm(in_ch, bottleneck_ch, 1, s1)
        self.conv2 = ConvNorm(bottleneck_ch, bottleneck_ch, 3, s3)
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


def stage_blocks(depth: int, stage: int, stride_in_1x1: bool) -> nn.Sequential:
    """ResNet stage ``stage`` (0 = res2 ... 3 = res5): its bottlenecks, the
    first with the shortcut and (from res3 on) stride 2."""
    out_ch, mid_ch = 256 * 2**stage, 64 * 2**stage
    in_ch = 64 if stage == 0 else out_ch // 2
    return nn.Sequential(*[Bottleneck(in_ch if b == 0 else out_ch, out_ch, mid_ch,
                                      (1 if stage == 0 else 2) if b == 0 else 1, stride_in_1x1)
                           for b in range(STAGE_BLOCKS[depth][stage])])


class ResNet(nn.Module):
    """Bottom-up trunk: NCHW input -> {"res2": (B, 256, H/4, W/4), ..., "res5": (B, 2048, H/32, W/32)}.

    ``max_stage`` truncates the trunk."""

    def __init__(self, depth: int = 50, stride_in_1x1: bool = True, max_stage: int = 5):
        super().__init__()
        self.stem = Stem()
        self.names = [f"res{stage + 2}" for stage in range(max_stage - 1)]
        for stage, name in enumerate(self.names):
            self.add_module(name, stage_blocks(depth, stage, stride_in_1x1))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = self.stem(x)
        outs = {}
        for name in self.names:
            x = getattr(self, name)(x)
            outs[name] = x
        return outs


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
                 dtype: torch.dtype = torch.float32):
        super().__init__(channels)
        self.bottom_up = ResNet(depth, stride_in_1x1)
        self.dtype = dtype

    def forward(self, x_nhwc: torch.Tensor) -> dict[str, torch.Tensor]:
        x = x_nhwc.permute(0, 3, 1, 2).to(self.dtype)
        res = self.bottom_up(x.contiguous(memory_format=memory_format(self.dtype)))
        maps = {**res, **self.pyramid(res)}
        return {k: v.permute(0, 2, 3, 1) for k, v in maps.items()}
