"""ViTDet's backbone: a plain ViT and its simple feature pyramid (detectron2
``ViT`` and ``SimpleFeaturePyramid``, Li et al., arXiv:2203.16527).

The port's own model: the JAX package has no ViT.  Module and parameter
names are detectron2's, so the ``backbone.*`` part of a zoo ViTDet state
dict loads key for key (``net.patch_embed.proj.weight``, ``net.pos_embed``,
``net.blocks.2.attn.rel_pos_h``, ``simfp_2.4.norm.weight``, ...).

The trunk: a 16 x 16 patch embedding, the absolute position table of the
pre-training grid (14 x 14 after its cls slot) bicubically resized to the
token grid on every forward, then pre-norm blocks (LayerNorm, attention,
residual; LayerNorm, a GELU MLP, residual).  A windowed block zero-pads its
normalised tokens to a multiple of the window and attends inside each
window, the padded tokens taking part as keys; a global block attends over
every token.  Every attention adds decomposed relative positions: the
unscaled queries times the tables gathered at each (query, key) row and
column offset, added to the scaled scores before the softmax.  The scores
are explicit float32 batched products, so the sums run in the same order as
in the plain reference.  Drop-path is inactive at inference and left out.

The pyramid reads the last (stride 16) map: transposed 2 x 2 convolutions up
to strides 4 and 8, the map itself, a 2 x 2 max pool to stride 32; then a
bias-free 1 x 1 and 3 x 3 convolution with channel LayerNorm at each
scale; p6 is p5 taken at stride 2.  Everything computes in float32.

Tracing (``utils/profiling.py``): each attention core (the scaled scores,
the relative positions, the softmax and the product with the values; not
the qkv or output projections) is the span ``track.attn_global`` or
``track.attn_window``, and counts ``4 x heads x N_q x N_k x d`` FLOPs for
its two products plus ``2 x heads x N_q x (k_h + k_w) x d`` for the
relative-position products, over its batch of images or windows, under
``vitdet.attn_flops``, from the shapes (no sync).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from apse_uav_torch.dcnn.config import ViTConfig
from apse_uav_torch.dcnn.models.resnet import ConvLN, LayerNorm2d
from apse_uav_torch.utils import profiling

NORM_EPS = 1e-6  # every LayerNorm of the trunk
PRETRAIN_GRID = 224 // 16  # the position table's side (the pre-training images' patches), after its cls slot
SCALE_FACTORS = (4.0, 2.0, 1.0, 0.5)  # the pyramid's p2 ... p5 against the stride-16 map


@functools.lru_cache(maxsize=16)
def rel_index(q_size: int, k_size: int, device: str) -> torch.Tensor:
    """(q_size, k_size) int64 rows of a relative-position table of
    2 max(q_size, k_size) - 1 rows for each (query, key) offset along one
    axis (detectron2 ``get_rel_pos``): a device constant, made once."""
    q = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    return ((q - k) + (k_size - 1) * max(q_size / k_size, 1.0)).long().to(device)


def add_decomposed_rel_pos(attn: torch.Tensor, q: torch.Tensor, rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                           q_hw: tuple[int, int], k_hw: tuple[int, int]) -> torch.Tensor:
    """attn (B, q_h q_w, k_h k_w) plus, at each (query, key), the query's
    product with the height table at their row offset and with the width
    table at their column offset; added in place, heights first.  q (B,
    q_h q_w, d) unscaled."""
    (q_h, q_w), (k_h, k_w) = q_hw, k_hw
    if rel_pos_h.shape[0] != 2 * max(q_h, k_h) - 1 or rel_pos_w.shape[0] != 2 * max(q_w, k_w) - 1:
        raise ValueError(f"relative-position tables of {rel_pos_h.shape[0]} and {rel_pos_w.shape[0]} rows for "
                         f"{q_hw} queries and {k_hw} keys: the input is not the model's img_size")
    r_h = rel_pos_h[rel_index(q_h, k_h, str(q.device))]
    r_w = rel_pos_w[rel_index(q_w, k_w, str(q.device))]
    b, _, dim = q.shape
    r_q = q.reshape(b, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, r_h)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, r_w)
    full = attn.view(b, q_h, q_w, k_h, k_w)
    full.add_(rel_h[:, :, :, :, None]).add_(rel_w[:, :, :, None, :])
    return attn


class Attention(nn.Module):
    """Multi-head self-attention over an (B, H, W, C) grid of tokens with
    decomposed relative positions (tables sized for ``size`` x ``size``),
    its core traced as the span ``span``."""

    def __init__(self, dim: int, num_heads: int, size: int, span: str):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.span = span
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        n, heads = h * w, self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * heads, n, -1).unbind(0)
        with profiling.span(self.span):
            attn = (q * self.scale) @ k.transpose(-2, -1)
            attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, (h, w), (h, w))
            x = attn.softmax(dim=-1) @ v
        d = q.shape[-1]
        profiling.count("vitdet.attn_flops", b * heads * (4 * n * n * d + 2 * n * (h + w) * d))
        x = x.view(b, heads, h, w, -1).permute(0, 2, 3, 1, 4).reshape(b, h, w, -1)
        return self.proj(x)


class Mlp(nn.Module):
    """fc1, exact GELU, fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


def window_partition(x: torch.Tensor, window: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """(B, H, W, C) zero-padded to multiples of ``window`` -> (B * windows,
    window, window, C), windows in row-major order, and the padded (H, W)."""
    b, h, w, c = x.shape
    pad_h, pad_w = (window - h % window) % window, (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window, window, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, pad_hw: tuple[int, int],
                       hw: tuple[int, int]) -> torch.Tensor:
    """The inverse of :func:`window_partition`, the padding cut off."""
    (hp, wp), (h, w) = pad_hw, hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.view(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    return x[:, :h, :w, :].contiguous() if hp > h or wp > w else x


class Block(nn.Module):
    """A pre-norm transformer block; ``window`` > 0 attends inside windows."""

    def __init__(self, vit: ViTConfig, window: int, size: int):
        super().__init__()
        dim = vit.embed_dim
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.attn = Attention(dim, vit.num_heads, size, "track.attn_window" if window else "track.attn_global")
        self.norm2 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.mlp = Mlp(dim, int(dim * vit.mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self.window:
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window)
            x = window_unpartition(self.attn(x), self.window, pad_hw, (h, w))
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """A patch_size x patch_size / patch_size convolution: NCHW -> (B, H/p, W/p, C)."""

    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).permute(0, 2, 3, 1)


def abs_pos(pos_embed: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """The (1, 1 + S*S, C) position table as a (1, H, W, C) grid: its cls
    slot dropped, bicubically resized (``align_corners=False``) where the
    grid is not S x S."""
    pos_embed = pos_embed[:, 1:]
    size = int(math.sqrt(pos_embed.shape[1]))
    grid = pos_embed.reshape(1, size, size, -1)
    if (size, size) == tuple(hw):
        return grid
    return F.interpolate(grid.permute(0, 3, 1, 2), size=hw, mode="bicubic", align_corners=False).permute(0, 2, 3, 1)


class ViT(nn.Module):
    """The plain trunk: NCHW normalised images -> the (B, C, H/16, W/16) last map."""

    def __init__(self, vit: ViTConfig):
        super().__init__()
        self.patch_embed = PatchEmbed(vit.patch_size, vit.embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + PRETRAIN_GRID ** 2, vit.embed_dim))
        grid = vit.img_size // vit.patch_size
        windows = set(vit.window_block_indexes)
        self.blocks = nn.ModuleList(
            Block(vit, vit.window_size if i in windows else 0, vit.window_size if i in windows else grid)
            for i in range(vit.depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        x = x + abs_pos(self.pos_embed, (x.shape[1], x.shape[2]))
        for blk in self.blocks:
            x = blk(x)
        return x.permute(0, 3, 1, 2)


class ViTFeaturePyramid(nn.Module):
    """The backbone (detectron2 ``SimpleFeaturePyramid`` over ``net``, a
    :class:`ViT`): NHWC normalised images -> NHWC p2..p6 of ``channels``."""

    def __init__(self, vit: ViTConfig, channels: int = 256):
        super().__init__()
        self.net = ViT(vit)
        dim = vit.embed_dim
        self.levels = []
        for scale in SCALE_FACTORS:
            if scale == 4.0:
                layers = [nn.ConvTranspose2d(dim, dim // 2, 2, stride=2), LayerNorm2d(dim // 2), nn.GELU(),
                          nn.ConvTranspose2d(dim // 2, dim // 4, 2, stride=2)]
                out = dim // 4
            elif scale == 2.0:
                layers, out = [nn.ConvTranspose2d(dim, dim // 2, 2, stride=2)], dim // 2
            elif scale == 1.0:
                layers, out = [], dim
            else:
                layers, out = [nn.MaxPool2d(2, 2)], dim
            name = f"p{int(math.log2(vit.patch_size / scale))}"
            self.add_module(f"simfp_{name[1:]}", nn.Sequential(*layers, ConvLN(out, channels, 1),
                                                                ConvLN(channels, channels, 3)))
            self.levels.append(name)

    def forward(self, x_nhwc: torch.Tensor) -> dict[str, torch.Tensor]:
        last = self.net(x_nhwc.permute(0, 3, 1, 2).contiguous())
        maps = {name: getattr(self, f"simfp_{name[1:]}")(last) for name in self.levels}
        maps["p6"] = maps["p5"][:, :, ::2, ::2]  # detectron2's LastLevelMaxPool: a 1x1 max pool at stride 2
        return {k: v.permute(0, 2, 3, 1) for k, v in maps.items()}
