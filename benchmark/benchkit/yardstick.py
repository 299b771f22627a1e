"""The yardsticks: the card's published peaks, the least time a kernel's
bytes and operations need, and the FLOPs of the tracker's model.

Peaks are those of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data
sheet): HBM 3.35 TB/s and 67 TFLOP/s of float32 outside the tensor cores.
With TF32 off, as the tracker runs, its convolutions and products run at
that float32 rate.  A roofline share is a bound over the time measured, so
it cannot pass 100 %; one that reads higher counts too much work.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the card needs for ``nbytes`` moved once and ``ops``
    float32 operations: the larger of the two."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32)


# -- the ArUco kernels (K1-K5), counted from each call's shapes -----------------
# Each function takes the arguments a kernel wrapper was called with and
# returns (bytes, operations): every input byte read once, every output
# byte written once, and the arithmetic the algorithm needs.

def labels_work(dark, rounds: int = 3, mop: int = 8):
    """K1: the (K, win, win) dark mask read, int32 labels written; ~500e3
    operations a window for the sweep schedule."""
    return dark.numel() * 5, dark.shape[0] * 500e3


def proposals_work(pool, h: int, w: int, params):
    """K2: the pooled gray read, 17 bytes a proposal slot written; per cell
    and scale ~20 operations of score, 2 (2 r + 1) of dilation and 4 of NMS."""
    from refplain.aruco.detector import scale_plans

    plans = scale_plans(h, w, params)
    st = params.proposal_stride
    b = pool.shape[0]
    ops = b * (h // st) * (w // st) * (2 + sum(20 + 2 * (2 * e.r_d + 1) + 4 for e in plans))
    return pool.numel() * 4 + b * len(plans) * params.per_scale_k * 17, ops


def remap_work(src, map_xy, th: int = 0, tw: int = 0, *args, **kwargs):
    """K3 (gray, whole map): the source read, the map read once a batch (8
    bytes a pixel), one byte a pixel and frame written; ~36 operations of
    blend a pixel and frame and ~20 to decode a map entry."""
    px = map_xy.shape[0] * map_xy.shape[1]
    b = src.shape[0]
    return src.numel() + px * 8 + b * px, b * px * 36 + px * 20


def remap_selected_work(src, map_xy, sel, th: int, tw: int, *args, **kwargs):
    """K4 (gray, selected tiles): 3 source bytes read and one written a pixel
    of every selected tile, and the map of every tile some frame selected."""
    import torch

    tile_px = th * tw
    n_sel = int((sel >= 0).sum())
    n_any = int(torch.unique(sel[sel >= 0]).numel())
    return n_sel * tile_px * 4 + n_any * tile_px * 8, n_sel * tile_px * 36 + n_any * tile_px * 20


def pool_work(frames, st: int, out_hw):
    """K5: the u8 source read, the pooled plan written; 16 operations an output byte."""
    out = frames.shape[0] * frames.shape[1] * out_hw[0] * out_hw[1]
    return frames.numel() + out, out * 16


# Each ArUco kernel: the wrapper (module, function) the front calls, the
# counting function, and the names of its kernels in a profiler trace.
ARUCO_KERNELS = {
    "K1": ("apse_uav_torch.aruco.cuda_labeling", "labels", labels_work, ("labels_kernel",)),
    "K2": ("apse_uav_torch.aruco.cuda_proposals", "proposals_from_pool", proposals_work,
           ("integral_rows", "integral_cols", "flags_kernel", "tiles_kernel", "select_kernel")),
    "K3": ("apse_uav_torch.preproc.cuda_remap", "remap_gray", remap_work, ("remap_kernel",)),
    "K4": ("apse_uav_torch.preproc.cuda_remap", "remap_gray_selected", remap_selected_work, ()),
    "K5": ("apse_uav_torch.preproc.cuda_pool", "pool_source", pool_work, ("pool4_kernel",)),
}


# -- the tracker's model: 2 x the multiply-adds of every convolution and product --

def _conv(h: int, w: int, cin: int, cout: int, k: int) -> int:
    return h * w * cin * cout * k * k


def backbone_macs(depth: int, h: int, w: int, stride_in_1x1: bool = True) -> int:
    """The ResNet trunk (stem, res2-res5) on an (h, w) padded input."""
    from refplain.dcnn.models.resnet import STAGE_BLOCKS

    h, w = h // 2, w // 2
    macs = _conv(h, w, 3, 64, 7)
    h, w = h // 2, w // 2  # the stem's 3x3/2 max pool
    cin = 64
    for stage, n in enumerate(STAGE_BLOCKS[depth]):
        out, mid = 256 * 2 ** stage, 64 * 2 ** stage
        s = 1 if stage == 0 else 2
        ho, wo = h // s, w // s
        for b in range(n):
            c = cin if b == 0 else out
            if b == 0:
                h1, w1 = (ho, wo) if stride_in_1x1 else (h, w)
                macs += _conv(h1, w1, c, mid, 1) + _conv(ho, wo, mid, mid, 3) + _conv(ho, wo, mid, out, 1)
                macs += _conv(ho, wo, c, out, 1)  # the shortcut
            else:
                macs += _conv(ho, wo, c, mid, 1) + _conv(ho, wo, mid, mid, 3) + _conv(ho, wo, mid, out, 1)
        h, w, cin = ho, wo, out
    return macs


def level_sizes(h: int, w: int) -> list[tuple[int, int]]:
    """(h, w) of P2-P6 on an (h, w) padded input (strides 4 to 64)."""
    return [(h // 2 ** s, w // 2 ** s) for s in range(2, 7)]


def fpn_macs(h: int, w: int, channels: int = 256) -> int:
    """Lateral 1x1 and output 3x3 convolutions on P2-P5 (P6 is a max pool)."""
    return sum(_conv(lh, lw, 256 * 2 ** i, channels, 1) + _conv(lh, lw, channels, channels, 3)
               for i, (lh, lw) in enumerate(level_sizes(h, w)[:4]))


def rpn_macs(h: int, w: int, channels: int = 256, anchors: int = 3) -> int:
    """The RPN head on P2-P6: a 3x3 convolution, 1x1 objectness and deltas."""
    return sum(_conv(lh, lw, channels, channels, 3) + _conv(lh, lw, channels, 5 * anchors, 1)
               for lh, lw in level_sizes(h, w))


def box_head_macs(proposals: int, channels: int = 256, res: int = 7, fc: int = 1024, classes: int = 4) -> int:
    """Two FC layers and the predictor (classes + 1 scores, 4 deltas a class) a proposal."""
    return proposals * (channels * res * res * fc + fc * fc + fc * (classes + 1) + fc * 4 * classes)


def mask_head_macs(detections: int, channels: int = 256, res: int = 14, convs: int = 4, classes: int = 4) -> int:
    """Four 3x3 convolutions at res, the 2x2 transposed one to 2 res, the 1x1 predictor, a detection."""
    one = convs * _conv(res, res, channels, channels, 3) + _conv(res, res, channels, channels, 2)
    return detections * (one + _conv(2 * res, 2 * res, channels, classes, 1))


def tracker_flops(cfg: dict, pad_hw, detections: int, capped: int) -> float:
    """FLOPs of the tracker's model for one frame: the backbone and FPN at
    ``pad_hw``, the RPN head on P2-P6, the box head on every post-NMS
    proposal, the mask head on the ``detections`` kept, the re-ID head on
    the ``capped`` ones (``cfg`` is the configuration file's ``model`` and
    ``tracker``).  The resize to the network's input is left out: a
    bilinear resize needs tens of MFLOP, and how an implementation spends
    more on it is not the model's work."""
    m, t = cfg["model"], cfg["tracker"]
    roi = m["roi"]
    h, w = pad_hw
    ch = m["fpn_channels"]
    macs = (backbone_macs(m["depth"], h, w, m["stride_in_1x1"]) + fpn_macs(h, w, ch)
            + rpn_macs(h, w, ch, len(m["anchors"]["aspect_ratios"]))
            + box_head_macs(m["rpn"]["post_nms_topk_test"], ch, roi["box_pooler_resolution"], roi["box_fc_dim"],
                            roi["num_classes"])
            + mask_head_macs(detections, roi["mask_conv_dim"], roi["mask_pooler_resolution"], roi["num_mask_conv"],
                             roi["num_classes"])
            + capped * ch * t["roi_size"] ** 2 * t["embedding_dim"])
    return 2.0 * macs
