"""The yardsticks: the tracker's FLOPs against PyTorch's own count of the
plain model's layers, and K1-K5's bytes and operations against the bounds
the measured package's smoke run gave at the main path's shapes."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_small import spec
from benchkit import yardstick


def _counted(module, x) -> int:
    with FlopCounterMode(display=False) as fc:
        module(x)
    return fc.get_total_flops()


@pytest.mark.parametrize("depth", [50, 101])
def test_backbone_and_fpn_flops(depth):
    """R-FPN at 768x1344 on the meta device: FlopCounterMode counts every
    convolution of the plain model; the hand count has to agree exactly."""
    from refplain.dcnn.models.resnet import ResNetFPN

    with torch.device("meta"):
        net = ResNetFPN(depth, 256, True, torch.float32)
        x = torch.empty(1, 768, 1344, 3)
    hand = 2 * (yardstick.backbone_macs(depth, 768, 1344) + yardstick.fpn_macs(768, 1344))
    assert _counted(net, x) == hand


def test_heads_flops():
    """RPN head on P2-P6, box head on 1,000 proposals, mask head on 7
    detections: FlopCounterMode on the plain heads against the hand count."""
    from benchkit.refmodel import model_config
    from refplain.dcnn.models.roi_heads import BoxHead, BoxPredictor, MaskHead
    from refplain.dcnn.models.rpn import RPNHead

    cfg = model_config(spec.find_cell("track-r101fpn-b4").config["model"])
    roi = cfg.roi
    with torch.device("meta"):
        rpn = RPNHead(3, 256, torch.float32)
        maps = {f"p{i + 2}": torch.empty(1, h, w, 256) for i, (h, w) in enumerate(yardstick.level_sizes(768, 1344))}
        box = torch.nn.Sequential(BoxHead(256 * 49, roi.box_fc_dim, roi.num_box_fc),
                                  BoxPredictor(roi.box_fc_dim, roi.num_classes))
        mask = MaskHead(roi.num_classes, 256, roi.mask_conv_dim, roi.num_mask_conv)
        rois = torch.empty(1000, 256 * 49)
        mrois = torch.empty(7, 256, 14, 14)
    assert _counted(rpn, maps) == 2 * yardstick.rpn_macs(768, 1344)
    assert _counted(box, rois) == 2 * yardstick.box_head_macs(1000)
    assert _counted(mask, mrois) == 2 * yardstick.mask_head_macs(7)


def test_tracker_flops_a_frame():
    """~590 GFLOP a frame of the model at 10 detections, the resize not counted:
    the sum of the parts that the tests above hold to FlopCounterMode."""
    cell = spec.find_cell("track-r101fpn-b4")
    f = yardstick.tracker_flops(cell.config, (768, 1344), 10, 10)
    parts = (yardstick.backbone_macs(101, 768, 1344) + yardstick.fpn_macs(768, 1344) + yardstick.rpn_macs(768, 1344)
             + yardstick.box_head_macs(1000) + yardstick.mask_head_macs(10) + 10 * 256 * 10 ** 2 * 128)
    assert f == 2 * parts
    assert 540e9 < f < 620e9


def test_aruco_kernel_bounds_at_the_main_path():
    """K2, K3 (pooled plan), K5 at 8 frames of 3840x2160: the bounds of the
    measured package's table of kernels (PERF.md), to its 5 digits."""
    from refplain.aruco.detector import DetectorParams

    p = DetectorParams()
    frames = torch.empty(8, 3, 2160, 3840, dtype=torch.uint8, device="meta")
    pooled = torch.empty(8, 3, 544, 1024, dtype=torch.uint8, device="meta")  # the pooled plan, pad included
    map_pooled = torch.empty(544, 1024, 2, device="meta")
    pool = torch.empty(8, 540, 960, device="meta")
    ms = lambda w: yardstick.bound_s(*w) * 1e3  # noqa: E731
    assert ms(yardstick.pool_work(frames, 4, (544, 1024))) == pytest.approx(0.06341, abs=5e-6)
    assert ms(yardstick.remap_work(pooled, map_pooled)) == pytest.approx(0.00665, abs=5e-6)
    assert ms(yardstick.proposals_work(pool, 2160, 3840, p)) == pytest.approx(0.03305, abs=5e-6)
    # K1 on 8 frames of 10 candidate windows of 64x64 (its bound is by operations).
    dark = torch.empty(80, 64, 64, dtype=torch.bool, device="meta")
    assert ms(yardstick.labels_work(dark)) == pytest.approx(80 * 500e3 / 67e12 * 1e3)


def test_k4_counts_selected_and_distinct_tiles():
    src = torch.zeros(2, 3, 64, 128, dtype=torch.uint8)
    map_xy = torch.zeros(64, 128, 2)
    sel = torch.tensor([[0, 1, -1], [1, 2, -1]], dtype=torch.int32)
    nbytes, ops = yardstick.remap_selected_work(src, map_xy, sel, 32, 64)
    tile = 32 * 64
    assert nbytes == 4 * tile * 4 + 3 * tile * 8 and ops == 4 * tile * 36 + 3 * tile * 20
