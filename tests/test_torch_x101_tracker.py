"""PyTorch port, Mask R-CNN X101-32x8d-FPN through the tracker (``track_uav
--resnext 32x8d``) on the CPU, held to the benchmark's plain X-FPN reference
(``benchmark/``: ``refplain/dcnn/models/resnext.py``,
``benchkit/refmodel_x101.py``).

The model is X-26-FPN (one bottleneck a stage, the published 32 groups of
8, 16, 32 and 64 channels, the stride on the 3x3) on 96x160 frames resized
to 64x128, with 100 boxes before the RPN's NMS, 16 after and 8 detection
slots, on the benchmark's seeded X101 weights and their calibration.  Both
sides run the same float32 operations in the same order, so every number
the benchmark compares reads exactly 0.  Also: ``track_uav``'s
``--resnext``, the grouped-convolution spans and counter, the X101 FLOP
count against ``FlopCounterMode``, grouped ``conv2`` weights in
``load_detectron2`` and the flax init, grouped C4 refused, and R101's
forward unchanged by the group fields.
"""

import copy
import dataclasses
import os
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from benchkit import spec, weights_x101, yardstick_x101  # noqa: E402
from benchkit.context import Checks  # noqa: E402
from benchkit.refmodel import tracker_config  # noqa: E402
from benchkit.refmodel_x101 import RefTrackerX101, model_config_x101  # noqa: E402
from refplain.dcnn.models.association import AssociationHead as RefAssociationHead  # noqa: E402
from refplain.dcnn.models.resnet import ResNetFPN as RefResNetFPN  # noqa: E402
from refplain.dcnn.models.resnext import MaskRCNNX as RefMaskRCNNX  # noqa: E402

from apse_uav_torch.cli.track_uav import build_parser, build_tracker, model_config, track_frames  # noqa: E402
from apse_uav_torch.dcnn import config as pconfig, flax_init, weights as pweights  # noqa: E402
from apse_uav_torch.dcnn.engines import RcnnTracker  # noqa: E402
from apse_uav_torch.dcnn.models.c4 import build_model  # noqa: E402
from apse_uav_torch.dcnn.models.mask_rcnn import MaskRCNN  # noqa: E402
from apse_uav_torch.dcnn.models.resnet import GroupedConvNorm, ResNetFPN  # noqa: E402
from apse_uav_torch.utils import profiling  # noqa: E402

CELL = "x101fpn-b4"
HW = (96, 160)
B = 2
SEED = 2 ** 33 + 11
CPU = torch.device("cpu")


def small_config() -> dict:
    """The cell's configuration file, cut to the CPU's size (depth 26)."""
    cfg = copy.deepcopy(spec.find_cell(CELL).config)
    m = cfg["model"]
    m["depth"] = 26
    m["input"]["min_size_test"], m["input"]["max_size_test"] = 64, 128
    m["rpn"]["pre_nms_topk_test"], m["rpn"]["post_nms_topk_test"] = 100, 16
    m["roi"]["detections_per_image"] = 8
    return cfg


@pytest.fixture(scope="module")
def x101():
    """The port's X-26 RcnnTracker and the plain reference tracker on the same
    seeded, calibrated weights, and four preprocessed frames (two batches)."""
    cfg = small_config()
    m, t = cfg["model"], cfg["tracker"]
    g = torch.Generator().manual_seed(SEED)
    raw = torch.randint(0, 256, (2 * B, *HW, 3), generator=g, dtype=torch.uint8)
    ckpt, assoc = weights_x101.seeded_weights(SEED, m, m["fpn_channels"] * t["roi_size"] ** 2, t["embedding_dim"],
                                              CPU)
    ref = RefTrackerX101(m, t, ckpt, assoc, HW, cfg["camera"], CPU)
    calibration = weights_x101.calibrate_background(ckpt, ref, list(raw.numpy()), cfg["calibration"]["per_frame"],
                                                    B)
    frames, _ = ref.pre(raw, with_gray=False)  # undistorted, as --preprocess hands them to the tracker
    port = RcnnTracker(model_config_x101(m, pconfig), tracker_config(t, pconfig), ckpt, assoc, HW, device="cpu")
    return {"cfg": cfg, "ckpt": ckpt, "ref": ref, "port": port, "frames": frames, "calibration": calibration}


def test_x101_tracker_matches_plain_reference(x101):
    """Two batches from the fresh state: detections, masks, snapshots (ids,
    classes, embeddings) and the track state after each batch, under the
    cell's limits; every number reads exactly 0."""
    driver = spec.find_cell(CELL).driver
    port, ref = x101["port"], x101["ref"]
    assert min(x101["calibration"]["candidates_per_frame"]) >= x101["cfg"]["calibration"]["per_frame"]
    port.reset()
    checks = Checks(driver.LIMITS)
    detections = tracks = 0
    for k in range(2):
        x = x101["frames"][k * B:(k + 1) * B]
        before = port.state
        pending = port.process_frames_async(x)
        snaps = port.materialize(pending)
        rdets, feats = ref.detect(x)
        driver.compare_detections(pending[0], rdets, checks)
        state, recents = ref.associate(before, *ref.embed(rdets, feats))
        for j in range(B):
            driver.compare_snapshot({key: v[j] for key, v in snaps.items()},
                                    {key: v[j].numpy() for key, v in recents.items()}, checks)
        driver.compare_state(port.state, state, checks)
        detections += int(pending[0]["valid"].sum())
        tracks += int(snaps["valid"].sum())
    assert {k: v["value"] for k, v in checks.as_dict().items()} == {k: 0.0 for k in driver.LIMITS}
    assert detections > 0 and tracks > 0


def test_x101_model_is_the_published_trunk():
    """X101-32x8d's trunk on the meta device: 33 grouped 3x3s of 32 groups,
    256 ... 2048 wide, the stride on the 3x3, 86.5 M convolution weights."""
    with torch.device("meta"):
        model = build_model(pconfig.mask_rcnn_x101_32x8d_fpn(4))
    trunk = model.backbone.bottom_up
    grouped = [m for m in trunk.modules() if isinstance(m, GroupedConvNorm)]
    assert len(grouped) == 33 and {m.groups for m in grouped} == {32}
    assert [trunk.res2[0].conv2.out_channels, trunk.res3[0].conv2.out_channels, trunk.res4[0].conv2.out_channels,
            trunk.res5[0].conv2.out_channels] == [256, 512, 1024, 2048]
    assert trunk.res3[0].conv1.stride == (1, 1) and trunk.res3[0].conv2.stride == (2, 2)
    weights = sum(m.weight.numel() for m in trunk.modules() if isinstance(m, torch.nn.Conv2d))
    assert round(weights / 1e6, 1) == 86.5


@pytest.mark.parametrize("argv,preset", [
    ([], pconfig.mask_rcnn_r101_fpn),
    (["--resnext", "32x8d"], pconfig.mask_rcnn_x101_32x8d_fpn),
    (["--resnext", "32x8d", "--arch", "fpn", "--depth", "101"], pconfig.mask_rcnn_x101_32x8d_fpn),
])
def test_track_uav_resnext_picks_the_preset(argv, preset):
    """``--resnext 32x8d`` gives mask_rcnn_x101_32x8d_fpn (32 groups of 8,
    the stride on the 3x3, the ImageNet pixel std), otherwise R101-FPN;
    ``--confidence`` applies to both."""
    args = build_parser().parse_args(["--images", ".", "--weights", "w.pth", "--confidence", "0.6"] + argv)
    cfg = model_config(args)
    want = preset(4)
    assert cfg == dataclasses.replace(want, roi=dataclasses.replace(want.roi, score_thresh_test=0.6))
    grouped = "--resnext" in argv
    assert (cfg.num_groups, cfg.width_per_group, cfg.stride_in_1x1) == ((32, 8, False) if grouped else (1, 64, True))
    assert cfg.input.pixel_std == ((57.375, 57.120, 58.395) if grouped else (1.0, 1.0, 1.0))


@pytest.mark.parametrize("argv", [["--arch", "c4"], ["--depth", "50"]])
def test_track_uav_resnext_needs_r_fpn_101(argv):
    args = build_parser().parse_args(["--images", ".", "--weights", "w.pth", "--resnext", "32x8d"] + argv)
    with pytest.raises(SystemExit, match="--resnext 32x8d needs --arch fpn --depth 101"):
        model_config(args)


def test_check_supported_rejects_grouped_c4():
    """detectron2's zoo has no X101-C4: a grouped C4 config is refused; the
    grouped FPN config builds MaskRCNN."""
    c4 = pconfig.mask_rcnn_r101_c4(4)
    with torch.device("meta"):
        for groups in ((32, 8), (1, 128)):
            with pytest.raises(ValueError, match="ResNeXt bottlenecks run only in 'fpn'"):
                build_model(dataclasses.replace(c4, num_groups=groups[0], width_per_group=groups[1]))
        assert type(build_model(pconfig.mask_rcnn_x101_32x8d_fpn(4))) is MaskRCNN


def test_build_tracker_resnext_tracks_through_track_frames(x101, tmp_path):
    """``build_tracker`` for ``--resnext 32x8d`` (the X-26 config in place
    of the preset) loads the grouped checkpoint whole, and ``track_frames``
    runs it to its snapshots."""
    path = str(tmp_path / "x26.pth")
    torch.save({"model": x101["ckpt"]}, path)
    args = build_parser().parse_args(["--images", str(tmp_path), "--weights", path, "--resnext", "32x8d",
                                      "--device", "cpu"])
    cfg = model_config_x101(x101["cfg"]["model"], pconfig)
    tracker, pre = build_tracker(args, HW, cfg=cfg)
    assert pre is None and not tracker.predictor.missing and tracker.reid == "p2"
    assert tracker.predictor.model.backbone.bottom_up.res4[0].conv2.weight.shape == (1024, 32, 3, 3)
    frames = [(i, f) for i, f in enumerate(x101["frames"][:B].numpy())]
    out = list(track_frames(tracker, None, frames, B))
    assert [idx for idx, _, _ in out] == list(range(B))


def test_gconv_spans_and_counter(x101):
    """A batch opens one ``track.gconv`` span a bottleneck inside
    ``track.features``, and the counter reads the grouped convolutions'
    FLOPs that the benchmark's yardstick counts from the shapes."""
    cfg = x101["cfg"]
    port = x101["port"]
    profiling.reset_spans()
    profiling.reset_counters()
    profiling.enable_spans(True)
    try:
        port.process_frames_async(x101["frames"][:B])
    finally:
        profiling.enable_spans(False)
    recorded = profiling.spans()
    profiling.reset_spans()
    gconv = [s for s in recorded if s.name == "track.gconv"]
    assert len(gconv) == 4  # X-26: one bottleneck a stage
    assert all(recorded[s.parent].name == "track.features" for s in gconv)
    want = sum(f for f, _ in yardstick_x101.gconv_work(cfg, port.predictor.pad_hw, B))
    assert profiling.counters["x101.gconv_flops"] == want


def test_r101_forward_runs_the_same_ops():
    """At ``num_groups == 1`` the port's trunk and FPN run the plain
    reference's ops in the same order, with the same outputs bit for bit,
    and open no span and count nothing new, spans on."""

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops.append((str(func), tuple(out.shape) if isinstance(out, torch.Tensor) else None))
            return out

    port, ref = ResNetFPN(26).eval(), RefResNetFPN(26).eval()
    g = torch.Generator().manual_seed(3)
    ref.load_state_dict({k: torch.randn(v.shape, generator=g) * 0.1 + (1.0 if k.endswith("running_var") else 0.0)
                         for k, v in ref.state_dict().items()})
    port.load_state_dict(ref.state_dict())
    x = torch.randn(1, 64, 96, 3, generator=g)
    profiling.reset_spans()
    profiling.reset_counters()
    profiling.enable_spans(True)
    try:
        with torch.no_grad(), Ops() as port_ops:
            got = port(x)
    finally:
        profiling.enable_spans(False)
    with torch.no_grad(), Ops() as ref_ops:
        want = ref(x)
    assert profiling.spans() == [] and profiling.counters == {}
    assert port_ops.ops == ref_ops.ops and len(port_ops.ops) > 100
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_load_detectron2_takes_and_refuses_grouped_conv2(x101):
    """The X-26 model loads the grouped checkpoint key for key; an R-26
    checkpoint (plain conv2) or a grouped one into R-26 is a shape
    mismatch."""
    cfg = model_config_x101(x101["cfg"]["model"], pconfig)
    model = MaskRCNN(cfg)
    missing, unused = pweights.load_detectron2(model, x101["ckpt"])
    assert missing == [] and unused == []
    plain = MaskRCNN(dataclasses.replace(cfg, num_groups=1, width_per_group=64, stride_in_1x1=True))
    with pytest.raises(ValueError, match=r"shape mismatch at backbone\.bottom_up\.res2\.0\.conv1\.weight"):
        pweights.load_detectron2(plain, x101["ckpt"])
    with pytest.raises(ValueError, match="shape mismatch"):
        pweights.load_detectron2(model, plain.state_dict())


def test_flax_init_draws_grouped_conv2(x101):
    """``finetune_uav``'s fill-in for missing parameters (``mask_rcnn_init``)
    draws each grouped conv2 at (width, width / 32, 3, 3), with LeCun's
    fan-in of that kernel, and it loads into the X-26 model."""
    cfg = model_config_x101(x101["cfg"]["model"], pconfig)
    keys = {f"backbone.bottom_up.res{s}.0.conv2.weight" for s in range(2, 6)}
    drawn = flax_init.mask_rcnn_init(cfg, 0, only=keys)
    assert set(drawn) == keys
    for s in range(2, 6):
        w = drawn[f"backbone.bottom_up.res{s}.0.conv2.weight"]
        width = 256 * 2 ** (s - 2)
        assert w.shape == (width, width // 32, 3, 3)
        assert 0.8 < float(w.std()) * (9 * width // 32) ** 0.5 < 1.1
    missing, _ = pweights.load_detectron2(MaskRCNN(cfg), drawn)
    assert not keys & set(missing)


def test_x101_flops_match_flop_counter():
    """The X101 counts against FlopCounterMode on the plain reference's
    modules on the meta device: the trunk at the cell's 768x1344 input
    (675.2 GFLOP, of which the grouped 3x3s 78.48), and a whole frame at
    128x256 (trunk, FPN, RPN, box head on every proposal, mask head on the
    detections, re-ID head on the capped ones)."""
    cfg = copy.deepcopy(spec.find_cell(CELL).config)
    m, t = cfg["model"], cfg["tracker"]
    ref_cfg = model_config_x101(m)
    with torch.device("meta"):
        model = RefMaskRCNNX(ref_cfg, m["num_groups"], m["width_per_group"])
        trunk_in = torch.empty(1, 3, 768, 1344)
    with FlopCounterMode(display=False) as fc:
        model.backbone.bottom_up(trunk_in)
    grouped = sum(sum(ops.values()) for name, ops in fc.get_flop_counts().items() if name.endswith(".conv2"))
    assert fc.get_total_flops() == 2 * yardstick_x101.trunk_macs(101, 32, 8, 768, 1344) == 675_235_233_792
    assert grouped == sum(f for f, _ in yardstick_x101.gconv_work(cfg, (768, 1344), 1)) == 78_479_622_144

    h, w, proposals, dets, capped = 128, 256, m["rpn"]["post_nms_topk_test"], 7, 5
    roi = m["roi"]
    with torch.device("meta"):
        head = RefAssociationHead(256 * t["roi_size"] ** 2, t["embedding_dim"])
        images = torch.empty(1, h, w, 3)
        box_in = torch.empty(proposals, 256 * roi["box_pooler_resolution"] ** 2)
        mask_in = torch.empty(dets, 256, roi["mask_pooler_resolution"], roi["mask_pooler_resolution"])
        crops = torch.empty(capped, 256 * t["roi_size"] ** 2)
    heads = model.roi_heads
    with FlopCounterMode(display=False) as fc:
        feats = model.features(images)
        model.proposal_generator["rpn_head"]({n: feats[n] for n in ("p2", "p3", "p4", "p5", "p6")})
        heads.box_predictor(heads.box_head(box_in))
        heads.mask_head(mask_in)
        head(crops)
    assert fc.get_total_flops() == yardstick_x101.tracker_flops(cfg, (h, w), dets, capped)
