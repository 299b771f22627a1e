"""PyTorch port, Mask R-CNN R-C4 through the tracker (``track_uav --arch c4``)
on the CPU, held to the benchmark's plain C4 reference (``benchmark/``:
``refplain/dcnn/models/c4.py``, ``benchkit/refmodel_c4.py``).

The model is R-26-C4 (one bottleneck a stage; res5, the RPN and the heads at
their published widths) on 96x160 frames resized to 64x128, with 100 boxes
before the RPN's NMS, 16 after and 8 detection slots (res5 costs the same
at any frame size: its ROIs set the time), on the benchmark's
seeded C4 weights and their calibration.  Both sides run the same float32
operations in the same order, so every number the benchmark compares reads
exactly 0.  Also: ``track_uav``'s ``--arch``, the re-ID map each
architecture reads, the res5 spans and counter, and the C4 FLOP count
against ``FlopCounterMode``.
"""

import copy
import dataclasses
import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from benchkit import spec, weights_c4, yardstick_c4  # noqa: E402
from benchkit.context import Checks  # noqa: E402
from benchkit.refmodel import tracker_config  # noqa: E402
from benchkit.refmodel_c4 import RefTrackerC4, model_config_c4  # noqa: E402
from refplain.dcnn.models.association import AssociationHead as RefAssociationHead  # noqa: E402
from refplain.dcnn.models.c4 import MaskRCNNC4 as RefMaskRCNNC4  # noqa: E402

from apse_uav_torch.cli.track_uav import build_parser, build_tracker, model_config, track_frames  # noqa: E402
from apse_uav_torch.dcnn import config as pconfig, tracker as ptracker  # noqa: E402
from apse_uav_torch.dcnn.engines import RcnnTracker, reid_map  # noqa: E402
from apse_uav_torch.dcnn.models.c4 import MaskRCNNC4, build_model  # noqa: E402
from apse_uav_torch.dcnn.models.mask_rcnn import MaskRCNN  # noqa: E402
from apse_uav_torch.utils import profiling  # noqa: E402

CELL = "c4-r101-b4"
HW = (96, 160)
B = 2
SEED = 2 ** 33 + 11
CPU = torch.device("cpu")


def small_config() -> dict:
    """The cell's configuration file, cut to the CPU's size."""
    cfg = copy.deepcopy(spec.find_cell(CELL).config)
    m = cfg["model"]
    m["depth"] = 26
    m["input"]["min_size_test"], m["input"]["max_size_test"] = 64, 128
    m["rpn"]["pre_nms_topk_test"], m["rpn"]["post_nms_topk_test"] = 100, 16
    m["roi"]["detections_per_image"] = 8
    return cfg


@pytest.fixture(scope="module")
def c4():
    """The port's C4 RcnnTracker and the plain reference tracker on the same
    seeded, calibrated weights, and four preprocessed frames (two batches)."""
    cfg = small_config()
    m, t = cfg["model"], cfg["tracker"]
    g = torch.Generator().manual_seed(SEED)
    raw = torch.randint(0, 256, (2 * B, *HW, 3), generator=g, dtype=torch.uint8)
    ckpt, assoc = weights_c4.seeded_weights(SEED, m["depth"], m["roi"]["num_classes"], 256 * t["roi_size"] ** 2,
                                            t["embedding_dim"], CPU)
    ref = RefTrackerC4(m, t, ckpt, assoc, HW, cfg["camera"], CPU)
    calibration = weights_c4.calibrate_background(ckpt, ref, list(raw.numpy()), cfg["calibration"]["per_frame"], B)
    frames, _ = ref.pre(raw, with_gray=False)  # undistorted, as --preprocess hands them to the tracker
    port = RcnnTracker(model_config_c4(m, pconfig), tracker_config(t, pconfig), ckpt, assoc, HW, device="cpu")
    return {"cfg": cfg, "ckpt": ckpt, "ref": ref, "port": port, "frames": frames, "calibration": calibration}


def test_c4_tracker_matches_plain_reference(c4):
    """Two batches from the fresh state: detections, masks, snapshots (ids,
    classes, embeddings) and the track state after each batch, under the
    cell's limits; every number reads exactly 0."""
    driver = spec.find_cell(CELL).driver
    port, ref = c4["port"], c4["ref"]
    port.reset()
    checks = Checks(driver.LIMITS)
    detections = tracks = 0
    for k in range(2):
        x = c4["frames"][k * B:(k + 1) * B]
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
    assert detections > 0 and tracks > 0 and port.state["masks"].shape[-1] == 14


@pytest.mark.parametrize("arch,cls", [("fpn", MaskRCNN), ("c4", MaskRCNNC4)])
def test_track_uav_arch_picks_the_preset(arch, cls):
    """``--arch c4`` gives mask_rcnn_r101_c4, otherwise the R-FPN preset;
    ``--confidence`` applies to both; the association head takes 25,600
    inputs either way."""
    args = build_parser().parse_args(["--images", ".", "--weights", "w.pth", "--confidence", "0.6"]
                                     + (["--arch", arch] if arch == "c4" else []))
    cfg = model_config(args)
    preset = {"fpn": pconfig.mask_rcnn_r101_fpn, "c4": pconfig.mask_rcnn_r101_c4}[arch](4)
    assert cfg == dataclasses.replace(preset, roi=dataclasses.replace(preset.roi, score_thresh_test=0.6))
    with torch.device("meta"):
        assert type(build_model(cfg)) is cls
    assert reid_map(cfg)[1] * pconfig.TrackerConfig().roi_size ** 2 == 25_600


def test_build_tracker_c4_tracks_through_track_frames(c4, tmp_path):
    """``build_tracker`` for ``--arch c4`` sizes the head by the re-ID map's
    width, and ``track_frames`` runs the C4 tracker to its snapshots."""
    path = str(tmp_path / "c4.pth")
    torch.save({"model": c4["ckpt"]}, path)
    args = build_parser().parse_args(["--images", str(tmp_path), "--weights", path, "--arch", "c4", "--device", "cpu"])
    cfg = model_config_c4(c4["cfg"]["model"], pconfig)
    tracker, pre = build_tracker(args, HW, cfg=cfg)
    assert pre is None and tracker.reid == "res2" and tracker.head.fc.in_features == 25_600
    assert not tracker.predictor.missing
    frames = [(i, f) for i, f in enumerate(c4["frames"][:B].numpy())]
    out = list(track_frames(tracker, None, frames, B))
    assert [idx for idx, _, _ in out] == list(range(B))
    assert all(snap["valid"].shape == (pconfig.TrackerConfig().max_tracks,) for _, _, snap in out)


@pytest.mark.parametrize("arch", ["fpn", "c4"])
def test_embeddings_read_the_architectures_map(c4, arch):
    """R-FPN embeds from p2, as before; C4 from res2.  The tracker reads no other map."""
    if arch == "fpn":
        cfg = pconfig.mask_rcnn_r50_fpn(4, depth=26)
        tracker = RcnnTracker(cfg, pconfig.TrackerConfig(), None, c4["port"].head.state_dict(), HW, device="cpu")
    else:
        tracker = c4["port"]
    name = {"fpn": "p2", "c4": "res2"}[arch]
    assert tracker.reid == name
    g = torch.Generator().manual_seed(3)
    d = 5
    xy = torch.rand(B, d, 2, generator=g) * 100
    dets = {"boxes": torch.cat([xy, xy + 20 + torch.rand(B, d, 2, generator=g) * 30], -1),
            "scores": torch.rand(B, d, generator=g), "classes": torch.zeros(B, d, dtype=torch.int64),
            "valid": torch.ones(B, d, dtype=torch.bool), "masks": torch.rand(B, d, 14, 14, generator=g)}
    x = torch.randn(B, HW[0] // 4, HW[1] // 4, 256, generator=g)
    got = tracker.embed(dets, {name: x})
    want = ptracker.prepare_frame(dets, x, tracker.head, tracker.cfg, HW)
    assert torch.equal(got[1], want[1])
    other = {"p2": "res2", "res2": "p2"}[name]
    with pytest.raises(KeyError):
        tracker.embed(dets, {other: x})


def test_res5_counter_and_spans(c4):
    """A batch counts B * (post-NMS proposals + detection slots) ROIs through
    res5, and the two res5 spans open inside ``track.roi_heads``."""
    m = c4["cfg"]["model"]
    profiling.reset_spans()
    profiling.reset_counters()
    profiling.enable_spans(True)
    try:
        c4["port"].process_frames_async(c4["frames"][:B])
    finally:
        profiling.enable_spans(False)
    recorded = profiling.spans()
    profiling.reset_spans()
    assert profiling.counters["c4.res5_rois"] == B * (m["rpn"]["post_nms_topk_test"] + m["roi"]["detections_per_image"])
    res5 = [s for s in recorded if s.name.startswith("track.res5_")]
    assert [s.name for s in res5] == ["track.res5_box", "track.res5_mask"]
    assert all(recorded[s.parent].name == "track.roi_heads" for s in res5)


@pytest.mark.parametrize("depth", [50, 101])
def test_c4_flops_match_flop_counter(depth):
    """The C4 FLOP count of a frame (trunk to res4, RPN on res4, res5 and the
    predictor on every proposal, res5 and the mask head on the detections,
    the re-ID head on the capped ones) equals FlopCounterMode on the plain
    reference's modules, on the meta device at a 128x224 input."""
    cfg = small_config()
    cfg["model"]["depth"] = depth
    m, t = cfg["model"], cfg["tracker"]
    h, w, proposals, dets, capped = 128, 224, m["rpn"]["post_nms_topk_test"], 7, 5
    with torch.device("meta"):
        model = RefMaskRCNNC4(model_config_c4(m))
        head = RefAssociationHead(256 * t["roi_size"] ** 2, t["embedding_dim"])
        images = torch.empty(1, h, w, 3)
        rois = torch.empty(proposals, 1024, 14, 14)
        det_rois = torch.empty(dets, 1024, 14, 14)
        crops = torch.empty(capped, 256 * t["roi_size"] ** 2)
    heads = model.roi_heads
    with FlopCounterMode(display=False) as fc:
        feats = model.features(images)
        model.proposal_generator["rpn_head"]({"res4": feats["res4"]})
        heads.box_predictor(heads.res5(rois).mean(dim=(2, 3)))
        heads.mask_head(heads.res5(det_rois))
        head(crops)
    assert fc.get_total_flops() == yardstick_c4.tracker_flops(cfg, (h, w), dets, capped)
