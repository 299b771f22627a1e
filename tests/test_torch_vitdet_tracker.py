"""PyTorch port, Mask R-CNN ViTDet-B through the tracker (``track_uav --arch
vitdet``) on the CPU, held to the benchmark's plain ViTDet reference
(``benchmark/``: ``refplain/dcnn/models/vitdet.py``,
``benchkit/refmodel_vitdet.py``).

The model is one period of ViTDet-B's layer pattern (window, window,
global) with 3 heads of the published 64 channels, on 256x256 squares: 16 x
16 tokens, 14 x 14 windows padded to 28; the pyramid and heads at their
published widths; 96x160 frames resized to 154x256, 100 boxes before the
RPN's NMS, 16 after and 8 detection slots, on the benchmark's seeded ViTDet
weights and their calibration.  Both sides run the same float32 operations
in the same order, so the maps and every number the benchmark compares
read exactly 0.  Also: the square pad reads 0 after normalising, the RGB
order of ``input.format``, the bicubic position table, detectron2's key
names in ``load_detectron2``, the attention spans and counter, the FLOP
count against ``FlopCounterMode``, ``track_uav --arch vitdet``, and the
R-FPN, X101 and C4 forwards unchanged by the new fields.
"""

import copy
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from benchkit import spec, weights_vitdet, yardstick_vitdet  # noqa: E402
from benchkit.context import Checks  # noqa: E402
from benchkit.refmodel import model_config as ref_model_config, tracker_config  # noqa: E402
from benchkit.refmodel_c4 import model_config_c4  # noqa: E402
from benchkit.refmodel_vitdet import RefTrackerViTDet, model_config_vitdet  # noqa: E402
from benchkit.refmodel_x101 import model_config_x101  # noqa: E402
from refplain.dcnn.models.association import AssociationHead as RefAssociationHead  # noqa: E402
from refplain.dcnn.models.c4 import MaskRCNNC4 as RefMaskRCNNC4  # noqa: E402
from refplain.dcnn.models.mask_rcnn import MaskRCNN as RefMaskRCNN  # noqa: E402
from refplain.dcnn.models.resnext import MaskRCNNX as RefMaskRCNNX  # noqa: E402
from refplain.dcnn.models.vitdet import MaskRCNNViTDet as RefMaskRCNNViTDet  # noqa: E402

from apse_uav_torch.cli.track_uav import build_parser, build_tracker, model_config, track_frames  # noqa: E402
from apse_uav_torch.dcnn import config as pconfig, flax_init, weights as pweights  # noqa: E402
from apse_uav_torch.dcnn.engines import RcnnTracker, TrackPredictor, resize_frames_matmul  # noqa: E402
from apse_uav_torch.dcnn.models.c4 import build_model  # noqa: E402
from apse_uav_torch.dcnn.models.vit import abs_pos  # noqa: E402
from apse_uav_torch.utils import profiling  # noqa: E402

CELL = "vitdet-b-b4"
HW = (96, 160)
B = 2
SEED = 2 ** 33 + 13
CPU = torch.device("cpu")


def small_config() -> dict:
    """The cell's configuration file, cut to the CPU's size (one period of 3 blocks, 3 heads, 256x256)."""
    cfg = copy.deepcopy(spec.find_cell(CELL).config)
    m = cfg["model"]
    m["vit"].update(embed_dim=192, num_heads=3, depth=3, window_block_indexes=[0, 1], img_size=256)
    m["input"].update(min_size_test=256, max_size_test=256, square_size=256)
    m["rpn"]["pre_nms_topk_test"], m["rpn"]["post_nms_topk_test"] = 100, 16
    m["roi"]["detections_per_image"] = 8
    return cfg


@pytest.fixture(scope="module")
def vitdet():
    """The port's small ViTDet RcnnTracker and the plain reference tracker on
    the same seeded, calibrated weights, and four preprocessed colour frames
    (two batches)."""
    cfg = small_config()
    m, t = cfg["model"], cfg["tracker"]
    g = torch.Generator().manual_seed(SEED)
    raw = torch.randint(0, 256, (2 * B, *HW, 3), generator=g, dtype=torch.uint8)
    ckpt, assoc = weights_vitdet.seeded_weights(SEED, m, m["fpn_channels"] * t["roi_size"] ** 2, t["embedding_dim"],
                                                CPU)
    ref = RefTrackerViTDet(m, t, ckpt, assoc, HW, cfg["camera"], CPU)
    calibration = weights_vitdet.calibrate_background(ckpt, ref, list(raw.numpy()), cfg["calibration"]["per_frame"],
                                                      B)
    frames, _ = ref.pre(raw, with_gray=False)  # undistorted, as --preprocess hands them to the tracker
    port = RcnnTracker(model_config_vitdet(m, pconfig), tracker_config(t, pconfig), ckpt, assoc, HW, device="cpu")
    return {"cfg": cfg, "ckpt": ckpt, "ref": ref, "port": port, "frames": frames, "calibration": calibration}


def test_vitdet_tracker_matches_plain_reference(vitdet):
    """Two batches from the fresh state: the pyramid's maps, detections,
    masks, snapshots (ids, classes, embeddings) and the track state after
    each batch, under the cell's limits; every number reads exactly 0."""
    driver = spec.find_cell(CELL).driver
    port, ref = vitdet["port"], vitdet["ref"]
    assert min(vitdet["calibration"]["candidates_per_frame"]) >= vitdet["cfg"]["calibration"]["per_frame"]
    port.reset()
    checks = Checks(driver.LIMITS)
    detections = tracks = 0
    maps = {}
    hook = port.predictor.model.backbone.register_forward_hook(lambda mod, args, out: maps.update(out))
    for k in range(2):
        x = vitdet["frames"][k * B:(k + 1) * B]
        before = port.state
        try:
            pending = port.process_frames_async(x)
        finally:
            if k:
                hook.remove()
        snaps = port.materialize(pending)
        rdets, feats = ref.detect(x)
        assert sorted(maps) == sorted(feats) == ["p2", "p3", "p4", "p5", "p6"]
        assert all(torch.equal(maps[n], feats[n]) for n in feats)
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


def test_square_pad_reads_zero_after_normalising(vitdet):
    """The predictor fills the square's pad with the pixel mean, so the
    model's normalisation leaves exact zeros there and, inside, the
    reference's normalised image bit for bit; boxes are clipped to the
    resized image."""
    pred, ref = vitdet["port"].predictor, vitdet["ref"]
    assert (pred.pad_hw, pred.net_hw, pred.clip_hw) == ((256, 256), (154, 256), (154, 256))
    x = vitdet["frames"][:B]
    model = pred.model
    got = (pred.resize(x) - model.pixel_mean) / model.pixel_std
    want = (ref.resize(x) - ref.model.pixel_mean) / ref.model.pixel_std
    nh, nw = pred.net_hw
    assert torch.equal(got[:, :nh, :nw], want)
    assert torch.equal(got[:, nh:], torch.zeros_like(got[:, nh:])) and not got[:, nh:].signbit().any()


def test_rgb_format_flips_the_frames_before_the_resize(vitdet):
    """``input.format`` "RGB" hands the model the BGR frames' channels
    reversed, flipped before the resize; a BGR config (R-FPN's) takes the
    frames as they are."""
    x = vitdet["frames"][:B]
    assert x[..., 0].ne(x[..., 2]).any()
    pred = vitdet["port"].predictor
    nh, nw = pred.net_hw
    assert torch.equal(pred.resize(x)[:, :nh, :nw], resize_frames_matmul(x.flip(-1), *pred._resize_mats))
    r26 = pconfig.mask_rcnn_r50_fpn(4, depth=26)
    r26 = dataclasses.replace(r26, input=dataclasses.replace(r26.input, min_size_test=64, max_size_test=128))
    bgr = TrackPredictor(r26, None, HW, device="cpu")
    rgb = TrackPredictor(dataclasses.replace(r26, input=dataclasses.replace(r26.input, format="RGB")), None, HW,
                         device="cpu")
    (ph, pw), (nh, nw) = bgr.pad_hw, bgr.net_hw
    assert torch.equal(bgr.resize(x), F.pad(resize_frames_matmul(x, *bgr._resize_mats), (0, 0, 0, pw - nw, 0, ph - nh)))
    assert torch.equal(rgb.resize(x), bgr.resize(x.flip(-1)))
    assert bgr.clip_hw == bgr.pad_hw == (64, 128)


def _bicubic_np(table: np.ndarray, out: int) -> np.ndarray:
    """(S, S, C) resized to (out, out, C) by separable cubic convolution
    (A = -0.75, pixel centres, edge rows repeated), in float64."""
    a, s = -0.75, table.shape[0]

    def weights(t):
        t = np.abs(t)
        return np.where(t <= 1, ((a + 2) * t - (a + 3)) * t * t + 1,
                        np.where(t < 2, ((a * t - 5 * a) * t + 8 * a) * t - 4 * a, 0.0))

    m = np.zeros((out, s))
    for i in range(out):
        src = (i + 0.5) * s / out - 0.5
        f = np.floor(src)
        for tap in range(-1, 3):
            m[i, int(np.clip(f + tap, 0, s - 1))] += weights(src - (f + tap))
    return np.einsum("ij,jkc,lk->ilc", m, table.astype(np.float64), m)


def test_position_table_is_resized_bicubically(vitdet):
    """The 14 x 14 table (after its cls slot) is resampled to the 16 x 16
    token grid by cubic convolution, and used as it is on a 14 x 14 grid."""
    pos = vitdet["port"].predictor.model.backbone.net.pos_embed.detach()
    assert pos.shape == (1, 197, 192)
    table = pos[0, 1:].reshape(14, 14, -1)
    assert torch.equal(abs_pos(pos, (14, 14))[0], table)
    got = abs_pos(pos, (16, 16))[0].numpy()
    np.testing.assert_allclose(got, _bicubic_np(table.numpy(), 16), rtol=0, atol=2e-6)


def test_load_detectron2_takes_vitdet_keys(vitdet):
    """The port's model is named as detectron2's ViTDet, so the seeded
    checkpoint loads key for key; a table of the wrong size is refused."""
    cfg = model_config_vitdet(vitdet["cfg"]["model"], pconfig)
    model = build_model(cfg)
    own = model.state_dict()
    for key, shape in (("backbone.net.pos_embed", (1, 197, 192)), ("backbone.net.patch_embed.proj.weight",
                                                                    (192, 3, 16, 16)),
                       ("backbone.net.blocks.0.attn.rel_pos_h", (27, 64)),
                       ("backbone.net.blocks.2.attn.rel_pos_w", (31, 64)),
                       ("backbone.net.blocks.2.mlp.fc1.weight", (768, 192)),
                       ("backbone.simfp_2.1.weight", (96,)), ("backbone.simfp_2.3.weight", (96, 48, 2, 2)),
                       ("backbone.simfp_2.4.norm.weight", (256,)), ("backbone.simfp_5.2.weight", (256, 256, 3, 3)),
                       ("proposal_generator.rpn_head.conv.conv1.weight", (256, 256, 3, 3)),
                       ("roi_heads.box_head.conv4.norm.bias", (256,)), ("roi_heads.box_head.fc1.weight",
                                                                        (1024, 12544)),
                       ("roi_heads.mask_head.mask_fcn1.norm.weight", (256,))):
        assert tuple(own[key].shape) == shape, key
    assert "roi_heads.box_head.conv1.bias" not in own and "roi_heads.mask_head.mask_fcn1.bias" not in own
    assert pweights.load_detectron2(model, vitdet["ckpt"]) == ([], [])
    bad = dict(vitdet["ckpt"], **{"backbone.net.blocks.2.attn.rel_pos_h": torch.zeros(27, 64)})
    with pytest.raises(ValueError, match=r"shape mismatch at backbone\.net\.blocks\.2\.attn\.rel_pos_h"):
        pweights.load_detectron2(model, bad)


def test_attention_spans_and_counter(vitdet):
    """A batch opens one ``track.attn_window`` span in each windowed block
    and one ``track.attn_global`` in the global one, inside
    ``track.features``, and the counter reads the attention cores' FLOPs
    that the benchmark's yardstick counts from the shapes."""
    port = vitdet["port"]
    profiling.reset_spans()
    profiling.reset_counters()
    profiling.enable_spans(True)
    try:
        port.process_frames_async(vitdet["frames"][:B])
    finally:
        profiling.enable_spans(False)
    recorded = profiling.spans()
    profiling.reset_spans()
    names = [s.name for s in recorded if s.name.startswith("track.attn")]
    assert names == ["track.attn_window", "track.attn_window", "track.attn_global"]
    assert all(recorded[s.parent].name == "track.features" for s in recorded if s.name.startswith("track.attn"))
    want = sum(f for f, _, _ in yardstick_vitdet.attention_work(vitdet["cfg"]["model"]["vit"], B))
    assert profiling.counters["vitdet.attn_flops"] == want


def test_vitdet_b_is_the_published_model():
    """ViTDet-B on the meta device: 12 blocks of 768 with 12 heads, global
    attention in blocks 2, 5, 8 and 11 (tables of 127 rows), 14 x 14
    windows elsewhere (27 rows), 85.9 M trunk and 110.5 M model parameters;
    the preset's input is a 1024 RGB square."""
    cfg = pconfig.mask_rcnn_vitdet_b(4)
    with torch.device("meta"):
        model = build_model(cfg)
    net = model.backbone.net
    assert len(net.blocks) == 12 and net.blocks[0].attn.num_heads == 12
    assert [i for i, b in enumerate(net.blocks) if not b.window] == [2, 5, 8, 11]
    assert {b.attn.rel_pos_h.shape[0] for b in net.blocks if b.window} == {27}
    assert {b.attn.rel_pos_h.shape[0] for b in net.blocks if not b.window} == {127}
    assert round(sum(p.numel() for p in net.parameters()) / 1e6, 1) == 85.9
    assert round(sum(p.numel() for p in model.parameters()) / 1e6, 1) == 110.5
    assert (cfg.input.format, cfg.input.square_size, cfg.input.min_size_test, cfg.input.max_size_test) == \
        ("RGB", 1024, 1024, 1024)


@pytest.mark.parametrize("argv,preset", [
    ([], pconfig.mask_rcnn_r101_fpn),
    (["--arch", "vitdet"], pconfig.mask_rcnn_vitdet_b),
    (["--arch", "vitdet", "--depth", "50"], pconfig.mask_rcnn_vitdet_b),
])
def test_track_uav_arch_vitdet_picks_the_preset(argv, preset):
    """``--arch vitdet`` gives mask_rcnn_vitdet_b whatever the depth, with
    ``--confidence`` applied."""
    args = build_parser().parse_args(["--images", ".", "--weights", "w.pth", "--confidence", "0.6"] + argv)
    want = preset(4)
    assert model_config(args) == dataclasses.replace(want, roi=dataclasses.replace(want.roi, score_thresh_test=0.6))


def test_vitdet_refuses_what_it_does_not_run():
    """``--resnext`` with ``--arch vitdet``, ViTDet in bfloat16 or off its
    square, an unknown head norm, and a flax init of ViTDet are refused."""
    args = build_parser().parse_args(["--images", ".", "--weights", "w.pth", "--arch", "vitdet", "--resnext", "32x8d"])
    with pytest.raises(SystemExit, match="needs --arch fpn"):
        model_config(args)
    cfg = pconfig.mask_rcnn_vitdet_b(4)
    with torch.device("meta"):
        with pytest.raises(ValueError, match="float32 only"):
            build_model(dataclasses.replace(cfg, compute_dtype="bfloat16"))
        with pytest.raises(ValueError, match="square_size=0"):
            build_model(dataclasses.replace(cfg, input=dataclasses.replace(cfg.input, square_size=0)))
        with pytest.raises(ValueError, match="conv_norm='BN'"):
            build_model(dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, conv_norm="BN")))
    with pytest.raises(ValueError, match="no ViTDet"):
        flax_init.mask_rcnn_init(cfg, 0, only={"backbone.net.pos_embed"})


def test_build_tracker_vitdet_tracks_through_track_frames(vitdet, tmp_path):
    """``build_tracker`` for ``--arch vitdet`` (the small config in place of
    the preset) loads the checkpoint whole, embeds from p2, and
    ``track_frames`` runs it to its snapshots."""
    path = str(tmp_path / "vitdet.pth")
    torch.save({"model": vitdet["ckpt"]}, path)
    args = build_parser().parse_args(["--images", str(tmp_path), "--weights", path, "--arch", "vitdet",
                                      "--device", "cpu"])
    tracker, pre = build_tracker(args, HW, cfg=model_config_vitdet(vitdet["cfg"]["model"], pconfig))
    assert pre is None and not tracker.predictor.missing and tracker.reid == "p2"
    frames = [(i, f) for i, f in enumerate(vitdet["frames"][:B].numpy())]
    out = list(track_frames(tracker, None, frames, B))
    assert [idx for idx, _, _ in out] == list(range(B))


def test_vitdet_flops_match_flop_counter(vitdet):
    """The ViTDet counts against FlopCounterMode on the plain reference's
    modules on the meta device: ViTDet-B's trunk on the 1024 square (965.6
    GFLOP, of which the attention cores 234.7) and its pyramid (143.3), and
    a whole frame of the small config (trunk, pyramid, RPN on p2-p6, the
    box head on every proposal, the mask head on the detections, the re-ID
    head on the capped ones)."""
    full = spec.find_cell(CELL).config
    m = full["model"]
    heads = {"rpn_num_conv": 2, "num_box_conv": 4}
    with torch.device("meta"):
        model = RefMaskRCNNViTDet(model_config_vitdet(m), m["vit"], heads)
        square = torch.empty(1, 3, 1024, 1024)
    with FlopCounterMode(display=False) as fc:
        top = model.backbone.net(square)
    counts = fc.get_flop_counts()
    cores = sum(sum(v.values()) for k, v in counts.items() if k.endswith(".attn")) - sum(
        sum(v.values()) for k, v in counts.items() if k.endswith((".attn.qkv", ".attn.proj")))
    assert fc.get_total_flops() == 2 * yardstick_vitdet.vit_macs(m["vit"]) == 965_634_883_584
    assert cores == sum(f for f, _, _ in yardstick_vitdet.attention_work(m["vit"], 1)) == 234_668_359_680
    with FlopCounterMode(display=False) as fc:
        for name in ("simfp_2", "simfp_3", "simfp_4", "simfp_5"):
            getattr(model.backbone, name)(top)
    assert fc.get_total_flops() == 2 * yardstick_vitdet.pyramid_macs(m["vit"], 256) == 143_344_533_504

    cfg = vitdet["cfg"]
    m, t, roi = cfg["model"], cfg["tracker"], cfg["model"]["roi"]
    proposals, dets, capped = m["rpn"]["post_nms_topk_test"], 7, 5
    with torch.device("meta"):
        model = RefMaskRCNNViTDet(model_config_vitdet(m), m["vit"], heads)
        head = RefAssociationHead(256 * t["roi_size"] ** 2, t["embedding_dim"])
        images = torch.empty(1, 154, 256, 3)
        box_in = torch.empty(proposals, 256 * roi["box_pooler_resolution"] ** 2)
        mask_in = torch.empty(dets, 256, roi["mask_pooler_resolution"], roi["mask_pooler_resolution"])
        crops = torch.empty(capped, 256 * t["roi_size"] ** 2)
    heads_ = model.roi_heads
    with FlopCounterMode(display=False) as fc:
        feats = model.features(images)
        model.proposal_generator["rpn_head"]({n: feats[n] for n in ("p2", "p3", "p4", "p5", "p6")})
        heads_.box_predictor(heads_.box_head(box_in))
        heads_.mask_head(mask_in)
        head(crops)
    assert fc.get_total_flops() == yardstick_vitdet.tracker_flops(cfg, (256, 256), dets, capped)


class _Ops(TorchDispatchMode):
    """Records each op and its output's shape."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((str(func), tuple(out.shape) if isinstance(out, torch.Tensor) else None))
        return out


def _seeded_like(model: torch.nn.Module, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g) * 0.05 + (1.0 if k.endswith(("running_var", "norm.weight")) else 0.0)
            for k, v in model.state_dict().items()}


@pytest.mark.parametrize("cell", ["track-r101fpn-b4", "x101fpn-b4", "c4-r101-b4"])
def test_other_models_run_the_same_ops(cell):
    """At the new fields' defaults R-FPN, X101 and C4 (depth 26, 64x96
    input, 50 proposals) run the plain reference's inference, a frozen copy
    of the port before them, with the same outputs bit for bit, and open no
    attention span and count nothing new.  R-FPN and X101 run its ops in
    its order; C4 its backbone's and RPN head's (after them the port's C4
    and the reference's ran different ops before these fields came)."""
    m = copy.deepcopy(spec.find_cell(cell).config["model"])
    m["depth"] = 26
    m["rpn"]["pre_nms_topk_test"], m["rpn"]["post_nms_topk_test"] = 50, 50
    if cell == "x101fpn-b4":
        ref = RefMaskRCNNX(model_config_x101(m), m["num_groups"], m["width_per_group"])
        port_cfg = model_config_x101(m, pconfig)
    elif cell == "c4-r101-b4":
        ref, port_cfg = RefMaskRCNNC4(model_config_c4(m)), model_config_c4(m, pconfig)
    else:
        ref, port_cfg = RefMaskRCNN(ref_model_config(m)), ref_model_config(m, pconfig)
    port = build_model(port_cfg)
    ref.load_state_dict(_seeded_like(ref, 4))
    assert pweights.load_detectron2(port, ref.state_dict()) == ([], [])
    port.eval(), ref.eval()
    images = torch.rand(1, 64, 96, 3, generator=torch.Generator().manual_seed(5)) * 255
    profiling.reset_counters()
    profiling.reset_spans()
    profiling.enable_spans(True)
    try:
        with torch.no_grad(), _Ops() as port_ops:
            got, _ = port.inference(images)
    finally:
        profiling.enable_spans(False)
    with torch.no_grad(), _Ops() as ref_ops:
        want, _ = ref.inference(images)
    assert not any(s.name.startswith("track.attn") for s in profiling.spans())
    assert not any(k.startswith("vitdet.") for k in profiling.counters)
    profiling.reset_spans()
    if cell == "c4-r101-b4":
        with torch.no_grad(), _Ops() as port_ops:
            port.proposal_generator["rpn_head"]({"res4": port.features(images)["res4"]})
        with torch.no_grad(), _Ops() as ref_ops:
            ref.proposal_generator["rpn_head"]({"res4": ref.features(images)["res4"]})
    assert port_ops.ops == ref_ops.ops and len(port_ops.ops) > 100
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
