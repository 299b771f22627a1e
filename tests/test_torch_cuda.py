"""PyTorch port, the Hopper kernels against their plain versions on the card.

These tests need an NVIDIA GPU (sm_90a) and nvcc: each kernel is built from
``apse_uav_torch/csrc`` and run at small shapes, and the wrappers' input
checks are exercised on CUDA tensors.  Without a card they skip.  The file
imports neither JAX nor the JAX package, so on the card it runs without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

``chip_smoke.py`` holds the same kernels to the same contracts at the main
path's 4K shapes.
"""

import os

import numpy as np
import pytest
import torch

from apse_uav_torch.aruco import cuda_labeling, cuda_proposals, detector as det
from apse_uav_torch.aruco.pipeline import ArucoPipeline, ArucoPipelineConfig, init_carry
from apse_uav_torch.core import camera
from apse_uav_torch.preproc import cuda_pool, cuda_remap, remap, twopass
from apse_uav_torch.utils.synthetic import MarkerSpec, labeling_masks, render_scene

pytestmark = pytest.mark.cuda

W, H = 960, 544
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cam():
    mtx, dist = camera.load_camera_params(os.path.join(REPO, "data", "cam_params.json"))
    return mtx * np.array([[W / 3840, 1, W / 3840], [1, H / 2160, H / 2160], [1, 1, 1]]), dist


@pytest.fixture(scope="module")
def table(dev):
    """The gray colour table of gamma 2 on the card (the remap kernels' input)."""
    return cuda_remap.colour_table(2.0, dev)


@pytest.fixture(scope="module")
def frames(cam, dev):
    specs = [MarkerSpec(4, (0.0, 0.5), 5, leds=0b10110010), MarkerSpec(1, (-4.0, -2.0), 30),
             MarkerSpec(2, (4.0, 1.5), -20), MarkerSpec(3, (1.5, -2.5), 90)]
    return torch.stack([render_scene(*cam, (W, H), specs, altitude=12.0, device=dev).permute(2, 0, 1)
                        for _ in range(2)]).contiguous()


@pytest.mark.parametrize("k", [1, 37, 600])
@pytest.mark.parametrize("win", [64, 48, 33, 32, 17])
def test_labels_bit_identical(dev, win, k):
    """K1: the label field equals the plain version's bit for bit on masks the
    schedule does not converge on (serpentines, a spiral), full-dark rows and
    columns, a checkerboard, isolated cells, all-dark and empty windows, and
    random masks of densities 0.3, 0.55 and 0.8; K = 1 launches each mask
    alone.  With 16-byte mask loads (win a multiple of 16) and without them
    (any other win, or a window not 16-byte aligned)."""
    rng = np.random.default_rng(win * 1000 + k)
    hard = list(labeling_masks(win).values())
    rand = [rng.random((win, win)) < dens for dens in (0.3, 0.55, 0.8) for _ in range(max(1, -(-(k - len(hard)) // 3)))]
    masks = torch.from_numpy(np.stack(hard + rand)).to(dev)
    batches = [masks[i:i + 1] for i in range(masks.shape[0])] if k == 1 else [masks[:k]]
    if k == 37:  # the same windows 1 byte past a 16-byte boundary
        flat = torch.zeros(k * win * win + 1, dtype=torch.bool, device=dev)
        flat[1:] = masks[:k].reshape(-1)
        batches.append(flat[1:].view(k, win, win))
    for dark in batches:
        got = cuda_labeling.labels(dark)
        torch.cuda.synchronize()
        assert torch.equal(got, det._label_sweeps(dark))


def test_labels_input_checks(dev):
    assert cuda_labeling.labels(torch.zeros((0, 64, 64), dtype=torch.bool, device=dev)).shape == (0, 64, 64)
    with pytest.raises(ValueError):
        cuda_labeling.labels(torch.zeros((2, 65, 65), dtype=torch.bool, device=dev))
    with pytest.raises(ValueError):
        cuda_labeling.labels(torch.zeros((2, 64, 128), dtype=torch.bool, device=dev)[:, :, ::2])
    with pytest.raises(ValueError):
        cuda_labeling.labels(torch.zeros((2, 64, 64), dtype=torch.uint8, device=dev))


def _same_set_per_scale(pool, h, w, p) -> int:
    """K2 against its plain version: the same valid candidates per scale,
    scores within 5e-4; returns the number of valid candidates."""
    got = cuda_proposals.proposals_from_pool(pool, h, w, p)
    want = det._proposals_from_pool(pool, h, w, p)
    assert all(g.shape == x.shape for g, x in zip(got, want))
    k = p.per_scale_k
    n_valid = 0
    for b in range(pool.shape[0]):
        for a in range(0, got[0].shape[1], k):
            def cand(pr):
                c, s, v, ok = (t[b, a:a + k].cpu() for t in pr)
                return {(float(cc[0]), float(cc[1]), float(ss)): float(vv) for cc, ss, vv, o in zip(c, s, v, ok) if o}

            g, w_ = cand(got), cand(want)
            assert set(g) == set(w_), (b, a // k)
            assert all(abs(g[key] - w_[key]) <= 5e-4 for key in g)
            n_valid += len(g)
    return n_valid


def test_proposals_same_set_per_scale(dev, cam, frames, table):
    """K2: the same valid candidates per scale as the plain version, scores
    within 5e-4 (in practice bit-identical: both integrate exactly in f64)."""
    p = det.DetectorParams()
    th, tw = remap.pick_tiles(W, H)
    mtx = torch.as_tensor(cam[0], dtype=torch.float32, device=dev)
    gray = cuda_remap.remap_gray(frames, camera.undistort_rectify_map(mtx, camera.pad_dist_coeffs(cam[1], dev),
                                                                      (W, H)), th, tw, table=table)
    pool = gray.to(torch.float32).reshape(2, H // 4, 4, W // 4, 4).mean(dim=(2, 4))
    assert _same_set_per_scale(pool, H, W, p) >= 8


@pytest.mark.parametrize("hw", [(392, 528), (544, 51200)], ids=["overhang_132x98", "wide_12800"])
def test_proposals_same_set_overhang_and_wide(dev, hw):
    """K2 where its 32 x 64 tiles overhang both edges of the pooled grid
    (pooled 132 x 98) and at a pooled width of 12,800 cells, beyond the
    12,288 cells the unfused kernel's shared-memory rows allowed: dark
    squares of many sizes in a bright noisy field."""
    h, w = hw
    gen = torch.Generator(device=dev).manual_seed(w)
    pool = torch.full((2, h // 4, w // 4), 200.0, device=dev)
    for f in range(2):
        for _ in range(24 if w > 10000 else 14):
            s = int(torch.randint(3, min(40, h // 8), (1,), generator=gen, device=dev))
            y = int(torch.randint(0, h // 4 - s, (1,), generator=gen, device=dev))
            x = int(torch.randint(0, w // 4 - s, (1,), generator=gen, device=dev))
            pool[f, y:y + s, x:x + s] = 20.0
    pool += torch.randint(0, 4, pool.shape, generator=gen, device=dev).to(torch.float32) / 4
    assert _same_set_per_scale(pool, h, w, det.DetectorParams()) >= 4
    with pytest.raises(ValueError):
        cuda_proposals.proposals_from_pool(pool, h, w, det.DetectorParams(per_scale_k=17))


@pytest.mark.parametrize("rgb", [False, True], ids=["gray", "bgrg"])
def test_colour_table_bit_identical(dev, rgb):
    """The table kernel equals the plain table (the LAB chain of every one of
    the 2^24 colours in PyTorch on the card) bit for bit, at gamma 2 and at
    another gamma."""
    for gamma in (2.0, 1.6):
        got = cuda_remap.colour_table(gamma, dev, rgb=rgb)
        torch.cuda.synchronize()
        assert torch.equal(got, remap.lab_gamma_table(gamma, rgb=rgb, device=dev, chunk=1 << 22)), gamma


def _full_and_selected(frames, map_xy, table):
    """K3 bit-identical to the plain version, and K4's tiles bit-identical to
    the plain version and to K3's full frame, with -1 padding and duplicates."""
    dev = frames.device
    th, tw = remap.pick_tiles(W, H)
    full = cuda_remap.remap_gray(frames, map_xy, th, tw, table=table)
    plain = remap.remap_gray_u8(frames, map_xy)
    assert torch.equal(full, plain)
    ntx = W // tw
    sel = torch.tensor([[0, 7, 7, ntx + 3, -1, -1], [-1, -1, -1, -1, -1, 5]], dtype=torch.int32, device=dev)
    out = cuda_remap.remap_gray_selected(frames, map_xy, sel, th, tw, table=table)
    for b in range(2):
        for t in {int(v) for v in sel[b].tolist() if v >= 0}:
            ty, tx = divmod(t, ntx)
            ys, xs = slice(ty * th, (ty + 1) * th), slice(tx * tw, (tx + 1) * tw)
            assert torch.equal(out[b, ys, xs], full[b, ys, xs]), (b, t)
            assert torch.equal(out[b, ys, xs], plain[b, ys, xs]), (b, t)
    return th, tw, sel


def test_remap_full_and_selected(dev, cam, frames, table):
    """K3 bit-identical to the plain version (the colour table is the chain's
    bits: no FMA contraction, round half to even, IEEE division), and K4's
    tiles bit-identical to the plain version and to K3's full frame, with -1
    padding and duplicates; the wrappers' checks on the card."""
    mtx = torch.as_tensor(cam[0], dtype=torch.float32, device=dev)
    map_xy = camera.undistort_rectify_map(mtx, camera.pad_dist_coeffs(cam[1], dev), (W, H))
    th, tw, sel = _full_and_selected(frames, map_xy, table)
    with pytest.raises(ValueError):
        cuda_remap.remap_gray(frames[:, :, :, ::2], map_xy, th, tw, table=table)
    with pytest.raises(ValueError):
        cuda_remap.remap_gray_selected(frames, map_xy, sel.to(torch.int64), th, tw, table=table)
    with pytest.raises(ValueError):
        cuda_remap.remap_gray(frames, map_xy, th, tw)  # no table
    with pytest.raises(ValueError):
        cuda_remap.remap_gray(frames, map_xy, th, tw, table=table.to(torch.int32))


def test_remap_random_frames_bit_identical(dev, cam, table):
    """K3, K4 and K3's RGB mode bit-identical to the plain versions on uniform
    random frames, where nearly every output pixel is a colour of its own
    (the tables' worst case)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    frames = torch.randint(0, 256, (2, 3, H, W), generator=gen, device=dev, dtype=torch.uint8)
    mtx = torch.as_tensor(cam[0], dtype=torch.float32, device=dev)
    map_xy = camera.undistort_rectify_map(mtx, camera.pad_dist_coeffs(cam[1], dev), (W, H))
    _full_and_selected(frames, map_xy, table)
    rgb, gray = cuda_remap.remap_rgb_gray(frames, map_xy, table=cuda_remap.colour_table(2.0, dev, rgb=True))
    rgb_p, gray_p = remap.remap_rgb_gray_u8(frames, map_xy)
    assert torch.equal(rgb, rgb_p) and torch.equal(gray, gray_p)


def test_pipeline_cuda_matches_cpu(cam, frames):
    """The slice on the card (every kernel) against the port on the CPU
    (plain versions): same detections and LEDs, corners within 0.05 px."""
    cfg = ArucoPipelineConfig()
    gpipe = ArucoPipeline(*cam, (W, H), cfg, device="cuda")
    cpipe = ArucoPipeline(*cam, (W, H), cfg, device="cpu")
    _, g = gpipe.process(frames, init_carry(cfg, "cuda"), first=True)
    _, c = cpipe.process(frames.cpu(), init_carry(cfg, "cpu"), first=True)
    for key in ("detected", "measured", "leds"):
        assert torch.equal(g[key].cpu(), c[key]), key
    assert c["measured"].all()
    assert float((g["corners"].cpu() - c["corners"]).abs().max()) <= 0.05


@pytest.mark.parametrize("shape", [(2, 3, H, W), (3, 3, 98, 132)], ids=["960x544", "132x98"])
def test_pool_bit_identical(dev, shape):
    """K5: every byte of the padded output equals the plain version's, pad
    zeros included (the wrapper allocates with torch.empty, so the kernel
    writes the pad), at the slice's size and at one whose height is not a
    multiple of 4."""
    gen = torch.Generator(device=dev).manual_seed(shape[2])
    frames = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
    b, c, h, w = shape
    out_hw = twopass.pooled_frame_size(w, h, 4)[::-1]
    got = cuda_pool.pool_source(frames, 4, out_hw)
    torch.cuda.synchronize()
    assert got.shape == (b, c, *out_hw)
    assert torch.equal(got, twopass.pool_source_u8(frames, 4, out_hw))
    assert not got[:, :, h // 4:].any() and not got[:, :, :, w // 4:].any()
    with pytest.raises(ValueError):
        cuda_pool.pool_source(frames[..., :-2], 4, out_hw)  # width not a multiple of 4
    with pytest.raises(ValueError):
        cuda_pool.pool_source(frames, 2, (h, w))  # the kernel pools by 4


def test_remap_rgb_mode_bit_identical(dev, cam, frames, table):
    """K3's RGB mode: RGB and gray bit-identical to the plain version on
    planar input, on HWC input and on an HWC view of planar frames (strided,
    no copy); its gray equals K3's gray-only launch (which, with K4, keeps
    test_remap_full_and_selected's bit-identity)."""
    mtx = torch.as_tensor(cam[0], dtype=torch.float32, device=dev)
    map_xy = camera.undistort_rectify_map(mtx, camera.pad_dist_coeffs(cam[1], dev), (W, H))
    lut = cuda_remap.colour_table(2.0, dev, rgb=True)
    rgb, gray = cuda_remap.remap_rgb_gray(frames, map_xy, table=lut)
    rgb_p, gray_p = remap.remap_rgb_gray_u8(frames, map_xy)
    assert torch.equal(rgb, rgb_p) and torch.equal(gray, gray_p)
    assert torch.equal(gray, cuda_remap.remap_gray(frames, map_xy, *remap.pick_tiles(W, H), table=table))
    hwc = frames.permute(0, 2, 3, 1)
    for src in (hwc, hwc.contiguous()):
        rgb_h, gray_h = cuda_remap.remap_rgb_gray(src, map_xy, hwc=True, table=lut)
        assert rgb_h.shape == (2, H, W, 3) and torch.equal(rgb_h, rgb.permute(0, 2, 3, 1))
        assert torch.equal(gray_h, gray)
    out, g = remap.Preprocessor(*cam, (W, H), device=dev)(hwc.contiguous(), with_gray=False)
    assert g is None and torch.equal(out, rgb.permute(0, 2, 3, 1))
    # Any frame size: the overhanging tiles are masked.
    small = map_xy[:37, :201].contiguous()
    rgb_s, gray_s = cuda_remap.remap_rgb_gray(frames, small, table=lut)
    rgb_sp, gray_sp = remap.remap_rgb_gray_u8(frames, small)
    assert torch.equal(rgb_s, rgb_sp) and torch.equal(gray_s, gray_sp)
    for bad in (None, table):  # no table; the gray table is not the packed one
        with pytest.raises(ValueError):
            cuda_remap.remap_rgb_gray(frames, map_xy, table=bad)


def test_single_pass_cuda_matches_cpu(cam, frames):
    """The single-pass front on the card (K3 full frame, K2, K1) against the
    port on the CPU: same detections and LEDs, corners within 0.05 px."""
    from apse_uav_torch import _build

    cfg = ArucoPipelineConfig(two_pass=False)
    gpipe = ArucoPipeline(*cam, (W, H), cfg, device="cuda")
    cpipe = ArucoPipeline(*cam, (W, H), cfg, device="cpu")
    _build.reset_counts()
    _, g = gpipe.process(frames, init_carry(cfg, "cuda"), first=True)
    assert all(_build.launches.get(n, 0) > 0 for n in (cuda_labeling.NAME, cuda_proposals.NAME, cuda_remap.K3))
    _, c = cpipe.process(frames.cpu(), init_carry(cfg, "cpu"), first=True)
    for key in ("detected", "measured", "leds"):
        assert torch.equal(g[key].cpu(), c[key]), key
    assert c["measured"].all()
    assert float((g["corners"].cpu() - c["corners"]).abs().max()) <= 0.05


def _tiny_tracker(device):
    """The CPU parity tests' small tracker (R50-FPN, 64 short side, 4
    detections, 3 tracked) from a seeded checkpoint and re-ID head."""
    import dataclasses

    from apse_uav_torch.dcnn.config import TrackerConfig, mask_rcnn_r50_fpn
    from apse_uav_torch.dcnn.engines import RcnnTracker
    from apse_uav_torch.dcnn.models.association import init_weights
    from apse_uav_torch.utils.synthetic import detectron2_checkpoint

    cfg = mask_rcnn_r50_fpn(2)
    cfg = dataclasses.replace(
        cfg, rpn=dataclasses.replace(cfg.rpn, pre_nms_topk_test=32, post_nms_topk_test=16),
        roi=dataclasses.replace(cfg.roi, detections_per_image=4, score_thresh_test=0.0),
        input=dataclasses.replace(cfg.input, min_size_test=64, max_size_test=128))
    tcfg = TrackerConfig(max_tracks=8, max_detections=3, embedding_dim=8, roi_size=4)
    return RcnnTracker(cfg, tcfg, detectron2_checkpoint(0, 50, 2), init_weights(256 * 16, 8), (100, 160),
                       device=device)


def test_tracker_cuda_matches_cpu(dev):
    """The DCNN tracker on the card (cuDNN/cuBLAS in float32, no TF32) against
    its CPU run on 3 frames of 100x160: identical valid, ids and classes,
    boxes within 0.05 px, masks within 1e-3, identical CSV rows."""
    from apse_uav_torch.utils.mask_geometry import dcnn_log_line

    frames = np.random.default_rng(1).integers(0, 255, (3, 100, 160, 3), np.uint8)
    g = _tiny_tracker("cuda").process_frames(frames)
    c = _tiny_tracker("cpu").process_frames(frames)
    for t in range(3):
        for k in ("valid", "ids", "classes"):
            np.testing.assert_array_equal(g[k][t], c[k][t], err_msg=f"frame {t} {k}")
        v = c["valid"][t]
        np.testing.assert_allclose(g["boxes"][t][v], c["boxes"][t][v], rtol=0, atol=0.05)
        np.testing.assert_allclose(g["masks"][t][v], c["masks"][t][v], rtol=0, atol=1e-3)
        assert dcnn_log_line({k: a[t] for k, a in g.items()}, 2, t, (100, 160)) == \
            dcnn_log_line({k: a[t] for k, a in c.items()}, 2, t, (100, 160))


def test_tracker_dispatch_syncs_only_to_test_convergence(dev):
    """Dispatching a batch on the card synchronises with the host only at the
    NMS and auction convergence tests (counted by ops.loops)."""
    import warnings

    from apse_uav_torch.dcnn.ops import loops

    tracker = _tiny_tracker("cuda")
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 255, (2, 100, 160, 3), np.uint8)).to(dev)
    tracker.process_frames(x)
    loops.reset_checks()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tracker.process_frames_async(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    assert syncs == loops.checks["count"] > 0, (syncs, loops.checks["count"])


def test_bf16_maps_near_float32_and_cpu(dev):
    """The tiny R50-FPN with compute_dtype="bfloat16" on the card (cuDNN bf16):
    bfloat16 p2-p6 within 3e-2 of each map's max-abs of the float32 maps and
    of the bf16 CPU run (the CPU test against the reference measures its own
    bf16-to-float32 gap at 1.2e-2 on this model)."""
    import dataclasses

    from apse_uav_torch.dcnn.config import mask_rcnn_r50_fpn
    from apse_uav_torch.dcnn.engines import TrackPredictor
    from apse_uav_torch.utils.synthetic import detectron2_checkpoint

    base = dataclasses.replace(mask_rcnn_r50_fpn(2), input=dataclasses.replace(mask_rcnn_r50_fpn(2).input,
                                                                                 min_size_test=64, max_size_test=128))
    ckpt = detectron2_checkpoint(0, 50, 2)
    frames = np.random.default_rng(1).integers(0, 255, (2, 100, 160, 3), np.uint8)
    maps = {}
    for key, dtype, device in (("f32", "float32", "cuda"), ("bf16", "bfloat16", "cuda"), ("bf16_cpu", "bfloat16", "cpu")):
        pred = TrackPredictor(dataclasses.replace(base, compute_dtype=dtype), ckpt, (100, 160), device=device)
        dets, feats = pred(frames)
        maps[key] = {n: feats[n].float().cpu() for n in ("p2", "p3", "p4", "p5", "p6")}
        assert (feats["p2"].dtype == torch.bfloat16) == (dtype == "bfloat16")
        assert dets["boxes"].dtype == torch.float32 and dets["scores"].dtype == torch.float32
    for n, want in maps["f32"].items():
        scale = float(want.abs().max())
        assert float((maps["bf16"][n] - want).abs().max()) <= 3e-2 * scale, n
        assert float((maps["bf16"][n] - maps["bf16_cpu"][n]).abs().max()) <= 3e-2 * scale, n


@pytest.mark.parametrize("solver", ["linear_sum_assignment", "auction_assignment"])
def test_solvers_cuda_match_cpu(dev, solver):
    """The exact and the eps-scaled assignment on the card against the CPU on
    seeded 32x32 costs, both ways: identical assignments."""
    from apse_uav_torch.dcnn import hungarian

    fn = getattr(hungarian, solver)
    for seed in range(3):
        c = torch.from_numpy(np.random.default_rng(seed).uniform(0, 4, (32, 32)).astype(np.float32))
        for maximize in (False, True):
            assert torch.equal(fn(c.to(dev), maximize)[1].cpu(), fn(c, maximize)[1]), (seed, maximize)


@pytest.mark.parametrize("metric", ["bbox_center_dist", "mask_iou", "embeddings"])
def test_association_metrics_cuda_match_cpu(dev, metric):
    """The tiny tracker under each association metric on the card against
    its CPU run on 3 frames: identical valid, ids and classes."""
    import dataclasses

    frames = np.random.default_rng(1).integers(0, 255, (3, 100, 160, 3), np.uint8)
    out = {}
    for device in ("cuda", "cpu"):
        tracker = _tiny_tracker(device)
        tracker.cfg = dataclasses.replace(tracker.cfg, association_metric=metric)
        out[device] = tracker.process_frames(frames)
    for k in ("valid", "ids", "classes"):
        np.testing.assert_array_equal(out["cuda"][k], out["cpu"][k], err_msg=k)


def test_device_threefry_matches_numpy(dev):
    """The training streams on the card: ``split``-derived keys' uniforms (the
    sampling priorities) bit for bit against the numpy reproduction of
    ``jax.random``, the normal and the LeCun init against the CPU's."""
    from apse_uav_torch.dcnn import flax_init

    keys = flax_init.split(flax_init.prng_key(7), 4)
    got = flax_init.uniform_t(keys, 300_001, dev).cpu().numpy()
    for i in range(4):
        np.testing.assert_array_equal(got[i], flax_init.uniform(keys[i], (300_001,), 0.0, 1.0))
    np.testing.assert_array_equal(flax_init.normal_t(keys[0], 50_000, dev, 0.01).cpu().numpy(),
                                  flax_init.normal_t(keys[0], 50_000, "cpu", 0.01).numpy())
    np.testing.assert_array_equal(flax_init.lecun_normal_t(keys[1], (3, 3, 64, 32), dev).cpu().numpy(),
                                  flax_init.lecun_normal_t(keys[1], (3, 3, 64, 32), "cpu").numpy())


def test_detector_train_step_cuda_matches_cpu(dev):
    """One fine-tune step of the tiny R50 (RPN + ROI heads, frozen backbone,
    mask head on; batch 2 at 64x64) on the card against the CPU from the same
    weights, batch, key, backbone maps and proposals (the card's: ROIAlign's
    bfloat16 copy of the maps turns a last-bit difference into a bf16 step,
    top-k and NMS flip on such differences of the logits; the maps
    themselves within 1e-4 of their max-abs): each loss within 1e-4 relative, the trained
    tensors' change within 1e-4 of its max-abs (plus 2 ulp), the frozen ones
    untouched on both."""
    import dataclasses

    from apse_uav_torch.dcnn.config import mask_rcnn_r50_fpn
    from apse_uav_torch.dcnn.engines import full_fp32
    from apse_uav_torch.utils.synthetic import detectron2_checkpoint, learning_scenes

    cfg = mask_rcnn_r50_fpn(2)
    cfg = dataclasses.replace(
        cfg, rpn=dataclasses.replace(cfg.rpn, pre_nms_topk_train=64, post_nms_topk_train=32, batch_size_per_image=32),
        roi=dataclasses.replace(cfg.roi, batch_size_per_image=16))
    ckpt = detectron2_checkpoint(3, 50, 2)
    images, gt = next(learning_scenes(2, (64, 64), seed=2))
    gt["masks"] = np.zeros((2, 4, 64, 64), np.float32)
    for i in range(2):
        for j in range(4):
            x1, y1, x2, y2 = gt["boxes"][i, j].astype(int)
            gt["masks"][i, j, y1:y2, x1:x2] = 1.0
    out, given = {}, None
    for d in (dev, torch.device("cpu")):
        with full_fp32():  # no TF32 in cuDNN's convolutions
            out[d.type], given = _one_step(cfg, ckpt, images, gt, d, given)
    (gl, gp, names), (cl, cp, _) = out["cuda"], out["cpu"]
    for k, v in cl.items():
        assert abs(gl[k] - v) <= 1e-4 * abs(v), (k, gl[k], v)
    upd = max(float((cp[n] - torch.as_tensor(ckpt[n])).abs().max()) for n in names)
    for n in gp:
        if n in names:
            tol = 1e-4 * upd + 2 * np.spacing(cp[n].abs().numpy())
            assert (np.abs((gp[n] - cp[n]).numpy()) <= tol).all(), n
        else:
            assert torch.equal(gp[n], cp[n]) and torch.equal(cp[n], torch.as_tensor(ckpt[n])), n


def _one_step(cfg, ckpt, images, gt, d, given=None):
    """One fine-tune step of ``cfg``'s model from ``ckpt`` on ``d``, on the
    ``given`` (maps, proposals) or its own: ((losses, every tensor after the
    step, the trained names), the (maps, proposals) used)."""
    from apse_uav_torch.dcnn import flax_init, weights as W
    from apse_uav_torch.dcnn.models.mask_rcnn import MaskRCNN
    from apse_uav_torch.train import optim, steps

    model = MaskRCNN(cfg)
    W.load_detectron2(model, ckpt)
    model = model.to(d)
    tensors = model.state_dict(keep_vars=True)
    opt = optim.build_finetune_optimizer(tensors, lr=optim.warmup_multistep_schedule(0.02, (), 1, 1.0))
    steps.trainable_only(opt.trainable(), tensors.values())
    x = torch.from_numpy(images).to(d)
    with torch.no_grad():
        feats = model.features(x)
    if given is None:
        given = feats, model.training_proposals(x, feats)
    else:
        for k, v in feats.items():
            assert float((v - given[0][k].to(d)).abs().max()) <= 1e-4 * float(v.abs().max()), k
    feats, proposals = {k: v.to(d) for k, v in given[0].items()}, tuple(t.to(d) for t in given[1])
    losses = steps.detector_train_step(model, opt, x, {k: torch.from_numpy(v).to(d) for k, v in gt.items()},
                                       flax_init.prng_key(5), True, proposals=proposals, features=feats)
    return ({k: float(v) for k, v in losses.items()}, {k: v.detach().cpu() for k, v in tensors.items()},
            opt.names), given


def test_c4_inference_cuda_matches_cpu(dev):
    """The C4 model (a depth-26 R-C4, 3 classes, 64 -> 16 proposals, 4
    detections) on 2 images of 128x128, card against CPU from one seeded C4
    checkpoint, TF32 off: res2-res4 within 1e-4 of each map's max-abs, the
    same valid detections and classes, boxes within 1e-3 px, 14x14 masks
    within 1e-4."""
    import dataclasses

    from apse_uav_torch.dcnn import weights as W
    from apse_uav_torch.dcnn.config import mask_rcnn_r50_c4
    from apse_uav_torch.dcnn.engines import full_fp32
    from apse_uav_torch.dcnn.models.c4 import build_model
    from apse_uav_torch.utils.synthetic import detectron2_checkpoint

    cfg = mask_rcnn_r50_c4(3)
    cfg = dataclasses.replace(cfg, depth=26,
                              rpn=dataclasses.replace(cfg.rpn, pre_nms_topk_test=64, post_nms_topk_test=16),
                              roi=dataclasses.replace(cfg.roi, detections_per_image=4))
    ckpt = detectron2_checkpoint(0, 26, 3, architecture="c4")
    images = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (2, 128, 128, 3)).astype(np.float32))
    out = {}
    for d in (dev, torch.device("cpu")):
        model = build_model(cfg).eval()
        assert W.load_detectron2(model, ckpt) == ([], [])
        with full_fp32():
            det, feats = model.to(d).inference(images.to(d))
        out[d.type] = ({k: v.cpu() for k, v in det.items()}, {k: v.cpu() for k, v in feats.items()})
    (gd, gf), (cd, cf) = out["cuda"], out["cpu"]
    for k in ("res2", "res3", "res4"):
        assert float((gf[k] - cf[k]).abs().max()) <= 1e-4 * float(cf[k].abs().max()), k
    assert torch.equal(gd["valid"], cd["valid"]) and torch.equal(gd["classes"], cd["classes"])
    torch.testing.assert_close(gd["boxes"], cd["boxes"], rtol=0, atol=1e-3)
    torch.testing.assert_close(gd["masks"], cd["masks"], rtol=0, atol=1e-4)


def test_dp_step_on_one_nccl_rank_matches_plain_step(dev):
    """The data-parallel step on a one-rank NCCL group (the all-reduce of
    one rank is the identity) against the plain step on the same card, from
    the same weights, batch and key: losses and updated tensors within 1e-6
    relative (atol 1e-7)."""
    import torch.distributed as dist

    from apse_uav_torch.dcnn.engines import full_fp32
    from apse_uav_torch.parallel import dp

    job = dp.dryrun_job(2)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{dp.free_port()}", world_size=1, rank=0)
    try:
        with full_fp32():
            losses, state = dp.run_step(job, 0, 1, dev)
    finally:
        dist.destroy_process_group()
    with full_fp32():
        want, want_state = dp.plain_step(job, dev)
    for k, v in want.items():
        np.testing.assert_allclose(losses[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    for k, v in want_state.items():
        np.testing.assert_allclose(state[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
