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
from apse_uav_torch.utils.synthetic import MarkerSpec, render_scene

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
def frames(cam, dev):
    specs = [MarkerSpec(4, (0.0, 0.5), 5, leds=0b10110010), MarkerSpec(1, (-4.0, -2.0), 30),
             MarkerSpec(2, (4.0, 1.5), -20), MarkerSpec(3, (1.5, -2.5), 90)]
    return torch.stack([render_scene(*cam, (W, H), specs, altitude=12.0, device=dev).permute(2, 0, 1)
                        for _ in range(2)]).contiguous()


@pytest.mark.parametrize("win", [64, 33])
def test_labels_bit_identical(dev, win):
    """K1: the label field equals the plain version's bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(win)
    dark = torch.rand((37, win, win), generator=gen, device=dev) < 0.55
    dark[0] = False
    dark[1] = True
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


def test_proposals_same_set_per_scale(dev, cam, frames):
    """K2: the same valid candidates per scale as the plain version, scores
    within 5e-4 (in practice bit-identical: both integrate exactly in f64)."""
    p = det.DetectorParams()
    th, tw = remap.pick_tiles(W, H)
    mtx = torch.as_tensor(cam[0], dtype=torch.float32, device=dev)
    gray = cuda_remap.remap_gray(frames, camera.undistort_rectify_map(mtx, camera.pad_dist_coeffs(cam[1], dev),
                                                                      (W, H)), th, tw)
    pool = gray.to(torch.float32).reshape(2, H // 4, 4, W // 4, 4).mean(dim=(2, 4))
    got = cuda_proposals.proposals_from_pool(pool, H, W, p)
    want = det._proposals_from_pool(pool, H, W, p)
    k = p.per_scale_k
    n_valid = 0
    for b in range(2):
        for a in range(0, got[0].shape[1], k):
            def cand(pr):
                c, s, v, ok = (t[b, a:a + k].cpu() for t in pr)
                return {(float(cc[0]), float(cc[1]), float(ss)): float(vv) for cc, ss, vv, o in zip(c, s, v, ok) if o}

            g, w_ = cand(got), cand(want)
            assert set(g) == set(w_), (b, a // k)
            assert all(abs(g[key] - w_[key]) <= 5e-4 for key in g)
            n_valid += len(g)
    assert n_valid >= 8


def test_remap_full_and_selected(dev, cam, frames):
    """K3 bit-identical to the plain version (both round alike: no FMA
    contraction, round half to even, IEEE division), and K4's tiles
    bit-identical to the plain version and to K3's full frame, with -1
    padding and duplicates."""
    mtx = torch.as_tensor(cam[0], dtype=torch.float32, device=dev)
    map_xy = camera.undistort_rectify_map(mtx, camera.pad_dist_coeffs(cam[1], dev), (W, H))
    th, tw = remap.pick_tiles(W, H)
    full = cuda_remap.remap_gray(frames, map_xy, th, tw)
    plain = remap.remap_gray_u8(frames, map_xy)
    assert torch.equal(full, plain)
    ntx = W // tw
    sel = torch.tensor([[0, 7, 7, ntx + 3, -1, -1], [-1, -1, -1, -1, -1, 5]], dtype=torch.int32, device=dev)
    out = cuda_remap.remap_gray_selected(frames, map_xy, sel, th, tw)
    for b in range(2):
        for t in {int(v) for v in sel[b].tolist() if v >= 0}:
            ty, tx = divmod(t, ntx)
            ys, xs = slice(ty * th, (ty + 1) * th), slice(tx * tw, (tx + 1) * tw)
            assert torch.equal(out[b, ys, xs], full[b, ys, xs]), (b, t)
            assert torch.equal(out[b, ys, xs], plain[b, ys, xs]), (b, t)
    with pytest.raises(ValueError):
        cuda_remap.remap_gray(frames[:, :, :, ::2], map_xy, th, tw)
    with pytest.raises(ValueError):
        cuda_remap.remap_gray_selected(frames, map_xy, sel.to(torch.int64), th, tw)


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


def test_remap_rgb_mode_bit_identical(dev, cam, frames):
    """K3's RGB mode: RGB and gray bit-identical to the plain version on
    planar input, on HWC input and on an HWC view of planar frames (strided,
    no copy); its gray equals K3's gray-only launch (which, with K4, keeps
    test_remap_full_and_selected's bit-identity)."""
    mtx = torch.as_tensor(cam[0], dtype=torch.float32, device=dev)
    map_xy = camera.undistort_rectify_map(mtx, camera.pad_dist_coeffs(cam[1], dev), (W, H))
    rgb, gray = cuda_remap.remap_rgb_gray(frames, map_xy)
    rgb_p, gray_p = remap.remap_rgb_gray_u8(frames, map_xy)
    assert torch.equal(rgb, rgb_p) and torch.equal(gray, gray_p)
    assert torch.equal(gray, cuda_remap.remap_gray(frames, map_xy, *remap.pick_tiles(W, H)))
    hwc = frames.permute(0, 2, 3, 1)
    for src in (hwc, hwc.contiguous()):
        rgb_h, gray_h = cuda_remap.remap_rgb_gray(src, map_xy, hwc=True)
        assert rgb_h.shape == (2, H, W, 3) and torch.equal(rgb_h, rgb.permute(0, 2, 3, 1))
        assert torch.equal(gray_h, gray)
    out, g = remap.Preprocessor(*cam, (W, H), device=dev)(hwc.contiguous(), with_gray=False)
    assert g is None and torch.equal(out, rgb.permute(0, 2, 3, 1))
    # Any frame size: the overhanging tiles are masked.
    small = map_xy[:37, :201].contiguous()
    rgb_s, gray_s = cuda_remap.remap_rgb_gray(frames, small)
    rgb_sp, gray_sp = remap.remap_rgb_gray_u8(frames, small)
    assert torch.equal(rgb_s, rgb_sp) and torch.equal(gray_s, gray_sp)


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
