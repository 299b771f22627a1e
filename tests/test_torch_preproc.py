"""PyTorch port, preprocessing: pool (kernel K5's wrapper on CPU tensors),
remap + LAB gamma + gray (the plain versions of kernels K3/K4 and of K3's RGB
mode), Preprocessor, tile grid and renderer, against the JAX package on the
CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apse_uav_tpu.core import camera as jcam
from apse_uav_tpu.preproc import remap as jremap, twopass as jtp
from apse_uav_tpu.preproc.pallas_remap import _pick_tiles
from apse_uav_tpu.utils import synthetic as jsyn
from apse_uav_torch.core import camera as tcam
from apse_uav_torch.preproc import cuda_pool, cuda_remap, remap as tremap, twopass as ttp
from apse_uav_torch.utils import synthetic as tsyn

W, H = 960, 544
REPO = os.path.join(os.path.dirname(__file__), "..")
SPECS = [
    (4, (0.0, 0.5), 5, 0b10110010),
    (1, (-4.0, -2.0), 30, None),
    (2, (4.0, 1.5), -20, None),
    (3, (1.5, -2.5), 90, None),
]


@pytest.fixture(scope="module")
def cam():
    mtx, dist = jcam.load_camera_params(os.path.join(os.path.dirname(__file__), "..", "data", "cam_params.json"))
    ms = mtx * np.array([[W / 3840, 1, W / 3840], [1, H / 2160, H / 2160], [1, 1, 1]])
    return ms, dist


@pytest.fixture(scope="module")
def frames(cam):
    """Two rendered frames, planar (2, 3, H, W) u8, from the JAX renderer."""
    ms, dist = cam
    out = []
    for t in range(2):
        specs = [jsyn.MarkerSpec(i, (x + 0.1 * t, y), yaw, leds=leds) for i, (x, y), yaw, leds in SPECS]
        out.append(jsyn.render_scene(ms, dist, (W, H), specs, altitude=12.0))
    return np.ascontiguousarray(np.stack(out).transpose(0, 3, 1, 2))


def test_pool_source_bit_identical(frames):
    st = 4
    hw = jtp.pooled_frame_size(W, H, st)[::-1]
    want = np.asarray(jtp.pool_source_u8(jnp.asarray(frames), st, hw))
    got = ttp.pool_source_u8(torch.from_numpy(frames), st, hw).numpy()
    assert np.array_equal(got, want)
    assert ttp.pooled_frame_size(W, H, st) == jtp.pooled_frame_size(W, H, st)
    assert np.array_equal(ttp.pooled_camera(np.eye(3) * 7, st), jtp.pooled_camera(np.eye(3) * 7, st))


@pytest.mark.parametrize("pooled", [False, True], ids=["full", "pooled"])
def test_remap_gray_matches_jax(cam, frames, pooled):
    """Plain remap + LAB gamma + gray against remap.preprocess_frames.

    The undistort map and the bilinear u8 resample are bit-identical; the
    LAB chain is not everywhere (XLA:CPU pow/cbrt/FMA, see
    test_torch_core's colorspace census), so a pinned fraction of pixels
    may differ: measured 3.4e-5 (full) and 8.3e-5 (pooled), <= 3 levels.
    Pinned: <= 2e-4 of the pixels, <= 4 gray levels (one u8 LAB step
    through the gamma LUT).
    """
    ms, dist = cam
    src = frames
    size = (W, H)
    if pooled:
        st = 4
        wp, hp = jtp.pooled_frame_size(W, H, st)
        src = np.asarray(jtp.pool_source_u8(jnp.asarray(frames), st, (hp, wp)))
        ms = jtp.pooled_camera(ms, st)
        size = (wp, hp)
    rgb_j, gray_j = jremap.preprocess_frames(jnp.asarray(src.transpose(0, 2, 3, 1)), jnp.asarray(ms, jnp.float32),
                                             jnp.asarray(dist, jnp.float32), size)
    rgb_t, gray_t = tremap.preprocess_frames(torch.from_numpy(src), ms, dist, size)
    d = np.abs(gray_t.numpy().astype(int) - np.asarray(gray_j).astype(int))
    assert (d > 0).mean() <= 2e-4 and d.max() <= 4, ((d > 0).mean(), d.max())
    # The resample alone is bit-identical.
    mtx_t = torch.tensor(ms, dtype=torch.float32)
    map_t = tcam.undistort_rectify_map(mtx_t, tcam.pad_dist_coeffs(dist), size)
    und_t = tremap.bilinear_remap_u8(torch.from_numpy(src), map_t).numpy()
    map_j = jcam.undistort_rectify_map(jnp.asarray(ms, jnp.float32), jnp.asarray(dist, jnp.float32), size)
    und_j = np.stack([np.asarray(jremap.bilinear_remap_u8(jnp.asarray(f.transpose(1, 2, 0)), map_j)) for f in src])
    assert np.array_equal(und_t, und_j.transpose(0, 3, 1, 2))
    # The wrappers of K3 take the plain version on CPU tensors.
    th, tw = tremap.pick_tiles(*size)
    assert torch.equal(cuda_remap.remap_gray(torch.from_numpy(src), map_t, th, tw), gray_t)


def test_selected_tiles_on_cpu_are_the_full_frame_tiles(cam, frames):
    ms, dist = cam
    map_t = tcam.undistort_rectify_map(torch.tensor(ms, dtype=torch.float32), tcam.pad_dist_coeffs(dist), (W, H))
    th, tw = tremap.pick_tiles(W, H)
    src = torch.from_numpy(frames)
    full = cuda_remap.remap_gray(src, map_t, th, tw)
    ntx = W // tw
    sel = torch.tensor([[0, 5, 5, ntx + 1, -1], [3, -1, -1, -1, -1]], dtype=torch.int32)
    out = cuda_remap.remap_gray_selected(src, map_t, sel, th, tw)
    for b in range(2):
        chosen = {int(t) for t in sel[b] if t >= 0}
        for t in range((H // th) * ntx):
            ty, tx = divmod(t, ntx)
            tile = (b, slice(ty * th, (ty + 1) * th), slice(tx * tw, (tx + 1) * tw))
            if t in chosen:
                assert torch.equal(out[tile], full[tile])
            else:
                assert not out[tile].any()


def test_pick_tiles_and_tau_rule():
    for size in ((3840, 2160), (960, 544), (1024, 544), (1280, 736), (640, 480)):
        assert tremap.pick_tiles(*size) == _pick_tiles(*size)
    with pytest.raises(NotImplementedError):
        tremap.check_no_tilt(np.r_[np.zeros(12), 0.01, 0.0])
    tremap.check_no_tilt(np.zeros(5))


def test_renderer_matches_jax(cam):
    """The float64 torch renderer against the reference's numpy renderer:
    the same scene to the last u8 level except on pixels whose box mean
    lands on a rounding edge (last-ulp sin/cos differences)."""
    ms, dist = cam
    w, h = 240, 136
    mtx = ms * np.array([[w / W, 1, w / W], [1, h / H, h / H], [1, 1, 1]])
    specs_j = [jsyn.MarkerSpec(i, xy, yaw, leds=leds) for i, xy, yaw, leds in SPECS]
    specs_t = [tsyn.MarkerSpec(i, xy, yaw, leds=leds) for i, xy, yaw, leds in SPECS]
    want = jsyn.render_scene(mtx, dist, (w, h), specs_j, altitude=6.0)
    got = tsyn.render_scene(mtx, dist, (w, h), specs_t, altitude=6.0, device="cpu").numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, ((d > 0).mean(), d.max())
    assert (want < 100).sum() > 50  # the markers are in view


@pytest.fixture(scope="module")
def packed_pool():
    """test_pallas_pool's setting: two random 1280x736 frames, their packed
    source and the full-res and pooled plans' geometry (plans built without
    the on-disk cache)."""
    from apse_uav_tpu.preproc.pallas_remap import PallasPreprocessor, build_remap_plan

    w, h = 1280, 736
    mtx, dist = jcam.load_camera_params(os.path.join(REPO, "data", "cam_params.json"))
    mtx = np.asarray(mtx) * np.array([[w / 3840, 1, w / 3840], [1, h / 2160, h / 2160], [1, 1, 1.0]])
    wp, hp = jtp.pooled_frame_size(w, h, 4)
    mtx_p = jtp.pooled_camera(np.asarray(mtx, np.float64), 4)
    pre = PallasPreprocessor(mtx, dist, (w, h), want_rgb=False, plan=build_remap_plan(mtx, dist, (w, h), cache=False))
    plan_p = build_remap_plan(mtx_p, dist, (wp, hp), cache=False, valid_wh=(w // 4, h // 4))
    pre_p = PallasPreprocessor(mtx_p, dist, (wp, hp), want_rgb=False, plan=plan_p)
    frames = np.random.default_rng(0).integers(0, 256, (2, 3, h, w), np.uint8)
    return frames, pre.host_pack(frames), pre.dims, pre_p.dims


@pytest.mark.parametrize("route", ["xla", pytest.param("pallas_interpret", marks=pytest.mark.slow)])
def test_pool_wrapper_matches_jax_packed_pool(packed_pool, route):
    """K5's wrapper on a CPU tensor against the reference's packed pool --
    its XLA chain (twopass.pool_packed_to_packed, which test_pallas_pool pins
    to K5) or K5 itself in interpret mode -- bit for bit: the packed output
    unpacked to planar u8 with a numpy view, its core against the port's
    pooled frame, and every pad byte zero on both sides."""
    import jax

    from apse_uav_tpu.preproc.pallas_pool import pool_packed_to_packed_pallas

    frames, packed, dims, dims_p = packed_pool
    b, _, h, w = frames.shape
    h4, w4 = h // 4, w // 4
    if route == "xla":
        want = jax.jit(lambda pk: jtp.pool_packed_to_packed(pk, dims, h, w, dims_p))(jnp.asarray(packed))
    else:
        want = pool_packed_to_packed_pallas(jnp.asarray(packed), dims, h, w, dims_p, interpret=True)
    planar = np.asarray(want).view(np.uint8).reshape(b, 3, dims_p.padded_h, dims_p.padded_w)
    core = (slice(None), slice(None), slice(dims_p.pad_y, dims_p.pad_y + h4), slice(dims_p.pad_x, dims_p.pad_x + w4))
    hp, wp = ttp.pooled_frame_size(w, h, 4)[::-1]
    got = cuda_pool.pool_source(torch.from_numpy(frames), 4, (hp, wp)).numpy()
    assert got.shape == (b, 3, hp, wp) and got.dtype == np.uint8
    assert np.array_equal(got[:, :, :h4, :w4], planar[core])
    assert not got[:, :, h4:].any() and not got[:, :, :, w4:].any()
    pad = planar.copy()
    pad[core] = 0
    assert not pad.any()


@pytest.mark.parametrize("batch", [True, False], ids=["batch", "single"])
def test_preprocessor_matches_jax(cam, frames, batch):
    """Preprocessor on the CPU against the reference's Preprocessor, RGB and
    gray, on the batch of rendered frames and on one frame, with and without
    gray.

    Equal except for the LAB chain's documented differences (XLA:CPU's FMAs
    and pow, see test_torch_core's colorspace census): measured on these
    frames 38 of 1,044,480 pixels (3.6e-5; 4.2e-5 on the first frame alone),
    by at most 3 levels, in RGB and in gray alike.  Pinned: at most 5e-5 of
    the pixels, at most 4 levels.
    """
    ms, dist = cam
    hwc = np.ascontiguousarray(frames.transpose(0, 2, 3, 1))
    src = hwc if batch else hwc[0]
    jpre = jremap.Preprocessor(ms, dist, (W, H))
    tpre = tremap.Preprocessor(ms, dist, (W, H), device="cpu")
    rgb_j, gray_j = (np.asarray(x) for x in jpre(jnp.asarray(src)))
    rgb_t, gray_t = tpre(torch.from_numpy(src))
    assert rgb_t.shape == rgb_j.shape == src.shape and gray_t.shape == gray_j.shape == src.shape[:-1]
    assert rgb_t.dtype == gray_t.dtype == torch.uint8
    d = np.abs(rgb_t.numpy().astype(int) - rgb_j.astype(int)).max(axis=-1)
    dg = np.abs(gray_t.numpy().astype(int) - gray_j.astype(int))
    assert (d > 0).mean() <= 5e-5 and d.max() <= 4, ((d > 0).mean(), d.max())
    assert (dg > 0).mean() <= 5e-5 and dg.max() <= 4, ((dg > 0).mean(), dg.max())
    rgb_n, gray_n = tpre(torch.from_numpy(src), with_gray=False)
    rgb_jn, gray_jn = jpre(jnp.asarray(src), with_gray=False)
    assert gray_n is None and gray_jn is None
    assert torch.equal(rgb_n, rgb_t) and np.array_equal(np.asarray(rgb_jn), rgb_j)
    # The wrapper of K3's RGB mode takes the plain version on CPU tensors, in
    # either layout.
    if batch:
        t = torch.from_numpy(frames)
        rgb_p, gray_p = cuda_remap.remap_rgb_gray(t, tpre.map_xy)
        assert torch.equal(rgb_p, rgb_t.permute(0, 3, 1, 2)) and torch.equal(gray_p, gray_t)


@pytest.mark.slow
def test_preprocessor_matches_pallas_rgb_and_cv2():
    """Preprocessor on the CPU against the reference's fused kernel with its
    RGB output (PallasPreprocessor(want_rgb=True), interpret mode) and
    against the OpenCV chain, at test_pallas_remap's 512x128.

    The Pallas kernel evaluates pow and cbrt with its own approximations
    (pallas_remap.py:521-585), so the reference's XLA chain itself differs
    from it: on the rendered frame 1.36e-3 of the pixels, by up to 4 levels.
    The port lands where XLA does (measured 1.40e-3, 4 levels).  Pinned on
    the rendered frame: at most 2e-3 of the pixels, at most 4 levels.  The
    cv2-chain bounds are test_pallas_remap's, on its sinusoidal image.
    """
    import cv2

    from apse_uav_tpu.preproc.pallas_remap import PallasPreprocessor

    h, w = 16 * 8, 256 * 2
    mtx, dist = jcam.load_camera_params(os.path.join(REPO, "data", "cam_params.json"))
    mtx = mtx.copy()
    mtx[0] *= w / 3840.0
    mtx[1] *= h / 2160.0
    specs = [jsyn.MarkerSpec(4, (0.0, 0.5), 5, leds=0b10110010), jsyn.MarkerSpec(1, (-4.0, -1.0), 30),
             jsyn.MarkerSpec(2, (4.0, 0.5), -20)]
    scene = jsyn.render_scene(mtx, dist, (w, h), specs, altitude=8.0)
    yy, xx = np.mgrid[0:h, 0:w]
    sines = np.stack([128 + 100 * np.sin(xx / 17.0) * np.cos(yy / 23.0), 128 + 90 * np.cos(xx / 29.0 + 1.0),
                      128 + 80 * np.sin(yy / 13.0 + 2.0)], -1).clip(0, 255).astype(np.uint8)
    hwc = np.stack([scene, sines])
    out, gray = PallasPreprocessor(mtx, dist, (w, h), interpret=True, want_rgb=True)(jnp.asarray(hwc.transpose(0, 3, 1, 2)))
    out = np.asarray(out).transpose(0, 2, 3, 1).astype(int)
    gray = np.asarray(gray).astype(int)
    rgb_t, gray_t = tremap.Preprocessor(mtx, dist, (w, h), device="cpu")(torch.from_numpy(hwc))
    rgb_t, gray_t = rgb_t.numpy().astype(int), gray_t.numpy().astype(int)
    d = np.abs(rgb_t[0] - out[0]).max(axis=-1)
    dg = np.abs(gray_t[0] - gray[0])
    assert (d > 0).mean() <= 2e-3 and d.max() <= 4, ((d > 0).mean(), d.max())
    assert (dg > 0).mean() <= 2e-3 and dg.max() <= 4, ((dg > 0).mean(), dg.max())

    mapx, mapy = cv2.initUndistortRectifyMap(mtx, dist.reshape(-1, 1), None, mtx, (w, h), cv2.CV_32FC1)
    ref = cv2.remap(sines, mapx, mapy, cv2.INTER_LINEAR)
    lut = np.clip((np.arange(256) / 255.0) ** 2 * 255.0, 0, 255).astype(np.uint8)
    lab = cv2.cvtColor(ref, cv2.COLOR_RGB2LAB)
    lab[..., 0] = cv2.LUT(lab[..., 0], lut)
    ref = cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)
    d = np.abs(rgb_t[1] - ref.astype(int))
    dg = np.abs(gray_t[1] - cv2.cvtColor(ref, cv2.COLOR_BGR2GRAY).astype(int))
    assert (d > 2).mean() < 0.02, ((d > 2).mean(), d.max())
    assert (dg > 2).mean() < 0.01, ((dg > 2).mean(), dg.max())
    assert (dg > 1).mean() < 0.05
