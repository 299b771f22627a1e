"""PyTorch port, preprocessing: pool, remap + LAB gamma + gray (the plain
versions of kernels K3/K4), tile grid and renderer, against the JAX package
on the CPU."""

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
from apse_uav_torch.preproc import cuda_remap, remap as tremap, twopass as ttp
from apse_uav_torch.utils import synthetic as tsyn

W, H = 960, 544
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
    got = tsyn.render_scene(mtx, dist, (w, h), specs_t, altitude=6.0).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, ((d > 0).mean(), d.max())
    assert (want < 100).sum() > 50  # the markers are in view
