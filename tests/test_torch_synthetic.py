"""PyTorch port, the synthetic scenes against the JAX package on the CPU:
``SceneRenderer`` (the reference's bench renderer), ``render_scene`` and the
ground truth (``marker_world_corners``, ``project_world_to_undistorted``).

Cameras, scenes and points are made with numpy from fixed seeds and handed to
both packages; tolerances are stated per test.
"""

import os

import numpy as np
import pytest
import torch

from apse_uav_tpu.core import camera as jcam
from apse_uav_tpu.utils import synthetic as js
from apse_uav_torch.utils import synthetic as ts

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
W, H = 480, 270


@pytest.fixture(scope="module")
def cam():
    """The real camera scaled to 480x270."""
    mtx, dist = jcam.load_camera_params(os.path.join(REPO, "data", "cam_params.json"))
    ms = mtx.copy()
    ms[0] *= W / 3840.0
    ms[1] *= H / 2160.0
    return ms, dist


def _operating_point(mod, yaw):
    """tests/test_aruco_operating_point.py's four vehicles, host LEDs 0b10110010."""
    return [mod.MarkerSpec(4, (0.5, -2.0), yaw_deg=yaw + 4.0, leds=0b10110010),
            mod.MarkerSpec(1, (7.5, 3.0), yaw_deg=yaw - 12.0),
            mod.MarkerSpec(2, (-9.0, 2.0), yaw_deg=yaw + 30.0),
            mod.MarkerSpec(3, (4.0, -6.5), yaw_deg=yaw + 75.0)]


def _bench(mod, i):
    """bench.py's scene i (host LEDs 0b1010)."""
    return [mod.MarkerSpec(4, (0.5, -2.0), yaw_deg=14.0 + 7 * i, leds=0b1010),
            mod.MarkerSpec(1, (7.5, 3.0), yaw_deg=40.0 + 5 * i),
            mod.MarkerSpec(2, (-9.0, 2.0), yaw_deg=70.0 - 9 * i),
            mod.MarkerSpec(3, (4.0, -6.5), yaw_deg=5.0 + 11 * i)]


@pytest.mark.parametrize("supersample,scenes", [(2, _operating_point), (1, _bench)], ids=["ss2_leds", "ss1_bench"])
def test_scene_renderer_matches_jax(cam, supersample, scenes):
    """The port's ``SceneRenderer`` against JAX's (``cache=False``) at 40 m on
    two frames: the same patch side, and at most 1e-4 of the pixels differ.

    The grids are float32 in both, but XLA contracts the lens fixed point's
    products into fused multiply-adds, so the grids differ in the last bits
    (over half the values; world coordinates by up to 3.4e-3 m, in the far
    corners).  The frames are nevertheless identical at supersample 2
    (measured: 0 pixels); at supersample 1 one pixel of 129,600 (7.7e-6)
    sits on the border of the lens' non-invertible zone, where the
    re-distortion test (``< 1e-3``) passes in one package and not the other,
    and reads asphalt texture against plain asphalt (measured 1.5e-5 of the
    pixels, by 7 levels)."""
    ms, dist = cam
    jr = js.SceneRenderer(ms, dist, (W, H), altitude=40.0, supersample=supersample, cache=False)
    tr = ts.SceneRenderer(ms, dist, (W, H), altitude=40.0, supersample=supersample, cache=False, device="cpu")
    assert tr._PS == jr._PS
    for i, yaw in enumerate((30.0, 75.0)):
        arg = yaw if scenes is _operating_point else i
        for jspec, tspec in zip(scenes(js, arg), scenes(ts, arg)):
            assert tr._world_bbox_slice(tspec) == jr._world_bbox_slice(jspec)
        want = jr.render(scenes(js, arg))
        got = tr.render(scenes(ts, arg))
        assert got.dtype == torch.uint8 and got.shape == (H, W, 3)
        differ = (got.numpy() != want).any(-1)
        assert differ.mean() <= 1e-4, differ.mean()


def test_scene_renderer_blanks_the_non_invertible_zone(cam):
    """The quirk the port reproduces: ``SceneRenderer`` is not
    ``render_scene``.  Pixels with a supersample in the lens' non-invertible
    zone (world coordinates 1e9) are plain asphalt, where ``render_scene``
    keeps its clamped float64 fixed point; elsewhere the float32 grids move a
    pixel's rounded mean by at most 1 level, on at most 1e-4 of the pixels
    (measured: 255 pixels differ in the zone, columns 0-15 of 480, and one
    outside it, by 1 level; 0.20 % of the frame in all)."""
    ms, dist = cam
    tr = ts.SceneRenderer(ms, dist, (W, H), altitude=40.0, supersample=2, cache=False, device="cpu")
    specs = _operating_point(ts, 30.0)
    diff = (tr.render(specs).to(torch.int32) - ts.render_scene(ms, dist, (W, H), specs, device="cpu")).abs()
    diff = diff[..., 0].numpy()
    blank = (tr.xw.numpy() == 1e9).reshape(H, 2, W, 2).any(axis=(1, 3))
    assert blank.any() and (diff[blank] > 0).any()
    assert diff[~blank].max() <= 1 and (diff[~blank] > 0).mean() <= 1e-4
    assert (tr.base.numpy()[tr.xw.numpy() == 1e9] == ts.ASPHALT).all()


def test_scene_renderer_cache_and_device_rule(cam, tmp_path, monkeypatch):
    """``cache=True`` writes the grids once under ``~/.cache/apse_uav_torch``
    and a second renderer reads them back (the same frame); ``device`` is
    cuda unless the caller asks for the CPU."""
    ms, dist = cam
    monkeypatch.setenv("HOME", str(tmp_path))
    specs = _bench(ts, 0)
    first = ts.SceneRenderer(ms, dist, (W, H), supersample=1, device="cpu").render(specs)
    (path,) = (tmp_path / ".cache" / "apse_uav_torch").iterdir()
    assert path.name.startswith("scene_") and path.suffix == ".npz"
    assert torch.equal(ts.SceneRenderer(ms, dist, (W, H), supersample=1, device="cpu").render(specs), first)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ts.SceneRenderer(ms, dist, (W, H), cache=False)


def test_render_scene_matches_jax(cam):
    """The port's float64 ``render_scene`` equals JAX's numpy one bit for bit
    (supersample 2 and 1, cam yaw 0 and 20)."""
    ms, dist = cam
    for ss, cam_yaw in ((2, 0.0), (1, 20.0)):
        want = js.render_scene(ms, dist, (W, H), _operating_point(js, 30.0), altitude=40.0, cam_yaw_deg=cam_yaw,
                               supersample=ss)
        got = ts.render_scene(ms, dist, (W, H), _operating_point(ts, 30.0), altitude=40.0, cam_yaw_deg=cam_yaw,
                              supersample=ss, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_ground_truth_matches_jax(cam):
    """``marker_world_corners`` and ``project_world_to_undistorted`` within
    1e-12 of JAX's on seeded markers (corner order included) and points,
    with and without a camera yaw."""
    ms, _ = cam
    rng = np.random.default_rng(0)
    for _ in range(8):
        xy, yaw = tuple(rng.uniform(-10, 10, 2)), float(rng.uniform(-180, 180))
        want = js.marker_world_corners(js.MarkerSpec(3, xy, yaw_deg=yaw))
        got = ts.marker_world_corners(ts.MarkerSpec(3, xy, yaw_deg=yaw))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    pts = rng.uniform(-12, 12, (16, 2))
    for alt, cam_yaw in ((40.0, 0.0), (25.0, 33.0)):
        np.testing.assert_allclose(ts.project_world_to_undistorted(pts, ms, alt, cam_yaw),
                                   js.project_world_to_undistorted(pts, ms, alt, cam_yaw), rtol=0, atol=1e-12)
