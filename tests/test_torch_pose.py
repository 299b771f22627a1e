"""PyTorch port, planar pose: the unrolled Cholesky and both ambiguity basins
against the JAX package on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apse_uav_tpu.aruco import pose as jpose
from apse_uav_tpu.core import camera as jcam
from apse_uav_torch.aruco import pose as tpose
from apse_uav_torch.core import camera as tcam


@pytest.fixture(scope="module")
def cam():
    mtx, dist = jcam.load_camera_params(os.path.join(os.path.dirname(__file__), "..", "data", "cam_params.json"))
    return mtx.astype(np.float32), dist.astype(np.float32)


def test_solve_spd6_matches_jax_and_keeps_nan():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(16, 6, 6)).astype(np.float32)
    a = m @ np.swapaxes(m, 1, 2) + 0.1 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(16, 6)).astype(np.float32)
    want = np.asarray(jax.vmap(jpose._solve_spd6)(jnp.asarray(a), jnp.asarray(b)))
    got = tpose._solve_spd6(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    singular = np.zeros((1, 6, 6), np.float32)
    assert not np.isfinite(tpose._solve_spd6(torch.from_numpy(singular), torch.ones(1, 6)).numpy()).all()


def test_pose_two_basins_match_jax(cam):
    """Markers projected from known poses at 8-40 m plus 0.05 px corner
    noise.  Tolerance: 1e-3 relative on tvec and 1e-3 rad on rvec -- the
    Gauss-Newton fixed point in float32 (6 steps) is reached on both sides,
    so the packages differ by the conditioning of the normal equations
    times f32 rounding, not by iterations."""
    mtx, dist = cam
    rng = np.random.default_rng(3)
    n = 24
    obj = np.asarray(jpose.marker_object_points(1.0))
    corners = []
    for _ in range(n):
        rvec = np.r_[rng.normal(scale=0.15, size=2), rng.uniform(-np.pi, np.pi)].astype(np.float32)
        tvec = np.r_[rng.uniform(-4, 4, size=2), rng.uniform(8, 40)].astype(np.float32) / 0.55
        pts = np.asarray(jcam.project_points(jnp.asarray(obj), jnp.asarray(rvec), jnp.asarray(tvec),
                                             jnp.asarray(mtx), jnp.asarray(dist)))
        corners.append(pts + rng.normal(scale=0.05, size=pts.shape))
    corners = np.stack(corners).astype(np.float32)
    want = [np.asarray(x) for x in jpose.estimate_pose_single_markers_two(jnp.asarray(corners), 1.0,
                                                                          jnp.asarray(mtx), jnp.asarray(dist))]
    got = [x.numpy() for x in tpose.estimate_pose_single_markers_two(
        torch.from_numpy(corners), 1.0, torch.from_numpy(mtx), tcam.pad_dist_coeffs(dist))]
    rv, tv, rv2, tv2, err, err2, swapped = got
    np.testing.assert_allclose(tv, want[1], rtol=1e-3)
    np.testing.assert_allclose(rv, want[0], atol=1e-3)
    # The second basin is flat-ish and poorly conditioned in rotation.
    np.testing.assert_allclose(tv2, want[3], rtol=1e-3)
    np.testing.assert_allclose(rv2, want[2], atol=5e-3)
    assert np.array_equal(swapped, want[6])
    assert np.isfinite(err).all()
    np.testing.assert_allclose(err, want[4], rtol=0.05, atol=1e-3)



def test_pipeline_pose_constants_match_the_eager_pose(cam):
    """``ArucoPipeline``'s pose, with the object points, the mirror and the
    source square's inverse made once by the pipeline, against
    ``estimate_pose_single_markers_two`` called alone (which copies them from
    the host and checks ``inv``'s error flag): every output bit for bit, on 2
    frames of 5 detection slots (an id seen twice, one absent, a crossed quad
    that takes the mirror).  The pipeline's path counts no pose sync, also on its
    second call; the eager one counts each of its three."""
    from apse_uav_torch.aruco import geometry as geo
    from apse_uav_torch.aruco.pipeline import ArucoPipeline, _slot_by_id
    from apse_uav_torch.utils import profiling

    w, h = 960, 544
    mtx = cam[0] * np.array([[w / 3840, 1, w / 3840], [1, h / 2160, h / 2160], [1, 1, 1]], np.float32)
    pipe = ArucoPipeline(mtx, cam[1], (w, h), device="cpu")
    rng = np.random.default_rng(11)
    obj = tpose.object_points(1.0)
    corners = torch.zeros((2, 5, 4, 2))
    for b in range(2):
        for k in range(5):
            rvec = torch.tensor([*rng.normal(scale=0.3, size=2), rng.uniform(-np.pi, np.pi)], dtype=torch.float32)
            tvec = torch.tensor([*rng.uniform(-2, 2, size=2), rng.uniform(4, 12)], dtype=torch.float32)
            corners[b, k] = tcam.project_points(obj, rvec, tvec, pipe.mtx, pipe.dist) + torch.from_numpy(
                rng.normal(scale=0.05, size=(4, 2)).astype(np.float32))
    corners[1, 4] = corners[1, 4, [0, 1, 3, 2]]  # crossed: its homography puts the plane behind the camera
    ids = torch.tensor([[4, 1, 2, 1, 9], [3, -1, 4, 2, 1]])
    profiling.reset_counters()
    for _ in range(2):
        got = pipe._front_from_detections(None, corners, ids)
    assert not {"pose_points", "pose_inverse", "pose_mirror"} & set(profiling.counted("sync"))
    present, slot = _slot_by_id(ids, corners)
    two = tpose.estimate_pose_single_markers_two(slot, 1.0, pipe.mtx, pipe.dist, tilt=pipe.tilt)
    cx, cy, msp = geo.marker_center_and_size(slot)
    want = dict(zip(["rvec", "utvec", "rvec2", "utvec2", "perr", "perr2", "pswap"], two),
                present=present, corners=slot, cx=cx, cy=cy, msp=torch.clamp(msp, min=1e-6), gray=None)
    assert profiling.counted("sync") == dict.fromkeys(("pose_points", "pose_inverse", "pose_mirror"), 1)
    assert got.keys() == want.keys() and got["present"].sum() == 7
    for k, v in want.items():
        assert v is None and got[k] is None or got[k].dtype == v.dtype and torch.equal(got[k], v), k
