"""Planar PnP pose (solvePnP ITERATIVE equivalent), batched, in PyTorch.

Counterpart of the JAX reference's ``aruco/pose.py``: homography init, a mirrored
init for the second planar-ambiguity basin, damped Gauss-Newton on the pixel
reprojection residual (through the distortion model) for both basins at
once, with the 6x6 normal equations solved by the unrolled Cholesky
:func:`_solve_spd6` (NaN-keeping pivot).  The Jacobian is exact, as the
reference's ``jax.jacfwd``, but reverse-mode (``torch.func.jacrev``):
PyTorch's forward mode promotes the tangent of ``0-d tensor + python float``
to float64, which breaks the float32 matmuls under ``vmap``.

Linearity: rvec(L) = rvec(1), tvec(L) = L * tvec(1), so the pipeline solves
with unit marker length once and scales inside the temporal scan.  A caller
that solves many times (the pipeline) makes pose's constants once
(:func:`object_points`, :data:`MIRROR`, :func:`source_inverse`) and passes
them to :func:`estimate_two`, which then makes no host sync: the same float
operations in the same order as :func:`estimate_pose_single_markers_two`,
which copies them from the host and checks ``inv``'s error flag every call.
"""

from __future__ import annotations

import torch

from apse_uav_torch.core import camera, rotation
from apse_uav_torch.utils import profiling


# The mirror of a rotation's first two columns: the homography's pose of a plane behind the camera.
MIRROR = (-1.0, -1.0, 1.0)


def object_points(marker_length: float, device=None) -> torch.Tensor:
    """OpenCV estimatePoseSingleMarkers object points (y up), (4, 3): a copy from the host."""
    half = marker_length / 2.0
    return torch.tensor([[-half, half, 0.0], [half, half, 0.0], [half, -half, 0.0], [-half, -half, 0.0]],
                        dtype=torch.float32, device=device)


def marker_object_points(marker_length: float, device=None) -> torch.Tensor:
    """:func:`object_points` on the path of a solve, counted as the sync it is on the card."""
    with profiling.sync("pose_points"):  # a copy from the host
        return object_points(marker_length, device)


def _unit_to_quad(q: torch.Tensor) -> torch.Tensor:
    """Projective map of the unit square onto quads (..., 4, 2) -> (..., 3, 3)."""
    x0, y0 = q[..., 0, 0], q[..., 0, 1]
    x1, y1 = q[..., 1, 0], q[..., 1, 1]
    x2, y2 = q[..., 2, 0], q[..., 2, 1]
    x3, y3 = q[..., 3, 0], q[..., 3, 1]
    dx1, dx2, dy1, dy2 = x1 - x2, x3 - x2, y1 - y2, y3 - y2
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12), den)
    g = (sx * dy2 - sy * dx2) / den
    hh = (dx1 * sy - dy1 * sx) / den
    return torch.stack([
        torch.stack([x1 - x0 + g * x1, x3 - x0 + hh * x3, x0], -1),
        torch.stack([y1 - y0 + g * y1, y3 - y0 + hh * y3, y0], -1),
        torch.stack([g, hh, torch.ones_like(g)], -1),
    ], -2)


def source_inverse(obj_xy: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of the map of the unit square onto the object square obj_xy (4, 2), for n markers: (n, 3, 3).
    ``inv_ex`` without its error check: ``linalg.inv``'s result, with no read of the error flag (a host sync on the
    card); the map of a square is never singular."""
    return torch.linalg.inv_ex(_unit_to_quad(obj_xy.expand(n, 4, 2)), check_errors=False)[0]


def _init_pose_planar(obj_xy: torch.Tensor, xy_norm: torch.Tensor, src_inv: torch.Tensor | None = None,
                      mirror: torch.Tensor | None = None):
    """Initial (rvec, tvec) (..., 3) from the homography obj plane -> image; ``src_inv`` and ``mirror`` as
    :func:`source_inverse` and :data:`MIRROR` give them, else made here."""
    if src_inv is None:
        with profiling.sync("pose_inverse"):  # inv reads its error flag back
            src_inv = torch.linalg.inv(_unit_to_quad(obj_xy.expand_as(xy_norm)))
    h_mat = _unit_to_quad(xy_norm) @ src_inv  # the exact 4-point homography via the projective square map
    h_mat = h_mat / torch.linalg.vector_norm(h_mat[..., :, 0], dim=-1)[..., None, None]
    r1, r2 = h_mat[..., :, 0], h_mat[..., :, 1]
    lam = 2.0 / (torch.linalg.vector_norm(r1, dim=-1) + torch.linalg.vector_norm(r2, dim=-1))
    r1 = r1 * lam[..., None]
    r2 = r2 * lam[..., None]
    t = h_mat[..., :, 2] * lam[..., None]
    q1 = r1 / torch.clamp(torch.linalg.vector_norm(r1, dim=-1), min=1e-12)[..., None]
    r2o = r2 - (q1 * r2).sum(-1, keepdim=True) * q1
    q2 = r2o / torch.clamp(torch.linalg.vector_norm(r2o, dim=-1), min=1e-12)[..., None]
    r_mat = torch.stack([q1, q2, torch.linalg.cross(q1, q2, dim=-1)], dim=-1)
    flip = t[..., 2] < 0
    t = torch.where(flip[..., None], -t, t)
    if mirror is None:
        with profiling.sync("pose_mirror"):  # a copy from the host
            mirror = torch.tensor(MIRROR, dtype=r_mat.dtype, device=r_mat.device)
    r_mat = torch.where(flip[..., None, None], r_mat * mirror, r_mat)
    return rotation.matrix_to_rodrigues(r_mat), t


def _solve_spd6(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD systems a (..., 6, 6) x = b (..., 6) by unrolled
    Cholesky; no pivot clamp, so a singular system yields NaN/inf for the
    caller's isfinite guard."""
    n = 6
    low = [[None] * n for _ in range(n)]
    for j in range(n):
        d = a[..., j, j]
        for k in range(j):
            d = d - low[j][k] * low[j][k]
        dj = torch.sqrt(d)
        low[j][j] = dj
        for i in range(j + 1, n):
            s = a[..., i, j]
            for k in range(j):
                s = s - low[i][k] * low[j][k]
            low[i][j] = s / dj
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - low[i][k] * y[k]
        y[i] = s / low[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - low[k][i] * x[k]
        x[i] = s / low[i][i]
    return torch.stack(x, dim=-1)


def _solve_pnp_planar_two(obj_pts: torch.Tensor, img_pts: torch.Tensor, mtx: torch.Tensor, dist14: torch.Tensor,
                          num_iters: int = 6, tilt: bool = False, src_inv: torch.Tensor | None = None,
                          mirror: torch.Tensor | None = None):
    """Both refined planar-ambiguity poses for img_pts (N, 4, 2).

    Returns best (N, 6), other (N, 6), best_err (N,), other_err (N,),
    take_b (N,) -- as the reference's ``_solve_pnp_planar_two``.
    ``src_inv`` (N, 3, 3) and ``mirror`` (3,): see :func:`_init_pose_planar`.
    """
    n = img_pts.shape[0]
    xy_norm = camera.undistort_points(img_pts, mtx, dist14, num_iters=5, tilt=tilt)
    rvec0, tvec0 = _init_pose_planar(obj_pts[:, :2], xy_norm, src_inv, mirror)

    def residual(params, target):
        proj = camera.project_points(obj_pts, params[:3], params[3:], mtx, dist14, tilt=tilt)
        return (proj - target).reshape(-1)

    jac_fn = torch.func.vmap(torch.func.jacrev(residual, argnums=0))

    r_a0 = rotation.rodrigues_to_matrix(rvec0)
    nrm = r_a0[..., :, 2]
    v = tvec0 / torch.clamp(torch.linalg.vector_norm(tvec0, dim=-1), min=1e-9)[..., None]
    n_ref = 2.0 * (nrm * v).sum(-1, keepdim=True) * v - nrm
    axis = torch.linalg.cross(nrm, n_ref, dim=-1)
    s = torch.linalg.vector_norm(axis, dim=-1)
    c = torch.clamp((nrm * n_ref).sum(-1), -1.0, 1.0)
    angle = torch.atan2(s, c)
    axis = axis / torch.clamp(s, min=1e-12)[..., None]
    q = rotation.rodrigues_to_matrix(torch.where((s > 1e-9)[..., None], axis * angle[..., None], torch.zeros_like(axis)))
    rvec_b0 = rotation.matrix_to_rodrigues(q @ r_a0)

    # Both basins refine together: (2N, 6) parameter rows.
    both = torch.cat([torch.cat([rvec0, tvec0], -1), torch.cat([rvec_b0, tvec0], -1)], 0)
    targets = torch.cat([img_pts, img_pts], 0)
    eye6 = torch.eye(6, dtype=both.dtype, device=both.device)
    for _ in range(num_iters):
        r = torch.func.vmap(residual)(both, targets)  # (2N, 8)
        jac = jac_fn(both, targets)  # (2N, 8, 6)
        jtj = jac.transpose(-1, -2) @ jac
        jtr = (jac.transpose(-1, -2) @ r[..., None])[..., 0]
        tr = torch.diagonal(jtj, dim1=-2, dim2=-1).sum(-1)
        damped = jtj + 1e-6 * eye6 * torch.clamp(tr / 6.0, min=1e-6)[..., None, None]
        step = _solve_spd6(damped, jtr)
        step = torch.where(torch.isfinite(step).all(-1, keepdim=True), step, torch.zeros_like(step))
        both = both - step
    params_a, params_b = both[:n], both[n:]
    err = (torch.func.vmap(residual)(both, targets) ** 2).sum(-1)
    err_a, err_b = err[:n], err[n:]

    z_max = 2.0 * mtx[0, 0]

    def sane(params, e):
        return (torch.isfinite(params).all(-1) & torch.isfinite(e) & (params[:, 5] > 0) & (params[:, 5] < z_max))

    sane_a, sane_b = sane(params_a, err_a), sane(params_b, err_b)
    take_b = sane_b & ((err_b < err_a) | ~sane_a)
    best = torch.where(take_b[:, None], params_b, params_a)
    best_err = torch.where(take_b, err_b, err_a)
    init = torch.cat([rvec0, tvec0], -1)
    any_sane = sane_a | sane_b
    best = torch.where(any_sane[:, None], best, init)
    other = torch.where(take_b[:, None], params_a, params_b)
    other_err = torch.where(take_b, err_a, err_b)
    ratio = (torch.linalg.vector_norm(other[:, 3:], dim=-1)
             / torch.clamp(torch.linalg.vector_norm(best[:, 3:], dim=-1), min=1e-9))
    other_ok = sane(other, other_err) & (ratio > 0.5) & (ratio < 2.0) & (other_err < 100.0 * best_err + 1.0)
    other = torch.where(other_ok[:, None], other, best)
    best_err_out = torch.where(any_sane, best_err, torch.full_like(best_err, float("inf")))
    other_err_out = torch.where(other_ok, other_err, best_err_out)
    return best, other, best_err_out, other_err_out, take_b


def solve_pnp_planar(obj_pts: torch.Tensor, img_pts: torch.Tensor, mtx: torch.Tensor, dist: torch.Tensor,
                     num_iters: int = 6, tilt: bool | None = None):
    """Planar PnP for one marker: obj_pts (4, 3), img_pts (4, 2) px ->
    (rvec (3,), tvec (3,)) of the basin with the smaller reprojection error."""
    dist14 = camera.pad_dist_coeffs(dist, device=img_pts.device)
    if tilt is None:
        tilt = camera.has_tilt(dist14)
    best = _solve_pnp_planar_two(obj_pts.to(torch.float32), img_pts.reshape(1, 4, 2).to(torch.float32), mtx, dist14,
                                 num_iters, tilt)[0][0]
    return best[:3], best[3:]


def estimate_pose_single_markers(corners: torch.Tensor, marker_length: float, mtx: torch.Tensor, dist: torch.Tensor,
                                 num_iters: int = 6, tilt: bool | None = None):
    """cv2.aruco.estimatePoseSingleMarkers: corners (..., 4, 2) px (clockwise
    from top-left) -> (rvecs (..., 3), tvecs (..., 3)) of the best basin."""
    return estimate_pose_single_markers_two(corners, marker_length, mtx, dist, num_iters, tilt)[:2]


def estimate_pose_single_markers_two(corners: torch.Tensor, marker_length: float, mtx: torch.Tensor,
                                     dist: torch.Tensor, num_iters: int = 6, tilt: bool | None = None):
    """Both planar-ambiguity basins for corners (..., 4, 2) px:
    (rvec, tvec, rvec_alt, tvec_alt, err, err_alt, swapped), best first."""
    dist14 = camera.pad_dist_coeffs(dist, device=corners.device)
    if tilt is None:
        tilt = camera.has_tilt(dist14)
    return estimate_two(corners, marker_object_points(marker_length, device=corners.device), mtx, dist14, num_iters,
                        tilt)


def estimate_two(corners: torch.Tensor, obj: torch.Tensor, mtx: torch.Tensor, dist14: torch.Tensor,
                 num_iters: int, tilt: bool, src_inv: torch.Tensor | None = None, mirror: torch.Tensor | None = None):
    """:func:`estimate_pose_single_markers_two` from the object points obj (4, 3) and the 14-entry dist; with
    ``src_inv`` (:func:`source_inverse` of obj for the markers' count) and ``mirror`` (:data:`MIRROR` on the
    corners' device), it makes no host sync."""
    lead = corners.shape[:-2]
    best, other, err, err2, swapped = _solve_pnp_planar_two(
        obj, corners.reshape(-1, 4, 2).to(torch.float32), mtx, dist14, num_iters, tilt, src_inv, mirror
    )
    shape = lambda t: t.reshape(*lead, *t.shape[1:])
    return (shape(best[:, :3]), shape(best[:, 3:]), shape(other[:, :3]), shape(other[:, 3:]),
            shape(err), shape(err2), shape(swapped))
