"""PyTorch port, core layer: package boundary, device rule, camera, rotation,
colorspace and dictionary against the JAX package on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apse_uav_tpu.aruco import dictionary as jdict
from apse_uav_tpu.aruco.detector import DetectorParams as JDetectorParams
from apse_uav_tpu.aruco.pipeline import ArucoPipelineConfig as JConfig
from apse_uav_tpu.core import camera as jcam, colorspace as jcs, rotation as jrot
from apse_uav_torch import convert
from apse_uav_torch.aruco import dictionary as tdict
from apse_uav_torch.core import camera as tcam, colorspace as tcs, rotation as trot
from apse_uav_torch.device import resolve_device

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(scope="module")
def cam():
    return jcam.load_camera_params(os.path.join(REPO, "data", "cam_params.json"))


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter (conftest imports JAX here), importing every
    module of the port (a walk of the package) leaves jax and the JAX package
    out of sys.modules, and the libraries the card machine lacks (cv2, PIL,
    matplotlib, orbax) too: those are imported only inside the functions that
    read or write images, videos or plots.  No port source names the JAX
    package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import apse_uav_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(apse_uav_torch.__path__, 'apse_uav_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "need = {'apse_uav_torch.cli.tracker_test', 'apse_uav_torch.cli.detector_test', 'apse_uav_torch.dcnn.flax_init',\n"
        "        'apse_uav_torch.evaluation.rle', 'apse_uav_torch.evaluation.mots', 'apse_uav_torch.train.checkpoint',\n"
        "        'apse_uav_torch.evaluation.mots_export', 'apse_uav_torch.cli.mots_vis', 'apse_uav_torch.cli.mots_eval',\n"
        "        'apse_uav_torch.cli.images_to_txt', 'apse_uav_torch.cli.aerial_view_test', 'apse_uav_torch.cli.track_uav',\n"
        "        'apse_uav_torch.utils.videowriter', 'apse_uav_torch.aruco.pipeline', 'apse_uav_torch.dcnn.engines',\n"
        "        'apse_uav_torch.dcnn.losses', 'apse_uav_torch.data.mot', 'apse_uav_torch.data.datasets',\n"
        "        'apse_uav_torch.data.loader', 'apse_uav_torch.train.optim', 'apse_uav_torch.train.steps',\n"
        "        'apse_uav_torch.train.loop', 'apse_uav_torch.evaluation.coco_eval', 'apse_uav_torch.cli.finetune_uav',\n"
        "        'apse_uav_torch.cli.train_association_head', 'apse_uav_torch.cli.association_head_test',\n"
        "        'apse_uav_torch.dcnn.models.c4', 'apse_uav_torch.data.cowc', 'apse_uav_torch.utils.profiling',\n"
        "        'apse_uav_torch.parallel.mesh', 'apse_uav_torch.parallel.dp', 'apse_uav_torch.cli.add_mask_head',\n"
        "        'apse_uav_torch.cli.create_coco_annotations', 'apse_uav_torch.cli.finetune_coco_dataset',\n"
        "        'apse_uav_torch.cli.finetune_faster_rcnn_aerial', 'apse_uav_torch.cli.finetune_segmentation'}\n"
        "assert need <= set(mods), need - set(mods)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'apse_uav_tpu'))]\n"
        "assert not bad, bad\n"
        "lazy = [m for m in sys.modules if m.split('.')[0] in ('cv2', 'PIL', 'matplotlib', 'orbax')]\n"
        "assert not lazy, lazy\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    named = []
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "apse_uav_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith((".py", ".cu"))]
    for path in paths:
        with open(path) as f:
            if "apse_uav_tpu" in f.read():
                named.append(os.path.relpath(path, REPO))
    assert not named, named


def test_cuda_request_raises_instead_of_falling_back(cam):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-fallback rule is exercised on the CPU-only host")
    from apse_uav_torch.aruco.detector import ArucoDetector
    from apse_uav_torch.aruco.pipeline import ArucoPipeline, ArucoPipelineConfig, init_carry
    from apse_uav_torch.cli.aruco_detect import main
    from apse_uav_torch.preproc.remap import Preprocessor
    from apse_uav_torch.utils.synthetic import render_scene

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ArucoPipeline(*cam, (960, 544))  # the default device is cuda
    with pytest.raises(RuntimeError, match="cuda"):
        ArucoPipeline(*cam, (960, 544), ArucoPipelineConfig(two_pass=False))
    with pytest.raises(RuntimeError, match="cuda"):
        ArucoDetector()
    with pytest.raises(RuntimeError, match="cuda"):
        Preprocessor(*cam, (960, 544))
    with pytest.raises(RuntimeError, match="cuda"):
        render_scene(*cam, (32, 16), [])
    with pytest.raises(RuntimeError, match="cuda"):
        init_carry(ArucoPipelineConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--path_camera_params", os.path.join(REPO, "data", "cam_params.json"), "--use_images",
              "--path_input_images", REPO])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_rotation_matches_jax():
    """f32 on both sides; 2e-6 absolute (a few ulps of the unit-scale
    matrices: the two libraries' sin/cos/acos differ in the last bit)."""
    rng = np.random.default_rng(0)
    rv = (rng.normal(size=(64, 3)) * rng.choice([1e-8, 0.3, 1.5, 3.1], size=(64, 1))).astype(np.float32)
    rm_j = np.asarray(jax.jit(jax.vmap(jrot.rodrigues_to_matrix))(jnp.asarray(rv)))
    rm_t = trot.rodrigues_to_matrix(torch.from_numpy(rv)).numpy()
    np.testing.assert_allclose(rm_t, rm_j, atol=2e-6)
    back_j = np.asarray(jax.jit(jax.vmap(jrot.matrix_to_rodrigues))(jnp.asarray(rm_j)))
    back_t = trot.matrix_to_rodrigues(torch.from_numpy(rm_j)).numpy()
    np.testing.assert_allclose(back_t, back_j, atol=2e-5)
    eul_j = np.asarray(jax.jit(jax.vmap(jrot.matrix_to_euler_zxy))(jnp.asarray(rm_j)))
    eul_t = trot.matrix_to_euler_zxy(torch.from_numpy(rm_j)).numpy()
    np.testing.assert_allclose(eul_t, eul_j, atol=2e-3)  # degrees


def test_camera_matches_jax(cam):
    """The undistort map must agree within 1e-3 px (the kernels sample it);
    point functions within f32 rounding of their magnitudes."""
    mtx, dist = cam
    w, h = 960, 544
    ms = mtx * np.array([[w / 3840, 1, w / 3840], [1, h / 2160, h / 2160], [1, 1, 1]])
    m_j = np.asarray(jcam.undistort_rectify_map(jnp.asarray(ms, jnp.float32), jnp.asarray(dist, jnp.float32), (w, h)))
    m_t = tcam.undistort_rectify_map(torch.tensor(ms, dtype=torch.float32), tcam.pad_dist_coeffs(dist), (w, h))
    assert np.abs(m_t.numpy() - m_j).max() < 1e-3

    rng = np.random.default_rng(1)
    d14 = np.asarray(jcam.pad_dist_coeffs(jnp.asarray(dist, jnp.float32)))
    xy = (rng.random((256, 2)) * 0.6 - 0.3).astype(np.float32)
    np.testing.assert_allclose(tcam.distort_normalized(torch.from_numpy(xy), torch.from_numpy(d14)).numpy(),
                               np.asarray(jcam.distort_normalized(jnp.asarray(xy), jnp.asarray(d14))), atol=2e-6)
    np.testing.assert_allclose(tcam.undistort_normalized(torch.from_numpy(xy), torch.from_numpy(d14)).numpy(),
                               np.asarray(jcam.undistort_normalized(jnp.asarray(xy), jnp.asarray(d14))), atol=2e-5)
    obj = (rng.random((8, 3)) - 0.5).astype(np.float32)
    obj[:, 2] = 0
    rvec = np.array([0.1, -0.2, 0.05], np.float32)
    tvec = np.array([0.3, -0.2, 12.0], np.float32)
    pj = np.asarray(jcam.project_points(jnp.asarray(obj), jnp.asarray(rvec), jnp.asarray(tvec),
                                        jnp.asarray(ms, jnp.float32), jnp.asarray(dist, jnp.float32)))
    pt = tcam.project_points(torch.from_numpy(obj), torch.from_numpy(rvec), torch.from_numpy(tvec),
                             torch.tensor(ms, dtype=torch.float32), tcam.pad_dist_coeffs(dist)).numpy()
    np.testing.assert_allclose(pt, pj, atol=1e-3)  # pixels

    tilted = np.concatenate([d14[:12], [0.01, -0.02]]).astype(np.float32)
    np.testing.assert_allclose(
        tcam.distort_normalized(torch.from_numpy(xy), torch.from_numpy(tilted)).numpy(),
        np.asarray(jcam.distort_normalized(jnp.asarray(xy), jnp.asarray(tilted))), atol=2e-6)
    np.testing.assert_allclose(
        tcam.undistort_normalized(torch.from_numpy(xy), torch.from_numpy(tilted)).numpy(),
        np.asarray(jcam.undistort_normalized(jnp.asarray(xy), jnp.asarray(tilted))), atol=2e-5)


def test_colorspace_gamma_gray_matches_jax():
    """LAB gamma + BGR2GRAY on 2^16 seeded colours.

    Not bit-identical everywhere: XLA's f32 pow/cbrt on the CPU are
    few-ulp approximations and XLA contracts a*b + c into FMAs, so rare
    colours land one u8 LAB step apart before the gamma LUT, which the LUT
    amplifies to up to 4 gray levels.  Census over all 2^24 colours: 270
    gray values differ (1.6e-5).  Pinned here: at most 4 of the 2^16 seeded
    colours differ, by at most 4 levels; everything else is bit-identical.
    """
    colours = np.random.default_rng(0).integers(0, 256, size=(1 << 16, 3)).astype(np.uint8)
    out_j = jcs.gamma_correct_u8(jnp.asarray(colours))
    gray_j = np.asarray(jcs.bgr_to_gray_u8(out_j)).astype(int)
    out_t = tcs.gamma_correct_u8(torch.from_numpy(colours))
    gray_t = tcs.bgr_to_gray_u8(out_t).numpy().astype(int)
    diff = np.abs(gray_t - gray_j)
    assert (diff > 0).sum() <= 4 and diff.max() <= 4, ((diff > 0).sum(), diff.max())
    # bgr_to_gray alone is integer arithmetic: identical.
    assert np.array_equal(tcs.bgr_to_gray_u8(torch.from_numpy(colours)).numpy(),
                          np.asarray(jcs.bgr_to_gray_u8(jnp.asarray(colours))))


def test_dictionary_matches_jax():
    assert np.array_equal(tdict.DICT_4X4_50, np.asarray(jdict.DICT_4X4_50, np.int64))
    rng = np.random.default_rng(2)
    codes = np.concatenate([jdict.DICT_4X4_50.astype(np.int64), rng.integers(0, 1 << 16, 500)])
    flips = np.where(rng.random(codes.size) < 0.5, 1 << rng.integers(0, 16, codes.size), 0)
    codes = codes ^ flips
    for rate in (2.0, 0.0):
        want = [np.asarray(x) for x in jdict.match_dictionary(jnp.asarray(codes, jnp.uint32), rate)]
        got = [x.numpy() for x in tdict.match_dictionary(torch.from_numpy(codes), rate)]
        for g, w_ in zip(got, want):
            assert np.array_equal(g, w_)
    for i in (0, 7, 49):
        assert np.array_equal(tdict.marker_image(i, 3), jdict.marker_image(i, 3))


@pytest.mark.parametrize("use_centroid_data", [False, True], ids=["aruco", "dcnn"])
def test_csv_io_copy_matches_jax(tmp_path, use_centroid_data):
    """The port's own copy of csv_io writes the same bytes and reads the
    same centroid rows as the JAX package's."""
    from apse_uav_tpu.utils import csv_io as jcsv
    from apse_uav_torch.utils import csv_io as tcsv

    rng = np.random.default_rng(5)
    frames = [{"detected": rng.integers(0, 2, 4), "marker_length": rng.random(), "leds": rng.integers(0, 256),
               "altitude": 40 * rng.random(), "fov_w": 90 * rng.random(), "fov_h": 50 * rng.random(),
               **{k: 20 * rng.random(3) for k in ("dist_aruco", "dist_aruco_bbox", "dist_dcnn", "dist_dcnn_bbox")}}
              for _ in range(6)]
    for mod, name in ((jcsv, "jax.csv"), (tcsv, "port.csv")):
        with mod.ResultsWriter(str(tmp_path / name), use_centroid_data) as w:
            for k, out in enumerate(frames):
                w.write_frame(k + 1, out)
    assert (tmp_path / "jax.csv").read_bytes() == (tmp_path / "port.csv").read_bytes()
    path = os.path.join(REPO, "data", "static_dcnn_data.csv")
    assert np.array_equal(tcsv.read_centroid_data(path), jcsv.read_centroid_data(path))


def test_convert_configs_and_camera_from_jax(cam):
    mtx_t, dist_t = convert.camera_tensors(*cam, device="cpu")
    assert mtx_t.dtype == dist_t.dtype == torch.float32
    assert np.array_equal(mtx_t.numpy(), cam[0].astype(np.float32))
    assert np.array_equal(dist_t.numpy(), np.asarray(jcam.pad_dist_coeffs(jnp.asarray(cam[1], jnp.float32))))
    dp = convert.detector_params(dataclasses.asdict(JDetectorParams(per_scale_k=5)))
    assert dp.per_scale_k == 5 and dp.scales == JDetectorParams().scales
    cfg = convert.pipeline_config(dataclasses.asdict(JConfig(n_avg=3, leds_threshold=200.0, led_bias_px=(0.4, 0.5))))
    assert (cfg.n_avg, cfg.leds_threshold, cfg.led_bias_px, cfg.two_pass) == (3, 200.0, (0.4, 0.5), True)
    dec = convert.detector_params(dataclasses.asdict(JDetectorParams(decimate=True, pallas_proposals=True)))
    assert dec.decimate and dataclasses.asdict(dec) == {
        k: v for k, v in dataclasses.asdict(JDetectorParams(decimate=True)).items()
        if k not in ("pallas_proposals", "pallas_interpret", "pallas_labeling")}
    with pytest.raises(ValueError, match="no field"):
        convert.pipeline_config({**dataclasses.asdict(JConfig()), "new_option": 1})


def _threads_in_a_worker(workers, libraries: bool = False):
    """A fresh interpreter that imports numpy (as jaxtyping's pytest plugin
    does), then runs the root conftest.py as an xdist worker of ``workers``
    (None: no xdist): the variables the conftest changed and a child
    process's OMP_NUM_THREADS; with ``libraries``, then torch's and cv2's
    threads and each BLAS and OpenMP pool's."""
    code = (
        "import json, os, runpy, subprocess, sys\n"
        "import numpy\n"
        "before = dict(os.environ)\n"
        "runpy.run_path(os.path.join(sys.argv[1], 'conftest.py'))\n"
        "got = {'changed': {k: os.environ.get(k) for k in {*before, *os.environ} if before.get(k) != os.environ.get(k)}}\n"
        "got['changed'].pop('KMP_DUPLICATE_LIB_OK', None)  # set by threadpoolctl's import\n"
        "got['child'] = subprocess.run([sys.executable, '-c', 'import os; print(os.environ.get(\"OMP_NUM_THREADS\"))'],\n"
        "                              capture_output=True, text=True, check=True).stdout.strip()\n"
        "if sys.argv[2] == 'True':\n"
        "    import cv2, torch\n"
        "    from threadpoolctl import threadpool_info\n"
        "    got.update(torch=torch.get_num_threads(), cv2=cv2.getNumThreads(),\n"
        "               pools=sorted({p['num_threads'] for p in threadpool_info()}))\n"
        "print(json.dumps(got))\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "OPENCV_FOR_THREADS_NUM") and not k.startswith("PYTEST_XDIST")}
    if workers:
        env["PYTEST_XDIST_WORKER_COUNT"] = str(workers)
    res = subprocess.run([sys.executable, "-c", code, REPO, str(libraries)], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout)


def test_xdist_workers_share_the_cores():
    """Under xdist each worker's torch, BLAS, OpenMP and OpenCV pools and its
    child processes get max(1, cores // workers) threads, set once by the
    root conftest.py; without xdist it leaves the environment as it was."""
    if "PYTEST_XDIST_WORKER_COUNT" in os.environ:  # this run: whatever budget it set, every pool took it
        budget = int(os.environ["OMP_NUM_THREADS"])
        child = subprocess.run([sys.executable, "-c", "import os; print(os.environ['OMP_NUM_THREADS'])"],
                               capture_output=True, text=True, check=True).stdout.strip()
        assert torch.get_num_threads() == budget and child == str(budget)
    cores = len(os.sched_getaffinity(0))
    budget = max(1, cores // 6)
    want = {"changed": {"OMP_NUM_THREADS": str(budget), "OPENCV_FOR_THREADS_NUM": str(budget)}, "child": str(budget)}
    assert _threads_in_a_worker(6, libraries=True) == {**want, "torch": budget, "cv2": budget, "pools": [budget]}
    assert _threads_in_a_worker(cores + 1) == {"changed": {"OMP_NUM_THREADS": "1", "OPENCV_FOR_THREADS_NUM": "1"},
                                               "child": "1"}
    assert _threads_in_a_worker(None) == {"changed": {}, "child": "None"}
