"""PyTorch port, frame and data parallelism and the profiling utilities on
the CPU: ``sharded_inference_fn`` and ``shard_map_batch`` over a mesh of two
CPU devices against the unsharded run, the data-parallel detector step over
two gloo processes against one process on the same batch (as
``tests/test_parallel.py`` holds JAX's mesh step against one device), the
dry run, ``StageTimer``, ``benchmark`` and ``trace``.

Inputs are made with numpy from fixed seeds; tolerances are stated per test.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from apse_uav_torch.dcnn import flax_init
from apse_uav_torch.dcnn.config import mask_rcnn_r50_fpn
from apse_uav_torch.parallel import dp, mesh
from apse_uav_torch.train import optim
from apse_uav_torch.utils import profiling

CPU2 = [torch.device("cpu"), torch.device("cpu")]


def test_sharded_inference_and_shard_map_match_unsharded():
    """A replica per device of ``tanh(x @ w)`` and of the ArUco front over
    a [cpu, cpu] mesh: chunks of the leading axis, concatenated in order,
    equal to the unsharded run (the same ops on the same rows); a batch that
    is not a multiple of the mesh raises."""
    from apse_uav_torch.aruco.pipeline import ArucoPipeline
    from apse_uav_torch.core import camera

    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    x = rng.normal(size=(16, 4)).astype(np.float32)
    run = mesh.sharded_inference_fn(lambda p, xs: {"y": torch.tanh(xs @ p)}, [w, w], CPU2)
    np.testing.assert_array_equal(run(x)["y"].numpy(), torch.tanh(torch.from_numpy(x) @ w).numpy())
    with pytest.raises(ValueError, match="multiple"):
        run(x[:5])

    mtx, dist = camera.load_camera_params(os.path.join(os.path.dirname(__file__), "..", "data", "cam_params.json"))
    mtx = np.array(mtx, np.float64)
    mtx[0] *= 256 / 3840.0
    mtx[1] *= 128 / 2160.0
    pipe = ArucoPipeline(mtx, dist, (256, 128), device="cpu")
    frames = torch.from_numpy(rng.integers(0, 255, (4, 3, 128, 256), np.uint8))
    front = mesh.shard_map_batch(CPU2, lambda fr: pipe.front(fr)["msp"])
    got = front(frames)
    assert got.shape[0] == 4
    torch.testing.assert_close(got, pipe.front(frames)["msp"], rtol=0, atol=0)


def test_shard_batch_places_chunks_and_data_mesh_rule():
    """``shard_batch`` gives each device its chunk of every leaf;
    ``data_mesh`` lists the visible cards and raises where there is none."""
    tree = {"a": np.arange(8 * 2, dtype=np.float32).reshape(8, 2), "b": (torch.arange(8),)}
    parts = mesh.shard_batch(CPU2, tree)
    assert len(parts) == 2
    np.testing.assert_array_equal(parts[1]["a"].numpy(), tree["a"][4:])
    assert parts[0]["b"][0].tolist() == [0, 1, 2, 3]
    if torch.cuda.is_available():
        assert len(mesh.data_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.data_mesh()


def _dp_job():
    """The JAX DP test's step (``tests/test_parallel.py:66``): depth 26, 32
    FPN channels, 3 classes, 8 images of 32x32 with two GT boxes each."""
    cfg = mask_rcnn_r50_fpn(num_classes=3)
    cfg = dataclasses.replace(
        cfg, depth=26, fpn_channels=32,
        rpn=dataclasses.replace(cfg.rpn, pre_nms_topk_train=64, post_nms_topk_train=32, pre_nms_topk_test=64,
                                post_nms_topk_test=32, batch_size_per_image=16),
        roi=dataclasses.replace(cfg.roi, num_classes=3, detections_per_image=8, batch_size_per_image=16,
                                box_fc_dim=64, mask_conv_dim=16))
    b, h, w, g = 8, 32, 32, 2
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    gt = {"boxes": np.stack([[[4.0 + i, 5.0, 20.0 + i % 3, 24.0], [10.0, 2.0 + i, 28.0, 18.0]]
                             for i in range(b)]).astype(np.float32),
          "classes": rng.integers(0, 3, (b, g)).astype(np.int32), "valid": np.ones((b, g), bool),
          "masks": (rng.uniform(size=(b, g, h, w)) > 0.5).astype(np.float32)}
    return dp.DPJob(cfg, flax_init.mask_rcnn_init(cfg, 0), images, gt, flax_init.prng_key(1))


def test_dp_step_over_two_gloo_ranks_matches_one_process():
    """The data-parallel step over 2 gloo processes (4 images each, the
    gradients all-reduce-averaged) equals one process's step on the 8
    images: the losses and the updated parameters within rtol 5e-4, atol
    1e-5 (the bound ``tests/test_parallel.py`` holds JAX's mesh step to);
    every trained tensor moved, the frozen ones untouched."""
    job = _dp_job()
    losses, state = dp.run_group(2, job)
    want, want_state = dp.plain_step(job, "cpu")
    assert set(losses) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(losses[k], v, rtol=5e-4, atol=1e-5, err_msg=k)
    trained = {k for k, lab in optim.param_labels(list(want_state), job.to_train).items() if lab == "train"}
    for k, v in want_state.items():
        np.testing.assert_allclose(state[k], v, rtol=5e-4, atol=1e-5, err_msg=k)
        moved = not np.array_equal(state[k], np.asarray(job.init[k]))
        assert moved == (k in trained), k


def test_dryrun_multichip_on_two_gloo_processes():
    """``dryrun_multichip(2)``: the reference dry run's step over two gloo
    processes returns rank 0's losses, every one finite."""
    losses = dp.dryrun_multichip(2)
    assert set(losses) == {"loss_rpn_loc", "loss_rpn_cls", "loss_cls", "loss_box_reg", "loss_mask", "loss_total"}
    assert all(np.isfinite(v) for v in losses.values())


def test_stage_timer_benchmark_and_trace(tmp_path):
    """``StageTimer`` counts and sums its stages (``timed`` and ``stage``),
    ``benchmark`` chains the seed serially through ``iters`` calls, and
    ``trace`` writes a Chrome trace that names the traced op."""
    timer = profiling.StageTimer()
    f = timer.timed("square", lambda x: x * x)
    f(torch.ones(4, 4))
    f(torch.ones(4, 4))
    ref = [None]
    with timer.stage("add", ref):
        ref[0] = torch.ones(3) + 1
    assert timer.counts == {"square": 2, "add": 1}
    assert "square" in timer.summary() and timer.totals["square"] > 0

    seeds = []

    def g(x, seed):
        seeds.append(int(seed))
        return (x + seed).sum()[None]

    assert profiling.benchmark(g, torch.ones(8), iters=3, warmup=1) > 0
    assert seeds == [1, 17, 145, 165]  # (8 * (1 + s)) % 251 + 1, chained
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    assert any("mm" in e.key for e in prof.key_averages())
    assert "aten::mm" in (tmp_path / "trace" / "trace.json").read_text()


def test_frame_sharding_check_on_cpu():
    """``chip_smoke.sharding_check`` (its ``parallel`` phase and its
    ``--all-cards`` run) on CPU devices: over [cpu, cpu] (the small R50-FPN,
    4 frames) it gives device 0's detections chunk by chunk (its
    data-parallel check is ``run_group`` + ``plain_step``, tested above)."""
    import importlib.util

    from torch_parity import E2E_HW, e2e_frames, port_config, tiny_dcnn_config

    from apse_uav_torch.utils.synthetic import detectron2_checkpoint

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    res = chip_smoke.sharding_check(CPU2, port_config(tiny_dcnn_config(num_classes=2)),
                                    detectron2_checkpoint(0, 50, 2), e2e_frames(4), iters=1)
    assert res["ok"] and res["same_detections"] and res["frames"] == 4 and res["size"] == [E2E_HW[1], E2E_HW[0]]
    assert res["valid_detections"] > 0
