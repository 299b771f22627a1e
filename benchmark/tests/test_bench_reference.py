"""The comparison that decides ``correct``, driven through the cells' own
drivers at a size the CPU holds (``bench_small``): the measured package
against the plain reference comes out correct; the control (the reference
one precision step down in the program's place) and every planted fault a
cell can have come out not correct.

On the CPU the ArUco control (undistortion maps in bfloat16) runs here;
the tracker's control (TF32 on) only means something on the card, so that
test is marked ``cuda`` and skips here.
"""

from __future__ import annotations

import time

import pytest
import torch

from bench_small import run_small


def _values(out) -> dict:
    return {k: v["value"] for k, v in out["checks"].as_dict().items()}


# -- planted faults, one for each that a cell can have -------------------------

def aruco_state_unchanged(pipe):
    """The temporal step returns the carry it was given."""
    step = pipe._step
    pipe._step = lambda carry, f, first, crow: (carry, step(carry, f, first, crow)[1])


def aruco_half_batch(pipe):
    """The front computes the first half of the batch and repeats it."""
    front = pipe.front

    def half(frames):
        h = (frames.shape[0] + 1) // 2
        out = front(frames[:h])
        idx = torch.arange(frames.shape[0], device=frames.device) % h
        return {k: v[idx] for k, v in out.items()}

    pipe.front = half


def aruco_altered(pipe):
    """The corners are moved by half a pixel where the front produces them."""
    front = pipe.front

    def moved(frames):
        out = front(frames)
        return {**out, "corners": out["corners"] + 0.5}

    pipe.front = moved


def tracker_state_unchanged(tracker):
    """The association leaves the track state as it found it."""
    associate = tracker.associate

    def same_state(det, emb):
        state = tracker.state
        recents = associate(det, emb)
        tracker.state = state
        return recents

    tracker.associate = same_state


def tracker_half_batch(tracker):
    """A batch's first half is detected and associated, and repeated."""
    dispatch = tracker.process_frames_async

    def half(frames):
        h = (frames.shape[0] + 1) // 2
        dets, recents = dispatch(frames[:h])
        idx = torch.arange(frames.shape[0], device=frames.device) % h
        return {k: v[idx] for k, v in dets.items()}, {k: v[idx] for k, v in recents.items()}

    tracker.process_frames_async = half


def tracker_altered(tracker):
    """Every detection's box is moved by one pixel where the predictor produces it."""
    post = tracker.predictor.postprocess
    tracker.predictor.postprocess = lambda dets: {**post(dets), "boxes": post(dets)["boxes"] + 1.0}


def tracker_late_altered(seconds: float):
    """From nine tenths of the window on, every snapshot box is moved by one
    pixel: past the range the sample is drawn from before the window, so
    only the window's last batch shows it."""

    def plant(tracker):
        dispatch, reset = tracker.process_frames_async, tracker.reset
        start = {}

        def reset_timed():
            reset()
            start["t"] = time.perf_counter()

        def late(frames):
            dets, recents = dispatch(frames)
            if "t" in start and time.perf_counter() - start["t"] > 0.9 * seconds:
                recents = {**recents, "boxes": recents["boxes"] + 1.0}
            return dets, recents

        tracker.reset, tracker.process_frames_async = reset_timed, late

    return plant


def test_aruco_port_matches_reference():
    out = run_small("aruco-2pass-b8")
    assert out["checks"].correct(), _values(out)
    assert out["notes"]["detected_compared"] > 0
    assert out["compared"] >= 2


def test_aruco_control_fails():
    out = run_small("aruco-2pass-b8", program="control")
    assert not out["checks"].correct(), _values(out)


@pytest.mark.parametrize("fault", [aruco_state_unchanged, aruco_half_batch, aruco_altered])
def test_aruco_faults_fail(fault):
    out = run_small("aruco-2pass-b8", break_program=fault)
    assert not out["checks"].correct(), (fault.__name__, _values(out))


@pytest.mark.parametrize("cell", ["track-r101fpn-b4", "track-r101fpn-b1"])
def test_tracker_port_matches_reference(cell):
    out = run_small(cell)
    assert out["checks"].correct(), _values(out)
    assert out["notes"]["valid_detections_compared"] > 0 and out["notes"]["tracks_compared"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("track-r101fpn-b4", tracker_state_unchanged), ("track-r101fpn-b4", tracker_half_batch),
    ("track-r101fpn-b4", tracker_altered), ("track-r101fpn-b1", tracker_state_unchanged),
    ("track-r101fpn-b1", tracker_altered),
])
def test_tracker_faults_fail(cell, fault):
    out = run_small(cell, break_program=fault)
    assert not out["checks"].correct(), (fault.__name__, _values(out))


def test_tracker_late_fault_fails():
    """The last batch of the window is always compared, however many the
    window held beyond the sample's range."""
    out = run_small("track-r101fpn-b4", seconds=3.0, break_program=tracker_late_altered(3.0))
    assert not out["checks"].correct(), _values(out)
    assert out["notes"]["sample"][-1] == out["attempted"] // 2 - 1


@pytest.mark.cuda
def test_tracker_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("the tracker's control is TF32, which only the card has")
    import bench_small

    cell, cfg, tr = bench_small.small_cell("track-r101fpn-b4")
    import time

    from benchkit.context import RunContext

    ctx = RunContext(cfg, tr, 2 ** 33 + 5, 1.0, False, torch.device("cuda", 0), time.perf_counter(), "control")
    out = cell.driver.run(ctx)
    assert not out["checks"].correct(), _values(out)


@pytest.mark.parametrize("cell,host_metrics", [
    ("aruco-2pass-b8", {"aruco.front_ms", "aruco.scan_ms"}),
    ("track-r101fpn-b4", {"track.upload_ms", "track.backbone_ms", "track.heads_ms", "track.assoc_ms", "track.mfu"}),
])
def test_traced_run_reads_its_per_layer_metrics(cell, host_metrics):
    """A traced run through run.py's result line: the host-clock readings are
    there and positive; the device-trace ones are left out on the CPU (no
    kernels to read), never reported as 0."""
    import run
    from bench_small import small_cell

    out = run_small(cell, trace=True)
    line = run.result_line(small_cell(cell)[0], out, {"platform": "cpu"}, True)
    assert line["correct"] and list(line)[-1] == "checks"
    assert host_metrics <= set(line["metrics"]) and all(v["value"] > 0 for v in line["metrics"].values())
    assert line["device"]["window_s"] > 0 and set(line["breakdown"]) == {"device_ops", "idle_gaps"}
