"""PyTorch port, the tracker's upload on the CPU: ``track_uav.UploadRing``
with pinning off (its slots in turn, a short batch as a view of its slot, a
new allocation only for a new frame shape or dtype), and ``track_frames``
with a CPU tracker, which stacks each batch as before and uses no ring.

The ring's copies to the card, its events and the tracker's card path are
held to a plain ``.to(device)`` upload in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from apse_uav_torch.cli.track_uav import UploadRing, track_frames
from apse_uav_torch.utils import profiling


def _frames(n, seed, shape=(6, 10, 3), dtype=np.uint8):
    return list(np.random.default_rng(seed).integers(0, 255, (n, *shape)).astype(dtype))


def test_upload_ring_turns_through_its_slots():
    """Three batches of three distinct frames: slots 0, 1, 0, the third
    batch in the first batch's buffer, each batch's rows its frames, and the
    buffers allocated once."""
    ring = UploadRing(3, pin=False)
    got = []
    for seed in range(3):
        frames = _frames(3, seed)
        i, rows = ring.stage(frames)
        np.testing.assert_array_equal(rows.numpy(), np.stack(frames))
        got.append((i, rows.data_ptr(), ring.buffers))
    assert [i for i, _, _ in got] == [0, 1, 0]
    assert got[0][1] == got[2][1] != got[1][1]
    assert got[0][2] is got[1][2] is got[2][2] and len(ring.buffers) == 2
    assert ring.events == [None, None]  # no copy to a card pending


def test_upload_ring_short_batch_is_a_view_of_its_slot():
    """After two full batches, a last batch of 2 frames in slots of 4: slot
    0's first 2 rows, in its memory; the rows after them keep the first
    batch's frames."""
    ring = UploadRing(4, pin=False)
    full = _frames(4, 0)
    ring.stage(full)
    ring.stage(_frames(4, 3))
    short = _frames(2, 1)
    i, rows = ring.stage(short)
    assert i == 0 and rows.shape == (2, 6, 10, 3)
    assert rows.data_ptr() == ring.buffers[0].data_ptr() and rows._base is ring.buffers[0]
    np.testing.assert_array_equal(rows.numpy(), np.stack(short))
    np.testing.assert_array_equal(ring.buffers[0][2:].numpy(), np.stack(full[2:]))


def test_upload_ring_stages_channel_reversed_views():
    """Frames handed over as views with a negative stride (BGR to RGB as
    ``frames[..., ::-1]``, which no tensor can view) stage as their values."""
    ring = UploadRing(2, pin=False)
    frames = _frames(2, 4)
    i, rows = ring.stage([f[..., ::-1] for f in frames])
    assert i == 0
    np.testing.assert_array_equal(rows.numpy(), np.stack(frames)[..., ::-1])


@pytest.mark.parametrize("change", ["none", "shape", "dtype"])
def test_upload_ring_allocates_again_only_for_a_new_frame_shape_or_dtype(change):
    """The same frames keep the buffers; frames of another shape or dtype get
    new ones, of (batch, *frame shape), and go on from slot 1."""
    ring = UploadRing(2, pin=False)
    ring.stage(_frames(2, 0))
    before = ring.buffers
    shape, dtype = {"none": ((6, 10, 3), np.uint8), "shape": ((8, 12, 3), np.uint8),
                    "dtype": ((6, 10, 3), np.float32)}[change]
    frames = _frames(2, 1, shape, dtype)
    i, rows = ring.stage(frames)
    assert (ring.buffers is before) == (change == "none") and i == 1
    assert ring.buffers[0].shape == (2, *shape) and rows.dtype == torch.from_numpy(frames[0]).dtype
    np.testing.assert_array_equal(rows.numpy(), np.stack(frames))


@pytest.mark.parametrize("n", [0, 3])
def test_upload_ring_refuses_a_batch_its_slots_cannot_hold(n):
    with pytest.raises(ValueError, match="slots of 2"):
        UploadRing(2, pin=False).stage(_frames(n, 0))


class _CpuTracker:
    """What ``track_frames`` calls of a tracker, on the CPU: each dispatch
    keeps the frames it was given; the snapshot is their first pixel."""

    device = torch.device("cpu")

    def __init__(self):
        self.given = []

    def process_frames_async(self, x):
        self.given.append(x)
        return x

    def materialize(self, x):
        return {"first": x[:, 0, 0, 0].numpy()}


def test_track_frames_on_cpu_stacks_each_batch_without_the_ring():
    """Five frames in batches of 2 through a CPU tracker: three batches
    (2, 2, 1) of the stacked frames, each counted at ``sync.upload`` and none
    at ``track.upload_pinned``; every frame yielded in order with its
    snapshot."""
    frames = _frames(5, 2)
    tracker = _CpuTracker()
    profiling.reset_counters()
    out = list(track_frames(tracker, None, enumerate(frames), 2))
    assert [x.shape[0] for x in tracker.given] == [2, 2, 1]
    for k, x in enumerate(tracker.given):
        assert x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), np.stack(frames[2 * k:2 * k + 2]))
    assert [i for i, _, _ in out] == [0, 1, 2, 3, 4] and all(f is frames[i] for i, f, _ in out)
    assert [int(s["first"]) for _, _, s in out] == [int(f[0, 0, 0]) for f in frames]
    assert profiling.counters.get("track.upload_pinned", 0) == 0 and profiling.counters["sync.upload"] == 3
