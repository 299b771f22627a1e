"""PyTorch port, checkpoints and the default re-ID head against the JAX package
on the CPU: the last/bestAP/bestAR rules, reference checkpoints (orbax)
converted into the port's format and loaded through ``--checkpoint`` and
``--assoc_weights``, and the default head (the reference's flax init under
``PRNGKey(1)``, reproduced without JAX).

Inputs are made with numpy from fixed seeds and handed to both packages.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import E2E_HW, e2e_frames, jax_mask_rcnn, port_config, tiny_dcnn_config

from apse_uav_tpu.dcnn import engines as jeng
from apse_uav_tpu.dcnn.config import TrackerConfig as JTrackerConfig
from apse_uav_tpu.dcnn.models.association import AssociationHead as JAssociationHead
from apse_uav_tpu.train import checkpoint as jckpt
from apse_uav_torch import convert
from apse_uav_torch.dcnn import engines as teng, flax_init
from apse_uav_torch.dcnn.config import TrackerConfig
from apse_uav_torch.dcnn.models.association import head_weights, init_weights
from apse_uav_torch.train import checkpoint as tckpt
from apse_uav_torch.utils.synthetic import detectron2_checkpoint


def test_checkpoint_manager_rules_match_jax(tmp_path):
    """The same saves through both managers: the same names written each time
    (``last`` always, ``bestAP`` / ``bestAR`` on a new or equal best), the
    same best metrics; the port's files hold the state and resume restores
    the bests; ``append_results_line`` writes the reference's text."""
    jm, tm = jckpt.CheckpointManager(str(tmp_path / "j")), tckpt.CheckpointManager(str(tmp_path / "t"))
    params = {"fc.weight": np.arange(6, dtype=np.float32).reshape(2, 3)}
    for it, (ap, ar) in enumerate([(0.1, 0.5), (0.3, 0.4), (0.3, 0.6), (None, 0.2), (0.2, None)]):
        state = {"params": params, "iteration": it}
        assert tm.save(state, ap=ap, ar=ar) == jm.save({"params": {"w": params["fc.weight"]}, "iteration": it},
                                                       ap=ap, ar=ar), it
        assert (tm.best_ap, tm.best_ar) == (jm.best_ap, jm.best_ar)
    best = tckpt.load_state(str(tmp_path / "t"), "bestAR")
    assert best["iteration"] == 2 and torch.equal(best["params"]["fc.weight"], torch.from_numpy(params["fc.weight"]))
    assert tckpt.load_state(str(tmp_path / "t"), "missing") is None
    again = tckpt.CheckpointManager(str(tmp_path / "t"))
    assert again.resume()["iteration"] == 4 and (again.best_ap, again.best_ar) == (0.3, 0.6)
    stats = {"AP": 0.25, "AR100": 1 / 3}
    for mod, name in ((tckpt, "t.txt"), (jckpt, "j.txt")):
        mod.append_results_line(str(tmp_path / name), 10, stats)
        mod.append_results_line(str(tmp_path / name), 20, stats)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_default_head_is_the_reference_init():
    """``init_weights`` against ``AssociationHead().init(PRNGKey(1), ...)`` at
    the tracker's shape (25600 -> 128) and a small one: the bias zero, the
    kernel within 4 float32 ulps of its largest value.  Measured: 1.86e-9
    (1 ulp at 0.0142) on 0.9 % of the values, from the last bits of XLA's
    ``log1p`` inside ``erf_inv``; the random bits, the key fold-ins and the
    uniform are bit-identical."""
    for in_dim, (c, r), e in ((25600, (256, 10), 128), (256 * 16, (256, 4), 8)):
        jp = JAssociationHead(embedding_dim=e).init(jax.random.PRNGKey(1), jnp.zeros((1, c, r, r)))["params"]
        kernel = np.asarray(jp["fc"]["kernel"])
        got = init_weights(in_dim, e)
        assert not np.asarray(jp["fc"]["bias"]).any() and not got["fc.bias"].any()
        diff = np.abs(got["fc.weight"].T - kernel)
        assert diff.max() <= 4 * np.spacing(np.abs(kernel).max()), diff.max()
        assert (diff > 0).mean() < 0.02
    key = jax.random.PRNGKey(1)
    np.testing.assert_array_equal(flax_init.fold_in(flax_init.prng_key(1), 12345),
                                  np.asarray(jax.random.key_data(jax.random.fold_in(key, 12345))))
    np.testing.assert_array_equal(flax_init.uniform(flax_init.prng_key(1), (1000,), -0.5, 0.7),
                                  np.asarray(jax.random.uniform(key, (1000,), minval=-0.5, maxval=0.7)))


def test_default_head_ids_match_jax():
    """The reproduction of the default-head fault: the tiny R50 tracker with
    ``TrackerConfig()`` (128-d embeddings of 10x10 ROIs) and no trained head,
    over 8 noise frames of 100x160: the port's ids equal the reference's in
    every frame (they differed from frame 2 with the earlier numpy head)."""
    jcfg = tiny_dcnn_config(num_classes=2)
    ckpt = detectron2_checkpoint(0, 50, 2)
    _, jparams = jax_mask_rcnn(jcfg, ckpt)
    assoc = JAssociationHead().init(jax.random.PRNGKey(1), jnp.zeros((1, 256, 10, 10)))["params"]
    frames = e2e_frames(8)
    jrecents = jeng.RcnnTracker(jcfg, JTrackerConfig(), jparams, assoc, E2E_HW).process_frames(frames)
    tracker = teng.RcnnTracker(port_config(jcfg), TrackerConfig(), ckpt, head_weights(None, 25600), E2E_HW,
                               device="cpu")
    trecents = tracker.process_frames(frames)
    for t in range(8):
        v = np.asarray(jrecents["valid"][t])
        np.testing.assert_array_equal(trecents["valid"][t], v)
        np.testing.assert_array_equal(trecents["ids"][t][v], np.asarray(jrecents["ids"][t])[v], err_msg=str(t))
    assert int(np.asarray(jrecents["ids"]).max()) > 4  # new tracks appear along the way


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """A JAX tiny R50 MaskRCNN and an AssociationHead saved by the
    reference's ``save_state`` (orbax), restored by its ``load_state``,
    converted with ``convert.checkpoint_state`` and saved in the port's format."""
    root = tmp_path_factory.mktemp("ckpt")
    jcfg = tiny_dcnn_config(num_classes=2)  # with the RPN top-k that --proposal_topk 16 sets
    jcfg = dataclasses.replace(jcfg, rpn=dataclasses.replace(jcfg.rpn, pre_nms_topk_test=16))
    _, jparams = jax_mask_rcnn(jcfg, detectron2_checkpoint(0, 50, 2))
    assoc = JAssociationHead().init(jax.random.PRNGKey(3), jnp.zeros((1, 256, 10, 10)))["params"]
    for name, params in (("model", jparams), ("head", assoc)):
        jckpt.save_state(str(root / "jax"), name, {"params": params, "iteration": 7, "best_ap": 0.5,
                                                   "best_ar": -np.inf})
        restored = jckpt.load_state(str(root / "jax"), name)
        state = convert.checkpoint_state(restored)
        assert state["iteration"] == 7 and state["best_ap"] == 0.5
        tckpt.save_state(str(root / "port"), name, state)
    return {"root": root, "jcfg": jcfg, "jparams": jparams, "assoc": assoc}


def test_jax_checkpoints_load_through_the_cli_flags(jax_checkpoints):
    """The converted checkpoints through ``tracker_test``'s ``--checkpoint``
    and ``--assoc_weights`` on 3 frames of 100x160: the port's detections and
    ids equal the reference's from its own checkpoint (float fields within
    1e-3 px / 1e-4), and its embeddings within 1e-5."""
    from apse_uav_torch.cli import tracker_test

    c, root = jax_checkpoints, jax_checkpoints["root"]
    frames = e2e_frames()
    jrecents = jeng.RcnnTracker(c["jcfg"], JTrackerConfig(), c["jparams"], c["assoc"], E2E_HW).process_frames(frames)
    args = tracker_test.build_parser().parse_args([
        "--sequence", "unused", "--checkpoint", str(root / "port" / "model"), "--assoc_weights",
        str(root / "port" / "head"), "--depth", "50", "--num_classes", "2", "--confidence", "0.0", "--min_size",
        "64", "--max_size", "128", "--proposal_topk", "16", "--detections", "4", "--batch", "3", "--device", "cpu"])
    tracker, pre = tracker_test.build_tracker(args, E2E_HW)
    assert not tracker.predictor.missing and pre is None
    recents, stats = tracker_test.track_sequence(args, list(frames), (tracker, pre))
    assert stats["frames"] == 3 and stats["hw"] == E2E_HW
    for t in range(3):
        v = np.asarray(jrecents["valid"][t])
        np.testing.assert_array_equal(recents[t]["valid"], v)
        for k in ("ids", "classes"):
            np.testing.assert_array_equal(recents[t][k][v], np.asarray(jrecents[k][t])[v], err_msg=k)
        np.testing.assert_allclose(recents[t]["boxes"][v], np.asarray(jrecents["boxes"][t])[v], rtol=0, atol=1e-3)
        np.testing.assert_allclose(recents[t]["scores"][v], np.asarray(jrecents["scores"][t])[v], rtol=0, atol=1e-4)
        np.testing.assert_allclose(recents[t]["embeddings"][v], np.asarray(jrecents["embeddings"][t])[v], rtol=0,
                                   atol=1e-5)


def test_missing_assoc_weights_fall_back_to_the_default_head(tmp_path, capsys):
    """A path that names no checkpoint keeps the default head, with a warning
    (the reference falls back silently); a saved one is read back as saved."""
    got = head_weights(str(tmp_path / "nothing"), 256 * 16, 8)
    assert "warning" in capsys.readouterr().out
    want = init_weights(256 * 16, 8)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    tckpt.save_state(str(tmp_path), "head", {"params": want})
    back = head_weights(os.path.join(str(tmp_path), "head"), 256 * 16, 8)
    assert all(torch.equal(back[k], torch.from_numpy(want[k])) for k in want)
