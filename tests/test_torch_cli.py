"""PyTorch port, the DCNN test CLIs on the CPU: ``tracker_test`` in its
``--sequence`` and ``--mots_evaluation`` modes on two tiny frames, its
results through ``mots_eval``, ``images_to_txt`` and ``mots_vis``;
``detector_test`` and ``aerial_view_test``; ``--help`` of every ported CLI;
and the device rule (``--device cuda`` without a card raises).

Weights are seeded detectron2-format checkpoints
(``utils.synthetic.detectron2_checkpoint``); frames are made with numpy.
"""

import importlib
import os

import numpy as np
import pytest
import torch

from apse_uav_torch.train import checkpoint as tckpt
from apse_uav_torch.utils.synthetic import detectron2_checkpoint

SMALL = ["--min_size", "64", "--max_size", "128", "--proposal_topk", "32", "--detections", "6"]
CLIS = ["track_uav", "tracker_test", "detector_test", "aerial_view_test", "mots_eval", "images_to_txt", "mots_vis",
        "aruco_detect"]


def _frames(n=2, hw=(48, 64)):
    return np.random.default_rng(4).integers(0, 255, (n, *hw, 3), np.uint8)


@pytest.fixture(scope="module")
def tracker_files(tmp_path_factory):
    """A KITTI-MOTS-like tree (sequence 0000, 2 PNG frames), its seqmap, and
    a seeded R50 4-class model (whose detections hold cars and persons)
    saved as the port's checkpoint."""
    import cv2

    root = tmp_path_factory.mktemp("mots")
    seq = root / "images" / "0000"
    seq.mkdir(parents=True)
    for i, frame in enumerate(_frames()):
        cv2.imwrite(str(seq / f"{i:06d}.png"), frame)
    (root / "seqmap.txt").write_text("0 empty 0 1\n")
    tckpt.save_state(str(root), "model", {"params": detectron2_checkpoint(5, 50, 4), "iteration": 0})
    return root


def _tracker_flags(root):
    return ["--checkpoint", str(root / "model"), "--depth", "50", "--num_classes", "4", "--confidence", "0.0",
            "--batch", "2", *SMALL]


def test_tracker_test_modes_and_mots_tools_on_cpu(tracker_files, capsys):
    """``--sequence`` prints its frame rate; ``--mots_evaluation`` writes one
    uint16 id PNG per frame; ``mots_eval`` of those results against
    themselves scores MOTSA = MOTSP = 1 with no id switch for every MOTS
    class that holds objects (at least one does); ``images_to_txt`` turns
    them into txt RLE that ``mots_vis`` renders."""
    from PIL import Image

    from apse_uav_torch.cli import images_to_txt, mots_eval, mots_vis, tracker_test
    from apse_uav_torch.evaluation.mots import run_eval

    root = tracker_files
    assert tracker_test.main(["--sequence", str(root / "images" / "0000"), "--force_cpu",
                              *_tracker_flags(root)]) == 0
    assert "average fps" in capsys.readouterr().out
    out = root / "results"
    assert tracker_test.main(["--mots_evaluation", str(root / "seqmap.txt"), "--kitti_root", str(root / "images"),
                              "--output_dir", str(out), "--device", "cpu", *_tracker_flags(root)]) == 0
    pngs = sorted(os.listdir(out / "0000"))
    assert pngs == ["000000.png", "000001.png"]
    ids = np.array(Image.open(out / "0000" / pngs[0]))
    assert ids.dtype == np.uint16 and ids.shape == (48, 64)
    assert mots_eval.main([str(out), str(out), str(root / "seqmap.txt")]) == 0
    scores = run_eval(str(out), str(out), str(root / "seqmap.txt"))
    held = [c for c, t in scores.items() if t["n_gt"] > 0]
    assert held
    for c in held:
        assert scores[c]["MOTSA"] == 1.0 and scores[c]["MOTSP"] == 1.0 and scores[c]["id_switches"] == 0, c
    assert images_to_txt.main([str(out), str(root / "txt")]) == 0
    assert os.path.exists(root / "txt" / "0000.txt")
    assert mots_vis.main([str(root / "txt"), str(root / "images"), str(root / "vis"), str(root / "seqmap.txt")]) == 0
    assert sorted(os.listdir(root / "vis" / "0000")) == pngs


def test_tracker_test_flags_on_cpu(tracker_files):
    """``--bf16``, ``--association`` (each metric) and ``--assoc_weights``
    (a saved head, and a missing path that keeps the default) through
    ``track_sequence``: ids from 1, never repeated within a frame."""
    from apse_uav_torch.cli import tracker_test
    from apse_uav_torch.dcnn.models.association import init_weights

    root = tracker_files
    tckpt.save_state(str(root), "head", {"params": init_weights(25600, 128, seed=5)})
    for extra in (["--bf16"], ["--association", "bbox_center_dist"], ["--association", "mask_iou"],
                  ["--assoc_weights", str(root / "head")], ["--assoc_weights", str(root / "none")]):
        args = tracker_test.build_parser().parse_args(["--sequence", "x", "--device", "cpu", *_tracker_flags(root),
                                                       *extra])
        recents, stats = tracker_test.track_sequence(args, list(_frames(2)))
        assert stats["frames"] == 2, extra
        for r in recents:
            ids = r["ids"][r["valid"]]
            assert len(ids) and (ids >= 1).all() and len(set(ids.tolist())) == len(ids), extra


def test_detector_and_aerial_view_cli_on_cpu(tmp_path, capsys):
    """``detector_test`` (R50, masks) and ``aerial_view_test`` (its defaults:
    3 classes, R50, no mask head) write the annotated copy of each image and
    report their detections; ``detect`` returns the snapshot layout."""
    import cv2

    from apse_uav_torch.cli import aerial_view_test, detector_test

    cv2.imwrite(str(tmp_path / "a.png"), _frames(1)[0])
    for name, classes in (("mask.pth", 4), ("aerial.pth", 3)):
        torch.save({"model": {k: torch.from_numpy(v) for k, v in detectron2_checkpoint(1, 50, classes).items()}},
                   str(tmp_path / name))
    assert detector_test.main(["--images", str(tmp_path), "--weights", str(tmp_path / "mask.pth"), "--depth", "50",
                               "--confidence", "0.0", "--output_dir", str(tmp_path / "det"), "--device", "cpu"]) == 0
    assert os.listdir(tmp_path / "det") == ["a_det.png"]
    assert aerial_view_test.main(["--images", str(tmp_path), "--weights", str(tmp_path / "aerial.pth"),
                                  "--confidence", "0.0", "--output_dir", str(tmp_path / "air"), "--device",
                                  "cpu"]) == 0
    assert os.listdir(tmp_path / "air") == ["a_det.png"]
    assert capsys.readouterr().out.count("a.png: ") == 2
    args = detector_test.build_parser().parse_args(aerial_view_test.aerial_argv(["--images", "x", "--weights", "w",
                                                                                 "--device", "cpu"]))
    assert (args.num_classes, args.depth, args.no_mask) == (3, 50, True)
    det = detector_test.detect(detector_test.build_predictor(args, (48, 64), detectron2_checkpoint(1, 50, 3)),
                               _frames(1)[0])
    assert set(det) == {"valid", "ids", "boxes", "scores", "classes"} and det["boxes"].shape[1] == 4


@pytest.mark.parametrize("cli", CLIS)
def test_cli_help(cli, capsys):
    """``--help`` of every ported CLI exits 0 and names its flags."""
    mod = importlib.import_module(f"apse_uav_torch.cli.{cli}")
    with pytest.raises(SystemExit) as exc:
        mod.main(["--help"])
    assert exc.value.code == 0
    assert "usage" in capsys.readouterr().out


def test_cli_device_rule():
    """Without a card, ``--device cuda`` (the default) raises in the CLIs of
    this slice instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-fallback rule is exercised on the CPU-only host")
    from apse_uav_torch.cli import detector_test, tracker_test

    args = tracker_test.build_parser().parse_args(["--sequence", "x", "--weights", "unused.pth"])
    with pytest.raises(RuntimeError, match="cuda"):
        tracker_test.build_tracker(args, (48, 64))
    args = detector_test.build_parser().parse_args(["--images", "x", "--weights", "unused.pth"])
    with pytest.raises(RuntimeError, match="cuda"):
        detector_test.build_predictor(args, (48, 64), {})
