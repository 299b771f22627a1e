"""PyTorch port, the DCNN test CLIs on the CPU: ``tracker_test`` in its
``--sequence`` and ``--mots_evaluation`` modes on two tiny frames, its
results through ``mots_eval``, ``images_to_txt`` and ``mots_vis``;
``detector_test`` and ``aerial_view_test``; the training CLIs
(``finetune_uav``, ``train_association_head``, ``association_head_test``,
``finetune_segmentation``, ``finetune_faster_rcnn_aerial``) on tiny
fixtures, and (``slow``) ``train_association_head`` against the JAX CLI;
``aruco_detect``'s live view; ``--help`` of every ported CLI; and the device
rule (``--device cuda`` without a card raises).

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
        "aruco_detect", "finetune_uav", "train_association_head", "association_head_test", "add_mask_head",
        "create_coco_annotations", "finetune_coco_dataset", "finetune_faster_rcnn_aerial", "finetune_segmentation"]


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


def _save_pth(path, classes, mask_on=True):
    torch.save({"model": {k: torch.from_numpy(v)
                          for k, v in detectron2_checkpoint(1, 50, classes, mask_on=mask_on).items()}}, str(path))


def test_finetune_uav_cli_on_cpu(tmp_path, capsys):
    """``finetune_uav`` on a 2-image VisDrone tree (R50 from a seeded ``.pth``,
    batch 1 at 64x96, 1 iteration and its evaluation): results.txt, last /
    bestAP / bestAR with the optimizer state at iteration 1; a second run
    resumes there and takes iteration 2."""
    from PIL import Image

    from apse_uav_torch.cli import finetune_uav

    vis = tmp_path / "vis"
    (vis / "images").mkdir(parents=True)
    (vis / "annotations").mkdir()
    for i in range(2):
        Image.fromarray(_frames(1, (64, 96))[0]).save(vis / "images" / f"{i:07d}.png")
        (vis / "annotations" / f"{i:07d}.txt").write_text("10,10,30,20,1,4,0,0\n40,30,20,25,1,1,0,0\n")
    _save_pth(tmp_path / "w.pth", 4, mask_on=False)
    argv = ["--visdrone_train", str(vis), "--workdir", str(tmp_path / "run"), "--weights", str(tmp_path / "w.pth"),
            "--depth", "50", "--max_iter", "1", "--test_period", "1", "--batch_size", "1", "--train_size", "64", "96",
            "--eval_images", "1", "--device", "cpu"]
    assert finetune_uav.main(argv) == 0
    lines = (tmp_path / "run" / "results.txt").read_text().strip().split("\n")
    assert len(lines) == 2 and lines[1].startswith("1\t")
    for name in ("last", "bestAP", "bestAR"):
        assert os.path.exists(tmp_path / "run" / name)
    state = tckpt.load_state(str(tmp_path / "run"), "last")
    assert state["iteration"] == 1 and int(state["opt_state"]["count"]) == 1
    assert all(k.startswith(("proposal_generator.", "roi_heads.")) for k in state["opt_state"]["trace"])
    assert finetune_uav.main(argv[:argv.index("--max_iter") + 1] + ["2"] + argv[argv.index("--max_iter") + 2:]) == 0
    assert "resumed at iteration 1" in capsys.readouterr().out
    assert tckpt.load_state(str(tmp_path / "run"), "last")["iteration"] == 2


def _changed(state: dict, start: dict) -> set[str]:
    return {k for k, v in state.items() if not np.array_equal(v.numpy(), np.asarray(start[k]))}


def test_finetune_segmentation_cli_on_cpu(tmp_path, capsys):
    """``finetune_segmentation`` on 5 seeded COCO images with RLE masks
    (fold 0 of 5 held out; R50 from a seeded ``.pth``, batch 1 at 64x96, 2
    iterations on GT proposals): only mask-head tensors change, ``last``
    holds iteration 2, and ``--merge_into`` / ``--merge_out`` write a
    detectron2-named ``.pkl`` holding the detector's tensors with the
    trained mask head, which loads into the port with no key missing."""
    from apse_uav_torch.cli import finetune_segmentation
    from apse_uav_torch.dcnn import weights as W
    from apse_uav_torch.dcnn.config import mask_rcnn_r50_fpn
    from apse_uav_torch.dcnn.models.mask_rcnn import MaskRCNN
    from apse_uav_torch.utils.synthetic import write_coco_dataset

    ann, images = write_coco_dataset(str(tmp_path / "coco"), 5, (64, 96))
    _save_pth(tmp_path / "w.pth", 4)
    det = detectron2_checkpoint(6, 50, 4, mask_on=False)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in det.items()}}, str(tmp_path / "det.pth"))
    argv = ["--coco_json", ann, "--coco_images", images, "--workdir", str(tmp_path / "run"), "--weights",
            str(tmp_path / "w.pth"), "--depth", "50", "--max_iter", "2", "--test_period", "2", "--batch_size", "1",
            "--train_size", "64", "96", "--merge_into", str(tmp_path / "det.pth"), "--merge_out",
            str(tmp_path / "merged.pkl"), "--device", "cpu"]
    assert finetune_segmentation.main(argv) == 0
    assert "merged mask head into" in capsys.readouterr().out
    state = tckpt.load_state(str(tmp_path / "run"), "last")
    assert state["iteration"] == 2
    start = detectron2_checkpoint(1, 50, 4)
    changed = _changed(state["params"], start)
    assert changed and all(k.startswith("roi_heads.mask_head.") for k in changed)
    merged = W.load_torch_file(str(tmp_path / "merged.pkl"))
    for k, v in merged.items():
        want = state["params"][k].numpy() if k.startswith("roi_heads.mask_head.") else det[k]
        np.testing.assert_array_equal(v, want, err_msg=k)
    model = MaskRCNN(mask_rcnn_r50_fpn(4))
    assert W.load_detectron2(model, merged) == ([], [])
    assert finetune_segmentation.kfold_split(list(range(11)), 5, 1) == ([0, 1, 4, 5, 6, 7, 8, 9, 10], [2, 3])


def test_finetune_faster_rcnn_aerial_cli_on_cpu(tmp_path, monkeypatch):
    """``finetune_faster_rcnn_aerial --rpn_only`` on a seeded UAVDT tree (2
    sequences of 2 frames of 64x96; R50 3 classes from a seeded ``.pth``,
    masks off, batch 1, 2 iterations; the loader's train size cut to 64x96,
    which the CLI, like the reference's, takes no flag for): ``last`` at
    iteration 2, and only the RPN and the box head and predictor moved
    (``to_train`` = RPN + box head)."""
    import functools

    from apse_uav_torch.cli import finetune_faster_rcnn_aerial
    from apse_uav_torch.data import loader
    from apse_uav_torch.utils.synthetic import write_uavdt_dataset

    monkeypatch.setattr(loader, "LoaderConfig", functools.partial(loader.LoaderConfig, train_size=(64, 96),
                                                                  min_size=64, max_size=96))

    uav = write_uavdt_dataset(str(tmp_path / "uav"), 2, 2, (64, 96))
    _save_pth(tmp_path / "w.pth", 3, mask_on=False)
    assert finetune_faster_rcnn_aerial.main(
        ["--uavdt_dir", uav, "--workdir", str(tmp_path / "run"), "--weights", str(tmp_path / "w.pth"),
         "--max_iter", "2", "--test_period", "2", "--batch_size", "1", "--rpn_only", "--device", "cpu"]) == 0
    state = tckpt.load_state(str(tmp_path / "run"), "last")
    assert state["iteration"] == 2
    changed = _changed(state["params"], detectron2_checkpoint(1, 50, 3, mask_on=False))
    assert changed and all(k.startswith(("proposal_generator.", "roi_heads.box_head.", "roi_heads.box_predictor."))
                           for k in changed)
    assert any(k.startswith("roi_heads.box_head.") for k in changed)


def test_aruco_live_view_shows_frames_until_q():
    """``--display``: each annotated frame goes to one window; the ``q`` key
    sets ``quit``, and ``close`` destroys the windows (a stand-in for cv2's
    GUI calls)."""
    from apse_uav_torch.cli.aruco_detect import Display

    calls = []

    class FakeCv2:
        FONT_HERSHEY_SIMPLEX = 0

        def __getattr__(self, name):
            return lambda *a, **k: calls.append(name)

        def waitKey(self, ms):
            calls.append("waitKey")
            return ord("q") if calls.count("imshow") == 2 else -1

    view = Display()
    view.cv2 = FakeCv2()
    row = {"corners": np.zeros((4, 4, 2)), "detected": np.zeros(4, bool), "dist_aruco": np.zeros(3),
           "altitude": 0.0, "marker_length": 0.0, "leds": 0}
    import sys
    from unittest import mock

    with mock.patch.dict(sys.modules, {"cv2": view.cv2}):
        view.show(np.zeros((8, 8, 3), np.uint8), row)
        assert not view.quit
        view.show(np.zeros((8, 8, 3), np.uint8), row)
        assert view.quit
        view.close()
    assert calls.count("imshow") == 2 and calls[-1] == "destroyAllWindows"


@pytest.fixture(scope="module")
def assoc_files(tmp_path_factory):
    """A KITTI-MOTS tree (sequence 0001: 8 frames of 48x80, 4 objects), its
    seqmap, the same sequence in MOT17's layout, and a seeded R50 ``.pth``."""
    from apse_uav_torch.utils.synthetic import tracking_sequence, write_mot_sequence, write_mots_sequence

    root = tmp_path_factory.mktemp("assoc")
    frames, objects = tracking_sequence(8, (48, 80), 4, seed=1)
    write_mots_sequence(str(root / "instances"), str(root / "images"), "0001", frames, objects)
    write_mot_sequence(str(root / "MOT-01"), frames, objects)
    (root / "seqmap.txt").write_text("0001 empty 0 7\n")
    _save_pth(root / "w.pth", 80)
    return root


def _assoc_argv(root, workdir):
    return ["--instances_txt", str(root / "instances"), "--images", str(root / "images"), "--seqmap",
            str(root / "seqmap.txt"), "--weights", str(root / "w.pth"), "--workdir", str(workdir), "--depth", "50",
            "--epochs", "2"]


def test_association_training_and_test_clis_on_cpu(assoc_files, tmp_path, capsys):
    """``train_association_head`` (2 epochs of 2 batches of 4 frames):
    ``epoch_0`` / ``epoch_1`` and ``train_info.txt``; ``association_head_test``
    reads ``epoch_1`` through ``--assoc_weights`` and reports the anchor's
    nearest-neighbour accuracy."""
    from apse_uav_torch.cli import association_head_test, train_association_head

    head = train_association_head.main(_assoc_argv(assoc_files, tmp_path / "run") + ["--device", "cpu"])
    assert head.fc.weight.shape == (128, 256 * 64)
    lines = (tmp_path / "run" / "train_info.txt").read_text().strip().split("\n")
    assert [ln.split(":")[0] for ln in lines] == ["epoch 0", "epoch 1"]
    assert all(np.isfinite(float(ln.split()[-1])) for ln in lines)
    state = tckpt.load_state(str(tmp_path / "run"), "epoch_1")
    assert state["epoch"] == 1
    np.testing.assert_array_equal(state["params"]["fc.weight"].numpy(), head.fc.weight.detach().numpy())
    capsys.readouterr()
    assert association_head_test.main(["--sequence", str(assoc_files / "MOT-01"), "--weights",
                                       str(assoc_files / "w.pth"), "--assoc_weights", str(tmp_path / "run" / "epoch_1"),
                                       "--depth", "50", "--frames", "5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("frame ") == 4 and "nearest-neighbor accuracy" in out


@pytest.mark.slow
def test_train_association_head_cli_matches_jax(assoc_files, tmp_path):
    """The port's ``train_association_head`` against the JAX CLI on the same
    files: ``train_info.txt`` within 1e-4 of each epoch's loss (the ROIs
    agree to ~1e-6 of their max-abs, the init to 1 ulp)."""
    from apse_uav_tpu.cli import train_association_head as jcli
    from apse_uav_torch.cli import train_association_head

    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jcli.main(_assoc_argv(assoc_files, tmp_path / "jax")) == 0
    train_association_head.main(_assoc_argv(assoc_files, tmp_path / "port") + ["--device", "cpu"])
    want = (tmp_path / "jax" / "train_info.txt").read_text().strip().split("\n")
    got = (tmp_path / "port" / "train_info.txt").read_text().strip().split("\n")
    assert len(want) == len(got) == 2
    for a, b in zip(want, got):
        assert abs(float(a.split()[-1]) - float(b.split()[-1])) <= 1e-4 * abs(float(a.split()[-1])) + 2e-6


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
    from apse_uav_torch.cli import finetune_uav, train_association_head

    with pytest.raises(RuntimeError, match="cuda"):
        finetune_uav.main(["--workdir", "unused", "--visdrone_train", "unused"])
    with pytest.raises(RuntimeError, match="cuda"):
        train_association_head.main(["--instances_txt", "x", "--images", "x", "--seqmap", "x", "--weights", "x",
                                     "--workdir", "x"])
    from apse_uav_torch.cli import finetune_coco_dataset, finetune_faster_rcnn_aerial, finetune_segmentation

    for cli, argv in ((finetune_coco_dataset, ["--coco_json", "x", "--coco_images", "x", "--workdir", "x"]),
                      (finetune_faster_rcnn_aerial, ["--uavdt_dir", "x", "--workdir", "x"]),
                      (finetune_segmentation, ["--coco_json", "x", "--coco_images", "x", "--workdir", "x"])):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(argv)


def test_surgery_and_annotation_clis_run_on_the_host(tmp_path):
    """``add_mask_head`` and ``create_coco_annotations`` move arrays and
    text on the host: they take no ``--device`` and run where there is no
    card (their output is checked against JAX's in ``test_torch_surgery``)."""
    from apse_uav_torch.cli import add_mask_head, create_coco_annotations

    for cli in (add_mask_head, create_coco_annotations):
        assert "--device" not in cli.build_parser().format_help()
    (tmp_path / "l.csv").write_text("car,1,2,10,8,a.png,64,48\n")
    assert create_coco_annotations.main([str(tmp_path / "l.csv"), str(tmp_path / "a.json")]) == 0
    _save_pth(tmp_path / "d.pth", 3, mask_on=False)
    _save_pth(tmp_path / "m.pth", 80)
    assert add_mask_head.main(["--detector", str(tmp_path / "d.pth"), "--mask_source", str(tmp_path / "m.pth"),
                               "--out", str(tmp_path / "o.pkl"), "--depth", "50"]) == 0
