"""PyTorch port, weight surgery and the annotation CLI against the JAX
package on the CPU: ``strip_backbone_prefix``, ``merge_mask_head`` and
``slice_predictor_classes`` on detectron2 names against the reference's on
its flax paths (the two compared through ``convert.mask_rcnn_state_dict``),
``add_mask_head`` against the JAX CLI on the same files (its output loads
into the port and gives masks), and ``create_coco_annotations`` byte for
byte.  Checkpoints are seeded detectron2-format state dicts
(``utils.synthetic.detectron2_checkpoint``); the surgery moves arrays
without arithmetic, so every comparison is exact.
"""

import pickle

import numpy as np
import pytest
import torch

from apse_uav_tpu.dcnn import weights as jW
from apse_uav_torch import convert
from apse_uav_torch.dcnn import weights as tW
from apse_uav_torch.utils.synthetic import detectron2_checkpoint


def _port_names(flat: dict) -> dict:
    return convert.mask_rcnn_state_dict(flat)


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)


@pytest.fixture(scope="module")
def coco80():
    """A seeded R50-FPN checkpoint with the model zoo's 80 COCO classes."""
    return detectron2_checkpoint(1, 50, 80)


def test_strip_backbone_prefix_matches_jax(coco80):
    """The backbone entries without their prefix, nothing else: the
    reference's ``resnet/...``, ``fpn/...`` paths are the port's
    ``bottom_up.*``, ``fpn_*`` names."""
    want = jW.strip_backbone_prefix(jW.map_detectron2_weights(coco80, 50, True))
    want = {k[len("backbone."):]: v for k, v in _port_names({f"backbone/{p}": v for p, v in want.items()}).items()}
    got = tW.strip_backbone_prefix(tW.reference_subset(coco80, 50, True))
    _assert_same(got, want)
    assert all(k.startswith(("bottom_up.", "fpn_")) for k in got)


def test_merge_mask_head_matches_jax(coco80):
    """A mask-less detector with the mask head of another checkpoint grafted
    in: the detector's own entries kept, only mask-head entries taken."""
    det = detectron2_checkpoint(2, 50, 80, mask_on=False)
    want = jW.merge_mask_head(jW.map_detectron2_weights(det, 50, False), jW.map_detectron2_weights(coco80, 50, True))
    got = tW.merge_mask_head(tW.reference_subset(det, 50, False), tW.reference_subset(coco80, 50, True))
    _assert_same(got, _port_names(want))
    np.testing.assert_array_equal(got["roi_heads.box_predictor.cls_score.weight"],
                                  det["roi_heads.box_predictor.cls_score.weight"])


@pytest.mark.parametrize("rows", [[2, 7, 5], [2, 7, 5, 0]])
def test_slice_predictor_classes_matches_jax(coco80, rows):
    """The 80-class predictor cut to ``rows``: class scores (K + 1, D) keep
    the rows and the background last, box deltas (4K, D) the four rows of
    each class, the mask predictor (K, C, 1, 1) the channels; the rows the
    reference selects on its transposed kernels."""
    want = jW.slice_predictor_classes(jW.map_detectron2_weights(coco80, 50, True), rows, 80)
    got = tW.slice_predictor_classes(tW.reference_subset(coco80, 50, True), rows, 80)
    _assert_same(got, _port_names(want))
    k = len(rows)
    assert got["roi_heads.box_predictor.cls_score.weight"].shape == (k + 1, 1024)
    np.testing.assert_array_equal(got["roi_heads.box_predictor.cls_score.bias"][-1],
                                  coco80["roi_heads.box_predictor.cls_score.bias"][80])
    np.testing.assert_array_equal(got["roi_heads.box_predictor.bbox_pred.weight"][:4],
                                  coco80["roi_heads.box_predictor.bbox_pred.weight"][8:12])
    assert got["roi_heads.mask_head.predictor.weight"].shape == (k, 256, 1, 1)


def test_add_mask_head_cli_matches_jax_and_loads(tmp_path, coco80):
    """``add_mask_head`` (a 3-class mask-less detector ``.pth`` and the
    80-class mask source ``.pkl``, the default COCO car / truck / bus rows)
    against the JAX CLI on the same files: the same tensors (the JAX
    pickle's flax paths through ``convert``); the port's ``.pkl`` loads into
    a 3-class R50-FPN with no key missing or unused, and gives masks."""
    from apse_uav_tpu.cli import add_mask_head as jcli
    from apse_uav_torch.cli import add_mask_head
    from apse_uav_torch.dcnn.config import mask_rcnn_r50_fpn
    from apse_uav_torch.dcnn.models.mask_rcnn import MaskRCNN

    torch.save({"model": {k: torch.from_numpy(v) for k, v in detectron2_checkpoint(3, 50, 3, mask_on=False).items()}},
               tmp_path / "det.pth")
    with open(tmp_path / "coco.pkl", "wb") as f:
        pickle.dump({"model": coco80, "__author__": "synthetic"}, f)
    argv = ["--detector", str(tmp_path / "det.pth"), "--mask_source", str(tmp_path / "coco.pkl"), "--depth", "50"]
    assert jcli.main(argv + ["--out", str(tmp_path / "jax.pkl")]) == 0
    assert add_mask_head.main(argv + ["--out", str(tmp_path / "port.pkl")]) == 0
    with open(tmp_path / "jax.pkl", "rb") as f:
        want = _port_names(pickle.load(f)["model"])
    got = tW.load_torch_file(str(tmp_path / "port.pkl"))
    _assert_same(got, want)
    model = MaskRCNN(mask_rcnn_r50_fpn(3)).eval()
    assert tW.load_detectron2(model, got) == ([], [])
    with torch.no_grad():
        det, _ = model.inference(torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (1, 64, 64, 3))
                                                  .astype(np.float32)))
    assert det["masks"].shape == (1, 100, 28, 28) and torch.isfinite(det["masks"]).all()


def test_create_coco_annotations_matches_jax(tmp_path):
    """The port's copy writes the JAX CLI's JSON byte for byte."""
    from apse_uav_tpu.cli.create_coco_annotations import convert as jconvert
    from apse_uav_torch.cli import create_coco_annotations

    csv = tmp_path / "labels.csv"
    csv.write_text("car,1,2,10,8,img1.png,64,48\nbus,5,6,20,10,img1.png,64,48\n\nperson,3,4,5,6,img2.png,64,48\n")
    jconvert(str(csv), str(tmp_path / "jax.json"))
    assert create_coco_annotations.main([str(csv), str(tmp_path / "port.json")]) == 0
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
