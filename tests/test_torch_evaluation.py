"""PyTorch port, the evaluation stack against the JAX package: the RLE codec
(count strings byte for byte), the MOTS formats and metrics (the eight
scenarios of ``tests/test_mots.py`` on the port, each also against the
reference), and the tracker's MOTS export.

Inputs are made with numpy from fixed seeds and handed to both packages.
"""

import numpy as np
import pytest

from apse_uav_tpu.evaluation import mots as jmots, mots_export as jexport, rle as jrle
from apse_uav_torch.evaluation import mots as tmots, mots_export as texport, rle as trle

H, W = 40, 60


def _rand_mask(rng, h, w, blobs=3):
    m = np.zeros((h, w), np.uint8)
    for _ in range(blobs):
        y, x = rng.integers(0, h), rng.integers(0, w)
        rh, rw = rng.integers(1, h // 2 + 1), rng.integers(1, w // 2 + 1)
        m[y : y + rh, x : x + rw] = 1
    return m


def _mask_pair(case: str, seed: int):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(3, 60, 2))
    a, b = _rand_mask(rng, h, w), _rand_mask(rng, h, w)
    if case == "empty":
        a[:] = 0
    elif case == "full":
        a[:] = 1
    elif case == "noise":
        a = (rng.uniform(size=(h, w)) < 0.5).astype(np.uint8)
        b = (rng.uniform(size=(h, w)) < 0.3).astype(np.uint8)
    elif case == "corner_pixel":
        a[:] = 0
        a[-1, -1] = 1
        b[:] = 0
        b[0, 0] = 1
    return a, b


CASES = [(c, s) for c in ("blobs", "noise") for s in range(4)] + [("empty", 0), ("full", 1), ("corner_pixel", 2)]


@pytest.mark.parametrize("op", ["roundtrip_and_strings", "area", "iou", "iou_iscrowd", "merge", "toBbox"])
@pytest.mark.parametrize("case,seed", CASES)
def test_rle_matches_jax(op, case, seed):
    """Each RLE operation on the same masks: the port's compressed strings
    byte-identical to the reference's, decode exact, areas, IoU (also with
    ``iscrowd``), merges and boxes identical."""
    a, b = _mask_pair(case, seed)
    ta, tb, ja, jb = trle.encode(a), trle.encode(b), jrle.encode(a), jrle.encode(b)
    if op == "roundtrip_and_strings":
        assert ta == ja and tb == jb
        np.testing.assert_array_equal(trle.decode(ta), a)
        np.testing.assert_array_equal(trle.decode(ja), jrle.decode(ja))
        str_form = {"size": ja["size"], "counts": ja["counts"].decode()}
        np.testing.assert_array_equal(trle.decode(str_form), a)
    elif op == "area":
        assert trle.area(ta) == jrle.area(ja) == int(a.sum())
    elif op in ("iou", "iou_iscrowd"):
        crowd = [int(op == "iou_iscrowd")] * 2
        np.testing.assert_array_equal(trle.iou([ta, tb], [tb, ta], crowd), jrle.iou([ja, jb], [jb, ja], crowd))
    elif op == "merge":
        for inter in (False, True):
            assert trle.merge([ta, tb], inter) == jrle.merge([ja, jb], inter)
        np.testing.assert_array_equal(trle.decode(trle.merge([ta, tb])), a | b)
    else:
        np.testing.assert_array_equal(trle.toBbox(ta), jrle.toBbox(ja))
        np.testing.assert_array_equal(trle.toBbox(tb), jrle.toBbox(jb))


# -- the eight scenarios of tests/test_mots.py, on both packages ----------------


def _obj(pkg, x, y, w, h, track, cls=1):
    m = np.zeros((H, W), np.uint8)
    m[y : y + h, x : x + w] = 1
    rle, mots = pkg
    return mots.SegmentedObject(rle.encode(m), cls, track)


PKGS = {"torch": (trle, tmots), "jax": (jrle, jmots)}


def _metrics(make_gt_res, max_frame):
    """compute_mots_metrics of the scenario in both packages; identical results; the port's total."""
    out = {}
    for name, pkg in PKGS.items():
        gt, res = make_gt_res(pkg)
        out[name] = pkg[1].compute_mots_metrics(gt, res, {"0000": max_frame}, 1)
    assert out["torch"] == out["jax"]
    return out["torch"][1]


def test_perfect_tracking_scores_one():
    total = _metrics(lambda p: ({"0000": {0: [_obj(p, 2, 2, 8, 8, 1)], 1: [_obj(p, 4, 2, 8, 8, 1)]}},
                                {"0000": {0: [_obj(p, 2, 2, 8, 8, 7)], 1: [_obj(p, 4, 2, 8, 8, 7)]}}), 1)
    assert total["tp"] == 2 and total["fp"] == 0 and total["fn"] == 0
    assert total["sMOTSA"] == pytest.approx(1.0) and total["MOTSA"] == pytest.approx(1.0)
    assert total["MT"] == pytest.approx(1.0) and total["id_switches"] == 0


def test_id_switch_counted():
    total = _metrics(lambda p: ({"0000": {f: [_obj(p, 2, 2, 8, 8, 1)] for f in range(3)}},
                                {"0000": {0: [_obj(p, 2, 2, 8, 8, 5)], 1: [_obj(p, 2, 2, 8, 8, 5)],
                                          2: [_obj(p, 2, 2, 8, 8, 9)]}}), 2)
    assert total["id_switches"] == 1
    assert total["MOTSA"] == pytest.approx(1 - 1 / 3)


def test_fp_fn_and_ignore_region():
    total = _metrics(lambda p: ({"0000": {0: [_obj(p, 2, 2, 8, 8, 1), _obj(p, 30, 20, 10, 10, 10, cls=10)]}},
                                {"0000": {0: [_obj(p, 2, 2, 8, 8, 4), _obj(p, 31, 21, 8, 8, 5),
                                              _obj(p, 50, 2, 6, 6, 6)]}}), 0)
    assert total["tp"] == 1 and total["n_itr"] == 1 and total["fp"] == 1 and total["fn"] == 0


def test_missed_gt_is_fn_and_ml():
    total = _metrics(lambda p: ({"0000": {f: [_obj(p, 2, 2, 8, 8, 1)] for f in range(2)}}, {"0000": {}}), 1)
    assert total["fn"] == 2 and total["tp"] == 0
    assert total["ML"] == pytest.approx(1.0)


def test_txt_roundtrip(tmp_path):
    """The port writes what the reference reads, and reads what it writes."""
    gt = {"0000": {0: [_obj(PKGS["torch"], 2, 2, 8, 8, 1001)], 3: [_obj(PKGS["torch"], 12, 4, 6, 6, 1002)]}}
    tmots.write_sequences(gt, str(tmp_path / "t"))
    jmots.write_sequences({"0000": {f: [jmots.SegmentedObject(o.mask, o.class_id, o.track_id) for o in objs]
                                    for f, objs in gt["0000"].items()}}, str(tmp_path / "j"))
    assert (tmp_path / "t" / "0000.txt").read_text() == (tmp_path / "j" / "0000.txt").read_text()
    loaded = tmots.load_txt(str(tmp_path / "j" / "0000.txt"))
    assert set(loaded) == {0, 3} and loaded[3][0].track_id == 1002
    np.testing.assert_array_equal(trle.decode(loaded[0][0].mask), trle.decode(gt["0000"][0][0].mask))


def test_overlap_assertion(tmp_path):
    p = PKGS["torch"]
    tmots.write_sequences({"0000": {0: [_obj(p, 2, 2, 8, 8, 1), _obj(p, 4, 4, 8, 8, 2)]}}, str(tmp_path))
    with pytest.raises(AssertionError):
        tmots.load_txt(str(tmp_path / "0000.txt"))


def test_paste_and_crop_overlaps():
    m = np.ones((28, 28), np.float32)
    box = np.array([10.0, 5.0, 20.0, 15.0])
    full = texport.paste_mask_np(m, box, (H, W))
    np.testing.assert_array_equal(full, jexport.paste_mask_np(m, box, (H, W)))
    ys, xs = np.nonzero(full)
    assert ys.min() == 5 and ys.max() == 14 and xs.min() == 10 and xs.max() == 19
    a = np.zeros((H, W), bool)
    a[:10, :10] = True
    b = np.zeros((H, W), bool)
    b[5:15, 5:15] = True
    out = texport.crop_overlapping_masks([a, b], [0.9, 0.5])
    assert (out[0] & out[1]).sum() == 0 and out[0].sum() == 100
    for got, want in zip(out, jexport.crop_overlapping_masks([a, b], [0.9, 0.5])):
        np.testing.assert_array_equal(got, want)


def test_export_lines_and_image():
    recent = {
        "valid": np.array([True, True, False, False]),
        "ids": np.array([3, 5, 0, 0]),
        "boxes": np.array([[2.0, 2.0, 10.0, 10.0], [20.0, 8.0, 30.0, 18.0], [0, 0, 0, 0], [0, 0, 0, 0]]),
        "scores": np.array([0.9, 0.8, 0.0, 0.0]),
        "classes": np.array([2, 0, 0, 0]),  # car, person
        "masks": np.ones((4, 28, 28), np.float32),
    }
    lines = texport.file_lines_from_recent(recent, 7, (H, W))
    assert lines == jexport.file_lines_from_recent(recent, 7, (H, W))
    assert len(lines) == 2 and lines[0].startswith("7 1003 1 40 60 ") and lines[1].startswith("7 2005 2 40 60 ")
    img = texport.result_image_from_recent(recent, (H, W))
    np.testing.assert_array_equal(img, jexport.result_image_from_recent(recent, (H, W)))
    assert set(np.unique(img)) == {0, 1003, 2005}


# -- random sequences --------------------------------------------------------------


def _random_recent(rng, n=6, classes=(0, 1, 2, 3)):
    xy = rng.uniform(-5, 50, (n, 2))
    wh = rng.uniform(2, 25, (n, 2))
    return {"valid": rng.uniform(size=n) < 0.8, "ids": rng.integers(1, 20, n),
            "boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "scores": rng.uniform(0.3, 1, n).astype(np.float32), "classes": rng.choice(classes, n),
            "masks": rng.uniform(0, 1, (n, 28, 28)).astype(np.float32)}


def test_export_and_metrics_match_jax_on_random_sequences():
    """Random tracker snapshots over 6 frames: the export's txt lines and id
    images identical to the reference's; results loaded back and scored
    against a perturbed copy give identical metrics for both MOTS classes."""
    rng = np.random.default_rng(7)
    recents = [_random_recent(rng) for _ in range(6)]
    gts = [_random_recent(np.random.default_rng(100 + f)) for f in range(6)]
    for r, g in zip(recents, gts):  # the ground truth holds three of the results' cars
        r["classes"][:3] = 2
        r["valid"][:3] = True
        for k in ("boxes", "masks", "classes", "valid"):
            g[k][:3] = r[k][:3]
    out = {}
    for name, (rle, mots), export in (("torch", (trle, tmots), texport), ("jax", (jrle, jmots), jexport)):
        res_lines, gt_lines = [], []
        for f in range(6):
            res_lines += export.file_lines_from_recent(recents[f], f, (H, W))
            gt_lines += export.file_lines_from_recent(gts[f], f, (H, W))
            img = export.result_image_from_recent(recents[f], (H, W))
            out.setdefault(f"{name}_img", []).append(img)

        def frames(lines):
            d = {}
            for ln in lines:
                fr, tid, cls, h, w, counts = ln.split(" ")
                d.setdefault(int(fr), []).append(mots.SegmentedObject({"size": [int(h), int(w)],
                                                                       "counts": counts.encode()}, int(cls),
                                                                      int(tid)))
            return d

        out[f"{name}_lines"] = res_lines + gt_lines
        out[name] = [mots.compute_mots_metrics({"0000": frames(gt_lines)}, {"0000": frames(res_lines)}, {"0000": 5},
                                               c) for c in (1, 2)]
    assert out["torch_lines"] == out["jax_lines"] and len(out["torch_lines"]) > 6
    for a, b in zip(out["torch_img"], out["jax_img"]):
        np.testing.assert_array_equal(a, b)
    assert out["torch"] == out["jax"]
    assert any(t["tp"] > 0 for _, t in out["torch"])
