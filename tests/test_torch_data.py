"""PyTorch port, the data pipelines against the JAX package on the CPU.

The dataset-dict generators on on-disk fixtures of the JAX data tests' kind
(equal dicts), the detection loader (equal batches from one seed, masks
included, over two passes), the MOT / KITTI-MOTS loaders through the tiny
R50 backbone (equal ids, ROIs within 1e-5 of their max-abs), and the
channels-first ``roi_align`` / ``roi_pool``.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_parity import jax_mask_rcnn, port_config, tiny_dcnn_config

from apse_uav_tpu.data import datasets as jds, loader as jld, mot as jmot
from apse_uav_tpu.evaluation import rle as jrle
from apse_uav_torch.data import datasets as tds, loader as tld, mot as tmot
from apse_uav_torch.dcnn import weights as tW
from apse_uav_torch.dcnn.models.mask_rcnn import MaskRCNN
from apse_uav_torch.utils.synthetic import (detectron2_checkpoint, tracking_sequence, write_mot_sequence,
                                            write_mots_sequence)

jroi = importlib.import_module("apse_uav_tpu.dcnn.ops.roi_align")
troi = importlib.import_module("apse_uav_torch.dcnn.ops.roi_align")


def _png(path, h, w, seed):
    Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)).save(path)


def test_dataset_generators_equal(tmp_path):
    vis = tmp_path / "vis"
    os.makedirs(vis / "images")
    os.makedirs(vis / "annotations")
    for i in range(2):
        _png(vis / "images" / f"000000{i}.png", 40, 60, i)
        with open(vis / "annotations" / f"000000{i}.txt", "w") as f:
            f.write("10,10,20,15,1,4,0,0\n5,5,8,8,1,1,0,0\n1,1,4,4,1,0,0,0\n3,4,9,9,1,9,0,0\n")
    assert tds.generate_visdrone_dataset_dictionaries(str(vis)) == jds.generate_visdrone_dataset_dictionaries(str(vis))
    uav = tmp_path / "uav"
    for seq in ("M0101", "M0501"):
        os.makedirs(uav / seq)
        for t in (1, 2):
            _png(uav / seq / f"img00000{t}.jpg", 32, 48, t)
        with open(uav / f"{seq}_gt_whole.txt", "w") as f:
            f.write("1,7,2,3,10,8,0,0,1\n1,10,5,6,9,9,0,0,1\n2,7,3,3,10,8,0,0,2\n1,8,5,6,9,9,0,2,1\n")
    assert tds.generate_uav_dataset_dictionaries(str(uav)) == jds.generate_uav_dataset_dictionaries(str(uav))
    _png(tmp_path / "img1.png", 30, 40, 3)
    m = np.zeros((30, 40), np.uint8)
    m[2:9, 1:10] = 1
    coco = {"images": [{"id": 5, "file_name": "img1.png", "height": 30, "width": 40}],
            "annotations": [{"id": 1, "image_id": 5, "category_id": 3, "bbox": [1, 2, 10, 8], "iscrowd": 0,
                             "segmentation": {"size": [30, 40], "counts": jrle.encode(m)["counts"].decode()}},
                            {"id": 2, "image_id": 5, "category_id": 99, "bbox": [3, 3, 5, 5], "iscrowd": 0}]}
    with open(tmp_path / "ann.json", "w") as f:
        json.dump(coco, f)
    for mapping in (None, tds.COCO_CATEGORY_IDS_TO_UAV):
        assert (tds.generate_coco_dataset_dictionaries(str(tmp_path / "ann.json"), str(tmp_path),
                                                       category_mapping=mapping)
                == jds.generate_coco_dataset_dictionaries(str(tmp_path / "ann.json"), str(tmp_path),
                                                          category_mapping=mapping))
    vis_d = jds.generate_visdrone_dataset_dictionaries(str(vis))[0]
    assert tds.fabricate_outputs(vis_d) == jds.fabricate_outputs(vis_d)
    cowc = tmp_path / "cowc"
    os.makedirs(cowc)
    _png(cowc / "scene.png", 80, 70, 5)
    ann = np.zeros((80, 70), np.uint8)
    ann[[10, 40, 70], [12, 50, 30]] = 255
    Image.fromarray(ann).save(cowc / "scene_Annotated_Cars.png")
    assert (tds.generate_cowc_dataset_dictionaries(str(cowc), box_size=10, tile=64)
            == jds.generate_cowc_dataset_dictionaries(str(cowc), box_size=10, tile=64))


def _loader_dicts(tmp_path, n=5):
    dicts = []
    for i in range(n):
        h, w = 40 + 6 * i, 56 + 4 * i
        _png(tmp_path / f"im{i}.png", h, w, 10 + i)
        m = np.zeros((h, w), np.uint8)
        m[5:20, 6:30] = 1
        anns = [{"bbox": [4, 4, 16, 12], "bbox_mode": "xywh", "category_id": i % 3, "is_crowd": 0},
                {"bbox": [6, 5, 24, 15], "bbox_mode": "xywh", "category_id": 1, "is_crowd": 0,
                 "segmentation": jrle.encode(m)}]
        dicts.append({"file_name": str(tmp_path / f"im{i}.png"), "image_id": i, "height": h, "width": w,
                      "annotations": anns})
    return dicts


@pytest.mark.parametrize("training", [True, False])
def test_detection_loader_batches_equal(tmp_path, training):
    """The same seed gives the same images and GT (boxes, classes, valid,
    28x28 masks) in both packages, batch for batch over two passes (the
    shuffle, flips and colour draws consumed in the same order)."""
    dicts = _loader_dicts(tmp_path)
    cfg = dict(train_size=(64, 96), min_size=48, max_size=96, max_gt=4, batch_size=2, mask_size=28)
    jl = iter(jld.DetectionLoader(dicts, jld.LoaderConfig(**cfg), training=training, seed=4))
    tl = iter(tld.DetectionLoader(dicts, tld.LoaderConfig(**cfg), training=training, seed=4))
    n = 0
    for (ji, jg), (ti, tg) in zip(jl, tl):
        np.testing.assert_array_equal(ti, ji)
        assert set(tg) == set(jg) == {"boxes", "classes", "valid", "masks"}
        for k in jg:
            np.testing.assert_array_equal(tg[k], jg[k], err_msg=k)
        n += 1
        if n == 4:
            break
    assert n == (4 if training else 2)
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    np.testing.assert_array_equal(tld.lighting_delta(rng_a, 0.2), jld.lighting_delta(rng_b, 0.2))
    ann = dicts[0]["annotations"]
    for k, v in jld.pad_gt(ann, 4, (1.5, 2.0), 96.0).items():
        np.testing.assert_array_equal(tld.pad_gt(ann, 4, (1.5, 2.0), 96.0)[k], v)


def test_roi_align_chw_and_roi_pool_match_jax():
    """``roi_align`` (channels first) within 1e-5 of the max-abs, ``roi_pool``
    identical, on boxes inside, across and outside a 23x37 map."""
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(16, 23, 37)).astype(np.float32)
    b = rng.uniform(-10, 140, (12, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.uniform(1, 80, (12, 2)).astype(np.float32)
    b[0] = [3, 3, 3, 3]
    for scale in (0.25, 0.2507):
        for aligned in (False, True):
            want = np.asarray(jroi.roi_align(jnp.asarray(feat), jnp.asarray(b), 8, scale, 4, aligned))
            got = troi.roi_align(torch.from_numpy(feat), torch.from_numpy(b), 8, scale, 4, aligned).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        want = np.asarray(jroi.roi_pool(jnp.asarray(feat), jnp.asarray(b), (8, 6), scale))
        np.testing.assert_array_equal(troi.roi_pool(torch.from_numpy(feat), torch.from_numpy(b), (8, 6), scale).numpy(),
                                      want)


@pytest.fixture(scope="module")
def backbones():
    cfg = tiny_dcnn_config(num_classes=2)
    ckpt = detectron2_checkpoint(2, 50, 2)
    jm, jp = jax_mask_rcnn(cfg, ckpt)
    backbone_fn = jax.jit(lambda imgs: jm.apply({"params": jp}, imgs, mode="backbone"))
    model = MaskRCNN(port_config(cfg))
    tW.load_detectron2(model, ckpt)
    return backbone_fn, model.eval()


def _same_batches(jbatches, tbatches):
    for (jids, jr), (tids, tr) in zip(jbatches, tbatches):
        np.testing.assert_array_equal(tids, jids)
        assert tr.shape == np.asarray(jr).shape
        np.testing.assert_allclose(tr, np.asarray(jr), rtol=0, atol=1e-5 * np.abs(np.asarray(jr)).max())


def test_mots_and_mot_loaders_match_jax(tmp_path, backbones):
    """KITTI-MOTS (mask-cropped ROIAlign) and MOT (ROIPool) batches from the
    same files: equal ids, ROIs within 1e-5 of their max-abs."""
    backbone_fn, model = backbones
    frames, objects = tracking_sequence(5, (72, 120), 4, seed=3)
    write_mots_sequence(str(tmp_path / "instances"), str(tmp_path / "images"), "0002", frames, objects)
    jl = jmot.MOTSLoader(str(tmp_path / "instances"), str(tmp_path / "images"), ["0002"],
                         jmot.RoiFeaturesGenerator(backbone_fn, 8), 2)
    tl = tmot.MOTSLoader(str(tmp_path / "instances"), str(tmp_path / "images"), ["0002"],
                         tmot.RoiFeaturesGenerator(model, 8), 2)
    assert tl.num_batches("0002") == jl.num_batches("0002") == 2
    _same_batches([jl.get_training_batch("0002", i) for i in range(2)],
                  [tl.get_training_batch("0002", i) for i in range(2)])
    write_mot_sequence(str(tmp_path / "MOT-01"), frames, objects)
    jl = jmot.MOTLoader(str(tmp_path / "MOT-01"), jmot.RoiFeaturesGenerator(backbone_fn, 8), 2)
    tl = tmot.MOTLoader(str(tmp_path / "MOT-01"), tmot.RoiFeaturesGenerator(model, 8), 2)
    assert tl.num_of_batches == jl.num_of_batches == 2
    _same_batches([jl.get_training_batch(i) for i in range(2)], [tl.get_training_batch(i) for i in range(2)])
