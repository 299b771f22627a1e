"""PyTorch port, the COWC ROI-feature path against the JAX package on the
CPU: ``MaskRCNN.roi_features`` (backbone -> box pooler -> box head FC
trunk), ``roi_align_hwc``'s ``plane`` modulation, and
``CowcRoiFeaturesLoader`` fed the same annotated images and the same fake
feature function (``tests/test_data.py``'s), with ``build_roi_feature_fn``
on a small model.

Inputs are made with numpy from fixed seeds; tolerances are stated per test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_parity import jax_mask_rcnn, port_config, tiny_dcnn_config

from apse_uav_tpu.data.cowc import CowcRoiFeaturesLoader as JLoader
from apse_uav_torch.data.cowc import CowcRoiFeaturesLoader, build_roi_feature_fn
from apse_uav_torch.dcnn import weights as tW
from apse_uav_torch.dcnn.models.mask_rcnn import MaskRCNN
from apse_uav_torch.utils.synthetic import detectron2_checkpoint

jroi = importlib.import_module("apse_uav_tpu.dcnn.ops.roi_align")
troi = importlib.import_module("apse_uav_torch.dcnn.ops.roi_align")


@pytest.mark.parametrize("aligned", [False, True])
def test_roi_align_plane_matches_jax_and_the_product(aligned):
    """``roi_align_hwc(..., plane=p)`` against JAX's on the same map, boxes
    (inside, on the border, outside) and plane: within 1e-5 of the result's
    max-abs (XLA fuses the weighted sums into multiply-adds: a few float32
    ulp, 1.1e-6 measured); and within 1e-5 of ROIAlign of ``feat *
    plane[..., None]`` (the modulation is exact up to rounding)."""
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(20, 24, 6)).astype(np.float32)
    plane = rng.uniform(0, 1, (20, 24)).astype(np.float32)
    boxes = np.asarray([[2.0, 3.0, 15.5, 11.0], [-3.0, -2.0, 6.0, 9.0], [18.0, 14.0, 30.0, 25.0],
                        [5.0, 5.0, 5.5, 5.2]], np.float32)
    want = np.asarray(jroi.roi_align_hwc(jnp.asarray(feat), jnp.asarray(boxes), 5, 0.5, 2, aligned,
                                         plane=jnp.asarray(plane)))
    got = troi.roi_align_hwc(torch.from_numpy(feat), torch.from_numpy(boxes), 5, 0.5, 2, aligned,
                             plane=torch.from_numpy(plane)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    product = troi.roi_align_hwc(torch.from_numpy(feat * plane[..., None]), torch.from_numpy(boxes), 5, 0.5, 2,
                                 aligned).numpy()
    assert np.abs(got - product).max() <= 1e-5 * scale


def test_roi_features_match_jax():
    """``roi_features`` of the small R50-FPN on given boxes against JAX's
    ``mode="roi_features"``: (B, N, 1024) float32 within 1e-4 of the
    features' max-abs (the maps agree to ~1e-6, the bf16 pooling rows
    equal)."""
    jcfg = tiny_dcnn_config(num_classes=3)
    ckpt = detectron2_checkpoint(0, 50, 3)
    jm, jp = jax_mask_rcnn(jcfg, ckpt)
    images = np.random.default_rng(0).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    boxes = np.asarray([[[4.0, 4.0, 30.0, 22.0], [10.0, 12.0, 60.0, 50.0], [0.0, 0.0, 8.0, 8.0]]] * 2, np.float32)
    boxes[1] += 3.0
    want = np.asarray(jax.jit(lambda p, x, b: jm.apply({"params": p}, x, mode="roi_features", gt={"boxes": b}))(
        jp, jnp.asarray(images), jnp.asarray(boxes)))
    model = MaskRCNN(port_config(jcfg)).eval()
    tW.load_detectron2(model, ckpt)
    got = build_roi_feature_fn(model)(images, boxes)
    assert got.shape == want.shape == (2, 3, 1024) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def _cowc_dir(tmp_path, p=32):
    """``tests/test_data.py``'s COWC tree: one 2-patch image, cars as
    saturated-red pixels (one at the corner, to exercise the clip),
    negatives as saturated-blue pixels."""
    Image.fromarray(np.full((p * 2, p, 3), 120, np.uint8)).save(tmp_path / "big.png")
    cars = np.zeros((p * 2, p, 3), np.uint8)
    for r, c in ((5, 6), (20, 3), (0, 0), (p + 8, 10), (p + 30, 20)):
        cars[r, c, 0] = 255
    Image.fromarray(cars).save(tmp_path / "big_Annotated_Cars.png")
    neg = np.zeros((p * 2, p, 3), np.uint8)
    for r, c in ((12, 25), (28, 14), (p + 2, 2), (p + 16, 28)):
        neg[r, c, 2] = 255
    Image.fromarray(neg).save(tmp_path / "big_Annotated_Negatives.png")


def test_cowc_loader_matches_jax(tmp_path):
    """The same tree and fake feature function (box centre and area) through
    both loaders: the same chunks of padded boxes handed to the function,
    and the same batches (2 of 2 cars + 2 negatives), equal."""
    _cowc_dir(tmp_path)

    def fake(captured, xp):
        def fn(images, boxes):
            captured.append(np.asarray(boxes[0]).copy())
            b = np.asarray(boxes[0])
            f = np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2, (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])],
                         axis=-1)
            return xp(f[None])
        return fn

    jcap, tcap = [], []
    jb = list(JLoader(fake(jcap, jnp.asarray), str(tmp_path), patch_size=32, bbox_width=4, batch_size=4, chunk=8))
    tb = list(CowcRoiFeaturesLoader(fake(tcap, torch.from_numpy), str(tmp_path), patch_size=32, bbox_width=4,
                                    batch_size=4, chunk=8))
    assert len(jcap) == len(tcap) == 2
    for a, b in zip(jcap, tcap):
        np.testing.assert_array_equal(a, b)
    assert len(tb) == len(jb) == 2
    for (jf, jl), (tf, tl) in zip(jb, tb):
        np.testing.assert_array_equal(tf, np.asarray(jf))
        assert tl.tolist() == np.asarray(jl).tolist() == [1, 1, 0, 0]
    assert any(np.allclose(f, [2, 2, 16]) for f in tb[0][0])
