"""PyTorch port, the training losses against the JAX package on the CPU.

The triplet losses and their gradients against ``jax.grad``; the RPN's
anchor labels and balanced sampling (bit-identical masks from the same key),
its losses, the ROI heads' proposal matching and losses, and the GT mask
targets, each fed the same numpy inputs.  Tolerances are stated per test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apse_uav_tpu.dcnn import losses as jl
from apse_uav_tpu.dcnn.config import mask_rcnn_r50_fpn
from apse_uav_tpu.dcnn.models import roi_heads as jrh, rpn as jrpn
from apse_uav_torch.dcnn import losses as tl
from apse_uav_torch.dcnn.models import roi_heads as trh, rpn as trpn

jmr = importlib.import_module("apse_uav_tpu.dcnn.models.mask_rcnn")

CFG = mask_rcnn_r50_fpn(num_classes=3)


def _embeddings(n=12, d=16, seed=0, dup=True):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    if dup:
        e[3] = e[2]  # one pair at distance exactly 0
    labels = rng.integers(0, 4, n)
    valid = np.ones(n, bool)
    valid[-3:] = False
    return labels, e, valid


@pytest.mark.parametrize("kind", ["hard", "all"])
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_triplet_losses_and_gradients_match_jax(kind, squared, with_valid):
    """Loss within 1e-6 relative, gradient within 1e-6 of its max-abs; the
    zero distance gives a finite gradient."""
    labels, e, valid = _embeddings()
    v = valid if with_valid else None

    def jfn(x):
        if kind == "hard":
            return jl.batch_hard_triplet_loss(jnp.asarray(labels), x, 0.2, squared,
                                              None if v is None else jnp.asarray(v))
        return jl.batch_all_triplet_loss(jnp.asarray(labels), x, 0.2, squared,
                                         None if v is None else jnp.asarray(v))[0]

    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(e))
    x = torch.from_numpy(e).requires_grad_(True)
    tv = None if v is None else torch.from_numpy(v)
    if kind == "hard":
        got = tl.batch_hard_triplet_loss(torch.from_numpy(labels), x, 0.2, squared, tv)
    else:
        got = tl.batch_all_triplet_loss(torch.from_numpy(labels), x, 0.2, squared, tv)[0]
    (g,) = torch.autograd.grad(got, x)
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want)) + 1e-7
    want_g = np.asarray(want_g)
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(g.numpy(), want_g, rtol=0, atol=1e-6 * np.abs(want_g).max() + 1e-9)
    if kind == "all":
        frac = tl.batch_all_triplet_loss(torch.from_numpy(labels), x.detach(), 0.2, squared, tv)[1]
        want_frac = jl.batch_all_triplet_loss(jnp.asarray(labels), jnp.asarray(e), 0.2, squared,
                                              None if v is None else jnp.asarray(v))[1]
        assert abs(float(frac) - float(want_frac)) < 1e-7


def test_masked_sqrt_gradient_is_zero_at_zero_distance():
    """Two equal embeddings: their distance is exactly 0 and so is its
    gradient (the masked square root), as in JAX; no NaN anywhere."""
    e = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]], requires_grad=True)
    d = tl.pairwise_distances(e)
    (g,) = torch.autograd.grad(d[0, 1], e)
    assert float(d[0, 1]) == 0.0 and torch.all(g == 0)
    (jg,) = [np.asarray(jax.grad(lambda x: jl.pairwise_distances(x)[0, 1])(jnp.asarray(e.detach().numpy())))]
    np.testing.assert_array_equal(g.numpy(), jg)


def _level_shapes(hw=(64, 96)):
    return {f"p{i}": (hw[0] // 2**i, hw[1] // 2**i) for i in range(2, 7)}


def _gt(b=2, g=5, seed=0, hw=(64, 96)):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, g, 4), np.float32)
    xy = rng.uniform(0, [hw[1] - 20, hw[0] - 20], (b, g, 2))
    wh = rng.uniform(8, 40, (b, g, 2))
    boxes[..., :2], boxes[..., 2:] = xy, xy + wh
    valid = np.zeros((b, g), bool)
    valid[:, :3] = True
    valid[1, 3] = True
    classes = rng.integers(0, CFG.roi.num_classes, (b, g)).astype(np.int32)
    return boxes.astype(np.float32), classes, valid


def _rpn_outputs(b=2, seed=1, hw=(64, 96)):
    rng = np.random.default_rng(seed)
    shapes = _level_shapes(hw)
    a = len(CFG.anchors.aspect_ratios)
    logits = {n: rng.normal(size=(b, h * w * a)).astype(np.float32) for n, (h, w) in shapes.items()}
    deltas = {n: (0.2 * rng.normal(size=(b, h * w * a, 4))).astype(np.float32) for n, (h, w) in shapes.items()}
    return shapes, logits, deltas


def _anchors(shapes):
    names = sorted(shapes)
    return np.concatenate([np.asarray(jrpn.grid_anchors(tuple(shapes[n]), jrpn.LEVEL_STRIDES[n], CFG.anchors.sizes[i],
                                                        tuple(CFG.anchors.aspect_ratios), CFG.anchors.offset))
                           for i, n in enumerate(names)])


def test_label_and_subsample_bit_identical():
    """Anchor labels, matched indices and the sampled mask from the same keys
    are identical to JAX's (ties among the uniforms included)."""
    shapes, _, _ = _rpn_outputs()
    anchors = _anchors(shapes)
    boxes, _, valid = _gt()
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), 2))
    t_lab, t_match = trpn.label_anchors(torch.from_numpy(anchors), torch.from_numpy(boxes), torch.from_numpy(valid),
                                        0.7, 0.3)
    t_sel = trpn.subsample_labels(keys, t_lab, 256, 0.5)
    # Small budgets too, so that positives and negatives are both cut.
    t_sel_small = trpn.subsample_labels(keys, t_lab, 8, 0.25)
    for i in range(boxes.shape[0]):
        lab, match = jrpn.label_anchors(jnp.asarray(anchors), jnp.asarray(boxes[i]), jnp.asarray(valid[i]), 0.7, 0.3)
        np.testing.assert_array_equal(t_lab[i].numpy(), np.asarray(lab))
        np.testing.assert_array_equal(t_match[i].numpy(), np.asarray(match))
        np.testing.assert_array_equal(t_sel[i].numpy(), np.asarray(jrpn.subsample_labels(keys[i], lab, 256, 0.5)))
        np.testing.assert_array_equal(t_sel_small[i].numpy(),
                                      np.asarray(jrpn.subsample_labels(keys[i], lab, 8, 0.25)))
    assert int(t_sel_small.sum()) == 16 and int((t_lab == 1).sum()) > 0


def test_rpn_losses_match_jax():
    """Both RPN losses of each image within 1e-6 relative, and their
    gradients with respect to logits and deltas within 1e-6 of their max-abs."""
    shapes, logits, deltas = _rpn_outputs()
    boxes, _, valid = _gt()
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(4), 2))
    tlog = {k: torch.from_numpy(v).requires_grad_(True) for k, v in logits.items()}
    tdel = {k: torch.from_numpy(v).requires_grad_(True) for k, v in deltas.items()}
    got = trpn.rpn_losses(keys, tlog, tdel, shapes, torch.from_numpy(boxes), torch.from_numpy(valid), CFG.anchors,
                          CFG.rpn)
    tg = torch.autograd.grad(sum(v.sum() for v in got.values()), list(tlog.values()) + list(tdel.values()))
    for i in range(2):
        def f(lg, dl):
            return jrpn.rpn_losses(keys[i], lg, dl, shapes, jnp.asarray(boxes[i]), jnp.asarray(valid[i]), CFG.anchors,
                                   CFG.rpn)
        want = f({k: jnp.asarray(v[i]) for k, v in logits.items()}, {k: jnp.asarray(v[i]) for k, v in deltas.items()})
        for k in want:
            assert abs(float(got[k][i]) - float(want[k])) <= 1e-6 * abs(float(want[k])), k
        jg = jax.grad(lambda lg, dl: sum(f(lg, dl).values()), argnums=(0, 1))(
            {k: jnp.asarray(v[i]) for k, v in logits.items()}, {k: jnp.asarray(v[i]) for k, v in deltas.items()})
        flat = [np.asarray(jg[0][k]) for k in logits] + [np.asarray(jg[1][k]) for k in deltas]
        for a, b in zip(tg, flat):
            np.testing.assert_allclose(a[i].numpy(), b, rtol=0, atol=1e-6 * np.abs(b).max() + 1e-12)


def test_select_proposals_training_budgets_match_jax():
    """``training=True`` takes the ``*_topk_train`` budgets: the same boxes,
    order and validity as JAX's training selection."""
    import dataclasses

    shapes, logits, deltas = _rpn_outputs()
    rpn = dataclasses.replace(CFG.rpn, pre_nms_topk_train=50, post_nms_topk_train=40, pre_nms_topk_test=10,
                              post_nms_topk_test=5)
    boxes, scores, valid = trpn.select_proposals({k: torch.from_numpy(v) for k, v in logits.items()},
                                                 {k: torch.from_numpy(v) for k, v in deltas.items()}, shapes,
                                                 (64, 96), CFG.anchors, rpn, training=True)
    assert boxes.shape == (2, 40, 4)
    for i in range(2):
        jb, js, jv = jrpn.select_proposals({k: jnp.asarray(v[i]) for k, v in logits.items()},
                                           {k: jnp.asarray(v[i]) for k, v in deltas.items()}, shapes, (64, 96),
                                           CFG.anchors, rpn, training=True)
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jv))
        np.testing.assert_allclose(boxes[i].numpy(), np.asarray(jb), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(scores[i].numpy(), np.asarray(js))


def _sample_inputs(seed=5, p=40):
    rng = np.random.default_rng(seed)
    boxes, classes, valid = _gt(seed=seed)
    props = np.repeat(boxes, p // boxes.shape[1], axis=1)
    props = (props + rng.normal(0, 6, props.shape)).astype(np.float32)
    props[..., 2:] = np.maximum(props[..., 2:], props[..., :2] + 2)
    pvalid = rng.uniform(size=props.shape[:2]) > 0.1
    return props, pvalid, boxes, classes, valid


def test_match_proposals_to_gt_identical():
    """The sampled rows, their matches, fg flags and classes are JAX's, for
    a budget above and below the number of candidates."""
    import dataclasses

    props, pvalid, boxes, classes, valid = _sample_inputs()
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(6), 2))
    for budget in (16, 64):
        roi = dataclasses.replace(CFG.roi, batch_size_per_image=budget)
        got = trh.match_proposals_to_gt(keys, torch.from_numpy(props), torch.from_numpy(pvalid),
                                        torch.from_numpy(boxes), torch.from_numpy(classes), torch.from_numpy(valid), roi)
        for i in range(2):
            want = jrh.match_proposals_to_gt(jnp.asarray(props[i]), jnp.asarray(pvalid[i]), jnp.asarray(boxes[i]),
                                             jnp.asarray(classes[i]), jnp.asarray(valid[i]), roi, keys[i])
            for k in want:
                np.testing.assert_array_equal(got[k][i].numpy(), np.asarray(want[k]), err_msg=k)


def test_box_and_mask_losses_and_mask_targets_match_jax():
    """box_head_losses and mask_head_loss within 1e-6 relative (and their
    gradients within 1e-6 of the max-abs); the cropped mask targets identical."""
    props, pvalid, boxes, classes, valid = _sample_inputs()
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(7), 2))
    roi = CFG.roi
    sample = trh.match_proposals_to_gt(keys, torch.from_numpy(props), torch.from_numpy(pvalid),
                                       torch.from_numpy(boxes), torch.from_numpy(classes), torch.from_numpy(valid), roi)
    b, s = sample["boxes"].shape[:2]
    k = roi.num_classes
    rng = np.random.default_rng(8)
    cls_logits = rng.normal(size=(b, s, k + 1)).astype(np.float32)
    deltas = rng.normal(size=(b, s, k, 4)).astype(np.float32)
    mask_logits = rng.normal(size=(b, s, k, 28, 28)).astype(np.float32)
    hw = (64, 96)
    masks = rng.uniform(size=(b, boxes.shape[1], 32, 48)) > 0.5  # masks at half the image resolution
    tc, td, tm = (torch.from_numpy(x).requires_grad_(True) for x in (cls_logits, deltas, mask_logits))
    target = trh.crop_resize_masks(torch.from_numpy(masks), sample["matched_gt"], sample["boxes"], hw, 28)
    got = trh.box_head_losses(tc, td, sample, torch.from_numpy(boxes), roi)
    got["loss_mask"] = trh.mask_head_loss(tm, sample, target, roi)
    tg = torch.autograd.grad(sum(v.sum() for v in got.values()), [tc, td, tm])
    for i in range(b):
        js = {kk: jnp.asarray(v[i].numpy()) for kk, v in sample.items()}
        jt = jmr._crop_resize_masks(jnp.asarray(masks[i])[js["matched_gt"]], js["boxes"], hw, 28)
        np.testing.assert_array_equal(target[i].numpy(), np.asarray(jt))
        jt_chunked = jmr._gather_crop_resize_masks(jnp.asarray(masks[i]), js["matched_gt"], js["boxes"], hw, 28)
        np.testing.assert_array_equal(target[i].numpy(), np.asarray(jt_chunked))

        def f(c, d, m):
            out = jrh.box_head_losses(c, d, js, jnp.asarray(boxes[i]), roi)
            out["loss_mask"] = jrh.mask_head_loss(m, js, jt, roi)
            return out

        args = (jnp.asarray(cls_logits[i]), jnp.asarray(deltas[i]), jnp.asarray(mask_logits[i]))
        want = f(*args)
        for kk in want:
            assert abs(float(got[kk][i]) - float(want[kk])) <= 1e-6 * abs(float(want[kk])), kk
        jg = jax.grad(lambda *a: sum(f(*a).values()), argnums=(0, 1, 2))(*args)
        for a, w in zip(tg, jg):
            w = np.asarray(w)
            np.testing.assert_allclose(a[i].numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())
    assert int(sample["fg"].sum()) > 0
