"""PyTorch port, Mask R-CNN R50-FPN against the JAX package on the CPU, stage
by stage, and the weight carriers between the packages.

One detectron2-format checkpoint (``utils.synthetic.detectron2_checkpoint``)
goes into both packages: into JAX through ``map_detectron2_weights`` +
``load_into_params``, into the port through ``weights.load_detectron2``.
Each stage of the port is fed the JAX stage's inputs, so its discrete
outputs (proposal order and validity, classes, detection validity) must be
identical; float tolerances are stated per test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import e2e_frames, jax_mask_rcnn, port_config, tiny_dcnn_config

from apse_uav_tpu.dcnn import weights as jW
from apse_uav_tpu.dcnn.models import mask_rcnn as jmask_rcnn, roi_heads as jrh
from apse_uav_tpu.dcnn.models.association import AssociationHead as JAssociationHead
from apse_uav_tpu.dcnn.models.mask_rcnn import RPN_LEVELS
from apse_uav_tpu.dcnn.models.rpn import select_proposals as j_select_proposals
from apse_uav_torch import convert
from apse_uav_torch.dcnn import weights as tW
from apse_uav_torch.dcnn.config import mask_rcnn_r101_fpn, mask_rcnn_r101_c4
from apse_uav_torch.dcnn.models import roi_heads as trh
from apse_uav_torch.dcnn.models.association import AssociationHead
from apse_uav_torch.dcnn.models.mask_rcnn import MaskRCNN, build_mask_rcnn, run_inference
from apse_uav_torch.dcnn.models.rpn import select_proposals as t_select_proposals
from apse_uav_torch.utils.synthetic import detectron2_checkpoint

HW = (64, 64)


def _jax_stages(model, params, images):
    """Every intermediate of the JAX MaskRCNN's inference, in one jit."""
    cfg = model.cfg

    def run(m, images):
        feats = m.backbone(m._normalize(images))
        logits, deltas = m.rpn_head({n: feats[n] for n in RPN_LEVELS})
        level_shapes = {n: tuple(feats[n].shape[1:3]) for n in RPN_LEVELS}

        def per_image(lg, dl, fi):
            boxes, scores, valid = j_select_proposals(lg, dl, level_shapes, HW, cfg.anchors, cfg.rpn)
            pooled = jrh.fpn_roi_align(fi, boxes, cfg.roi.box_pooler_resolution, cfg.roi.pooler_sampling_ratio)
            cls_logits, box_deltas = m.box_head(pooled)
            det = jrh.box_inference(cls_logits, box_deltas, boxes, valid, HW, cfg.roi)
            mask_pooled = jrh.fpn_roi_align(fi, det["boxes"], cfg.roi.mask_pooler_resolution,
                                            cfg.roi.pooler_sampling_ratio)
            return {"proposals": boxes, "proposal_scores": scores, "proposal_valid": valid, "pooled": pooled,
                    "cls_logits": cls_logits, "box_deltas": box_deltas, "mask_pooled": mask_pooled,
                    "mask_logits": m.mask_head(mask_pooled), **{f"det_{k}": v for k, v in det.items()}}

        out = jax.vmap(per_image)(logits, deltas, {n: feats[n] for n in jrh.POOL_LEVELS})
        return {**out, "feats": feats, "logits": logits, "deltas": deltas}

    out = jax.jit(lambda p, x: model.apply({"params": p}, x, method=run))(params, images)
    dets, _ = jmask_rcnn.run_inference(model, params, images)
    return jax.tree_util.tree_map(np.asarray, out), jax.tree_util.tree_map(np.asarray, dets)


@pytest.fixture(scope="module")
def models():
    jcfg = tiny_dcnn_config(num_classes=3)
    ckpt = detectron2_checkpoint(0, 50, 3)
    jmodel, jparams = jax_mask_rcnn(jcfg, ckpt)
    tmodel = MaskRCNN(port_config(jcfg)).eval()
    missing, unused = tW.load_detectron2(tmodel, ckpt)
    assert not missing and not unused
    images = np.random.default_rng(0).uniform(0, 255, (2, *HW, 3)).astype(np.float32)
    stages, dets = _jax_stages(jmodel, jparams, jnp.asarray(images))
    return {"jcfg": jcfg, "ckpt": ckpt, "jparams": jparams, "tmodel": tmodel, "images": images, "j": stages,
            "jdets": dets}


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / max(np.abs(np.asarray(want)).max(), 1e-12))


def test_backbone_and_rpn_head_match_jax(models):
    """res2-res5 and p2-p6 of the port's backbone, and its RPN head on them:
    each map within 1e-4 of its max-abs."""
    m, j = models["tmodel"], models["j"]
    with torch.no_grad():
        feats = m.features(_t(models["images"]))
        logits, deltas = m.proposal_generator["rpn_head"]({n: feats[n] for n in RPN_LEVELS})
    assert set(feats) == set(j["feats"])
    for name, want in j["feats"].items():
        assert feats[name].shape == want.shape, name
        assert _rel(feats[name].numpy(), want) <= 1e-4, (name, _rel(feats[name].numpy(), want))
    for name in RPN_LEVELS:
        assert _rel(logits[name].numpy(), j["logits"][name]) <= 1e-4, name
        assert _rel(deltas[name].numpy(), j["deltas"][name]) <= 1e-4, name


def test_select_proposals_on_jax_outputs(models):
    """The port's selection on the JAX logits and deltas: identical order and
    validity (and so identical scores), boxes within 1e-4 px."""
    j, cfg = models["j"], port_config(models["jcfg"])
    level_shapes = {n: j["feats"][n].shape[1:3] for n in RPN_LEVELS}
    boxes, scores, valid = t_select_proposals({n: _t(j["logits"][n]) for n in RPN_LEVELS},
                                              {n: _t(j["deltas"][n]) for n in RPN_LEVELS}, level_shapes, HW,
                                              cfg.anchors, cfg.rpn)
    np.testing.assert_array_equal(valid.numpy(), j["proposal_valid"])
    np.testing.assert_array_equal(scores.numpy(), j["proposal_scores"])
    np.testing.assert_allclose(boxes.numpy(), j["proposals"], rtol=0, atol=1e-4)


def test_fpn_roi_align_on_jax_outputs(models):
    """Box and mask pooling on the JAX maps and boxes: within 1e-5 of the maps' max-abs."""
    j, cfg = models["j"], models["jcfg"].roi
    feats = {n: _t(j["feats"][n]) for n in trh.POOL_LEVELS}
    scale = max(np.abs(j["feats"][n]).max() for n in trh.POOL_LEVELS)
    pooled = trh.fpn_roi_align(feats, _t(j["proposals"]), cfg.box_pooler_resolution, cfg.pooler_sampling_ratio)
    np.testing.assert_allclose(pooled.numpy(), j["pooled"], rtol=0, atol=1e-5 * scale)
    mask_pooled = trh.fpn_roi_align(feats, _t(j["det_boxes"]), cfg.mask_pooler_resolution, cfg.pooler_sampling_ratio)
    np.testing.assert_allclose(mask_pooled.numpy(), j["mask_pooled"], rtol=0, atol=1e-5 * scale)


def test_box_and_mask_heads_on_jax_inputs(models):
    """BoxHead + BoxPredictor and MaskHead on the JAX pooled features: each
    output within 1e-5 of its max-abs."""
    j, heads = models["j"], models["tmodel"].roi_heads
    nb, p = j["pooled"].shape[:2]
    with torch.no_grad():
        cls_logits, deltas = heads.box_predictor(heads.box_head(_t(j["pooled"]).reshape(nb * p, -1)))
        mask_logits = heads.mask_head(_t(j["mask_pooled"]).reshape(-1, *j["mask_pooled"].shape[2:]))
    assert _rel(cls_logits.reshape(nb, p, -1).numpy(), j["cls_logits"]) <= 1e-5
    assert _rel(deltas.reshape(j["box_deltas"].shape).numpy(), j["box_deltas"]) <= 1e-5
    assert _rel(mask_logits.reshape(j["mask_logits"].shape).numpy(), j["mask_logits"]) <= 1e-5


def test_box_inference_on_jax_outputs(models):
    """Identical classes and validity, boxes within 1e-4 px, scores within 1e-6."""
    j, cfg = models["j"], port_config(models["jcfg"]).roi
    det = trh.box_inference(_t(j["cls_logits"]), _t(j["box_deltas"]), _t(j["proposals"]), _t(j["proposal_valid"]),
                            HW, cfg)
    np.testing.assert_array_equal(det["valid"].numpy(), j["det_valid"])
    np.testing.assert_array_equal(det["classes"].numpy(), j["det_classes"])
    np.testing.assert_allclose(det["boxes"].numpy(), j["det_boxes"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(det["scores"].numpy(), j["det_scores"], rtol=0, atol=1e-6)
    assert j["det_valid"].any()


def test_inference_matches_jax(models):
    """The whole port model against the JAX ``inference`` mode: identical
    validity and classes, boxes within 1e-3 px, scores within 1e-4, masks
    (the sigmoid of each detection's class channel) within 1e-3: the
    backbone's float32 rounding (~1e-5 of its maps) passes through every
    head."""
    with torch.no_grad():
        det, feats = models["tmodel"].inference(_t(models["images"]))
    want = models["jdets"]
    np.testing.assert_array_equal(det["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(det["classes"].numpy(), want["classes"])
    np.testing.assert_allclose(det["boxes"].numpy(), want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(det["scores"].numpy(), want["scores"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(det["masks"].numpy(), want["masks"], rtol=0, atol=1e-3)
    assert det["masks"].shape == (2, 4, 28, 28)


def test_build_mask_rcnn_and_run_inference_match_jax(models):
    """``build_mask_rcnn`` + ``run_inference`` against JAX's ``run_inference``
    (the fixture's detections) at test_inference_matches_jax's bounds, and
    p2 within 1e-4 of its max-abs; no autograd graph; the default device
    is cuda."""
    model = build_mask_rcnn(port_config(models["jcfg"]), device="cpu")
    assert not model.training
    missing, unused = tW.load_detectron2(model, models["ckpt"])
    assert not missing and not unused
    det, feats = run_inference(model, _t(models["images"]))
    assert not det["boxes"].requires_grad and not feats["p2"].requires_grad
    want = models["jdets"]
    np.testing.assert_array_equal(det["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(det["classes"].numpy(), want["classes"])
    np.testing.assert_allclose(det["boxes"].numpy(), want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(det["scores"].numpy(), want["scores"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(det["masks"].numpy(), want["masks"], rtol=0, atol=1e-3)
    assert _rel(feats["p2"].numpy(), models["j"]["feats"]["p2"]) <= 1e-4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_mask_rcnn(port_config(models["jcfg"]))


def test_weight_carriers_both_ways(models):
    """JAX parameters -> ``convert.mask_rcnn_state_dict`` give back the
    checkpoint bit for bit (conv layouts, Dense transposes and the
    ConvTranspose flip undone), hence the same port model; the JAX config
    carries across; an unknown parameter path raises."""
    flat = jW.flatten(jax.tree_util.tree_map(np.asarray, models["jparams"]))
    sd = convert.mask_rcnn_state_dict(flat)
    ckpt = models["ckpt"]
    assert set(sd) == set(ckpt)
    for k, v in sd.items():
        np.testing.assert_array_equal(v, ckpt[k], err_msg=k)
    own = models["tmodel"].state_dict()
    assert all(torch.equal(own[k], torch.from_numpy(v)) for k, v in sd.items())
    with pytest.raises(ValueError, match="no port parameter"):
        convert.mask_rcnn_state_dict({"backbone/other/kernel": np.zeros(1)})
    assert convert.model_config(dataclasses.asdict(models["jcfg"])) == port_config(models["jcfg"])
    with pytest.raises(ValueError, match="no field"):
        convert.model_config({**dataclasses.asdict(models["jcfg"]), "unknown": 1})


def test_association_head_matches_jax():
    """The port's AssociationHead with ``convert.association_state_dict`` of
    random JAX parameters: within 1e-5 of the max-abs, unit norm."""
    rng = np.random.default_rng(7)
    head = JAssociationHead(embedding_dim=16)
    rois = rng.normal(size=(5, 8, 4, 4)).astype(np.float32)
    params = head.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 4, 4)))["params"]
    want = np.asarray(head.apply({"params": params}, jnp.asarray(rois)))
    port = AssociationHead(8 * 16, 16)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in convert.association_state_dict(
        jW.flatten(jax.tree_util.tree_map(np.asarray, params))).items()})
    with torch.no_grad():
        got = port(_t(rois)).numpy()
    assert _rel(got, want) <= 1e-5
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_detectron2_checkpoint_seeded_finite_and_decisive():
    """Deterministic in its seed; an R101 trunk on 64x64 stays finite and
    O(1); on the end-to-end frames the class scores of the detections are
    separated from each other and from the threshold by more than 1e-3."""
    a, b, c = (detectron2_checkpoint(s, 101, 4) for s in (5, 5, 6))
    assert a.keys() == b.keys() == c.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["backbone.bottom_up.stem.conv1.weight"], c["backbone.bottom_up.stem.conv1.weight"])
    m = MaskRCNN(mask_rcnn_r101_fpn(4)).eval()
    assert tW.load_detectron2(m, a) == ([], [])
    images = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        feats = m.features(images)
    for name, f in feats.items():
        assert torch.isfinite(f).all(), name
        assert 0.1 < float(f.std()) and float(f.abs().max()) < 100.0, (name, float(f.std()), float(f.abs().max()))

    cfg = port_config(tiny_dcnn_config(num_classes=2, score_thresh=0.5))
    m50 = MaskRCNN(cfg).eval()
    tW.load_detectron2(m50, detectron2_checkpoint(0, 50, 2))
    frames = torch.from_numpy(e2e_frames().astype(np.float32))
    with torch.no_grad():
        det, _ = m50.inference(frames[:, :64, :128])
    for s, v in zip(det["scores"].numpy(), det["valid"].numpy()):
        s = np.sort(s[v])
        assert len(s) >= 1
        assert np.diff(s).min(initial=1.0) > 1e-3 and (s - 0.5).min() > 1e-3, s


def test_unported_configs_raise():
    """R101-C4 builds through ``build_model`` (as ``MaskRCNNC4``, with
    detectron2's C4 names); ``MaskRCNN`` refuses a C4 config, and an unknown
    architecture raises in both."""
    from apse_uav_torch.dcnn.models.c4 import MaskRCNNC4, build_model

    cfg = mask_rcnn_r101_c4(4)
    m = build_model(cfg)
    assert isinstance(m, MaskRCNNC4)
    names = set(m.state_dict())
    assert {"backbone.res4.22.conv3.weight", "roi_heads.res5.2.conv3.weight",
            "roi_heads.box_predictor.cls_score.weight", "roi_heads.mask_head.deconv.weight"} <= names
    assert not any(k.startswith(("backbone.res5", "backbone.bottom_up", "roi_heads.box_head")) for k in names)
    assert isinstance(build_model(mask_rcnn_r101_fpn(4)), MaskRCNN)
    with pytest.raises(ValueError, match="build_model"):
        MaskRCNN(cfg)
    for make in (build_model, MaskRCNN):
        with pytest.raises(ValueError, match="architecture"):
            make(dataclasses.replace(cfg, architecture="dc5"))


# -- bfloat16 compute (compute_dtype="bfloat16") ---------------------------------


def _bt(x):
    """A JAX output as a torch tensor, bfloat16 kept bfloat16 (exactly)."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x).astype(np.float32)


@pytest.fixture(scope="module")
def bf16_models(models):
    """The same checkpoint and images in both packages with compute_dtype="bfloat16"."""
    jcfg = dataclasses.replace(models["jcfg"], compute_dtype="bfloat16")
    jmodel, jparams = jax_mask_rcnn(jcfg, models["ckpt"])
    tmodel = MaskRCNN(port_config(jcfg)).eval()
    tW.load_detectron2(tmodel, models["ckpt"])
    stages, dets = _jax_stages(jmodel, jparams, jnp.asarray(models["images"]))
    return {"jcfg": jcfg, "tmodel": tmodel, "j": stages, "jdets": dets}


def test_bf16_backbone_matches_jax(bf16_models, models):
    """bf16 res2-res5 and p2-p6 against the reference's bf16 path: bfloat16
    maps, each within 3e-2 of its max-abs.  The two libraries accumulate a
    convolution in different orders, which flips the bf16 rounding (2^-8
    relative) of ~1e-4 of the outputs a layer; 40+ layers amplify the flips
    to 1.3e-2 of max-abs (measured), the size of the reference's own bf16
    gap to its float32 maps (1.2e-2, checked here too)."""
    m, j = bf16_models["tmodel"], bf16_models["j"]
    with torch.no_grad():
        feats = m.features(_t(models["images"]))
    for name, want in j["feats"].items():
        assert feats[name].dtype == torch.bfloat16 and want.dtype.name == "bfloat16", name
        assert _rel(_f32(feats[name]), _f32(want)) <= 3e-2, (name, _rel(_f32(feats[name]), _f32(want)))
        assert _rel(_f32(want), models["j"]["feats"][name]) <= 3e-2, name


def test_bf16_rpn_and_heads_on_jax_inputs(bf16_models):
    """Each bf16 stage on the reference's bf16 inputs.  RPN head: logits and
    deltas bfloat16, within 8e-3 of their max-abs (two bf16 steps).  Proposal
    selection on the reference's logits and deltas: identical order, validity
    and bf16 scores (ties by the lower index), float32 boxes within 0.1 px
    (bf16 deltas, exp in bf16).  ROIAlign float32 within 1e-5; the box head
    float32 on bf16-rounded inputs, within 1e-5; mask logits bfloat16 within
    8e-3; box inference identical classes and validity."""
    m, j, cfg = bf16_models["tmodel"], bf16_models["j"], port_config(bf16_models["jcfg"])
    feats = {n: _bt(v) for n, v in j["feats"].items()}
    with torch.no_grad():
        logits, deltas = m.proposal_generator["rpn_head"]({n: feats[n] for n in RPN_LEVELS})
    for name in RPN_LEVELS:
        assert logits[name].dtype == torch.bfloat16
        assert _rel(_f32(logits[name]), _f32(j["logits"][name])) <= 8e-3, name
        assert _rel(_f32(deltas[name]), _f32(j["deltas"][name])) <= 8e-3, name
    level_shapes = {n: j["feats"][n].shape[1:3] for n in RPN_LEVELS}
    boxes, scores, valid = t_select_proposals({n: _bt(j["logits"][n]) for n in RPN_LEVELS},
                                              {n: _bt(j["deltas"][n]) for n in RPN_LEVELS}, level_shapes, HW,
                                              cfg.anchors, cfg.rpn)
    assert scores.dtype == torch.bfloat16 and boxes.dtype == torch.float32
    np.testing.assert_array_equal(valid.numpy(), j["proposal_valid"])
    np.testing.assert_array_equal(_f32(scores), _f32(j["proposal_scores"]))
    np.testing.assert_allclose(boxes.numpy(), j["proposals"], rtol=0, atol=0.1)
    pooled = trh.fpn_roi_align({n: feats[n] for n in trh.POOL_LEVELS}, _t(j["proposals"]),
                               cfg.roi.box_pooler_resolution, cfg.roi.pooler_sampling_ratio)
    assert pooled.dtype == torch.float32 and _rel(pooled.numpy(), j["pooled"]) <= 1e-5
    heads = m.roi_heads
    nb, p = j["pooled"].shape[:2]
    with torch.no_grad():
        cls_logits, box_deltas = heads.box_predictor(heads.box_head(_t(j["pooled"]).reshape(nb * p, -1)))
        mask_logits = heads.mask_head(_t(j["mask_pooled"]).reshape(-1, *j["mask_pooled"].shape[2:]))
    assert cls_logits.dtype == torch.float32 and mask_logits.dtype == torch.bfloat16
    assert _rel(cls_logits.reshape(nb, p, -1).numpy(), j["cls_logits"]) <= 1e-5
    assert _rel(box_deltas.reshape(j["box_deltas"].shape).numpy(), j["box_deltas"]) <= 1e-5
    assert _rel(_f32(mask_logits).reshape(j["mask_logits"].shape), _f32(j["mask_logits"])) <= 8e-3
    det = trh.box_inference(_t(j["cls_logits"]), _t(j["box_deltas"]), _t(j["proposals"]), _t(j["proposal_valid"]),
                            HW, cfg.roi)
    np.testing.assert_array_equal(det["valid"].numpy(), j["det_valid"])
    np.testing.assert_array_equal(det["classes"].numpy(), j["det_classes"])
    np.testing.assert_allclose(det["boxes"].numpy(), j["det_boxes"], rtol=0, atol=1e-4)


def test_bf16_inference_dtypes_match_jax(bf16_models, models):
    """The whole bf16 model: the reference's output dtypes (boxes and scores
    float32, masks bfloat16, bf16 maps), the same detections valid, masks in
    [0, 1]."""
    with torch.no_grad():
        det, feats = bf16_models["tmodel"].inference(_t(models["images"]))
    want = bf16_models["jdets"]
    for k, v in want.items():
        got = str(det[k].dtype).replace("torch.", "")
        assert got == v.dtype.name or (k == "classes" and got == "int64"), (k, got, v.dtype)
    np.testing.assert_array_equal(det["valid"].numpy(), want["valid"])
    assert all(f.dtype == torch.bfloat16 for f in feats.values())
    assert 0.0 <= float(det["masks"].min()) and float(det["masks"].max()) <= 1.0


def test_paste_masks_matches_jax():
    """``roi_heads.paste_masks`` against the reference's on seeded 28x28
    probabilities and boxes inside, across and beyond an 80x100 image (a
    sub-pixel one too): the same boolean masks, pixel for pixel."""
    rng = np.random.default_rng(0)
    probs = rng.uniform(0, 1, (5, 28, 28)).astype(np.float32)
    boxes = np.asarray([[10, 5, 40, 30], [-5, -3, 20, 18], [50, 40, 90, 70], [0, 0, 100, 80],
                        [30.5, 20.2, 31.0, 20.9]], np.float32)
    want = np.asarray(jrh.paste_masks(jnp.asarray(probs), jnp.asarray(boxes), (80, 100)))
    got = trh.paste_masks(_t(probs), _t(boxes), (80, 100))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
