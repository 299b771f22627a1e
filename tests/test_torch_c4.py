"""PyTorch port, the C4 model family (``mask_rcnn_R_{50,101}_C4_3x.yaml``)
against the JAX package on the CPU: stage by stage, one training step with
the optimizer's trained and frozen sets, and the zoo-pickle import.

One seeded detectron2-format C4 checkpoint
(``utils.synthetic.detectron2_checkpoint(..., architecture="c4")``) goes
into both packages: into JAX through ``map_detectron2_weights_c4`` +
``load_into_params``, into the port through ``weights.load_detectron2``.
Each stage of the port is fed the JAX stage's inputs, so its discrete
outputs (proposal order and validity, classes, detection validity) must be
identical; float tolerances are stated per test.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import c4_config, jax_c4, port_config

from apse_uav_tpu.dcnn import weights as jW
from apse_uav_tpu.dcnn.models import roi_heads as jrh
from apse_uav_tpu.dcnn.models.c4 import MaskRCNNC4 as JMaskRCNNC4
from apse_uav_tpu.dcnn.models.rpn import select_proposals as j_select_proposals
from apse_uav_tpu.train import optim as joptim, steps as jsteps
from apse_uav_torch import convert
from apse_uav_torch.dcnn import flax_init, weights as tW
from apse_uav_torch.dcnn.models.c4 import MaskRCNNC4, build_model
from apse_uav_torch.dcnn.models.rpn import select_proposals as t_select_proposals
from apse_uav_torch.train import optim as toptim, steps as tsteps
from apse_uav_torch.utils.synthetic import detectron2_checkpoint

HW = (128, 128)


def _jax_stages(model, params, images):
    """Every intermediate of the JAX MaskRCNNC4's inference, in one jit."""
    cfg = model.cfg

    def run(m, images):
        feats = m.backbone(m._normalize(images))
        logits, deltas = m.rpn_head({"res4": feats["res4"]})
        logits = {k: v.astype(jnp.float32) for k, v in logits.items()}
        deltas = {k: v.astype(jnp.float32) for k, v in deltas.items()}
        level_shapes = {"res4": tuple(feats["res4"].shape[1:3])}

        def per_image(lg, dl, r4):
            boxes, scores, valid = j_select_proposals(lg, dl, level_shapes, HW, cfg.anchors, cfg.rpn)
            box_feats = m._roi_transform(r4, boxes).mean(axis=(1, 2))
            cls_logits, box_deltas = m.box_predictor(box_feats.astype(jnp.float32))
            det = jrh.box_inference(cls_logits, box_deltas, boxes, valid, HW, cfg.roi)
            mask_logits = m.mask_head(jnp.transpose(m._roi_transform(r4, det["boxes"]), (0, 3, 1, 2)))
            return {"proposals": boxes, "proposal_scores": scores, "proposal_valid": valid, "box_feats": box_feats,
                    "cls_logits": cls_logits, "box_deltas": box_deltas, "mask_logits": mask_logits,
                    **{f"det_{k}": v for k, v in det.items()}}

        out = jax.vmap(per_image)(logits, deltas, feats["res4"])
        return {**out, "feats": feats, "logits": logits, "deltas": deltas}

    out = jax.jit(lambda p, x: model.apply({"params": p}, x, method=run))(params, images)
    dets, _ = jax.jit(lambda p, x: model.apply({"params": p}, x, mode="inference"))(params, images)
    return jax.tree_util.tree_map(np.asarray, out), jax.tree_util.tree_map(np.asarray, dets)


@pytest.fixture(scope="module")
def models():
    jcfg = c4_config()
    ckpt = detectron2_checkpoint(0, 26, 3, architecture="c4")
    jmodel, jparams = jax_c4(jcfg, ckpt)
    tmodel = build_model(port_config(jcfg)).eval()
    assert isinstance(tmodel, MaskRCNNC4)
    assert tW.load_detectron2(tmodel, ckpt) == ([], [])
    images = np.random.default_rng(0).uniform(0, 255, (2, *HW, 3)).astype(np.float32)
    stages, dets = _jax_stages(jmodel, jparams, jnp.asarray(images))
    return {"jcfg": jcfg, "ckpt": ckpt, "jmodel": jmodel, "jparams": jparams, "tmodel": tmodel, "images": images,
            "j": stages, "jdets": dets}


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / max(np.abs(np.asarray(want)).max(), 1e-12))


def test_c4_backbone_and_rpn_head_match_jax(models):
    """res2-res4 of the port's trunk (no res5, no FPN) and its RPN head on
    res4 (15 anchors a cell): each map within 1e-4 of its max-abs."""
    m, j = models["tmodel"], models["j"]
    with torch.no_grad():
        feats = m.features(_t(models["images"]))
        logits, deltas, _ = m.rpn_outputs(feats)
    assert set(feats) == set(j["feats"]) == {"res2", "res3", "res4"}
    for name, want in j["feats"].items():
        assert feats[name].shape == want.shape, name
        assert _rel(feats[name].numpy(), want) <= 1e-4, (name, _rel(feats[name].numpy(), want))
    assert logits["res4"].shape == (2, 8 * 8 * 15)
    assert _rel(logits["res4"].numpy(), j["logits"]["res4"]) <= 1e-4
    assert _rel(deltas["res4"].numpy(), j["deltas"]["res4"]) <= 1e-4


def test_c4_proposals_on_jax_outputs(models):
    """Selection on the single res4 level (stride 16, every anchor size) on
    the JAX logits and deltas: identical order, validity and scores, boxes
    within 1e-4 px."""
    j, cfg = models["j"], port_config(models["jcfg"])
    boxes, scores, valid = t_select_proposals({"res4": _t(j["logits"]["res4"])}, {"res4": _t(j["deltas"]["res4"])},
                                              {"res4": (8, 8)}, HW, cfg.anchors, cfg.rpn)
    np.testing.assert_array_equal(valid.numpy(), j["proposal_valid"])
    np.testing.assert_array_equal(scores.numpy(), j["proposal_scores"])
    np.testing.assert_allclose(boxes.numpy(), j["proposals"], rtol=0, atol=1e-4)


def test_c4_res5_box_features_and_detections_on_jax_inputs(models):
    """ROIAlign(14, 1/16, not aligned) + res5 + the 7x7 mean on the JAX res4
    and proposals: box features within 1e-4 of their max-abs, class logits
    and deltas within 1e-4; ``detect`` on the same inputs gives the JAX
    detections (identical classes and validity, boxes within 1e-3 px) and
    14x14 masks (res5 rerun on the detection boxes) within 1e-4."""
    m, j, jd = models["tmodel"], models["j"], models["jdets"]
    res4 = _t(j["feats"]["res4"])
    with torch.no_grad():
        x5 = m.roi_transform(res4, _t(j["proposals"]))
        cls_logits, box_deltas = m.box_outputs(x5, 2, 16)
        det = m.detect({"res4": res4}, _t(j["proposals"]), _t(j["proposal_valid"]), HW)
    assert x5.shape == (32, 2048, 7, 7)
    assert _rel(x5.mean(dim=(2, 3)).numpy(), j["box_feats"].reshape(32, 2048)) <= 1e-4
    assert _rel(cls_logits.numpy(), j["cls_logits"]) <= 1e-4
    assert _rel(box_deltas.numpy(), j["box_deltas"]) <= 1e-4
    np.testing.assert_array_equal(det["valid"].numpy(), j["det_valid"])
    np.testing.assert_array_equal(det["classes"].numpy(), j["det_classes"])
    np.testing.assert_allclose(det["boxes"].numpy(), j["det_boxes"], rtol=0, atol=1e-3)
    assert det["masks"].shape == (2, 4, 14, 14) and det["masks"].dtype == torch.float32
    np.testing.assert_allclose(det["masks"].numpy(), jd["masks"], rtol=0, atol=1e-4)


def test_c4_inference_end_to_end_matches_jax(models):
    """The port's ``inference`` against the JAX model's on the same images:
    the same valid detections and classes, scores within 1e-5, boxes within
    1e-3 px, masks within 1e-4; the maps are res2-res4."""
    with torch.no_grad():
        det, feats = models["tmodel"].inference(_t(models["images"]))
    jd = models["jdets"]
    assert set(feats) == {"res2", "res3", "res4"}
    np.testing.assert_array_equal(det["valid"].numpy(), jd["valid"])
    np.testing.assert_array_equal(det["classes"].numpy(), jd["classes"])
    np.testing.assert_allclose(det["scores"].numpy(), jd["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(det["boxes"].numpy(), jd["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(det["masks"].numpy(), jd["masks"], rtol=0, atol=1e-4)


def test_c4_flax_init_matches_jax():
    """``mask_rcnn_init`` of a C4 config = ``MaskRCNNC4.init(PRNGKey(seed))``
    through ``convert``'s C4 names (``res5/...`` -> ``roi_heads.res5``,
    ``box_predictor/...``): every parameter present, zeros and ones exact,
    the draws within 4 ulp of their tensor's largest value on under 2 % of
    the values."""
    cfg = c4_config()
    jp = jax.jit(lambda k: JMaskRCNNC4(cfg=cfg).init(k, jnp.zeros((1, 64, 64, 3)), mode="inference")["params"])(
        jax.random.PRNGKey(5))
    want = convert.mask_rcnn_state_dict(jW.flatten(jax.tree_util.tree_map(np.asarray, jp)))
    got = flax_init.mask_rcnn_init(port_config(cfg), 5)
    assert set(got) == set(want) == set(build_model(port_config(cfg)).state_dict())
    for k in want:
        assert got[k].shape == want[k].shape, k
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 4 * np.spacing(np.abs(want[k]).max()), (k, diff.max())
        assert (diff > 0).mean() < 0.02, k


def _c4_batch(b=1, seed=1):
    """The JAX C4 loss test's batch: noise images, two GT boxes with full masks."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (b, *HW, 3)).astype(np.float32)
    gt = {"boxes": np.tile(np.asarray([[[8.0, 8.0, 72.0, 72.0], [30.0, 40.0, 90.0, 100.0]]], np.float32), (b, 1, 1)),
          "classes": np.zeros((b, 2), np.int32), "valid": np.ones((b, 2), bool),
          "masks": np.ones((b, 2, *HW), np.float32)}
    return images, gt


@pytest.mark.parametrize("to_train", [("proposal_generator", "roi_heads"), ("backbone",), ("mask_head",),
                                      ("box_head",), ("backbone", "proposal_generator", "roi_heads")])
def test_c4_param_labels_match_jax(models, to_train):
    """Every tensor of the C4 model gets the label JAX's ``param_labels``
    gives its flax counterpart: under the default ``to_train`` only the RPN
    and the mask head train; ``res5`` and the box predictor stay frozen."""
    jl = jW.flatten(joptim.param_labels(models["jparams"], to_train))
    want = {convert._mask_rcnn_key(p)[0]: v for p, v in jl.items()}
    got = toptim.param_labels(list(models["tmodel"].state_dict()), to_train)
    assert got == want
    if to_train == ("proposal_generator", "roi_heads"):
        trained = {k.split(".")[1] for k, v in got.items() if v == "train"}
        assert trained == {"rpn_head", "mask_head"}


def test_c4_train_step_matches_jax(models):
    """One step of the reference regime (default ``to_train``, frozen
    backbone, masks on) from the same checkpoint, batch and key: each loss
    within 5e-5 relative, the trained tensors (RPN head, mask head) within
    1e-4 of the update's max-abs (plus 1 ulp), every other tensor untouched
    (``res5`` and the box predictor among them)."""
    jcfg, ckpt, jm, jp = models["jcfg"], models["ckpt"], models["jmodel"], models["jparams"]
    images, gt = _c4_batch()
    key = jax.random.PRNGKey(9)
    to_train = ("proposal_generator", "roi_heads")
    jtx = joptim.build_finetune_optimizer(jp, to_train, lr=joptim.warmup_multistep_schedule(0.02, (), 1, 1.0))
    jp1, _, jl = jax.jit(lambda p, s, im, g, k: jsteps.detector_train_step(jm, jtx, p, s, im, g, k, True))(
        jp, jtx.init(jp), jnp.asarray(images), {k: jnp.asarray(v) for k, v in gt.items()}, key)
    model = build_model(port_config(jcfg))
    tW.load_detectron2(model, ckpt)
    tensors = model.state_dict(keep_vars=True)
    opt = toptim.build_finetune_optimizer(tensors, to_train, lr=toptim.warmup_multistep_schedule(0.02, (), 1, 1.0))
    tsteps.trainable_only(opt.trainable(), tensors.values())
    before = {k: v.detach().numpy().copy() for k, v in tensors.items()}
    tl = tsteps.detector_train_step(model, opt, torch.from_numpy(images),
                                    {k: torch.from_numpy(v) for k, v in gt.items()}, np.asarray(key), True)
    assert set(tl) == set(jl) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask",
                                  "loss_total"}
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= 5e-5 * abs(float(jl[k])), (k, float(tl[k]), float(jl[k]))
    got = {k: v.detach().numpy() for k, v in tensors.items()}
    want = convert.mask_rcnn_state_dict(jW.flatten(jax.tree_util.tree_map(np.asarray, jp1)))
    upd = max(float(np.abs(want[n] - before[n]).max()) for n in opt.names)
    assert upd > 0
    for n in opt.names:
        tol = 1e-4 * upd + np.spacing(np.abs(want[n]).astype(np.float32))
        assert (np.abs(got[n] - want[n]) <= tol).all(), (n, float(np.abs(got[n] - want[n]).max()))
    assert {n.split(".")[1] for n in opt.names} == {"rpn_head", "mask_head"}
    for n in set(got) - set(opt.names):
        np.testing.assert_array_equal(got[n], before[n], err_msg=n)


@pytest.mark.parametrize("bare", [False, True])
def test_c4_zoo_pickle_import_matches_jax(tmp_path, bare):
    """A detectron2 R50-C4 zoo pickle (``{"model": ..., "__author__"}``;
    with ``bare``, the trunk named without ``backbone.``) through the port's
    ``load_torch_file`` + ``load_detectron2`` and through JAX's
    ``map_detectron2_weights_c4`` + ``load_into_params``: no missing or
    unused key on either side, and the two parameter sets equal through
    ``convert.mask_rcnn_state_dict``.  The trunk stays under ``backbone.``,
    never under ``backbone.bottom_up``."""
    from apse_uav_tpu.dcnn.config import mask_rcnn_r50_c4

    src = detectron2_checkpoint(2, 50, 7, architecture="c4")
    if bare:
        src = {(k[len("backbone."):] if k.startswith("backbone.") else k): v for k, v in src.items()}
    path = tmp_path / "c4.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": src, "__author__": "synthetic"}, f)
    jcfg = mask_rcnn_r50_c4(num_classes=7)
    jm = JMaskRCNNC4(cfg=jcfg)
    abstract = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), mode="inference"))
    jparams, missing, unused = jW.load_into_params(
        abstract["params"], jW.map_detectron2_weights_c4(jW.load_torch_file(str(path)), 50, mask_on=True))
    assert not missing and not unused
    model = build_model(port_config(jcfg))
    assert tW.load_detectron2(model, tW.load_torch_file(str(path))) == ([], [])
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    want = convert.mask_rcnn_state_dict(jW.flatten(jax.tree_util.tree_map(np.asarray, jparams)))
    assert set(got) == set(want)
    assert not any(k.startswith("backbone.bottom_up") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_r50_c4_inference_matches_jax():
    """R50-C4 at the JAX C4 test's size (1 image of 128x128, 64 -> 16
    proposals, 4 detections, 7 classes) end to end: the same valid
    detections and classes, boxes within 1e-3 px, masks within 1e-4."""
    jcfg = c4_config(depth=50, num_classes=7)
    ckpt = detectron2_checkpoint(4, 50, 7, architecture="c4")
    jm, jp = jax_c4(jcfg, ckpt)
    images = np.random.default_rng(0).integers(0, 255, (1, *HW, 3)).astype(np.float32)
    jd, _ = jax.jit(lambda p, x: jm.apply({"params": p}, x, mode="inference"))(jp, jnp.asarray(images))
    model = build_model(port_config(jcfg)).eval()
    tW.load_detectron2(model, ckpt)
    with torch.no_grad():
        det, _ = model.inference(torch.from_numpy(images))
    np.testing.assert_array_equal(det["valid"].numpy(), np.asarray(jd["valid"]))
    np.testing.assert_array_equal(det["classes"].numpy(), np.asarray(jd["classes"]))
    np.testing.assert_allclose(det["boxes"].numpy(), np.asarray(jd["boxes"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(det["masks"].numpy(), np.asarray(jd["masks"]), rtol=0, atol=1e-4)


def _jax_c4_maps_and_proposals(jm, jp, images):
    """The JAX C4 model's backbone maps and training proposals (the
    ``*_topk_train`` selection of its RPN head's float32 outputs on res4)."""

    def run(m, x):
        feats = m.backbone(m._normalize(x))
        logits, deltas = m.rpn_head({"res4": feats["res4"]})
        level_shapes = {"res4": tuple(feats["res4"].shape[1:3])}
        boxes, _, valid = jax.vmap(lambda lg, dl: j_select_proposals(
            {k: v.astype(jnp.float32) for k, v in lg.items()}, {k: v.astype(jnp.float32) for k, v in dl.items()},
            level_shapes, x.shape[1:3], m.cfg.anchors, m.cfg.rpn, training=True))(logits, deltas)
        return feats, boxes, valid

    return jax.jit(lambda p, x: jm.apply({"params": p}, x, method=run))(jp, jnp.asarray(images))


def test_c4_bf16_regime_step(models):
    """The bf16 regime on C4 (``compute_dtype="bfloat16"``,
    ``head_compute_dtype="float32"``: res2-res4 and res5 in bfloat16, the
    RPN head, the box predictor on the 7x7 mean and the mask head in
    float32, float32 parameters, gradients and update), against JAX's C4
    bf16 model from the same checkpoint:

    * res5 on JAX's bf16 res4 map and the same boxes: within one bfloat16
      ulp of the largest value of JAX's, on under 10 % of the values
      (measured: 1 ulp on 3.1 %; the two libraries' bf16 convolutions round
      differently);
    * the box predictor and the mask head on the port's own res5 output:
      JAX's ``box_predictor(x5.mean(axis=(1, 2)).astype(float32))`` and
      ``mask_head`` on that output within 1e-5 (the 7x7 mean is taken in
      bfloat16, then cast, in both);
    * one frozen-backbone step (default ``to_train``), on JAX's bf16 maps
      and training proposals, against JAX's bf16 step with the same batch
      and key (as ``test_bf16_train_step_matches_jax`` holds R-FPN's): the
      RPN losses within 1e-5 relative (measured 2.2e-7), the ROI losses and
      the total within 1e-3 relative (measured 3.1e-4, the res5 rounding
      above), the trained tensors within 1e-4 of the update's max-abs
      (measured 1.0e-5); every parameter float32."""
    jcfg, ckpt = models["jcfg"], models["ckpt"]
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16", head_compute_dtype="float32")
    jm, jp = jax_c4(jcfg, ckpt)
    images, gt = _c4_batch()
    key = jax.random.PRNGKey(9)
    to_train = ("proposal_generator", "roi_heads")
    jtx = joptim.build_finetune_optimizer(jp, to_train, lr=joptim.warmup_multistep_schedule(0.02, (), 1, 1.0))
    jp1, _, jl = jax.jit(lambda p, s, im, g, k: jsteps.detector_train_step(jm, jtx, p, s, im, g, k, True))(
        jp, jtx.init(jp), jnp.asarray(images), {k: jnp.asarray(v) for k, v in gt.items()}, key)
    feats, boxes, valid = _jax_c4_maps_and_proposals(jm, jp, images)
    model = build_model(port_config(jcfg))
    tW.load_detectron2(model, ckpt)
    x, g = torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in gt.items()}
    tfeats = {k: torch.from_numpy(np.asarray(v).astype(np.float32)).to(torch.bfloat16) for k, v in feats.items()}
    props = (torch.from_numpy(np.array(boxes)), torch.from_numpy(np.array(valid)))

    # res5 on the same pooled bf16 input, then the float32 predictors on the port's res5 output.
    jx5 = jax.jit(lambda p, r4, b: jm.apply({"params": p}, r4, b, method=lambda m, r4, b: m._roi_transform(r4, b)))(
        jp, feats["res4"][0], boxes[0])
    with torch.no_grad():
        x5 = model.roi_transform(tfeats["res4"][:1], props[0][:1])
        cls_logits, box_deltas = model.box_outputs(x5, 1, x5.shape[0])
        mask_logits = model.roi_heads.mask_head(x5).float()
        logits, _, _ = model.rpn_outputs(tfeats)
    assert x5.dtype == torch.bfloat16 and logits["res4"].dtype == torch.float32
    want5 = np.asarray(jx5).astype(np.float32).transpose(0, 3, 1, 2)
    diff = np.abs(x5.float().numpy() - want5)
    assert diff.max() <= float(np.spacing(np.abs(want5).max().astype(jnp.bfloat16))), float(diff.max())
    assert (diff > 0).mean() < 0.1, (diff > 0).mean()
    x5_nhwc = jnp.asarray(x5.float().numpy().transpose(0, 2, 3, 1)).astype(jnp.bfloat16)
    jcls, jdel, jmask = jax.jit(lambda p, x5: jm.apply({"params": p}, x5, method=lambda m, x5: (
        *m.box_predictor(x5.mean(axis=(1, 2)).astype(jnp.float32)),
        m.mask_head(jnp.transpose(x5, (0, 3, 1, 2))).astype(jnp.float32))))(jp, x5_nhwc)
    np.testing.assert_allclose(cls_logits[0].numpy(), np.asarray(jcls), rtol=0, atol=1e-5)
    np.testing.assert_allclose(box_deltas[0].numpy(), np.asarray(jdel), rtol=0, atol=1e-5)
    np.testing.assert_allclose(mask_logits.numpy(), np.asarray(jmask), rtol=0, atol=1e-5)

    tensors = model.state_dict(keep_vars=True)
    opt = toptim.build_finetune_optimizer(tensors, to_train, lr=toptim.warmup_multistep_schedule(0.02, (), 1, 1.0))
    tsteps.trainable_only(opt.trainable(), tensors.values())
    before = {k: v.detach().numpy().copy() for k, v in tensors.items()}
    tl = tsteps.detector_train_step(model, opt, x, g, np.asarray(key), True, proposals=props, features=tfeats)
    for k, rel in (("loss_rpn_cls", 1e-5), ("loss_rpn_loc", 1e-5), ("loss_cls", 1e-3), ("loss_box_reg", 1e-3),
                   ("loss_mask", 1e-3), ("loss_total", 1e-3)):
        assert abs(float(tl[k]) - float(jl[k])) <= rel * abs(float(jl[k])), (k, float(tl[k]), float(jl[k]))
    got = {k: v.detach().numpy() for k, v in tensors.items()}
    want = convert.mask_rcnn_state_dict(jW.flatten(jax.tree_util.tree_map(np.asarray, jp1)))
    upd = max(float(np.abs(want[n] - before[n]).max()) for n in opt.names)
    assert upd > 0
    for n in opt.names:
        tol = 1e-4 * upd + np.spacing(np.abs(want[n]).astype(np.float32))
        assert (np.abs(got[n] - want[n]) <= tol).all(), (n, float(np.abs(got[n] - want[n]).max()))
    for n in set(got) - set(opt.names):
        np.testing.assert_array_equal(got[n], before[n], err_msg=n)
    assert all(t.dtype == torch.float32 for t in tensors.values())
