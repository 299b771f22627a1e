"""PyTorch port, the training path against the JAX package on the CPU.

The random streams (``split``, ``uniform``, ``normal``, the conv LeCun init
and the whole-model flax init), the optimizer against optax, one
``association_train_step`` and one ``detector_train_step`` from the same
parameters, batch and key, and (``slow``) the two loops, a resume from a JAX
checkpoint converted mid-training, and the learning regression.  One
detectron2-format checkpoint goes into both packages
(``tests/torch_parity.py``).  Tolerances are stated per test.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import jax_mask_rcnn, port_config, tiny_dcnn_config

from apse_uav_tpu.dcnn import weights as jW
from apse_uav_tpu.dcnn.models.association import AssociationHead as JHead
from apse_uav_tpu.dcnn.models.mask_rcnn import MaskRCNN as JMaskRCNN
from apse_uav_tpu.train import optim as joptim, steps as jsteps
from apse_uav_torch import convert
from apse_uav_torch.dcnn import flax_init, weights as tW
from apse_uav_torch.dcnn.models.association import AssociationHead, init_weights
from apse_uav_torch.dcnn.models.mask_rcnn import MaskRCNN
from apse_uav_torch.train import optim as toptim, steps as tsteps
from apse_uav_torch.utils.synthetic import detectron2_checkpoint

HW = (64, 64)


def _train_cfg(mask_on=True):
    """The tiny R50-FPN with small training budgets (the JAX loop tests')."""
    cfg = tiny_dcnn_config(num_classes=2)
    return dataclasses.replace(
        cfg, mask_on=mask_on,
        rpn=dataclasses.replace(cfg.rpn, pre_nms_topk_train=64, post_nms_topk_train=32, batch_size_per_image=32),
        roi=dataclasses.replace(cfg.roi, batch_size_per_image=16))


def _batch(b=2, g=4, seed=0, hw=HW):
    """Noise images with bright boxes; full-image GT masks."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (b, *hw, 3)).astype(np.float32)
    gt = {"boxes": np.zeros((b, g, 4), np.float32), "classes": np.zeros((b, g), np.int32),
          "valid": np.zeros((b, g), bool), "masks": np.zeros((b, g, *hw), np.float32)}
    for i in range(b):
        for j in range(2):
            x, y = rng.integers(2, hw[1] // 2, 2)
            w, h = rng.integers(12, hw[0] // 2, 2)
            gt["boxes"][i, j] = [x, y, x + w, y + h]
            gt["valid"][i, j] = True
            gt["classes"][i, j] = rng.integers(0, 2)
            gt["masks"][i, j, y:y + h, x:x + w] = 1.0
            images[i, y:y + h, x:x + w] = 240.0
    return images, gt


def _port_flat(params) -> dict:
    """A JAX MaskRCNN parameter tree as the port's state dict."""
    return convert.mask_rcnn_state_dict(jW.flatten(params))


def _close_to_update(got: dict, want: dict, before: dict, names, rel: float) -> float:
    """Each parameter of ``names`` within ``rel`` times the largest update
    (want - before) plus one ulp of the parameter; returns the worst error
    relative to that update."""
    upd = max(float(np.abs(want[n] - before[n]).max()) for n in names)
    assert upd > 0
    worst = 0.0
    for n in names:
        err = np.abs(got[n] - want[n])
        tol = rel * upd + np.spacing(np.abs(want[n]).astype(np.float32))
        assert (err <= tol).all(), (n, float(err.max()), rel * upd)
        worst = max(worst, float(err.max()) / upd)
    return worst


# -- random streams -----------------------------------------------------------


def test_split_uniform_normal_lecun_match_jax_random():
    """``split`` and the device ``uniform`` bit for bit; ``normal`` (eager,
    and ``normal_t`` as jitted) and the conv LeCun init within 4 ulp of their largest value (1 ulp of
    ``erfinv``'s last bits, scaled), on under 2 % of the values, as
    ``tests/test_torch_checkpoint.py`` holds the head's init."""
    import flax.linen as fnn

    key = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(flax_init.split(flax_init.prng_key(11), 7), np.asarray(jax.random.split(key, 7)))
    keys = flax_init.split(flax_init.prng_key(11), 3)
    got = flax_init.uniform_t(keys, 200_003, "cpu").numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], np.asarray(jax.random.uniform(jnp.asarray(keys[i]), (200_003,))))
    np.testing.assert_array_equal(flax_init.uniform_t(keys[:1], 1000, "cpu", -0.5, 0.7)[0].numpy(),
                                  flax_init.uniform(keys[0], (1000,), -0.5, 0.7))
    checks = [(flax_init.normal(flax_init.prng_key(11), (50_000,), 0.01),
               np.asarray(jax.random.normal(key, (50_000,)) * np.float32(0.01))),
              (flax_init.normal_t(flax_init.prng_key(11), 50_000, "cpu", 0.01).numpy(),
               np.asarray(jax.jit(lambda k: jax.random.normal(k, (50_000,)) * np.float32(0.01))(key))),
              (flax_init.lecun_normal_t(flax_init.prng_key(11), (3, 3, 64, 32), "cpu").numpy(),
               np.asarray(fnn.initializers.lecun_normal()(key, (3, 3, 64, 32))))]
    for got, want in checks:
        diff = np.abs(got - want)
        assert diff.max() <= 4 * np.spacing(np.abs(want).max()), diff.max()
        assert (diff > 0).mean() < 0.02


def test_whole_model_flax_init_matches_jax():
    """``mask_rcnn_init`` = ``MaskRCNN.init(PRNGKey(seed))`` (a depth-26
    trunk, mask head on) through ``convert``'s names: every parameter
    present, zeros and ones exact, the draws within 4 ulp of the largest
    value of their tensor on under 2 % of the values."""
    cfg = dataclasses.replace(tiny_dcnn_config(num_classes=3), depth=26)
    jp = jax.jit(lambda k: JMaskRCNN(cfg=cfg).init(k, jnp.zeros((1, 64, 64, 3)), mode="inference")["params"])(
        jax.random.PRNGKey(5))
    want = _port_flat(jp)
    got = flax_init.mask_rcnn_init(port_config(cfg), 5)
    assert set(got) == set(want) == set(MaskRCNN(port_config(cfg)).state_dict())
    for k in want:
        assert got[k].shape == want[k].shape, k
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 4 * np.spacing(np.abs(want[k]).max()), (k, diff.max())
        assert (diff > 0).mean() < 0.02, k


# -- optimizer ----------------------------------------------------------------


def test_param_labels_match_jax():
    """Every parameter of the tiny R50 (mask head on) gets the label the JAX
    ``param_labels`` gives its flax counterpart, for each selection the
    reference's CLIs use; FrozenBN affines train under ``backbone``."""
    cfg = _train_cfg()
    shapes = jax.eval_shape(lambda: JMaskRCNN(cfg=cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                                            mode="inference"))["params"]
    for to_train in (("proposal_generator", "roi_heads"), ("backbone",), ("mask_head",), ("box_head",),
                     ("backbone", "proposal_generator", "roi_heads")):
        jl = jW.flatten(joptim.param_labels(shapes, to_train))
        want = {convert._mask_rcnn_key(p)[0]: v for p, v in jl.items()}
        got = toptim.param_labels(list(want), to_train)
        assert got == want, to_train
    labels = toptim.param_labels(list(want), ("backbone",))
    assert labels["backbone.bottom_up.res2.0.conv1.norm.weight"] == "train"
    assert labels["backbone.bottom_up.res2.0.conv1.norm.running_var"] == "frozen"


def test_optimizer_matches_optax_over_five_steps():
    """Five steps of ``build_finetune_optimizer`` (warmup schedule) on a small
    tree: a frozen subset, clipping triggered on steps 1-2, a non-finite
    gradient on step 3 (skipped when that tensor trains: no change to
    parameters, momentum or count; ignored when it is frozen).  Trained
    parameters within 1e-5 of the largest change optax makes (plus 1 ulp),
    momentum traces within 1e-6 of their max-abs, counts equal, frozen
    tensors untouched."""
    rng = np.random.default_rng(0)
    names = {"proposal_generator.rpn_head.conv.weight": ("rpn_head", "conv", "kernel"),
             "roi_heads.box_predictor.cls_score.bias": ("box_head", "cls_score", "bias"),
             "backbone.bottom_up.stem.conv1.norm.weight": ("backbone", "resnet", "stem_bn", "scale"),
             "backbone.bottom_up.stem.conv1.norm.running_mean": ("backbone", "resnet", "stem_bn", "mean"),
             "backbone.fpn_lateral2.weight": ("backbone", "fpn", "lateral2", "kernel")}
    values = {n: rng.normal(size=(3, 4)).astype(np.float32) for n in names}

    def tree(d):
        out = {}
        for n, path in names.items():
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = jnp.asarray(d[n])
        return out

    scales = [40.0, 20.0, 1.0, 1.0, 0.5]
    for to_train in (("proposal_generator", "roi_heads"), ("backbone", "proposal_generator")):
        jp = tree(values)
        tx = joptim.build_finetune_optimizer(jp, to_train, lr=joptim.warmup_multistep_schedule(0.02, (2,), 3))
        st = tx.init(jp)
        tp = {n: torch.from_numpy(v.copy()) for n, v in values.items()}
        opt = toptim.build_finetune_optimizer(tp, to_train, lr=toptim.warmup_multistep_schedule(0.02, (2,), 3))
        for step, scale in enumerate(scales):
            g = {n: (scale * rng.normal(size=(3, 4))).astype(np.float32) for n in names}
            if step == 2:
                g["roi_heads.box_predictor.cls_score.bias"][0, 0] = np.nan
            upd, st = tx.update(tree(g), st, jp)
            jp = optax.apply_updates(jp, upd)
            opt.step([torch.from_numpy(g[n]) for n in opt.names])
        jflat = jW.flatten(jp)
        want = {n: np.asarray(jflat["/".join(path)]) for n, path in names.items()}
        _close_to_update({n: t.numpy() for n, t in tp.items()}, want, values, opt.names, 1e-5)
        for n in set(names) - set(opt.names):
            np.testing.assert_array_equal(tp[n].numpy(), values[n], err_msg=n)
        inner = st.inner_states["train"].inner_state
        # A non-finite gradient of a frozen tensor skips nothing.
        skipped = int("roi_heads.box_predictor.cls_score.bias" in opt.names)
        assert int(opt.count) == int(inner.inner_state[2][1].count) == 5 - skipped
        assert int(opt.total_notfinite) == int(inner.total_notfinite) == skipped
        jtrace = jW.flatten(inner.inner_state[2][0].trace)
        for n in opt.names:
            jt = np.asarray(jtrace["/".join(names[n])])
            np.testing.assert_allclose(opt.trace[n].numpy(), jt, rtol=0, atol=1e-6 * np.abs(jt).max(), err_msg=n)
        assert "backbone.bottom_up.stem.conv1.norm.running_mean" not in opt.names
        np.testing.assert_array_equal(tp["backbone.bottom_up.stem.conv1.norm.running_mean"].numpy(),
                                      values["backbone.bottom_up.stem.conv1.norm.running_mean"])


# -- training steps -------------------------------------------------------------


def test_association_train_step_matches_jax():
    """One step of the 128-d head on 16 ROIs (4 of them padding) from the
    PRNGKey(0) init: loss within 1e-6 relative, the head's change within
    1e-5 of its max-abs (plus the 2 ulp that rounding each package's own
    sum can give)."""
    rng = np.random.default_rng(1)
    c, r, n = 16, 4, 16
    rois = rng.normal(size=(n, c, r, r)).astype(np.float32)
    ids = rng.integers(0, 4, n).astype(np.int64)
    valid = np.arange(n) < 12
    head = JHead(embedding_dim=128)
    jp = head.init(jax.random.PRNGKey(0), jnp.zeros((1, c, r, r)))["params"]
    tx = optax.sgd(0.01, momentum=0.9)
    jp1, _, jloss = jsteps.association_train_step(head, tx, jp, tx.init(jp), jnp.asarray(rois), jnp.asarray(ids),
                                                  jnp.asarray(valid))
    thead = AssociationHead(c * r * r)
    thead.load_state_dict({k: torch.from_numpy(v) for k, v in init_weights(c * r * r, 128, seed=0).items()})
    before = {k: v.detach().numpy().copy() for k, v in thead.state_dict().items()}
    opt = toptim.SGD(dict(thead.named_parameters()), lr=0.01, momentum=0.9, finetune=False)
    tloss = tsteps.association_train_step(thead, opt, torch.from_numpy(rois), torch.from_numpy(ids),
                                          torch.from_numpy(valid))
    assert abs(float(tloss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    want = convert.association_state_dict(jW.flatten(jp1))
    jbefore = convert.association_state_dict(jW.flatten(jp))
    # The init differs from the reference's by 1 ulp on ~1 % of the kernel;
    # the update is compared on top of each package's own start.
    got = {k: v.detach().numpy() for k, v in thead.state_dict().items()}
    upd = max(float(np.abs(want[k] - jbefore[k]).max()) for k in want)
    for k in want:
        np.testing.assert_allclose(got[k] - before[k], want[k] - jbefore[k], rtol=0,
                                   atol=1e-5 * upd + 2 * np.spacing(np.abs(want[k]).max()))


@pytest.fixture(scope="module")
def tiny_models():
    cfg = _train_cfg()
    ckpt = detectron2_checkpoint(3, 50, 2)
    model, params = jax_mask_rcnn(cfg, ckpt)
    return cfg, ckpt, model, params


def _detector_step(tiny_models, to_train, freeze, rel=1e-4):
    cfg, ckpt, jm, jp = tiny_models
    images, gt = _batch()
    key = jax.random.PRNGKey(9)
    # A constant rate (warmup factor 1): the update stands far above the
    # parameters' rounding.
    jtx = joptim.build_finetune_optimizer(jp, to_train, lr=joptim.warmup_multistep_schedule(0.02, (), 1, 1.0))
    jp1, _, jl = jax.jit(lambda p, s, im, g, k: jsteps.detector_train_step(jm, jtx, p, s, im, g, k, freeze))(
        jp, jtx.init(jp), jnp.asarray(images), {k: jnp.asarray(v) for k, v in gt.items()}, key)
    model = MaskRCNN(port_config(cfg))
    tW.load_detectron2(model, ckpt)
    tensors = model.state_dict(keep_vars=True)
    opt = toptim.build_finetune_optimizer(tensors, to_train, lr=toptim.warmup_multistep_schedule(0.02, (), 1, 1.0))
    tsteps.trainable_only(opt.trainable(), tensors.values())
    before = {k: v.detach().numpy().copy() for k, v in tensors.items()}
    tl = tsteps.detector_train_step(model, opt, torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in gt.items()},
                                    np.asarray(key), freeze)
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= 5e-5 * abs(float(jl[k])), (k, float(tl[k]), float(jl[k]))
    got = {k: v.detach().numpy() for k, v in tensors.items()}
    want = _port_flat(jp1)
    worst = _close_to_update(got, want, before, opt.names, rel)
    for n in set(got) - set(opt.names):
        np.testing.assert_array_equal(got[n], before[n], err_msg=n)
    return worst


def test_detector_train_step_matches_jax(tiny_models):
    """The reference regime (RPN + ROI heads, frozen backbone, mask head on):
    each loss within 5e-5 relative (the float32 features differ by ~1e-6
    between the libraries' convolutions), the updated parameters within 1e-4
    of the update's max-abs (plus 1 ulp); the frozen ones untouched."""
    _detector_step(tiny_models, ("proposal_generator", "roi_heads"), True)


def test_losses_on_given_proposals_equal_their_own(tiny_models):
    """``losses(proposals=..., features=...)`` on the model's own maps and
    training proposals (how the card and the CPU compare a step) is
    ``losses()`` exactly; given maps need the frozen-backbone regime."""
    cfg, ckpt, _, _ = tiny_models
    model = MaskRCNN(port_config(cfg))
    tW.load_detectron2(model, ckpt)
    images, gt = _batch()
    x, g = torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in gt.items()}
    key = flax_init.prng_key(4)
    own = model.losses(x, g, key, freeze_backbone=True)
    with torch.no_grad():
        feats = model.features(x)
    given = model.losses(x, g, key, freeze_backbone=True, proposals=model.training_proposals(x, feats),
                         features=feats)
    assert {k: float(v.detach()) for k, v in own.items()} == {k: float(v.detach()) for k, v in given.items()}
    with pytest.raises(ValueError, match="freeze_backbone"):
        model.losses(x, g, key, features=feats)


@pytest.mark.slow
def test_detector_train_step_with_backbone_matches_jax(tiny_models):
    """The whole model trained (backbone, FrozenBN affines included), through
    the convolution and ROIAlign backward: the losses within 5e-5, the
    updated parameters within 1e-3 of the update's max-abs.  The ROIAlign
    backward scatters into the reference's bfloat16 row buffer in both
    packages, summing in different orders, so the backbone gradients carry
    bfloat16 rounding (the worst error measured: 5.7e-4 of the update)."""
    _detector_step(tiny_models, ("backbone", "proposal_generator", "roi_heads"), False, rel=1e-3)


# -- loops ----------------------------------------------------------------------


def test_train_association_head_loop_matches_jax(tmp_path):
    """Two epochs of three batches (sizes 4, 3, 6: padded to 4, 4 and 8) on the CPU:
    ``train_info.txt`` equal line by line within 1e-5 of each loss, the final
    head within 1e-5 of the trained change's max-abs, an ``epoch_1``
    checkpoint in the port's format."""
    from apse_uav_tpu.train.loop import train_association_head as jtrain
    from apse_uav_torch.train import checkpoint as tckpt
    from apse_uav_torch.train.loop import train_association_head as ttrain

    c, r = 6, 4
    data_rng = np.random.default_rng(0)
    batches = []
    for n in (4, 3, 6):
        ids = data_rng.integers(0, 3, n).astype(np.int64)
        rois = (ids[:, None, None, None] * 0.3 + data_rng.normal(0, 0.5, (n, c, r, r))).astype(np.float32)
        batches.append((ids, rois))
    jp = jtrain(lambda i: batches[i], 3, str(tmp_path / "jax"), epochs=2, embedding_dim=8, roi_feature_shape=(c, r, r),
                log_fn=lambda s: None)
    head = ttrain(lambda i: batches[i], 3, str(tmp_path / "port"), epochs=2, embedding_dim=8,
                  roi_feature_shape=(c, r, r), log_fn=lambda s: None, device="cpu")
    jinfo = (tmp_path / "jax" / "train_info.txt").read_text().split("\n")
    tinfo = (tmp_path / "port" / "train_info.txt").read_text().split("\n")
    assert len(jinfo) == len(tinfo) == 3
    for a, b in zip(jinfo[:2], tinfo[:2]):
        assert a.split()[:2] == b.split()[:2]
        assert abs(float(a.split()[-1]) - float(b.split()[-1])) <= 1e-5 * abs(float(a.split()[-1])) + 2e-6
    want = convert.association_state_dict(jW.flatten(jp))
    start = init_weights(c * r * r, 8, seed=0)
    got = {k: v.detach().numpy() for k, v in head.state_dict().items()}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * np.abs(want[k] - start[k]).max() + 1e-7)
    state = tckpt.load_state(str(tmp_path / "port"), "epoch_1")
    assert state["epoch"] == 1 and set(state["params"]) == {"fc.weight", "fc.bias"}


def test_padded_rows_at_the_zero_init_bias_stay_finite():
    """A reference fault the port does not share: at the first step the
    head's bias is 0, so a zero-padded ROI embeds to the zero vector, where
    JAX's norm has a NaN gradient (0 * inf) that turns the whole head NaN;
    the port's norm has gradient 0 there, and the padded rows carry no loss."""
    rng = np.random.default_rng(2)
    c, r = 6, 4
    rois = np.zeros((8, c, r, r), np.float32)
    rois[:5] = rng.normal(size=(5, c, r, r))
    ids = np.array([0, 1, 0, 2, 1, 0, 0, 0])
    valid = np.arange(8) < 5
    head = JHead(embedding_dim=8)
    jp = head.init(jax.random.PRNGKey(0), jnp.zeros((1, c, r, r)))["params"]
    tx = optax.sgd(0.01, momentum=0.9)
    jp1, _, _ = jsteps.association_train_step(head, tx, jp, tx.init(jp), jnp.asarray(rois), jnp.asarray(ids),
                                              jnp.asarray(valid))
    assert np.isnan(np.asarray(jp1["fc"]["kernel"])).any()
    thead = AssociationHead(c * r * r, 8)
    thead.load_state_dict({k: torch.from_numpy(v) for k, v in init_weights(c * r * r, 8, seed=0).items()})
    opt = toptim.SGD(dict(thead.named_parameters()), lr=0.01, momentum=0.9, finetune=False)
    loss = tsteps.association_train_step(thead, opt, torch.from_numpy(rois), torch.from_numpy(ids),
                                         torch.from_numpy(valid))
    assert np.isfinite(float(loss)) and all(torch.isfinite(p).all() for p in thead.parameters())


def _loop_batches(seed=0, b=2, hw=HW):
    i = 0
    while True:
        images, gt = _batch(b=b, seed=seed + i, hw=hw)
        gt.pop("masks")
        yield images, gt
        i += 1


def _results(path):
    lines = open(path).read().strip().split("\n")
    return lines[0].split("\t"), [np.asarray([float(v) for v in ln.split("\t")]) for ln in lines[1:]]


@pytest.mark.slow
def test_finetune_detector_loop_and_resume_match_jax(tmp_path):
    """Four iterations at test_period 2 from the same weights: results.txt
    (losses within 1e-4 relative, AP/AR equal), the final parameters within
    1e-3 of the training's change; ``last`` / ``bestAP`` / ``bestAR``; then a
    resume from ``last`` (opt_state, iteration 4) to 6 against JAX's resume,
    and a resume from JAX's converted ``last`` to the same point."""
    from apse_uav_tpu.train import checkpoint as jckpt
    from apse_uav_tpu.train.loop import finetune_detector as jfine
    from apse_uav_torch.train import checkpoint as tckpt
    from apse_uav_torch.train.loop import finetune_detector as tfine

    cfg = dataclasses.replace(_train_cfg(mask_on=False),
                              roi=dataclasses.replace(_train_cfg().roi, score_thresh_test=0.0))
    ckpt = detectron2_checkpoint(3, 50, 2, mask_on=False)
    _, jp0 = jax_mask_rcnn(cfg, ckpt)
    evals = [_batch(seed=100)[0:2]]
    evals = [(evals[0][0], {k: v for k, v in evals[0][1].items() if k != "masks"})]
    logs = []
    jp = jfine(cfg, _loop_batches(), lambda: evals, str(tmp_path / "jax"), max_iter=4, test_period=2, init_params=jp0,
               log_fn=logs.append)
    model = tfine(port_config(cfg), _loop_batches(), lambda: evals, str(tmp_path / "port"), max_iter=4, test_period=2,
                  init_params=ckpt, log_fn=logs.append, device="cpu")
    for d in ("jax", "port"):
        for name in ("last", "bestAP", "bestAR", "results.txt"):
            assert os.path.exists(tmp_path / d / name), (d, name)
    jh, jrows = _results(tmp_path / "jax" / "results.txt")
    th, trows = _results(tmp_path / "port" / "results.txt")
    assert jh == th and len(jrows) == len(trows) == 2
    for a, b in zip(jrows, trows):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)
    want = _port_flat(jp)
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    start = {k: np.asarray(v) for k, v in ckpt.items()}
    trained = [k for k in got if not np.array_equal(want[k], start[k])]
    assert trained and all(k.startswith(("proposal_generator", "roi_heads")) for k in trained)
    _close_to_update(got, want, start, trained, 1e-3)
    # Resume both to 6; and the port from JAX's converted last.
    state = tckpt.load_state(str(tmp_path / "port"), "last")
    assert state["iteration"] == 4 and int(state["opt_state"]["count"]) == 4
    jp6 = jfine(cfg, _loop_batches(seed=50), lambda: evals, str(tmp_path / "jax"), max_iter=6, test_period=2,
                init_params=jp0, log_fn=logs.append)
    m6 = tfine(port_config(cfg), _loop_batches(seed=50), lambda: evals, str(tmp_path / "port"), max_iter=6,
               test_period=2, init_params=ckpt, log_fn=logs.append, device="cpu")
    assert convert.checkpoint_state(jckpt.load_state(str(tmp_path / "jax"), "last"))["iteration"] == 6
    # The JAX run's state at 4 converted: a fresh port run resumed from it.
    jstate4 = tmp_path / "jax4"
    jfine(cfg, _loop_batches(), lambda: evals, str(jstate4), max_iter=4, test_period=4, init_params=jp0,
          log_fn=logs.append)
    tckpt.save_state(str(tmp_path / "conv"), "last",
                     convert.checkpoint_state(jckpt.load_state(str(jstate4), "last")))
    m6c = tfine(port_config(cfg), _loop_batches(seed=50), lambda: evals, str(tmp_path / "conv"), max_iter=6,
                test_period=2, init_params=ckpt, log_fn=logs.append, device="cpu")
    want6 = _port_flat(jp6)
    for m in (m6, m6c):
        got6 = {k: v.detach().numpy() for k, v in m.state_dict().items()}
        _close_to_update(got6, want6, start, trained, 1e-3)
    assert any("resumed at iteration 4" in s for s in logs)


def test_learning_scenes_and_config_are_the_reference_regression():
    """``utils.synthetic.learning_scenes`` / ``learning_config`` (which
    ``chip_smoke.py`` runs on the card) are the JAX learning regression's
    generator and config: equal batches from one seed, equal configs."""
    from test_learning_regression import _cfg, _scene_batches

    from apse_uav_torch.utils.synthetic import learning_config, learning_scenes

    assert learning_config() == port_config(_cfg())
    for (ji, jg), (ti, tg) in zip(_scene_batches(seed=3), learning_scenes(seed=3)):
        np.testing.assert_array_equal(ti, ji)
        for k in jg:
            np.testing.assert_array_equal(tg[k], jg[k])
        break


@pytest.mark.slow
def test_port_learns_to_ap50(tmp_path):
    """The JAX learning regression (tests/test_learning_regression.py) on the
    port, on the CPU: R50-FPN, 2 classes, 96x96 scenes, batch 2, lr 0.005,
    seed 0 (the reproduced flax init), 150 iterations, evaluated every 25 as
    ``results.txt`` records: the run reaches AP50 >= 0.7 (``bestAP``'s rule).

    The first steps equal JAX's to 1e-5 and then drift apart: the run is
    chaotic (a 1e-7 difference in the pooled features grows to 1e-3 in the
    losses by step 16).  On this seed the port reaches AP50 0.87-0.89 at
    iterations 100-125 and falls to 0.02 at 150 (a last box-regression
    step), where JAX, on its own drift, is at 0.83 after 0.42 at 75; so the
    bar is held over the run, not at its last step."""
    from apse_uav_torch.train.loop import finetune_detector
    from apse_uav_torch.utils.synthetic import learning_config, learning_scenes

    eval_batches = [next(learning_scenes(seed=1000 + i)) for i in range(4)]
    finetune_detector(learning_config(), learning_scenes(seed=0), lambda: eval_batches, str(tmp_path),
                      max_iter=150, test_period=25, lr=0.005, seed=0, log_fn=lambda s: None, device="cpu")
    header, rows = _results(tmp_path / "results.txt")
    ap50 = [r[header.index("AP50")] for r in rows]
    assert len(ap50) == 6 and max(ap50) >= 0.7, ap50


@pytest.mark.slow
def test_port_learns_to_ap50_bf16(tmp_path):
    """The JAX bf16 learning regression (``test_detector_learns_to_ap50_bf16``)
    on the port, on the CPU: the shipped bf16 regime
    (``compute_dtype="bfloat16"``, ``head_compute_dtype="float32"``) on the
    same scenes, 400 iterations at lr 0.005, evaluated every 50; the run
    reaches AP50 >= 0.7 (held over the run, as the float32 test holds it:
    the run is chaotic)."""
    from apse_uav_torch.train.loop import finetune_detector
    from apse_uav_torch.utils.synthetic import learning_config, learning_scenes

    cfg = dataclasses.replace(learning_config(), compute_dtype="bfloat16", head_compute_dtype="float32")
    eval_batches = [next(learning_scenes(seed=1000 + i)) for i in range(4)]
    finetune_detector(cfg, learning_scenes(seed=0), lambda: eval_batches, str(tmp_path), max_iter=400,
                      test_period=50, lr=0.005, seed=0, log_fn=lambda s: None, device="cpu")
    header, rows = _results(tmp_path / "results.txt")
    ap50 = [r[header.index("AP50")] for r in rows]
    assert len(ap50) == 8 and max(ap50) >= 0.7, ap50


def _jax_maps_and_proposals(jm, jp, images):
    """The JAX model's backbone maps and training proposals (the
    ``*_topk_train`` selection of its RPN head's float32 outputs)."""
    from apse_uav_tpu.dcnn.models.mask_rcnn import RPN_LEVELS
    from apse_uav_tpu.dcnn.models.rpn import select_proposals

    def run(m, x):
        feats = m.backbone(m._normalize(x))
        logits, deltas = m.rpn_head({n: feats[n] for n in RPN_LEVELS})
        level_shapes = {n: tuple(feats[n].shape[1:3]) for n in RPN_LEVELS}
        boxes, _, valid = jax.vmap(lambda lg, dl: select_proposals(
            {k: v.astype(jnp.float32) for k, v in lg.items()}, {k: v.astype(jnp.float32) for k, v in dl.items()},
            level_shapes, x.shape[1:3], m.cfg.anchors, m.cfg.rpn, training=True))(logits, deltas)
        return feats, boxes, valid

    return jax.jit(lambda p, x: jm.apply({"params": p}, x, method=run))(jp, jnp.asarray(images))


def test_bf16_train_step_matches_jax(tiny_models):
    """The reference's shipped bf16 regime (``compute_dtype="bfloat16"``,
    ``head_compute_dtype="float32"``: a bf16 backbone, float32 heads, float32
    parameters, gradients and update, float32 at the loss boundary), one
    frozen-backbone step against JAX's bf16 step from the same checkpoint,
    batch and key, on JAX's bf16 maps and training proposals (the two
    libraries' bf16 convolutions round differently, and top-k / NMS turn
    that discrete).  The ROI losses within 1e-5 relative; the RPN losses
    within 1e-3 relative and the update within 1e-2 of its max-abs, because
    XLA on the CPU evaluates the float32 RPN convolution of bf16 maps at
    bf16 precision (its p2 logits 3.0e-2 from a float64 evaluation, the
    port's 1.4e-5).  Measured worst: RPN losses 3.4e-4, update 3.0e-3.
    Every parameter stays float32."""
    cfg, ckpt, _, _ = tiny_models
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16", head_compute_dtype="float32")
    jm, jp = jax_mask_rcnn(cfg, ckpt)
    images, gt = _batch()
    key = jax.random.PRNGKey(9)
    to_train = ("proposal_generator", "roi_heads")
    jtx = joptim.build_finetune_optimizer(jp, to_train, lr=joptim.warmup_multistep_schedule(0.02, (), 1, 1.0))
    jp1, _, jl = jax.jit(lambda p, s, im, g, k: jsteps.detector_train_step(jm, jtx, p, s, im, g, k, True))(
        jp, jtx.init(jp), jnp.asarray(images), {k: jnp.asarray(v) for k, v in gt.items()}, key)
    feats, boxes, valid = _jax_maps_and_proposals(jm, jp, images)
    model = MaskRCNN(port_config(cfg))
    tW.load_detectron2(model, ckpt)
    tensors = model.state_dict(keep_vars=True)
    opt = toptim.build_finetune_optimizer(tensors, to_train, lr=toptim.warmup_multistep_schedule(0.02, (), 1, 1.0))
    tsteps.trainable_only(opt.trainable(), tensors.values())
    before = {k: v.detach().numpy().copy() for k, v in tensors.items()}
    tl = tsteps.detector_train_step(
        model, opt, torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in gt.items()}, np.asarray(key), True,
        proposals=(torch.from_numpy(np.array(boxes)), torch.from_numpy(np.array(valid))),
        features={k: torch.from_numpy(np.asarray(v).astype(np.float32)).to(torch.bfloat16) for k, v in feats.items()})
    for k in ("loss_cls", "loss_box_reg", "loss_mask"):
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-5 * abs(float(jl[k])), (k, float(tl[k]), float(jl[k]))
    for k in ("loss_rpn_cls", "loss_rpn_loc", "loss_total"):
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-3 * abs(float(jl[k])), (k, float(tl[k]), float(jl[k]))
    assert all(t.dtype == torch.float32 for t in tensors.values())
    _close_to_update({k: v.detach().numpy() for k, v in tensors.items()}, _port_flat(jp1), before, opt.names, 1e-2)
