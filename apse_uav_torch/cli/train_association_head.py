"""Association-head triplet training on KITTI-MOTS on the PyTorch port
(train_association_head.py equivalent).

Flags are those of the JAX reference's ``cli/train_association_head.py``,
plus ``--device cuda|cpu`` (``cuda`` raises when no card is visible, never
falls back).  A frozen backbone (the ``backbone.*`` part of ``--weights``,
a detectron2 ``.pkl`` / ``.pth``: the reference's PartialCheckpointer
semantics) pools a ROI feature for every GT instance; batches of consecutive
annotated frames feed the batch-hard triplet loss (margin 0.2, SGD
0.01 / 0.9); one checkpoint per epoch (``epoch_<n>``, the port's format,
read by ``tracker_test --assoc_weights``) and ``train_info.txt`` land in
``--workdir``.

Usage:
    python -m apse_uav_torch.cli.train_association_head --instances_txt instances_txt \
        --images images --seqmap train.seqmap --weights model_final.pth --workdir runs/assoc
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--instances_txt", required=True, help="KITTI-MOTS instances_txt folder")
    p.add_argument("--images", required=True, help="KITTI-MOTS images root")
    p.add_argument("--seqmap", required=True)
    p.add_argument("--weights", required=True, help="detector checkpoint for the frozen backbone")
    p.add_argument("--workdir", required=True)
    p.add_argument("--depth", type=int, default=101, choices=(50, 101))
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--frames_in_batch", type=int, default=4)
    p.add_argument("--roi_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--margin", type=float, default=0.2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises when no card is visible) or cpu (plain PyTorch path)")
    return p


def frozen_backbone(args, device, weights: dict | None = None):
    """The MaskRCNN whose ``features`` the ROI generator reads: the reference's
    config of ``--depth`` with the checkpoint's ``backbone.*`` weights (the
    loaded ``weights``, or ``--weights``), on ``device``, without autograd."""
    from apse_uav_torch.dcnn import weights as W
    from apse_uav_torch.dcnn.config import mask_rcnn_r50_fpn, mask_rcnn_r101_fpn
    from apse_uav_torch.dcnn.models.mask_rcnn import MaskRCNN

    cfg = (mask_rcnn_r50_fpn if args.depth == 50 else mask_rcnn_r101_fpn)()
    model = MaskRCNN(cfg)
    src = W.load_torch_file(args.weights) if weights is None else weights
    missing, _ = W.load_detectron2(model.backbone, {k[len("backbone."):]: v for k, v in src.items()
                                                    if k.startswith("backbone.")})
    if missing:
        raise SystemExit(f"{args.weights}: {len(missing)} backbone parameters missing, e.g. {missing[:3]}")
    return model.to(device).eval().requires_grad_(False), cfg


def main(argv=None, weights: dict | None = None, log_fn=print):
    """Run the CLI; returns the trained head.  ``weights`` (a loaded state
    dict) saves reading ``--weights``."""
    args = build_parser().parse_args(argv)
    from apse_uav_torch.cli.track_uav import cli_device
    from apse_uav_torch.data.mot import MOTSLoader, RoiFeaturesGenerator
    from apse_uav_torch.evaluation.mots import load_seqmap
    from apse_uav_torch.train.loop import train_association_head

    device = cli_device(args)
    model, cfg = frozen_backbone(args, device, weights)
    gen = RoiFeaturesGenerator(model, roi_size=args.roi_size)
    seq_names, _ = load_seqmap(args.seqmap)
    loader = MOTSLoader(args.instances_txt, args.images, seq_names, gen, args.frames_in_batch)
    batches = [(seq, i) for seq in seq_names for i in range(loader.num_batches(seq))]

    def batch_fn(i):
        seq, b = batches[i]
        return loader.get_training_batch(seq, b)

    return train_association_head(batch_fn, num_batches=len(batches), workdir=args.workdir, epochs=args.epochs,
                                  roi_feature_shape=(cfg.fpn_channels, args.roi_size, args.roi_size), lr=args.lr,
                                  margin=args.margin, log_fn=log_fn, device=device)


if __name__ == "__main__":
    main()
    raise SystemExit(0)
