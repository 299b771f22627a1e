"""Mask-head-only fine-tuning with GT proposals
(dcnn/scripts/train/finetune_segmentation.py equivalent) on the PyTorch port.

Flags are those of the JAX reference's ``cli/finetune_segmentation.py``, plus
``--device cuda|cpu`` (``cuda`` raises when no card is visible, never falls
back).  The RPN is bypassed: the GT boxes feed the ROI heads
(PrecomputedProposals, reference :82-93; the JAX CLI swaps the training step
for one that does so, the port passes ``gt_proposals=True`` through
``finetune_detector``).  Only the mask head trains (:155), the data is split
into ``--kfold`` folds with ``--fold`` held out (:188-199), and
``--merge_into`` / ``--merge_out`` graft the trained mask head into a
detector checkpoint (merge_full_mask_rcnn, :53-61), written as a
detectron2-named ``.pkl`` that the port's loaders read.

Usage:
    python -m apse_uav_torch.cli.finetune_segmentation --coco_json ann.json \
        --coco_images images/ --workdir runs/seg --weights model_final.pkl \
        [--merge_into detector.pth --merge_out merged.pkl] [--device cpu]
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--coco_json", required=True, help="COCO json with RLE segmentations")
    p.add_argument("--coco_images", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--merge_into", default=None, help="detector checkpoint to graft the trained mask head into")
    p.add_argument("--merge_out", default=None, help="output .pkl for the merged checkpoint")
    p.add_argument("--depth", type=int, default=101, choices=(50, 101))
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--max_iter", type=int, default=500)
    p.add_argument("--test_period", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--kfold", type=int, default=5)
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--train_size", type=int, nargs=2, default=(768, 1344))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises when no card is visible) or cpu (plain PyTorch path)")
    return p


def kfold_split(dicts: list, kfold: int, fold: int) -> tuple[list, list]:
    """(train, validation): fold ``fold`` of ``kfold`` equal folds held out (the remainder trains)."""
    size = len(dicts) // max(kfold, 1)
    lo, hi = fold * size, (fold + 1) * size
    return dicts[:lo] + dicts[hi:], dicts[lo:hi]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import pickle

    from apse_uav_torch.cli.finetune_uav import initial_weights
    from apse_uav_torch.cli.track_uav import cli_device
    from apse_uav_torch.data.datasets import generate_coco_dataset_dictionaries
    from apse_uav_torch.data.loader import DetectionLoader, LoaderConfig
    from apse_uav_torch.dcnn import weights as W
    from apse_uav_torch.dcnn.config import mask_rcnn_r50_fpn, mask_rcnn_r101_fpn
    from apse_uav_torch.train.loop import finetune_detector

    device = cli_device(args)
    dicts = generate_coco_dataset_dictionaries(args.coco_json, args.coco_images)
    train_dicts, val_dicts = kfold_split(dicts, args.kfold, args.fold)
    cfg = (mask_rcnn_r50_fpn if args.depth == 50 else mask_rcnn_r101_fpn)(num_classes=args.num_classes)
    lcfg = LoaderConfig(train_size=tuple(args.train_size), batch_size=args.batch_size, mask_size=28)
    model = finetune_detector(cfg, iter(DetectionLoader(train_dicts, lcfg, training=True)),
                              lambda: DetectionLoader(val_dicts, lcfg, training=False), args.workdir,
                              max_iter=args.max_iter, to_train=("mask_head",), lr=args.lr,
                              test_period=args.test_period, init_params=initial_weights(args, cfg, device),
                              device=device, gt_proposals=True)
    if args.merge_into and args.merge_out:
        det = W.reference_subset(W.load_torch_file(args.merge_into), args.depth, mask_on=True)
        trained = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
        with open(args.merge_out, "wb") as f:
            pickle.dump({"model": W.merge_mask_head(det, trained), "__author__": "apse_uav_torch"}, f)
        print(f"merged mask head into {args.merge_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
