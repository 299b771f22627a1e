"""UAVDT aerial fine-tuning (dcnn/scripts/train/finetune_faster_rcnn_aerial.py)
on the PyTorch port.

Flags are those of the JAX reference's ``cli/finetune_faster_rcnn_aerial.py``,
plus ``--device cuda|cpu`` (``cuda`` raises when no card is visible, never
falls back): a 3-class R50/R101-FPN detector with masks off, from
``--weights`` over the reference's flax init under ``PRNGKey(0)``;
``--rpn_only`` trains the RPN and the box head (the reference's param
filter, :65-68), else the RPN and ROI heads; evaluation on the first 50
images every ``--test_period``.

Usage:
    python -m apse_uav_torch.cli.finetune_faster_rcnn_aerial --uavdt_dir UAVDT/train \
        --workdir runs/aerial --weights model_final.pkl [--rpn_only] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--uavdt_dir", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--depth", type=int, default=50, choices=(50, 101))
    p.add_argument("--num_classes", type=int, default=3)
    p.add_argument("--max_iter", type=int, default=1000)
    p.add_argument("--test_period", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--rpn_only", action="store_true", help="train RPN + box regression only")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises when no card is visible) or cpu (plain PyTorch path)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from apse_uav_torch.cli.finetune_uav import initial_weights
    from apse_uav_torch.cli.track_uav import cli_device
    from apse_uav_torch.data.datasets import generate_uav_dataset_dictionaries
    from apse_uav_torch.data.loader import DetectionLoader, LoaderConfig
    from apse_uav_torch.dcnn.config import mask_rcnn_r50_fpn, mask_rcnn_r101_fpn
    from apse_uav_torch.train.loop import finetune_detector

    device = cli_device(args)
    dicts = generate_uav_dataset_dictionaries(args.uavdt_dir)
    if not dicts:
        raise SystemExit("no UAVDT data found")
    make = mask_rcnn_r50_fpn if args.depth == 50 else mask_rcnn_r101_fpn
    cfg = dataclasses.replace(make(num_classes=args.num_classes), mask_on=False)
    lcfg = LoaderConfig(batch_size=args.batch_size)
    to_train = ("proposal_generator", "box_head") if args.rpn_only else ("proposal_generator", "roi_heads")
    finetune_detector(cfg, iter(DetectionLoader(dicts, lcfg, training=True)),
                      lambda: DetectionLoader(dicts[:50], lcfg, training=False), args.workdir,
                      max_iter=args.max_iter, to_train=to_train, lr=args.lr, test_period=args.test_period,
                      init_params=initial_weights(args, cfg, device), device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
