"""Toy COCO-dataset fine-tune demo (dcnn/scripts/train/finetune_coco_dataset.py)
on the PyTorch port.

Flags are those of the JAX reference's ``cli/finetune_coco_dataset.py``, plus
``--device cuda|cpu`` (``cuda`` raises when no card is visible, never falls
back): R50-FPN with ``--num_classes``, from the reference's flax init under
``PRNGKey(0)``, RPN and ROI heads trained, evaluated every 50 iterations,
checkpoints in ``--workdir`` (an end-to-end check of the training path on
any small COCO-format dataset; the reference uses the fruits_nuts toy set).

Usage:
    python -m apse_uav_torch.cli.finetune_coco_dataset --coco_json ann.json \
        --coco_images images/ --workdir runs/coco [--device cpu]
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--coco_json", required=True)
    p.add_argument("--coco_images", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--num_classes", type=int, default=3)
    p.add_argument("--max_iter", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises when no card is visible) or cpu (plain PyTorch path)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from apse_uav_torch.cli.track_uav import cli_device
    from apse_uav_torch.data.datasets import generate_coco_dataset_dictionaries
    from apse_uav_torch.data.loader import DetectionLoader, LoaderConfig
    from apse_uav_torch.dcnn.config import mask_rcnn_r50_fpn
    from apse_uav_torch.train.loop import finetune_detector

    device = cli_device(args)
    dicts = generate_coco_dataset_dictionaries(args.coco_json, args.coco_images)
    cfg = mask_rcnn_r50_fpn(num_classes=args.num_classes)
    lcfg = LoaderConfig(batch_size=args.batch_size, mask_size=28)
    finetune_detector(cfg, iter(DetectionLoader(dicts, lcfg, training=True)),
                      lambda: DetectionLoader(dicts, lcfg, training=False), args.workdir, max_iter=args.max_iter,
                      to_train=("proposal_generator", "roi_heads"), lr=args.lr, test_period=50, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
