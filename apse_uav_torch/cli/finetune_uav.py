"""Detector fine-tuning on VisDrone + COCO vehicle data on the PyTorch port
(finetune_uav.py equivalent).

Flags are those of the JAX reference's ``cli/finetune_uav.py``, plus
``--device cuda|cpu`` (``cuda`` raises when no card is visible, never falls
back).  Trains the RPN and ROI heads of a 4-class Mask R-CNN (mask head off,
backbone frozen) from ``--weights`` (a detectron2 ``.pkl`` / ``.pth``; the
parameters it lacks keep the reference's flax init under ``PRNGKey(0)``) or,
without it, from that init alone; periodic COCO AP evaluation,
``results.txt``, and ``last`` / ``bestAP`` / ``bestAR`` checkpoints (the
port's format, with the optimizer state) in ``--workdir``, resumed from
``last`` unless ``--no_resume``.

Usage:
    python -m apse_uav_torch.cli.finetune_uav --visdrone_train VisDrone/train \
        --workdir runs/uav --weights model_final.pkl [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--visdrone_train", default=None, help="VisDrone train dir (images/ + annotations/)")
    p.add_argument("--visdrone_val", default=None)
    p.add_argument("--coco_json", default=None, help="COCO json for extra vehicle data")
    p.add_argument("--coco_images", default=None)
    p.add_argument("--workdir", required=True)
    p.add_argument("--weights", default=None, help="initial checkpoint (.pkl/.pth)")
    p.add_argument("--depth", type=int, default=101, choices=(50, 101))
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--max_iter", type=int, default=1000)
    p.add_argument("--test_period", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--train_size", type=int, nargs=2, default=(768, 1344))
    p.add_argument("--to_train", nargs="+", default=["proposal_generator", "roi_heads"])
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--eval_images", type=int, default=100, help="cap eval set size per test")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises when no card is visible) or cpu (plain PyTorch path)")
    return p


def model_config(args):
    """The reference's fine-tune model: R50/R101-FPN, ``--num_classes``, no mask head (finetune_uav.py:92)."""
    from apse_uav_torch.dcnn.config import mask_rcnn_r50_fpn, mask_rcnn_r101_fpn

    cfg = (mask_rcnn_r50_fpn if args.depth == 50 else mask_rcnn_r101_fpn)(num_classes=args.num_classes)
    return dataclasses.replace(cfg, mask_on=False)


def initial_weights(args, cfg, device, weights: dict | None = None) -> dict | None:
    """The start of the fine-tune: ``--weights`` (or the loaded ``weights``)
    over the reference's flax init under ``PRNGKey(0)``, as a state dict;
    None without weights (the loop then takes that init itself)."""
    if weights is None and not args.weights:
        return None
    from apse_uav_torch.dcnn import flax_init, weights as W
    from apse_uav_torch.dcnn.models.mask_rcnn import MaskRCNN

    model = MaskRCNN(cfg)
    missing, _ = W.load_detectron2(model, W.load_torch_file(args.weights) if weights is None else weights)
    if missing:  # only these need the init
        W.load_detectron2(model, flax_init.mask_rcnn_init(cfg, 0, device, only=set(missing)))
    print(f"loaded {args.weights or 'weights'}; {len(missing)} params left at init")
    return model.state_dict()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from apse_uav_torch.cli.track_uav import cli_device
    from apse_uav_torch.data.datasets import (COCO_CATEGORY_IDS_TO_UAV, generate_coco_dataset_dictionaries,
                                              generate_visdrone_dataset_dictionaries)
    from apse_uav_torch.data.loader import DetectionLoader, LoaderConfig
    from apse_uav_torch.train.loop import finetune_detector

    device = cli_device(args)
    train_dicts: list[dict] = []
    val_dicts: list[dict] = []
    if args.visdrone_train:
        train_dicts += generate_visdrone_dataset_dictionaries(args.visdrone_train)
    if args.coco_json:
        train_dicts += generate_coco_dataset_dictionaries(args.coco_json, args.coco_images,
                                                          category_mapping=COCO_CATEGORY_IDS_TO_UAV)
    if args.visdrone_val:
        val_dicts += generate_visdrone_dataset_dictionaries(args.visdrone_val)
    if not train_dicts:
        raise SystemExit("no training data given")
    val_dicts = val_dicts or train_dicts[:args.eval_images]

    lcfg = LoaderConfig(train_size=tuple(args.train_size), batch_size=args.batch_size, mask_size=28)
    cfg = model_config(args)
    finetune_detector(cfg, iter(DetectionLoader(train_dicts, lcfg, training=True)),
                      lambda: DetectionLoader(val_dicts[:args.eval_images], lcfg, training=False), args.workdir,
                      max_iter=args.max_iter, to_train=tuple(args.to_train), lr=args.lr,
                      test_period=args.test_period, init_params=initial_weights(args, cfg, device),
                      resume=not args.no_resume, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
