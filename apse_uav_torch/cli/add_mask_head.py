"""Weight surgery CLI: graft a COCO mask head into a fine-tuned detector
(dcnn/scripts/add_mask_head_to_frcnn.py equivalent) on the PyTorch port.

Flags are those of the JAX reference's ``cli/add_mask_head.py``.  The
detector's R-FPN entries (mask head left out) and the mask source's mask
head, its predictor cut to ``--class_rows`` (default COCO car / truck /
bus), are written as one detectron2-named ``.pkl`` (``{"model": {name:
array}}``), which ``weights.load_torch_file`` / ``load_detectron2`` and the
port's ``--weights`` flags read.  (The reference writes the same tensors
under its flax paths.)  Host work only: no device.

Usage:
    python -m apse_uav_torch.cli.add_mask_head --detector frcnn.pth \
        --mask_source mask_rcnn_R_101_FPN_3x.pkl --out merged.pkl
"""

from __future__ import annotations

import argparse
import pickle


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--detector", required=True, help="target detector checkpoint (.pkl/.pth)")
    p.add_argument("--mask_source", required=True, help="COCO Mask R-CNN checkpoint with the mask head")
    p.add_argument("--out", required=True, help="output .pkl")
    p.add_argument("--depth", type=int, default=101, choices=(50, 101))
    p.add_argument("--class_rows", type=int, nargs="+", default=[2, 7, 5],
                   help="source class indices to keep (default COCO car/truck/bus)")
    p.add_argument("--num_src_classes", type=int, default=80)
    return p


def merge(args) -> dict:
    """The merged checkpoint: {detectron2 name: numpy array}."""
    from apse_uav_torch.dcnn import weights as W

    det = W.reference_subset(W.load_torch_file(args.detector), args.depth, mask_on=False)
    src = W.reference_subset(W.load_torch_file(args.mask_source), args.depth, mask_on=True)
    mask = W.slice_predictor_classes({k: v for k, v in src.items() if k.startswith("roi_heads.mask_head.")},
                                     args.class_rows, args.num_src_classes)
    return W.merge_mask_head(det, mask)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    merged = merge(args)
    with open(args.out, "wb") as f:
        pickle.dump({"model": merged, "__author__": "apse_uav_torch"}, f)
    n_mask = sum(k.startswith("roi_heads.mask_head.") for k in merged)
    print(f"wrote {args.out}: {len(merged)} tensors ({n_mask} mask-head grafts)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
