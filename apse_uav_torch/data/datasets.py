"""Dataset-dict generators (detectron2-style schema, no detectron2).

The port's copy of the JAX reference's ``data/datasets.py`` (plain Python and
numpy; PIL only to read image sizes).

Each generator returns a list of dicts::

    {"file_name", "image_id", "height", "width",
     "annotations": [{"bbox" [x,y,w,h], "bbox_mode": "xywh",
                      "category_id", "is_crowd", "target_id",
                      optional "segmentation" RLE}]}

mirroring the reference's generators:
* VisDrone (dcnn/utils/visdrone_utils.py:10-83) — txt annotations
  ``x,y,w,h,score,category,truncation,occlusion`` with the category map and
  ignore list below.
* UAVDT (dcnn/utils/UAV_utils.py:28-161) — per-sequence ``*_gt_whole.txt``
  with ``frame,id,x,y,w,h,out-of-view,occlusion,class``; sequence/id ignore
  lists; occlusion==2 dropped.
* COCO json (dcnn/utils/COCO_utils.py:24-76) — with COCO->UAV class remap.
* COWC aerial cars (dcnn/utils/cowc_utils.py) — point-annotation PNGs
  turned into fixed-size boxes, large frames sliced into tiles.
"""

from __future__ import annotations

import json
import os
from os.path import join

import numpy as np

# Class ids in the 4-class UAV vehicle model: 0 car, 1 truck, 2 bus, 3 person.
UAV_CLASSES = ("car", "truck", "bus", "person")

IGNORED_VISDRONE_CATEGORIES = (0, 3, 7, 8, 10, 11)
VISDRONE_CATEGORY_IDS_TO_UAV = {1: 3, 2: 3, 4: 0, 5: 0, 6: 1, 9: 2}

COCO_CATEGORY_IDS_TO_UAV = {1: 3, 3: 0, 6: 2, 8: 1}

UAVDT_IGNORED_SEQUENCES = ("M0601", "M0207")
UAVDT_IGNORED_IDS_PER_SEQUENCE = {
    "M0606": (68, 69, 112, 71),
    "M0501": (10,),
    "M1007": (36,),
    "M0210": (34, 6, 2, 11, 10, 30, 18),
    "M1401": (42, 66),
    "M1304": (75, 76),
    "M0204": (22,),
    "M1001": (11,),
    "M0802": (23, 53),
}

_IMG_EXTS = ("jpg", "png", "bmp")


def _image_size(path: str) -> tuple[int, int]:
    from PIL import Image

    with Image.open(path) as im:
        return im.height, im.width


def _images_in(path: str) -> list[str]:
    out = [
        f
        for f in sorted(os.listdir(path))
        if f.split(".")[-1] in _IMG_EXTS and "Annotated" not in f
    ]
    return out


def fabricate_outputs(gt_img_dict: dict) -> list[dict]:
    """GT -> fake perfect detections (score 1) for eval-plumbing tests
    (UAV_utils.py:42-57)."""
    return [
        {
            "image_id": gt_img_dict["image_id"],
            "category_id": a["category_id"],
            "bbox": a["bbox"],
            "score": 1,
        }
        for a in gt_img_dict["annotations"]
    ]


# ---------------------------------------------------------------------------


def generate_visdrone_dataset_dictionaries(dataset_dir: str) -> list[dict]:
    imgdir, anndir = join(dataset_dir, "images"), join(dataset_dir, "annotations")
    result = []
    for image_id, imgname in enumerate(_images_in(imgdir)):
        img_path = join(imgdir, imgname)
        h, w = _image_size(img_path)
        annotations = []
        ann_path = join(anndir, imgname.rsplit(".", 1)[0] + ".txt")
        with open(ann_path) as f:
            for i, line in enumerate(f):
                vals = [int(v) for v in line.strip().split(",") if v != ""]
                if not vals:
                    continue
                category = vals[5]
                if category in IGNORED_VISDRONE_CATEGORIES:
                    continue
                annotations.append(
                    {
                        "is_crowd": 0,
                        "bbox": vals[:4],
                        "bbox_mode": "xywh",
                        "category_id": VISDRONE_CATEGORY_IDS_TO_UAV[category],
                        "target_id": int(str(image_id) + str(i)),
                    }
                )
        result.append(
            {
                "file_name": img_path,
                "image_id": image_id,
                "height": h,
                "width": w,
                "annotations": annotations,
            }
        )
    return result


# ---------------------------------------------------------------------------


def generate_uav_dataset_dictionaries(
    dataset_dir: str, allowed: list[str] | None = None, category_mapping: dict | None = None
) -> list[dict]:
    """UAVDT layout: <seq>/<img00000k.jpg>, <seq>_gt_whole.txt next to it."""
    result = []
    image_id = 0
    sequences = sorted(
        d for d in os.listdir(dataset_dir) if os.path.isdir(join(dataset_dir, d))
    )
    for seq in sequences:
        if seq in UAVDT_IGNORED_SEQUENCES:
            continue
        if allowed is not None and seq not in allowed:
            continue
        gt_path = join(dataset_dir, seq + "_gt_whole.txt")
        if not os.path.exists(gt_path):
            gt_path = join(dataset_dir, seq, "gt_whole.txt")
        rows = []
        with open(gt_path) as f:
            for line in f:
                rows.append([int(v) for v in line.strip().split(",")])
        inst = np.asarray(rows).reshape(-1, 9)
        ignored_ids = UAVDT_IGNORED_IDS_PER_SEQUENCE.get(seq, ())
        seqdir = join(dataset_dir, seq)
        for imgname in _images_in(seqdir):
            frame_number = int(imgname.replace("img", "").split(".")[0])
            frame_objs = inst[inst[:, 0] == frame_number]
            annotations = []
            for o in frame_objs:
                target_id = int(o[1])
                if target_id in ignored_ids:
                    continue
                if o[7] == 2:  # large occlusion (UAV_utils.py:111)
                    continue
                cls = int(o[8]) - 1
                if category_mapping:
                    cls = category_mapping[cls]
                annotations.append(
                    {
                        "is_crowd": 0,
                        "bbox": [int(v) for v in o[2:6]],
                        "bbox_mode": "xywh",
                        "category_id": int(cls),
                        # globally-unique target id (UAV_utils.py:116)
                        "target_id": int(seq[1:] + imgname.replace("img", "").split(".")[0] + str(target_id)),
                    }
                )
            img_path = join(seqdir, imgname)
            h, w = _image_size(img_path)
            result.append(
                {
                    "file_name": img_path,
                    "image_id": image_id,
                    "height": h,
                    "width": w,
                    "annotations": annotations,
                }
            )
            image_id += 1
    return result


# ---------------------------------------------------------------------------


def generate_coco_dataset_dictionaries(
    json_filepath: str,
    imgfolder_path: str,
    allowed_classes: list[int] | None = None,
    category_mapping: dict | None = None,
) -> list[dict]:
    with open(json_filepath) as f:
        coco = json.load(f)
    anns_per_image: dict[int, list] = {}
    for ann in coco.get("annotations", []):
        anns_per_image.setdefault(ann["image_id"], []).append(ann)
    result = []
    for img in coco["images"]:
        annotations = []
        for ann in anns_per_image.get(img["id"], []):
            cat = ann["category_id"]
            if allowed_classes is not None and cat not in allowed_classes:
                continue
            if category_mapping is not None:
                if cat not in category_mapping:
                    continue
                cat = category_mapping[cat]
            a = {
                "is_crowd": ann.get("iscrowd", 0),
                "bbox": list(ann["bbox"]),
                "bbox_mode": "xywh",
                "category_id": cat,
                "target_id": ann.get("id", 0),
            }
            if isinstance(ann.get("segmentation"), dict):
                a["segmentation"] = ann["segmentation"]
            annotations.append(a)
        result.append(
            {
                "file_name": join(imgfolder_path, img["file_name"]),
                "image_id": img["id"],
                "height": img["height"],
                "width": img["width"],
                "annotations": annotations,
            }
        )
    return result


# ---------------------------------------------------------------------------


def generate_cowc_dataset_dictionaries(
    dataset_dir: str,
    box_size: int = 30,
    tile: int = 1024,
    annotation_suffix: str = "_Annotated_Cars.png",
) -> list[dict]:
    """COWC: large aerial frames + point-annotation PNGs (cowc_utils.py).

    Non-zero annotation pixels mark car centers; each becomes a
    ``box_size`` square.  Frames larger than ``tile`` are sliced into
    non-overlapping tiles (cowc_utils.py:33-47) with per-tile crops recorded
    as (file_name, crop) entries.
    """
    from PIL import Image

    result = []
    image_id = 0
    for fname in _images_in(dataset_dir):
        if fname.endswith(annotation_suffix.split(".")[0] + ".png") and "Annotated" in fname:
            continue
        ann_path = join(dataset_dir, fname.rsplit(".", 1)[0] + annotation_suffix)
        if not os.path.exists(ann_path):
            continue
        img_path = join(dataset_dir, fname)
        h, w = _image_size(img_path)
        ann = np.array(Image.open(ann_path))
        if ann.ndim == 3:
            ann = ann[..., :3].max(axis=-1)
        ys, xs = np.nonzero(ann)
        for ty in range(0, h, tile):
            for tx in range(0, w, tile):
                th, tw = min(tile, h - ty), min(tile, w - tx)
                sel = (ys >= ty) & (ys < ty + th) & (xs >= tx) & (xs < tx + tw)
                annotations = []
                for k, (y, x) in enumerate(zip(ys[sel], xs[sel])):
                    bx = float(x - tx - box_size / 2)
                    by = float(y - ty - box_size / 2)
                    annotations.append(
                        {
                            "is_crowd": 0,
                            "bbox": [bx, by, float(box_size), float(box_size)],
                            "bbox_mode": "xywh",
                            "category_id": 0,
                            "target_id": image_id * 100000 + k,
                        }
                    )
                result.append(
                    {
                        "file_name": img_path,
                        "image_id": image_id,
                        "height": th,
                        "width": tw,
                        "crop": (tx, ty, tw, th),
                        "annotations": annotations,
                    }
                )
                image_id += 1
    return result
