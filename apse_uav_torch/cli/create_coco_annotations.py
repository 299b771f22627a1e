"""CSV vehicle labels -> COCO annotation json
(dcnn/scripts/create_coco_annotations.py equivalent).

The port's copy of the JAX reference's ``cli/create_coco_annotations.py``
(pure Python: no device, the same JSON byte for byte).

CSV rows: ``class_name,x,y,w,h,filename,img_width,img_height``.

Usage:
    python -m apse_uav_torch.cli.create_coco_annotations labels.csv annotations.json
"""

from __future__ import annotations

import argparse
import json

NAME_TO_ID = {"car": 0, "truck": 1, "bus": 2, "person": 3}


def convert(csv_path: str, json_path: str) -> dict:
    images: list[dict] = []
    annotations: list[dict] = []
    img_name_to_id: dict[str, int] = {}
    with open(csv_path) as f:
        lines = [line for line in f if line.strip()]
    for ann_id, line in enumerate(lines):
        parts = line.split(",")
        category = NAME_TO_ID[parts[0]]
        bbox = [int(v) for v in parts[1:5]]
        filename = parts[5]
        w, h = int(parts[6]), int(parts[7].strip())
        if filename not in img_name_to_id:
            img_name_to_id[filename] = len(images)
            images.append({"id": img_name_to_id[filename], "file_name": filename, "width": w, "height": h})
        annotations.append(
            {
                "iscrowd": 0,
                "image_id": img_name_to_id[filename],
                "category_id": category,
                "bbox": bbox,
                "id": ann_id,
                "area": bbox[2] * bbox[3],
            }
        )
    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": i, "name": n} for n, i in NAME_TO_ID.items()],
    }
    with open(json_path, "w") as f:
        json.dump(coco, f, indent=1)
    return coco


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input_csv")
    p.add_argument("output_json")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    coco = convert(args.input_csv, args.output_json)
    print(f"wrote {len(coco['images'])} images / {len(coco['annotations'])} annotations")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
