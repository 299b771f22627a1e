"""uint16 id-PNG ground truth -> MOTS txt RLE files, on the PyTorch port
(mots_common/images_to_txt.py equivalent).

Usage:
    python -m apse_uav_torch.cli.images_to_txt input_folder output_folder
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input_folder", help="one subdirectory of PNGs per sequence")
    p.add_argument("output_folder")
    args = p.parse_args(argv)
    from apse_uav_torch.evaluation.mots import images_to_txt

    images_to_txt(args.input_folder, args.output_folder)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
