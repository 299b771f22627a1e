"""MOTS evaluation CLI on the PyTorch port (dcnn/mots_tools/mots_eval/eval.py equivalent).

Scores the cars and pedestrians of every sequence of the seqmap (txt files
or uint16 id-PNG directories) and prints the CLEAR-MOT-style tables.

Usage:
    python -m apse_uav_torch.cli.mots_eval results_folder gt_folder seqmap
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("results_folder")
    p.add_argument("gt_folder")
    p.add_argument("seqmap")
    args = p.parse_args(argv)
    from apse_uav_torch.evaluation.mots import run_eval

    run_eval(args.results_folder, args.gt_folder, args.seqmap)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
