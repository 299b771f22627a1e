"""Read the numbers the comparison decides ``correct`` by, for many seeds in
one process: of the measured program (``--program port``, the lower
readings) or of the control (``--program control``: the plain reference one
precision step below the configuration's in the program's place; the
upper readings).  The benchmark's own runs never run the control.

    python3 benchmark/control.py --workload track-r101fpn-b4 --program control --seconds 5 --seeds 11 12 13

Prints one JSON line a seed: the seed, the frames compared and every
number beside its limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--program", choices=("port", "control"), required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    from benchkit import chip, spec
    from benchkit.context import RunContext

    cell = spec.find_cell(args.workload)
    try:
        chip.require(cell.chips)
    except chip.NoChip as e:
        print(f"control: {e}", file=sys.stderr)
        return 2
    import torch

    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        ctx = RunContext(cell.config, cell.traffic, seed, args.seconds, False, dev, time.perf_counter(), args.program)
        out = cell.driver.run(ctx)
        print(json.dumps({"workload": cell.name, "program": args.program, "seed": seed, "compared": out["compared"],
                          "correct": out["checks"].correct(), "checks": out["checks"].as_dict(),
                          "notes": out.get("notes", {})}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
