"""Run one cell of the benchmark of ``apse_uav_torch`` once and print its result.

    python3 benchmark/run.py --workload aruco-2pass-b8 --seed 7 --seconds 30 --trace 0

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix, driver and per-layer readers are found by name
(``benchkit/spec.py``).  Set-up (imports, kernel loading, the scene, weights,
warm-up of the cell's shapes) runs first and is ``setup_s``; then the
driver's window runs for ``--seconds``; then the sampled outputs are
compared with the plain reference.  With ``--trace 1`` the window is
followed by a profiled stretch and the per-layer readings, and the metrics
printed are the per-layer ones.

The last lines of standard error give each number compared beside its
limit; the last line of standard output is the JSON result.  The run exits
non-zero and prints no result when there is no CUDA device, fewer than the
cell asks for, or when JAX, its libraries or the JAX package were loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, outcome: dict, device_rec: dict, trace: bool) -> dict:
    """The result: end-to-end metrics (untraced) or the per-layer readings
    (traced; a reader that finds nothing leaves its metric out), the device,
    the breakdown, and the numbers compared, each with its limit, last."""
    from benchkit import spec

    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome["metrics"][m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(outcome["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = outcome["checks"]
    line = {"correct": checks.correct(), "attempted": outcome["attempted"], "failed": outcome["failed"],
            "metrics": metrics, "device": device_rec}
    if trace:
        rec = outcome["record"]
        line["device"] = {**device_rec, "busy_s": rec["busy_s"], "window_s": rec["window_s"]}
        line["breakdown"] = rec["breakdown"]
    line["checks"] = checks.as_dict()
    return line


def main(argv=None) -> int:
    args = parse(argv)
    from benchkit import chip, guard, spec
    from benchkit.context import RunContext

    cell = spec.find_cell(args.workload)
    try:
        chip.require(cell.chips)
    except chip.NoChip as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    device = torch.device("cuda", 0)
    ctx = RunContext(cell.config, cell.traffic, args.seed, args.seconds, bool(args.trace), device, T_START)
    outcome = cell.driver.run(ctx)
    device_rec = {**chip.device_record(device, cell.chips), "memory_peak_bytes": outcome["memory_peak_bytes"]}
    line = result_line(cell, outcome, device_rec, bool(args.trace))
    found = guard.forbidden_loaded()
    if found:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    print(f"benchmark: {cell.name} seed {args.seed}: {outcome['compared']} frames compared, "
          f"card {chip.power_limit()}", file=sys.stderr)
    for key, v in outcome.get("notes", {}).items():
        print(f"note {key} {json.dumps(v)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
