"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's ``file`` holds its sizes and its ``family``; the family
names the driver ``drivers/<family>.py``.  The traffic mix is
``traffic/<traffic>.json``.  Each per-layer metric is read by
``metrics/<name>.py``.  A new cell therefore needs only new files and a
``workloads`` entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    driver: object
    end_to_end: list[dict]
    per_layer: list[dict]
    chips: int


def load_module(path: str, name: str):
    """Import the Python file at ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json(repo: str = REPO) -> dict:
    return read_json(os.path.join(repo, "BENCHMARK.json"))


def _listed_for(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None, repo: str = REPO) -> Cell:
    """The cell called ``name``: its entry, configuration, traffic, driver and
    metrics.  Raises KeyError for a name ``BENCHMARK.json`` does not list."""
    bench = benchmark_json(repo) if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(by_name)})")
    work = by_name[name]
    here = os.path.join(repo, os.path.basename(BENCH_DIR))
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(os.path.join(repo, configs[work["config"]]["file"]))
    traffic = read_json(os.path.join(here, "traffic", f"{work['traffic']}.json"))
    family = config["family"]
    driver = load_module(os.path.join(here, "drivers", f"{family}.py"), f"bench_driver_{family}")
    e2e = [m for m in bench["end_to_end"] if _listed_for(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if m["moves"] in e2e_names and _listed_for(m, name)]
    return Cell(name, work, config, traffic, driver, e2e, per_layer, int(work["chips"]))


def metric_reader(name: str, repo: str = REPO):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = os.path.join(repo, os.path.basename(BENCH_DIR), "metrics", f"{name}.py")
    return load_module(path, "bench_metric_" + name.replace(".", "_")).read
