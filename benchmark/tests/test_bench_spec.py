"""Every file of the benchmark is found by the name BENCHMARK.json gives it,
and a new cell needs only new files and a ``workloads`` entry."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_small import BENCH, spec

REPO = os.path.dirname(BENCH)


def bench_json():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in bench_json()["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = spec.find_cell(cell)
    assert c.config["name"] == c.workload["config"]
    assert c.config["family"] in ("aruco", "tracker")
    assert callable(c.driver.run)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_every_file_is_named_in_benchmark_json():
    b = bench_json()
    assert {os.path.relpath(os.path.join(REPO, c["file"]), BENCH) for c in b["configs"]} == {
        os.path.join("configs", f) for f in os.listdir(os.path.join(BENCH, "configs"))}
    assert {w["traffic"] + ".json" for w in b["workloads"]} == set(os.listdir(os.path.join(BENCH, "traffic")))
    assert {m["name"] + ".py" for m in b["per_layer"]} == {
        f for f in os.listdir(os.path.join(BENCH, "metrics")) if f.endswith(".py")}


def test_config_files_name_their_source():
    for c in bench_json()["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"] and cfg["assumed"]


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A copy of the benchmark with one more traffic file and workloads entry:
    the new cell is found, and no file of the copy was edited."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = bench_json()
    tr = json.loads((tmp_path / "benchmark" / "traffic" / "shifted16_b8.json").read_text())
    tr["batch"] = 4
    (tmp_path / "benchmark" / "traffic" / "shifted16_b4.json").write_text(json.dumps(tr))
    b["workloads"].append({"name": "aruco-2pass-b4", "config": "aruco_4x4_50_4k", "traffic": "shifted16_b4",
                           "chips": 1, "why": "calls of 4"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "aruco-2pass-b8" in m.get("workloads", ()):
            m["workloads"].append("aruco-2pass-b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    c = spec.find_cell("aruco-2pass-b4", repo=str(tmp_path))
    assert c.traffic["batch"] == 4 and c.config["family"] == "aruco"
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "aruco_fps"]
    assert spec.metric_reader("aruco.front_ms", repo=str(tmp_path))({"front_ms": 1.5}) == 1.5


def test_without_a_card_no_result(tmp_path):
    """No CUDA device: exit code 2 and no result line; nothing of JAX loaded."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", "aruco-2pass-b8", "--seed",
                        str(2 ** 33), "--seconds", "1"], capture_output=True, text=True, env=env, cwd=tmp_path,
                       timeout=120)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_nothing_of_jax_is_loaded():
    code = ("import sys; sys.path[:0] = [%r, %r]; import run; from benchkit import guard, refmodel, weights, scene;"
            " import refplain.aruco.pipeline; import apse_uav_torch.cli.track_uav, apse_uav_torch.aruco.pipeline;"
            " from benchkit import spec; [spec.find_cell(w['name']) for w in spec.benchmark_json()['workloads']];"
            " print(guard.forbidden_loaded())") % (BENCH, REPO)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_guard_compares_whole_top_level_names():
    from benchkit import guard

    assert guard.forbidden_loaded(["apse_uav_torch", "apse_uav_torch.aruco", "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["jax.numpy", "apse_uav_tpu.aruco", "flax"]) == ["apse_uav_tpu.aruco", "flax",
                                                                                   "jax.numpy"]
