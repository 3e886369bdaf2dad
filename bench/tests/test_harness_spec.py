"""Cells, configurations, traffic and metrics are found by name: a new
cell and a new metric are new files and entries, and no file the
benchmark has changes for them."""
import hashlib
import json
from pathlib import Path

import pytest

from bench import spec
from bench.tests import _smoke


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*")) if p.is_file()}


def test_the_repos_cells_and_metrics_resolve():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.config["engine"] and cell.traffic["k"] and cell.load["limits"]
        assert cell.traffic["loop"] in ("open", "closed")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_a_new_cell_and_metric_need_no_edit(tmp_path):
    root = _smoke.make_root(tmp_path)
    before = _digest(root)
    (root / "bench/traffic/tiny-open-slow.json").write_text(json.dumps(
        dict(_smoke.MIXES["tiny-open"], rate_qps=2.0)))
    (root / "bench/workloads/toy.open-slow.json").write_text(json.dumps(
        _smoke.CELLS["toy.open"][2]))
    (root / "bench/metrics/answers_done.open.py").write_text(
        '"""Requests of the window that finished."""\n\n\n'
        "def read(run):\n    return sum(1 for r in run.records if r.ok)\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "toy.open-slow", "config": "dense-toy", "traffic": "tiny-open-slow",
                           "chips": 1, "why": "toy"})
    b["per_layer"].append({"name": "answers_done.open", "unit": "count", "better": "higher",
                           "source": "program_counter", "layer": "engine",
                           "moves": "ttft_p90_ms", "workloads": ["toy.open-slow"]})
    for m in b["end_to_end"]:
        if m["name"] == "ttft_p90_ms":
            m["workloads"].append("toy.open-slow")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    out = _smoke.run(root, "toy.open-slow", seconds=2.0, trace=True)
    assert out["correct"]
    assert out["metrics"]["answers_done.open"]["value"] == out["attempted"] > 0
    plain = _smoke.run(root, "toy.open-slow", seconds=2.0)
    assert set(plain["metrics"]) == {"setup_s", "ttft_p90_ms"}


def test_each_pair_of_config_and_traffic_is_one_cell():
    pairs = [(w["config"], w["traffic"]) for w in spec.benchmark()["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")


def test_a_suffixed_metric_reads_its_base_reader(tmp_path):
    metrics = tmp_path / "bench" / "metrics"
    metrics.mkdir(parents=True)
    (metrics / "busy.py").write_text("def read(run):\n    return 1.0\n")
    (metrics / "busy.open.py").write_text("def read(run):\n    return 2.0\n")
    assert spec.reader("busy.closed", tmp_path)(None) == 1.0
    assert spec.reader("busy", tmp_path)(None) == 1.0
    assert spec.reader("busy.open", tmp_path)(None) == 2.0
    with pytest.raises(FileNotFoundError):
        spec.reader("idle.open", tmp_path)
