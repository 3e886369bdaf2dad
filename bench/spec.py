"""A cell's files, found by name.

`BENCHMARK.json` (at the root of the checkout) names each cell's
configuration and traffic mix and lists the metrics; the rest lives in
files of their own under `bench/`: `workloads/<cell>.json` (the sample
and the limits of the comparison), the configuration file that
`BENCHMARK.json` gives, `traffic/<mix>.json` (the loop, its load and
drain limit, and the requests' sizes) and `metrics/<metric>.py`
(or the reader of the name before the metric's first dot).
A new cell, configuration, mix or metric is a new file and a new entry;
no file here changes for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict      # the cell's entry in BENCHMARK.json
    config: dict     # the configuration file
    traffic: dict    # traffic/<mix>.json: the loop, its load, the sizes
    load: dict       # workloads/<cell>.json: the comparison's sample, limits

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json with its files (KeyError
    when no cell has that name)."""
    root = Path(root)
    spec = benchmark(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    cfg = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(name=name, entry=entry,
                config=load_json(root / cfg["file"]),
                traffic=load_json(root / "bench" / "traffic" / f"{entry['traffic']}.json"),
                load=load_json(root / "bench" / "workloads" / f"{name}.json"))


def metrics_for(name: str, trace: bool, root: Path = ROOT) -> list[dict]:
    """The metrics a run of cell `name` reports: the end-to-end ones with
    `--trace 0`, the per-layer ones with `--trace 1`; a metric with a
    `workloads` list only in the cells it lists."""
    spec = benchmark(root)
    return [m for m in spec["per_layer" if trace else "end_to_end"]
            if "workloads" not in m or name in m["workloads"]]


def reader(metric: str, root: Path = ROOT) -> Callable[..., Optional[float]]:
    """`read(run)` of `metrics/<metric>.py`, else of `metrics/<the name
    before its first dot>.py` (a reader that serves each cell it is
    listed in: `step_mfu.py` reads `step_mfu.open` and `step_mfu.closed`):
    the metric's value from a run's records, or None where the run holds
    nothing to read."""
    metrics = Path(root) / "bench" / "metrics"
    path = metrics / f"{metric}.py"
    if not path.is_file():
        path = metrics / f"{metric.split('.')[0]}.py"
    mod_name = "bench_metric_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
