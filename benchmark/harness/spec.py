"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix. The
configuration's file is the one ``configs`` gives it; the traffic mix is
``traffic/<traffic>.json``; each metric is read by
``metrics/<metric name>.py``. Adding a cell, a mix or a metric adds files
and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Spec:
    """``BENCHMARK.json`` at ``path``; its traffic mixes in
    ``traffic_dir`` and its cells' limits in ``limits_dir``."""

    def __init__(self, path: pathlib.Path = ROOT / "BENCHMARK.json",
                 traffic_dir: pathlib.Path = BENCH_DIR / "traffic",
                 limits_dir: pathlib.Path = BENCH_DIR / "limits"):
        self.root = path.parent
        self.data = json.loads(path.read_text())
        self.traffic_dir = traffic_dir
        self.limits_dir = limits_dir

    def workload(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic_path(self, name: str) -> pathlib.Path:
        return self.traffic_dir / f"{name}.json"

    def limits(self, workload: str) -> dict:
        """The limits of the numbers ``correct`` compares in ``workload``
        (``limits/<workload>.json``)."""
        return json.loads((self.limits_dir / f"{workload}.json").read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(self.traffic_path(name).read_text())

    def metrics(self, cell: str, section: str) -> list[dict]:
        """The metrics of ``section`` ("end_to_end" or "per_layer") that
        ``cell`` reports: those that list it, and those that list no
        cells."""
        return [m for m in self.data[section]
                if cell in m.get("workloads", [cell])]


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
