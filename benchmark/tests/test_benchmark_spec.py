"""BENCHMARK.json, the files it names and the rules they keep."""

import ast
import json
import pathlib

import pytest

from harness.spec import BENCH_DIR, NAME, ROOT, UNIT, Spec, reader

SPEC = Spec()
DATA = SPEC.data


def test_finds_config_traffic_and_metric_by_name():
    for cell in DATA["workloads"]:
        cfg = SPEC.config(cell["config"])
        assert cfg["name"] == cell["config"]
        traffic = SPEC.traffic(cell["traffic"])
        assert traffic["streams"] >= 1
        assert set(SPEC.limits(cell["name"])["limits"]) == {
            "det_gap", "miss_gap", "off_share", "unmatched", "size_gap"}
    for section in ("end_to_end", "per_layer"):
        for m in DATA[section]:
            assert callable(reader(m["name"]))
    with pytest.raises(KeyError):
        SPEC.workload("no-such-cell")


def test_names_and_units_keep_to_the_allowed_characters():
    names = [c["name"] for c in DATA["configs"]]
    names += [w["name"] for w in DATA["workloads"]]
    names += [w["traffic"] for w in DATA["workloads"]]
    names += [m["name"] for s in ("end_to_end", "per_layer")
              for m in DATA[s]]
    names += [k for c in DATA["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(m["name"] for s in ("end_to_end", "per_layer")
                   for m in DATA[s])) == len(DATA["end_to_end"]) + len(
                       DATA["per_layer"])
    for s in ("end_to_end", "per_layer"):
        for m in DATA[s]:
            assert UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in DATA["workloads"]]
                 + [m["layer"] for m in DATA["per_layer"]]
                 + [c["source"] for c in DATA["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in DATA["end_to_end"]}
    cells = [w["name"] for w in DATA["workloads"]]
    for m in DATA["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:
        reported = [m["name"] for m in SPEC.metrics(cell, "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert SPEC.metrics(cell, "per_layer")


def test_bounds_and_run_seconds_within_the_contract():
    assert 1 <= DATA["run_seconds"] <= 51
    for m in DATA["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert DATA["command"][:2] == ["python3", "benchmark/run.py"]
    assert DATA["paths"] == ["benchmark"]
    for cfg in DATA["configs"]:
        assert (ROOT / cfg["file"]).is_file()
        assert cfg["file"].startswith("benchmark/")


FORBIDDEN = {"jax", "jaxlib", "flax", "infercam_onnx_tpu"}


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_nothing_imports_jax_or_the_jax_package(path):
    """Judged by whole top-level names: the port's name begins with the
    JAX package's."""
    found = _imports(path) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference")
                                        .rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not {m for m in _imports(path)
                if m.startswith("infercam")}, path


def test_forbidden_check_compares_whole_names(monkeypatch):
    import sys

    import run

    monkeypatch.setitem(sys.modules, "infercam_onnx_tpu_torch_x", object())
    assert "infercam_onnx_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "infercam_onnx_tpu.detector", object())
    assert run.forbidden_modules() == ["infercam_onnx_tpu"]


def test_config_files_hold_the_published_widths():
    for name, (w, h, k) in {"rfb320": (320, 240, 4420),
                            "rfb640": (640, 480, 17640)}.items():
        cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json")
                         .read_text())
        assert (cfg["input_width"], cfg["input_height"]) == (w, h)
        assert cfg["base_channel"] == 16 and cfg["num_priors"] == k
        from reference.ultraface import priors
        assert len(priors(cfg)) == k
