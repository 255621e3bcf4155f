"""The reader of ``graph_replay_share`` on a synthetic run: the share of
the window's units run by replaying CUDA graphs, and None where the
program counts no replays (a program without them) or ran no unit."""

import json

import pytest

from harness.cell import Run
from harness.spec import BENCH_DIR, ROOT, reader

CFG320 = json.loads((BENCH_DIR / "configs" / "rfb320.json").read_text())
VGA_S2 = json.loads((BENCH_DIR / "traffic" / "vga-s2-det-32cam-15fps.json")
                    .read_text())


def _run(meter: dict) -> Run:
    return Run(cfg=CFG320, traffic=VGA_S2, setup_s=12.5, t0=10.0, t1=20.0,
               meter=dict(meter), submitted=[], spans=[],
               load={"received": [1200, 800]}, device={})


@pytest.mark.parametrize("replays, share", [(0, 0.0), (37, 37.0),
                                            (99, 99.0), (100, 100.0)])
def test_share_of_units_replayed(replays, share):
    run = _run({"batches": 100, "inferred_unique": 2000,
                "graph_replays": replays, "graph_captures": 0})
    assert reader("graph_replay_share")(run) == pytest.approx(share)


@pytest.mark.parametrize("meter", [
    {"batches": 100, "inferred_unique": 2000},  # a program without replays
    {"batches": 0, "graph_replays": 0},  # no unit in the window
    {}])
def test_nothing_to_read_gives_none(meter):
    assert reader("graph_replay_share")(_run(meter)) is None


def test_declared_for_every_cell_as_the_device_stage_share():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}["graph_replay_share"]
    assert m == {"name": "graph_replay_share", "unit": "%",
                 "better": "higher", "source": "program_counter",
                 "layer": "device stage",
                 "moves": "server_cpu_ms_per_frame"}
