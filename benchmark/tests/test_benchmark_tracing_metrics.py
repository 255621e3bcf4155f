"""The readers of the host path's tracing metrics on a synthetic run:
their values, None where the program recorded nothing to read (a program
without the spans and counters), and the stage CPU metrics adding up to
the server's CPU time per frame."""

import json

import pytest

from harness.cell import Run
from harness.spec import BENCH_DIR, ROOT, reader

CFG320 = json.loads((BENCH_DIR / "configs" / "rfb320.json").read_text())
VGA_S2 = json.loads((BENCH_DIR / "traffic" / "vga-s2-det-32cam-15fps.json")
                    .read_text())
STAGE_CPU = ("decode_cpu_ms", "dispatch_cpu_ms", "readback_wait_cpu_ms",
             "publish_cpu_ms")
NEW = STAGE_CPU + ("other_cpu_ms", "dispatch_wait_ms", "queue_wait_ms",
                   "input_launch_ms", "trunk_launch_ms", "post_launch_ms",
                   "readback_ms")
# 2,000 frames delivered in 100 units, the window [10, 20]
METER = {"batches": 100, "inferred_unique": 2000, "cpu_s_decode": 1.0,
         "cpu_s_upload": 0.2, "cpu_s_device": 3.0,
         "cpu_s_readback_wait": 0.4, "cpu_s_publish": 0.6,
         "queue_wait_s": 50.0, "queued_frames": 2000}


def _spans():
    """100 units in the window, each: a 40 ms device span holding two 2 ms
    input launches, a 10 ms trunk launch, a 6 ms post launch and a 1 ms
    readback; and spans outside the window that no reader counts."""
    out = []
    for i in range(100):
        a = 10.0 + 0.09 * i
        out += [("launch_input", a, a + 0.002),
                ("launch_input", a + 0.002, a + 0.004),
                ("launch_trunk", a + 0.004, a + 0.014),
                ("launch_post", a + 0.014, a + 0.020),
                ("readback", a + 0.020, a + 0.021),
                ("device_ycbcr", a, a + 0.040)]
    out += [("device_ycbcr", 25.0, 25.5), ("launch_trunk", 25.0, 25.2),
            ("readback", 9.0, 9.5)]
    return out


def _run(meter=None, spans=(), server_cpu_s=10.0, received=(1200, 800)):
    return Run(cfg=CFG320, traffic=VGA_S2, setup_s=12.5, t0=10.0, t1=20.0,
               meter=dict(meter or {}), submitted=[], spans=list(spans),
               load={"received": list(received)}, device={},
               server_cpu_s=server_cpu_s)


def test_each_reader_on_a_synthetic_run():
    run = _run(METER, _spans())
    want = {"decode_cpu_ms": 0.6, "dispatch_cpu_ms": 1.5,
            "readback_wait_cpu_ms": 0.2, "publish_cpu_ms": 0.3,
            "other_cpu_ms": 2.4, "queue_wait_ms": 25.0,
            # 4 s of device spans less 3 s of CPU, over 100 units
            "dispatch_wait_ms": 10.0, "input_launch_ms": 4.0,
            "trunk_launch_ms": 10.0, "post_launch_ms": 6.0,
            "readback_ms": 1.0}
    for name, value in want.items():
        assert reader(name)(run) == pytest.approx(value), name
    assert reader("dispatch_ms")(run) == pytest.approx(
        reader("dispatch_wait_ms")(run)
        + 1e3 * METER["cpu_s_device"] / METER["batches"])


def test_stage_cpu_metrics_add_up_to_the_servers_cpu_per_frame():
    for server_cpu_s in (5.2, 10.0, 31.7):
        run = _run(METER, _spans(), server_cpu_s=server_cpu_s)
        total = sum(reader(n)(run) for n in STAGE_CPU + ("other_cpu_ms",))
        assert total == pytest.approx(
            reader("server_cpu_ms_per_frame")(run))


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name):
    # a program without the new spans and counters: the parent's Meter
    # totals and stage spans only
    parent = _run({"batches": 100, "inferred_unique": 2000},
                  [("device_ycbcr", 11.0, 11.04), ("decode", 11.0, 11.01)])
    assert reader(name)(parent) is None
    assert reader(name)(_run({}, ())) is None
    no_frames = reader(name)(_run(METER, _spans(), received=(0,)))
    if name in STAGE_CPU + ("other_cpu_ms",):  # per frame delivered
        assert no_frames is None
    else:
        assert no_frames == reader(name)(_run(METER, _spans()))


def test_each_new_metric_is_declared_for_every_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["moves"] == "server_cpu_ms_per_frame" and m["unit"] == "ms"
        assert "workloads" not in m
