"""The comparison that decides ``correct``, shown to fail.

A whole run of the harness on the CPU at a test size (four cameras at 6
fps, decoded as the rfb320-vga-32cam cell decodes, the port's real server
and the load generator's process), held to the rfb320-vga-32cam cell's own
limits:
it passes as it stands, and fails with the timed path broken underneath
in each way a serving cell can break (`harness.faults`: a step that
returns its state unchanged, half of a batch left out, an answer altered
where it is produced, the chroma planes swapped; one card, so no exchange
between cards), and with each control in the program's place: the
reference with the resize's operands in TF32, and with the trunk in
float8 e4m3. On the card the controls and faults are read at the cells'
own sizes (``calibrate.py``)."""

import json
import shutil

import pytest
import torch

import run as bench
from harness import cell, compare
from harness.faults import FAULTS
from harness.spec import BENCH_DIR, ROOT, Spec

CELL = "rfb320-vga-32cam"
SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    data["workloads"] = [{"name": "tiny", "config": "rfb320",
                          "traffic": "tiny-vga-s2", "chips": 1, "why": "test"}]
    (tmp / "BENCHMARK.json").write_text(json.dumps(data))
    (tmp / "limits").mkdir()
    shutil.copy(BENCH_DIR / "limits" / f"{CELL}.json",
                tmp / "limits" / "tiny.json")
    s = Spec(tmp / "BENCHMARK.json", BENCH_DIR / "tests" / "data" / "traffic",
             tmp / "limits")
    s.root = ROOT
    return s


def _run(spec, fault=None):
    return bench.run_cell(spec, "tiny", SEED, 3.0, False,
                          torch.device("cpu"), program_fault=fault)


def test_a_sound_run_is_correct(spec):
    result = _run(spec)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["checks"]["records"]["value"]
    assert set(result["metrics"]) == {"setup_s", "server_cpu_ms_per_frame"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(spec, fault):
    result = _run(spec, FAULTS[fault])
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("control", ["fp8"])
def test_the_control_fails_the_limits(spec, control):
    """The control in the program's place, one record a frame, against
    the reference in the configuration's precision."""
    cfg = spec.config("rfb320")
    traffic = spec.traffic("tiny-vga-s2")
    seed, device = SEED, torch.device("cpu")
    from harness import frames, weights
    from reference import ultraface as ref

    jpegs = frames.stream_jpegs(traffic, seed)
    x = ref.network_inputs(cfg, [s[0] for s in jpegs],
                           scale=traffic["decode_scale"], device=device)
    params = weights.make_params(cfg, seed, device, x)
    refs = cell.references(cfg, traffic, seed, params, device)
    ctl = cell.references(cfg, traffic, seed, params, device,
                          control=control)
    size = cell.decoded_size(traffic)
    records = [(k, d, cell.as_record(draw[2], size), size)
               for k, draws in ctl.items() for d, draw in enumerate(draws)]
    checks = compare.compare(records, refs, cfg)
    limits = spec.limits("tiny")["limits"]
    print(control, checks)
    assert any(checks[k] > v for k, v in limits.items() if k in checks), \
        checks
