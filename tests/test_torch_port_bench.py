"""The port's headline bench and microbench (``infercam_onnx_tpu_torch/
bench.py``, ``microbench.py``) on the CPU, against the JAX bench.

- The eight cases of ``tests/test_bench_plan.py`` as cases of one
  parametrised test against the port's ``_Plan`` and ``main`` (every
  phase of ``main`` replaced by a stub: no serving window runs here).
  Where the port differs by design the case says so: a failed phase, or a
  MUST phase skipped at the hard wall, labels the line and exits 1; a
  signal's partial line exits 1; the anchor row goes to ``--anchors``.
- FLOPs per frame of the port's detect program (FlopCounterMode) within 2%
  of JAX's ``cost_analysis()`` for the JAX bench's program (RFB-320 bf16,
  B=2, 640x480): JAX counts every elementwise op, the port only the
  matmuls and convolutions, which are 99% of them.
- The CPU baseline's ``run_one`` on the weights JAX's
  ``init_params(0, background_bias=bench.BASELINE_BIAS)`` carries across
  equals JAX's float32 ``Detector.detect``: the same detections, boxes
  and confidences within the 5e-5 of ``test_torch_port_detector.py``
  (with the device phases' bias of 0.75 each picture gives more than
  64 detections, past the JAX detector's ``max_detections``; the
  baseline's bias keeps them sparse, as its own case checks).
- The microbench CLI on the CPU prints one line per batch with the JAX
  tool's keys.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infercam_onnx_tpu import detector as jdet
from infercam_onnx_tpu.config import DetectorConfig as JDetectorConfig
from infercam_onnx_tpu.models import ultraface as juf
from infercam_onnx_tpu.ops.postprocess import \
    batched_postprocess as jbatched_postprocess
from infercam_onnx_tpu.ops.preprocess import Preprocessor as JPreprocessor
from infercam_onnx_tpu.ops.preprocess import \
    preprocess_images as jpreprocess_images
from infercam_onnx_tpu_torch import bench, codec, microbench

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

# the keys of the JAX bench's line (bench.py's result dict, with the
# anchor, tiled and serving families its phases fill)
JAX_BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "p50_frame_ms",
    "p50_batch_ms", "batch", "cpu_baseline_fps", "fps_ycbcr_path",
    "fps_pixels_path", "fps_annotated_device", "fps_annotated_host",
    "fps_annotated_splice_fullres", "fps_annotated_host_fullres",
    "flops_per_frame", "onchip_fps", "onchip_ms_per_batch", "mfu_batch",
    "achieved_tflops", "device_compute_ms_per_batch", "device_only_fps",
    "anchor_dispatch_ms", "tiled_1080p_fps", "serving_p50_e2e_ms",
    "serving_frames", "serving_delivered_fps", "serving_mean_batch",
    "serving_latency_p50_e2e_ms", "serving_lossless_fps",
    "serving_lossless_mean_batch", "serving_lossless_max_batch",
    "bench_wall_s", "latch_s", "h2d_probe_mbps", "slow_link", "phase_s",
    "skipped_phases", "device"}
PORT_EXTRA_KEYS = {"power_limit", "flops_per_frame_f32",
                   "flops_per_frame_bf16", "nms_launches"}
MICROBENCH_KEYS = {"batch", "iters", "device", "preprocess_ms",
                   "preprocess+cnn_ms", "full_ms", "annotated_ms",
                   "splice_ms", "tiled_1080p_ms", "fps_on_chip"}


def _notes():
    msgs: list[str] = []
    return msgs, msgs.append


# -- main with every phase stubbed -----------------------------------------


ANCHOR = {"flops_per_frame": 938117120, "flops_per_frame_f32": 737280000,
          "flops_per_frame_bf16": 200837120, "onchip_fps": 1000.0,
          "onchip_ms_per_batch": 64.0, "onchip_wall_ms_per_batch": 70.0,
          "onchip_time_source": "host_clock", "mfu_batch": 64,
          "achieved_tflops": 0.9, "device_compute_ms_per_batch": 20.0,
          "device_only_fps": 800.0, "anchor_dispatch_ms": 4.0}
GPU = {"fps": 300.0, "fps_ycbcr": 300.0, "fps_pixels": 250.0,
       "fps_annotated_device": 200.0, "fps_annotated_host": 150.0,
       "latch_s": 0.0, "slow_rig": False, "p50_batch_ms": 30.0,
       "p50_frame_ms": 1.875}


def _serving(detector, *, coalesce=True, **kw):
    return {"serving_delivered_fps": 400.0 if coalesce else 450.0,
            "serving_mean_batch": 10.0, "serving_p50_e2e_ms": 40.0,
            "serving_p95_e2e_ms": 60.0, "serving_frames": 100}


@pytest.fixture
def stub_phases(monkeypatch):
    """Every phase of `bench.main` replaced by a stub that returns at once
    (the frames, the first device operation and the link probe are real,
    on the CPU); returns the names of the phases called, in order."""
    called: list[str] = []

    def stub(name, value):
        def fn(*args, **kwargs):
            called.append(name)
            return value(*args, **kwargs) if callable(value) else value
        monkeypatch.setattr(bench, name, fn)

    stub("bench_cpu_baseline", {"fps": 2.0, "ms_per_frame": 500.0})
    stub("make_detector", object())
    stub("bench_anchor", ANCHOR)
    stub("bench_gpu", GPU)
    stub("bench_annotate_fullres", {"fps_annotated_splice_fullres": 40.0,
                                    "fps_annotated_host_fullres": 30.0})
    stub("bench_serving_throughput", _serving)
    stub("bench_tiled", {"tiled_1080p_fps": 60.0,
                         "tiled_1080p_ycbcr_rows_fps": 50.0,
                         "tiled_1080p_ycbcr_scaled_fps": 60.0,
                         "tiled_1080p_rgb_scaled_fps": 40.0,
                         "tiled_1080p_device_scaled_fps": 90.0})
    stub("bench_serving_latency",
         lambda det, cut_through=False, **kw: {
             ("serving_latency_p50_e2e_ms" if cut_through
              else "serving_p50_e2e_ms"): 12.0})
    monkeypatch.setenv("BENCH_SECONDS", "0.1")
    return called


def _run_main(capsys, argv=("--device", "cpu")):
    rc = bench.main(list(argv))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.strip()]
    assert len(lines) == 1
    return rc, json.loads(lines[0])


# -- the eight cases of tests/test_bench_plan.py ---------------------------


def case_must_failure_labels_and_exits_1(tmp_path, capsys, monkeypatch,
                                         stub_phases):
    """A MUST phase that dies returns its default and is labelled, and the
    run goes on, as in JAX; by design the port's main then exits 1."""
    msgs, note = _notes()
    plan = bench._Plan(budget_s=100.0, hard_wall_s=1000.0, note=note)

    def boom():
        raise RuntimeError("device fell over")

    out = plan.run("serving_window", boom, est_s=5, must=True,
                   default={"serving_delivered_fps": 0.0})
    assert out == {"serving_delivered_fps": 0.0}
    assert "serving_window:failed" in plan.skipped
    assert "serving_window" in plan.phase_s
    assert any("FAILED" in m for m in msgs)
    assert plan.run("tiled_core", lambda: 7, est_s=5, must=True) == 7
    assert plan.failures() == ["serving_window:failed"]

    def failing(*args, **kwargs):
        raise RuntimeError("tiled fell over")

    monkeypatch.setattr(bench, "bench_tiled", failing)
    rc, line = _run_main(capsys)
    assert rc == 1
    assert line["skipped_phases"] == ["tiled_core:failed"]
    assert line["tiled_1080p_fps"] == 0.0
    assert line["serving_latency_p50_e2e_ms"] == 12.0  # later phases ran


def case_must_failure_without_default_propagates(tmp_path, capsys,
                                                 monkeypatch, stub_phases):
    """No default (detector_init): the exception surfaces; the port's main
    still prints its line, labelled with the error, first."""
    _, note = _notes()
    plan = bench._Plan(budget_s=100.0, hard_wall_s=1000.0, note=note)
    with pytest.raises(RuntimeError):
        plan.run("detector_init", lambda: (_ for _ in ()).throw(
            RuntimeError("no device")), est_s=5, must=True)

    def no_device(*args, **kwargs):
        raise RuntimeError("no device")

    monkeypatch.setattr(bench, "make_detector", no_device)
    with pytest.raises(RuntimeError):
        bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["partial"] is True and "no device" in row["error"]
    assert row["partial_at"] == "cpu_baseline"


def case_optional_skipped_when_musts_reserve_budget(tmp_path, capsys,
                                                    monkeypatch,
                                                    stub_phases):
    msgs, note = _notes()
    plan = bench._Plan(budget_s=100.0, hard_wall_s=1000.0, note=note)
    plan.declare_musts(serving_window=60, tiled_core=35)
    out = plan.run("lossless_depth2", lambda: 1, est_s=20,
                   default="skipped")
    assert out == "skipped"
    assert "lossless_depth2" in plan.skipped
    assert any("skipped" in m for m in msgs)
    plan.run("serving_window", lambda: 1, est_s=60, must=True)
    assert plan.reserve() == pytest.approx(35 * plan.scale)
    assert plan.failures() == []  # an optional skip is by design


def case_must_runs_when_budget_exhausted(tmp_path, capsys, monkeypatch,
                                         stub_phases):
    _, note = _notes()
    plan = bench._Plan(budget_s=0.0, hard_wall_s=1000.0, note=note)
    assert plan.remaining() <= 0.0
    assert plan.run("anchor", lambda: 42, est_s=30, must=True) == 42
    # main with no budget: every MUST phase runs, the optional ones skip
    monkeypatch.setenv("BENCH_BUDGET_S", "0")
    rc, line = _run_main(capsys)
    assert rc == 0
    assert line["skipped_phases"] == ["lossless_depth2",
                                      "deep_queue_latency"]
    assert stub_phases.count("bench_serving_throughput") == 2


def case_hard_wall_skips_musts_and_exits_1(tmp_path, capsys, monkeypatch,
                                           stub_phases):
    """Past the hard wall even MUST phases are skipped with their
    defaults, labelled, as in JAX; by design the port exits 1."""
    msgs, note = _notes()
    plan = bench._Plan(budget_s=500.0, hard_wall_s=10.0, note=note)
    out = plan.run("latency_preset", lambda: 1, est_s=5, must=True,
                   default={"p50": -1.0})
    assert out == {"p50": -1.0}
    assert "latency_preset" in plan.skipped
    assert any("hard wall" in m for m in msgs)
    assert plan.failures() == ["latency_preset"]
    monkeypatch.setenv("BENCH_HARD_WALL_S", "0")
    rc, line = _run_main(capsys)
    assert rc == 1
    assert set(bench.MUST_ESTIMATES) <= set(line["skipped_phases"])
    assert stub_phases == []  # nothing ran


def case_scale_adapts_to_observed_cost(tmp_path, capsys, monkeypatch,
                                       stub_phases):
    import time as _t

    _, note = _notes()
    plan = bench._Plan(budget_s=100.0, hard_wall_s=1000.0, note=note)
    plan.run("pipeline", lambda: _t.sleep(0.002), est_s=1e-9, must=True,
             default=0)
    assert 1.0 < plan.scale <= 6.0


def case_sigterm_emits_partial_line_and_exits_1(tmp_path, capsys,
                                                monkeypatch, stub_phases):
    """A signal mid-phase prints the snapshot of what was measured as the
    one JSON line, as in JAX; by design the port exits 1 (its MUST phases
    did not all run)."""
    script = tmp_path / "drive.py"
    script.write_text(
        "import os, signal, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from infercam_onnx_tpu_torch import bench\n"
        "snap = bench._Snapshot({'metric': 'm', 'value': 3.5,\n"
        "    'unit': 'f/s', 'vs_baseline': 2.0, 'partial_at': 'tiled',\n"
        "    'phase_s': {'anchor': 1.0}, 'skipped_phases': []})\n"
        "signal.signal(signal.SIGTERM, snap.emit_and_exit)\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "signal.pause()\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["partial"] is True
    assert row["value"] == 3.5 and row["vs_baseline"] == 2.0
    assert row["partial_at"] == "tiled"
    assert row["killed_by"] == f"signal {int(signal.SIGTERM)}"


def case_anchor_write_never_costs_the_line(tmp_path, capsys, monkeypatch,
                                           stub_phases):
    """``--anchors`` at a path that cannot be written: the line still
    prints (with every key) and the run exits 0; at a writable path the
    row is appended there and nothing else is written."""
    unwritable = tmp_path / "no_such_dir" / "anchors.jsonl"
    rc, line = _run_main(capsys, ["--device", "cpu", "--anchors",
                                  str(unwritable)])
    assert rc == 0 and not unwritable.exists()
    assert JAX_BENCH_KEYS | PORT_EXTRA_KEYS <= set(line)
    assert line["device"] == "cpu" and line["power_limit"] is None
    assert line["value"] == 450.0  # the lossless window's, the best
    assert line["vs_baseline"] == 225.0
    assert line["skipped_phases"] == []
    anchors = tmp_path / "anchors.jsonl"
    for _ in range(2):
        assert _run_main(capsys, ["--device", "cpu", "--anchors",
                                  str(anchors)])[0] == 0
    rows = [json.loads(r) for r in anchors.read_text().splitlines()]
    assert len(rows) == 2 and rows[0]["headline_fps"] == 450.0
    assert rows[0]["onchip_ms_per_batch"] == 64.0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "anchors.jsonl"]


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_case(case, tmp_path, capsys, monkeypatch, stub_phases):
    CASES[case](tmp_path, capsys, monkeypatch, stub_phases)


def test_entry_points_raise_without_a_gpu():
    """Without ``--device cpu`` both run on the card, and raise here."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for main in (bench.main, microbench.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])


# -- FLOPs against JAX's cost analysis -------------------------------------


def test_flops_per_frame_within_2pct_of_jax():
    b = 2
    params = juf.init_params(0, background_bias=0.75)
    priors = jnp.asarray(juf.generate_priors(320, 240))
    r_h, r_w = JPreprocessor(320, 240).matrices(640, 480)

    def program(images):  # the JAX bench's bench_mfu body
        xp = jpreprocess_images(images, r_h, r_w)
        s, bx = juf.forward(params, xp, priors, compute_dtype=jnp.bfloat16)
        return jbatched_postprocess(s, bx, min_confidence=0.5, max_iou=0.5,
                                    top_k=256, max_detections=64)

    cost = jax.jit(program).lower(
        jnp.zeros((b, 480, 640, 3), jnp.uint8)).compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    want = float(cost["flops"]) / b

    det = bench.make_detector(CPU)
    got = bench.bench_mfu(det, batch=b, iters=1)
    assert abs(got["flops_per_frame"] / want - 1) < 0.02, (got, want)
    # the split by dtype adds up; the resize runs in float32
    assert (got["flops_per_frame_f32"] + got["flops_per_frame_bf16"]
            == got["flops_per_frame"])
    assert got["flops_per_frame_f32"] == 2 * (240 * 480 * 640 * 3
                                              + 240 * 320 * 640 * 3)
    assert got["onchip_time_source"] == "host_clock"
    assert "mfu_pct" not in got  # no peak for the CPU


# -- the CPU baseline against JAX's float32 detector -----------------------


def test_cpu_baseline_matches_jax_detector():
    jparams = juf.init_params(0, background_bias=bench.BASELINE_BIAS)
    params = jax.tree_util.tree_map(np.asarray, jparams)
    run_one = bench.cpu_baseline_runner(params)
    jaxdet = jdet.Detector(JDetectorConfig(compute_dtype="float32"),
                           params=jparams)
    total = 0
    for data in bench._load_frames(4):
        got = run_one(data)
        want = jaxdet.detect(codec.decode_rgb(data))
        assert len(got) == len(want)
        total += len(got)
        for (gb, gc), (wb, wc) in zip(got, want):
            np.testing.assert_allclose(gb, wb, rtol=0, atol=5e-5)
            assert abs(gc - wc) <= 5e-5
    assert total >= 1  # the weights find something on these frames


def test_baseline_bias_keeps_detections_sparse():
    """The CPU baseline's background bias gives a few detections a
    synthetic picture, as real weights do; the device phases' 0.75 gives
    more than JAX's ``max_detections`` (64) on each, which would make the
    reference's quadratic NMS set the baseline's pace."""
    frames = bench._load_frames(4)
    counts = {bias: [len(bench.cpu_baseline_runner(bench.random_params(
        background_bias=bias))(f)) for f in frames]
        for bias in (bench.BASELINE_BIAS, bench.BACKGROUND_BIAS)}
    assert all(n < 16 for n in counts[bench.BASELINE_BIAS])
    assert sum(counts[bench.BASELINE_BIAS]) >= 1
    assert all(n > 64 for n in counts[bench.BACKGROUND_BIAS])


# -- the microbench CLI ----------------------------------------------------


def test_microbench_cli_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "infercam_onnx_tpu_torch.microbench",
         "--device", "cpu", "--batches", "1", "--iters", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln]
    assert len(lines) == 1
    row = lines[0]
    assert MICROBENCH_KEYS <= set(row)
    assert row["batch"] == 1 and row["iters"] == 2
    assert row["device"] == "cpu" and row["time_source"] == "host_clock"
    assert all(row[k] > 0 for k in MICROBENCH_KEYS if k.endswith("_ms"))
    assert row["nms_launches"] == 0  # the plain version on the CPU
