"""The metric readers and the yardstick's arithmetic on known inputs."""

import json

import pytest
import torch

from harness import work
from harness.cell import Run
from harness.spec import BENCH_DIR, reader

CFG320 = json.loads((BENCH_DIR / "configs" / "rfb320.json").read_text())
VGA_S2 = json.loads((BENCH_DIR / "traffic" / "vga-s2-det-32cam-15fps.json")
                    .read_text())


def _run(spans=(), submitted=(), meter=None, load=None, trace=None,
         work_=None):
    return Run(cfg=CFG320, traffic=VGA_S2, setup_s=12.5, t0=10.0, t1=20.0,
               meter=meter or {}, submitted=list(submitted),
               spans=list(spans), load=load or {}, device={}, trace=trace,
               work=work_)


def test_server_cpu_time_per_frame_delivered():
    run = _run(load={"received": [3000, 2000]})
    run.server_cpu_s = 25.0
    assert reader("server_cpu_ms_per_frame")(run) == pytest.approx(5.0)
    assert reader("server_cpu_ms_per_frame")(
        _run(load={"received": [0]})) is None


def test_mean_batch_and_stage_spans_in_the_window():
    run = _run(meter={"dropped": 50, "inferred_unique": 150, "batches": 10})
    assert reader("mean_batch")(run) == pytest.approx(15.0)
    spans = [("decode", 11.0, 11.004), ("decode", 12.0, 12.006),
             ("device_ycbcr", 11.0, 11.010), ("device_annot", 12.0, 12.02),
             ("decode", 25.0, 25.5)]
    run = _run(spans)
    assert sum(run.spans_in("decode")) == pytest.approx(0.010)
    assert sum(run.spans_in("device*")) == pytest.approx(0.030)
    assert reader("decode_ms")(run) == pytest.approx(5.0)
    assert reader("dispatch_ms")(run) == pytest.approx(15.0)
    assert reader("decode_ms")(_run()) is None


def test_card_time_per_frame_from_the_trace():
    trace = {"busy_s": 0.5, "window_s": 10.0}
    run = _run(load={"received": [3000, 2000]}, trace=trace)
    assert reader("card_ms_per_frame")(run) == pytest.approx(0.1)
    assert reader("card_ms_per_frame")(_run(load={"received": [5]})) is None


def test_resample_flops_of_known_shapes():
    flops, nbytes = work.resample_flops(CFG320, VGA_S2)
    # 320x240 decoded: each 160x120 chroma plane doubled, two taps a
    # sample but one at each edge; the resize to 320x240 is the identity
    rows = 2 * (2 * 120 - 2) + 2
    cols = 2 * (2 * 160 - 2) + 2
    chroma = 2 * (2 * rows * 160 + 2 * cols * 240)
    assert flops == chroma
    assert nbytes == 320 * 240 * 3 + 240 * 320 * 3 * 4
    # 640x480 into RFB-320 halves each side: four taps a sample, three at
    # each edge
    vga = dict(VGA_S2, decode_scale=1)
    flops_vga, _ = work.resample_flops(CFG320, vga)
    rows, cols = 2 * (2 * 240 - 2) + 2, 2 * (2 * 320 - 2) + 2
    taps_h = int((work.triangle_matrix(480, 240) != 0).sum())
    taps_w = int((work.triangle_matrix(640, 320) != 0).sum())
    assert taps_h == 4 * 240 - 2 and taps_w == 4 * 320 - 2
    assert flops_vga == 2 * (2 * rows * 320 + 2 * cols * 480) \
        + 2 * taps_h * 640 * 3 + 2 * taps_w * 240 * 3


def test_trunk_flops_match_the_programs_count():
    from infercam_onnx_tpu_torch.bench import count_flops, random_params
    from infercam_onnx_tpu_torch.models import ultraface as uf

    from harness.weights import make_params
    from reference.ultraface import network_inputs

    model = uf.UltraFace.create("RFB-320", random_params(), device="cpu")
    x = torch.zeros(1, 240, 320, 3)
    total, _ = count_flops(lambda: model(x))
    params = make_params(CFG320, 1, torch.device("cpu"),
                         torch.zeros(2, 240, 320, 3) + 0.1)
    assert work.trunk_flops(CFG320, VGA_S2, params,
                            torch.device("cpu")) == total
    del network_inputs


def test_rooflines_and_step_mfu_on_known_numbers():
    peaks = work.peaks("NVIDIA H100 80GB HBM3")
    w = {"resize_flops": 67e6, "resize_bytes": 335e3, "trunk_flops": 989e6,
         "nms_bytes": 3350}
    # 1,000 frames: the resize needs 1 ms at 67 TFLOP/s, the trunk 1 ms at
    # 989 TFLOP/s, NMS 1 us at 3.35 TB/s
    trace = {"frames": 1000, "window_s": 0.5, "peaks": peaks,
             "stage_s": {"resize": 0.004, "trunk": 0.002, "nms": 1e-4}}
    run = _run(trace=trace, work_=w)
    assert reader("resize_roofline")(run) == pytest.approx(25.0)
    assert reader("trunk_roofline")(run) == pytest.approx(50.0)
    assert reader("nms_roofline")(run) == pytest.approx(1.0)
    assert reader("step_mfu")(run) == pytest.approx(0.4)
    # a reader with nothing to read returns nothing, never 0
    quiet = _run(trace=dict(trace, stage_s={}), work_=w)
    assert reader("trunk_roofline")(quiet) is None
    assert reader("step_mfu")(_run()) is None


def test_idle_gaps_split_by_host_stage():
    from harness.trace import reduce

    kernels = [("sm80_xmma_gemm_f32f32", 0.0, 0.01),
               ("nms_kernel", 0.02, 0.021), ("elementwise", 0.005, 0.015),
               ("fprop_bf16", 0.05, 0.06)]
    spans = [("decode", 0.0, 0.03), ("device_ycbcr", 0.02, 0.08)]
    out = reduce(kernels, 0.0, 0.1, spans)
    assert out["busy_s"] == pytest.approx(0.026)
    assert out["stage_s"] == pytest.approx(
        {"resize": 0.01, "nms": 0.001, "trunk": 0.01})
    assert out["unmapped"][0][0] == "elementwise"
    gaps = dict(out["idle_gaps"])
    assert gaps["device_ycbcr"] == pytest.approx(0.04, abs=2e-4)
    assert gaps["no_stage"] == pytest.approx(0.02, abs=2e-4)
    assert sum(gaps.values()) == pytest.approx(0.074, abs=5e-4)
