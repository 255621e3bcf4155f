"""The ycbcr program's CUDA-graph replay where no card is: on the CPU the
serving worker's warm-up captures nothing, its ycbcr units launch the
program eagerly with the program's own outputs, and the Meter's two graph
counters (``graph_captures``, ``graph_replays``) stay put while ``/stats``
and ``/metrics`` report them. The replay itself runs only on a card
(``tests/test_torch_port_cuda.py``)."""

import asyncio
import json

import torch

from infercam_onnx_tpu_torch.config import (DetectorConfig, EngineConfig,
                                            ServerConfig)
from infercam_onnx_tpu_torch.detector import Detector, detect_from_ycbcr
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
from infercam_onnx_tpu_torch.serving.app import start_server
from infercam_onnx_tpu_torch.serving.inferer import InferenceWorker
from infercam_onnx_tpu_torch.serving.meter import METER, Meter
from infercam_onnx_tpu_torch.serving.router import InferJob

from tests.test_goldens_fixtures import SYNTH_PICS, WEIGHTS

GRAPH_TOTALS = ("graph_captures", "graph_replays")
ENGINE = dict(batch_buckets=(1, 2, 4), decode_mode="ycbcr", decode_scale=2,
              annotate_mode="host", link_adaptive=False)


def _datas() -> list[bytes]:
    return [p.read_bytes() for p in sorted(SYNTH_PICS.glob("*.jpg"))]


def _detector() -> Detector:
    return Detector(DetectorConfig(compute_dtype="float32"),
                    weights=str(WEIGHTS), device="cpu")


def _drained_totals() -> dict:
    METER.drain()
    return dict(METER.totals)


def test_cpu_warmup_captures_nothing_and_units_run_eager():
    det = _detector()
    worker = InferenceWorker(det, EngineConfig(**ENGINE))
    try:
        base = _drained_totals()
        worker.warmup([(480, 640)])
        jobs = [InferJob(i, d, None) for i, d in enumerate(_datas())]
        units = worker._decode(jobs)
        entries = worker._device_stage(units)
        cur = _drained_totals()
    finally:
        worker.close()
    assert det.graphs is None
    for name in GRAPH_TOTALS:
        assert cur[name] == base.get(name, 0), name
    (unit,), (entry,) = units, entries
    assert unit["kind"] == "ycbcr" and unit["batch"].shape[0] == 4
    geom = unit["geom"]
    w, h = geom["width"], geom["height"]
    want = detect_from_ycbcr(
        det.model, det.priors, unit["batch"],
        *det.preprocessor.matrices(w, h), width=w, height=h,
        y_pw=geom["y_pw"], y_ph=geom["y_ph"], c_pw=geom["c_pw"],
        c_ph=geom["c_ph"], sampling=tuple(geom["sampling"]),
        pack_output=True, **det._thresholds())
    assert torch.equal(entry["packed"], want)
    assert int(want[..., 5].sum()) > 0
    # asked directly, a CPU detector refuses to capture
    packed, geom = native_jpeg.load().decode_ycbcr_batch(_datas(), scale=2)
    assert det.capture_ycbcr_graphs(packed, geom) is False
    assert det.graphs is None


def test_meter_counts_graph_captures_and_replays_in_its_window():
    meter = Meter()
    meter.tick_graph_captures()
    meter.tick_graph_replays(3)
    window = meter.drain()
    assert (window["graph_captures"], window["graph_replays"]) == (1, 3)
    meter.tick_graph_replays()
    assert meter.drain()["graph_replays"] == 1
    assert (meter.totals["graph_captures"], meter.totals["graph_replays"]) \
        == (1, 4)


async def _get(port: int, path: str) -> bytes:
    """The body of a GET of ``path``."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\nConnection: close"
                 f"\r\n\r\n".encode())
    await writer.drain()
    reply = await asyncio.wait_for(reader.read(), 10)
    writer.close()
    return reply.split(b"\r\n\r\n", 1)[1]


def test_stats_and_metrics_report_the_graph_counters():
    """A CPU ycbcr server warmed at 640x480: ``/stats`` totals hold both
    counters, unmoved by the warm-up, and ``/metrics`` exports them as
    ``infercam_graph_captures_total`` and ``infercam_graph_replays_total``."""
    async def run():
        base = _drained_totals()
        server = await start_server(
            ServerConfig(http_address="127.0.0.1:0",
                         socket_address="127.0.0.1:0"),
            engine_config=EngineConfig(**ENGINE), detector=_detector(),
            warmup_resolutions=[(480, 640)])
        try:
            METER.drain()
            stats = json.loads(await _get(server.http_port, "/stats"))
            metrics = (await _get(server.http_port, "/metrics")).decode()
        finally:
            await server.close()
        return base, stats, metrics

    base, stats, metrics = asyncio.run(run())
    for name in GRAPH_TOTALS:
        assert stats["totals"][name] == base.get(name, 0), name
        assert f"\ninfercam_{name}_total {stats['totals'][name]}\n" in metrics
