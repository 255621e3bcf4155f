"""The port's link probe and transfer-path policy against the JAX
package's ``serving/link.py``, and the port's worker and server adapting
to it (the counterparts of ``tests/test_link_adaptive.py``), on the CPU.

The four policy functions must return the JAX package's ``(effective,
why)`` exactly over a grid of modes, rates, A/B pairs and tie bands. The
worker and server cases inject their probes (the port's probes take a
``device`` keyword) and bind port 0.
"""

import asyncio
import json
import math

import numpy as np
import pytest

from infercam_onnx_tpu.config import EngineConfig as JEngineConfig
from infercam_onnx_tpu.serving import link as jlink
from infercam_onnx_tpu_torch import codec
from infercam_onnx_tpu_torch.client.sender import ReplaySource, send_stream
from infercam_onnx_tpu_torch.config import (ClientConfig, DetectorConfig,
                                            EngineConfig, ServerConfig)
from infercam_onnx_tpu_torch.detector import Detector
from infercam_onnx_tpu_torch.serving import link
from infercam_onnx_tpu_torch.serving.app import start_server
from infercam_onnx_tpu_torch.serving.inferer import InferenceWorker
from torch_port_offline import offline_weights_chain  # noqa: E402,F401

RATES = [0.0, 5.0, 9.99, 10.0, 30.0, 39.9, 40.0, 42.0, 49.0, 70.0, 249.9,
         250.0, 1500.0, 25000.0]
AB = [None, (120.0, 80.0), (50.0, 90.0), (60.0, 60.0), (53.0, 50.1),
      (100.0, 75.0), (75.0, 100.0), (0.0, 0.0), (10.0, 9.5)]


@pytest.fixture(scope="module")
def det():
    return Detector(DetectorConfig(compute_dtype="float32"), rng=0,
                    device="cpu")


def _worker(det, **engine_kw) -> InferenceWorker:
    worker = InferenceWorker(det, EngineConfig(**engine_kw))
    worker.close()  # the tests below call it directly, not its threads
    return worker


# -- the policy, against the JAX package -------------------------------------


@pytest.mark.parametrize("mode", ["pixels", "ycbcr", "coefficients"])
@pytest.mark.parametrize("healthy", [40.0, 250.0])
def test_decide_decode_mode_equals_jax(mode, healthy):
    for mbps in RATES:
        assert (link.decide_decode_mode(mode, mbps, healthy)
                == jlink.decide_decode_mode(mode, mbps, healthy))


@pytest.mark.parametrize("configured", ["auto", "rows", "stacked"])
@pytest.mark.parametrize("tie_pct", [0.0, 5.0, 10.0, 30.0])
def test_decide_tiled_route_equals_jax(configured, tie_pct):
    for mbps in RATES:
        for ab in AB:
            for crossover in (40.0, 100.0):
                assert (link.decide_tiled_route(
                    configured, mbps, crossover, ab_ms=ab, tie_pct=tie_pct)
                    == jlink.decide_tiled_route(
                    configured, mbps, crossover, ab_ms=ab, tie_pct=tie_pct))


@pytest.mark.parametrize("configured", ["device", "host"])
@pytest.mark.parametrize("floor", [10.0, 38.0])
def test_decide_annotate_mode_equals_jax(configured, floor):
    for mbps in RATES:
        assert (link.decide_annotate_mode(configured, mbps, floor)
                == jlink.decide_annotate_mode(configured, mbps, floor))


@pytest.mark.parametrize("fields", [
    {}, {"decode_mode": "coefficients", "annotate_mode": "device"},
    {"decode_mode": "ycbcr", "annotate_mode": "host",
     "tiled_upload": "rows"},
    {"decode_mode": "coefficients", "tiled_upload": "stacked",
     "link_healthy_h2d_mbps": 1000.0, "link_annotate_floor_mbps": 50.0},
    {"link_tiled_rows_below_mbps": 100.0, "link_tiled_ab_tie_pct": 0.0},
])
def test_decide_equals_jax_and_engine_defaults_match(fields):
    cfg, jcfg = EngineConfig(**fields), JEngineConfig(**fields)
    for name in ("link_adaptive", "link_healthy_h2d_mbps",
                 "link_probe_period_s", "link_annotate_floor_mbps",
                 "link_tiled_rows_below_mbps", "link_tiled_ab_probe",
                 "link_tiled_ab_tie_pct", "tiled_upload", "tile_min_pixels",
                 "tile_grid", "tile_overlap"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    for mbps in RATES:
        for ab in AB:
            assert (link.decide(cfg, mbps, tiled_ab_ms=ab)
                    == jlink.decide(jcfg, mbps, tiled_ab_ms=ab))


def test_engine_refuses_an_unknown_tiled_upload():
    with pytest.raises(ValueError, match="tiled_upload"):
        EngineConfig(tiled_upload="chunked")


# -- the probes on the CPU -----------------------------------------------


def test_cpu_probes_return_finite_positive_rates():
    mbps = link.probe_h2d_mbps(size_mb=1.0, trials=2, device="cpu")
    assert math.isfinite(mbps) and mbps > 0
    stacked, rows = link.probe_tiled_route_ms(frames=2, mb_per_frame=0.25,
                                              trials=1, device="cpu")
    assert all(math.isfinite(v) and v > 0 for v in (stacked, rows))


def test_probes_refuse_a_missing_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the probes run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        link.probe_h2d_mbps()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        link.probe_tiled_route_ms()


# -- the counterparts of tests/test_link_adaptive.py --------------------------


def test_policy_reroutes_only_coefficients():
    healthy = 250.0
    mode, why = link.decide_decode_mode("coefficients", 45.0, healthy)
    assert mode == "ycbcr" and "degraded" in why
    mode, _ = link.decide_decode_mode("coefficients", 1500.0, healthy)
    assert mode == "coefficients"
    for configured in ("pixels", "ycbcr"):
        for mbps in (45.0, 1500.0):
            assert link.decide_decode_mode(configured, mbps,
                                           healthy)[0] == configured


def test_policy_tiled_route():
    route, why = link.decide_tiled_route("auto", 30.0, 40.0)
    assert route == "rows" and "crossover" in why
    for mbps in (49.0, 1500.0):
        route, why = link.decide_tiled_route("auto", mbps, 40.0)
        assert route == "stacked" and "one large copy" in why
    for configured in ("rows", "stacked"):
        for mbps in (30.0, 1500.0):
            assert link.decide_tiled_route(configured, mbps,
                                           40.0)[0] == configured


def test_policy_tiled_route_measured_ab():
    route, why = link.decide_tiled_route("auto", 70.0, 40.0,
                                         ab_ms=(120.0, 80.0))
    assert route == "rows" and "measured A/B" in why
    assert "80.0" in why and "120.0" in why
    route, why = link.decide_tiled_route("auto", 30.0, 40.0,
                                         ab_ms=(50.0, 90.0))
    assert route == "stacked" and "measured A/B" in why
    assert link.decide_tiled_route("auto", 30.0, 40.0,
                                   ab_ms=(60.0, 60.0))[0] == "stacked"
    assert link.decide_tiled_route("rows", 70.0, 40.0,
                                   ab_ms=(50.0, 90.0))[0] == "rows"


def test_policy_tiled_route_ab_tie_band():
    route, why = link.decide_tiled_route("auto", 60.0, 40.0,
                                         ab_ms=(53.0, 50.1))
    assert route == "stacked" and "tie band" in why
    assert link.decide_tiled_route("auto", 60.0, 40.0, ab_ms=(53.0, 50.1),
                                   tie_pct=0.0)[0] == "rows"
    assert link.decide_tiled_route("auto", 60.0, 40.0,
                                   ab_ms=(100.0, 75.0))[0] == "rows"
    assert link.decide_tiled_route("auto", 60.0, 40.0,
                                   ab_ms=(75.0, 100.0))[0] == "stacked"


def test_policy_annotate_floor():
    assert link.decide_annotate_mode("device", 38.0, 10.0)[0] == "device"
    mode, why = link.decide_annotate_mode("device", 5.0, 10.0)
    assert mode == "host" and "collapsed" in why
    for mbps in (5.0, 1500.0):
        assert link.decide_annotate_mode("host", mbps, 10.0)[0] == "host"


def test_decision_table_covers_all_three_choices():
    cfg = EngineConfig(decode_mode="coefficients", tiled_upload="auto",
                       annotate_mode="device")
    table = link.decide(cfg, 5.0)
    assert [table[k]["effective"] for k in
            ("decode_mode", "tiled_upload", "annotate_mode")] == [
        "ycbcr", "rows", "host"]
    table = link.decide(cfg, 1500.0)
    assert [table[k]["effective"] for k in
            ("decode_mode", "tiled_upload", "annotate_mode")] == [
        "coefficients", "stacked", "device"]
    for entry in table.values():
        assert {"configured", "effective", "why"} <= set(entry)


def test_worker_adapts_all_choices_and_recovers(det):
    worker = _worker(det, decode_mode="coefficients", tiled_upload="auto",
                     annotate_mode="device")
    assert worker._effective_tiled_route == "rows"  # pre-probe
    worker.probe_and_adapt(probe=lambda: 5.0)
    assert (worker._effective_decode_mode, worker._effective_tiled_route,
            worker._effective_annotate_mode) == ("ycbcr", "rows", "host")
    assert worker._annotate_device_active is False
    assert set(worker.link_status["decisions"]) == {
        "decode_mode", "tiled_upload", "annotate_mode"}
    worker.probe_and_adapt(probe=lambda: 1500.0)
    assert (worker._effective_decode_mode, worker._effective_tiled_route,
            worker._effective_annotate_mode) == ("coefficients", "stacked",
                                                 "device")
    assert worker._annotate_device_active is True
    assert worker.link_status["tiled_ab_ms"] is None  # no A/B was faked


def test_worker_tiled_route_follows_measured_ab(det):
    worker = _worker(det, tiled_upload="auto", tile_min_pixels=500_000)
    worker.probe_and_adapt(probe=lambda: 70.0,
                           probe_tiled=lambda: (120.0, 80.0))
    assert worker._effective_tiled_route == "rows"
    assert worker.link_status["tiled_ab_ms"] == {"stacked": 120.0,
                                                 "rows": 80.0}
    assert "measured A/B" in (
        worker.link_status["decisions"]["tiled_upload"]["why"])
    worker.probe_and_adapt(probe=lambda: 20.0,
                           probe_tiled=lambda: (50.0, 90.0))
    assert worker._effective_tiled_route == "stacked"

    off = _worker(det, tiled_upload="auto", link_tiled_ab_probe=False)
    off.probe_and_adapt(probe=lambda: 70.0,
                        probe_tiled=lambda: (120.0, 80.0))
    assert off._effective_tiled_route == "stacked"
    assert off.link_status["tiled_ab_ms"] is None

    calls = []

    def counting_ab():
        calls.append(1)
        return (120.0, 80.0)

    fixed = _worker(det, tiled_upload="stacked")
    fixed.probe_and_adapt(probe=lambda: 20.0, probe_tiled=counting_ab)
    assert fixed._effective_tiled_route == "stacked" and not calls
    untiled = _worker(det, tiled_upload="auto")
    untiled.probe_and_adapt(probe=lambda: 20.0, probe_tiled=counting_ab)
    assert not calls and untiled.link_status["tiled_ab_ms"] is None


def test_tiled_auto_without_adaptivity_defaults_healthy(det):
    assert _worker(det, tiled_upload="auto",
                   link_adaptive=False)._effective_tiled_route == "stacked"
    assert _worker(det, tiled_upload="auto",
                   link_adaptive=True)._effective_tiled_route == "rows"


def test_worker_adapts_and_recovers(det):
    worker = _worker(det, decode_mode="coefficients")
    assert worker._effective_decode_mode == "coefficients"
    assert worker.link_status["probed"] is False
    status = worker.probe_and_adapt(probe=lambda: 40.0)
    assert status["degraded"] is True and status["h2d_mbps"] == 40.0
    assert worker._effective_decode_mode == "ycbcr"
    assert status["configured_decode_mode"] == "coefficients"
    status = worker.probe_and_adapt(probe=lambda: 1500.0)
    assert status["degraded"] is False
    assert worker._effective_decode_mode == "coefficients"


def test_default_probes_run_on_the_workers_device(det):
    """Without injected probes the worker calls the link module's probes
    with its own device, and takes the A/B when tiling is on."""
    worker = _worker(det, tile_min_pixels=100)
    status = worker.probe_and_adapt()
    assert status["probed"] is True and status["h2d_mbps"] > 0
    assert set(status["tiled_ab_ms"]) == {"stacked", "rows"}


async def _stats(port: int) -> dict:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"GET /stats HTTP/1.1\r\nHost: x\r\n"
                 b"Connection: close\r\n\r\n")
    await writer.drain()
    body = (await asyncio.wait_for(reader.read(), 10.0)).split(
        b"\r\n\r\n", 1)[1]
    writer.close()
    return json.loads(body)


def test_timer_reprobe_flips_paths_both_directions(det, monkeypatch):
    reading = {"mbps": 5.0}
    monkeypatch.setattr(link, "probe_h2d_mbps",
                        lambda **kw: reading["mbps"])
    monkeypatch.setattr(
        link, "probe_tiled_route_ms",
        lambda **kw: ((120.0, 80.0) if reading["mbps"] < 250.0
                      else (50.0, 90.0)))

    async def wait_effective(port, want, timeout=15.0):
        loop = asyncio.get_running_loop()
        deadline, last = loop.time() + timeout, None
        while loop.time() < deadline:
            last = (await _stats(port))["link"]["decisions"]
            if tuple(last[k]["effective"] for k in (
                    "decode_mode", "tiled_upload", "annotate_mode")) == want:
                return
            await asyncio.sleep(0.1)
        raise AssertionError(f"decisions never became {want}; last {last}")

    async def run():
        server = await start_server(
            ServerConfig(http_address="127.0.0.1:0",
                         socket_address="127.0.0.1:0"),
            engine_config=EngineConfig(
                batch_buckets=(1,), decode_mode="coefficients",
                tiled_upload="auto", annotate_mode="device",
                tile_min_pixels=1_000_000, link_probe_period_s=0.3),
            detector=det)
        try:
            port = server.http_port
            await wait_effective(port, ("ycbcr", "rows", "host"))
            reading["mbps"] = 1500.0
            await wait_effective(port, ("coefficients", "stacked", "device"))
            reading["mbps"] = 5.0
            await wait_effective(port, ("ycbcr", "rows", "host"))
        finally:
            await server.close()

    asyncio.run(run())


def test_server_flips_path_on_slow_probe(det, tmp_path, monkeypatch):
    """A server configured for the splice path on a (faked) slow link
    comes up on the ycbcr path, says so in /stats, warms up and serves
    that path."""
    monkeypatch.setattr(link, "probe_h2d_mbps", lambda **kw: 42.0)
    rng = np.random.default_rng(7)
    for i in range(3):
        frame = rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
        (tmp_path / f"f{i}.jpg").write_bytes(codec.encode_rgb(frame))
    served = []

    async def run():
        server = await start_server(
            ServerConfig(http_address="127.0.0.1:0",
                         socket_address="127.0.0.1:0"),
            engine_config=EngineConfig(batch_buckets=(1,),
                                       decode_mode="coefficients",
                                       annotate_mode="device"),
            detector=det, warmup_resolutions=[(48, 64)])
        try:
            stats = await _stats(server.http_port)
            dispatch = server.worker._device_stage

            def tap(units):
                served.extend(u["kind"] for u in units)
                return dispatch(units)

            server.worker._device_stage = tap
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", server.http_port)
            writer.write(b"GET /detections?name=s HTTP/1.1\r\nHost: x\r\n"
                         b"Connection: close\r\n\r\n")
            await writer.drain()
            await asyncio.sleep(0.2)  # the subscription registers
            sender = asyncio.ensure_future(send_stream(
                ReplaySource(str(tmp_path), fps=30),
                ClientConfig(address=f"127.0.0.1:{server.socket_port}",
                             channel="s"), max_frames=60))
            data = b""
            while (b"\r\n\r\n" not in data
                   or data.split(b"\r\n\r\n", 1)[1].count(b"\n") < 2):
                chunk = await asyncio.wait_for(reader.read(4096), 20.0)
                if not chunk:
                    break
                data += chunk
            writer.close()
            await sender
            return stats, data
        finally:
            await server.close()

    stats, data = asyncio.run(run())
    assert stats["link"]["probed"] is True
    assert stats["link"]["degraded"] is True
    assert stats["link"]["h2d_mbps"] == 42.0
    assert stats["link"]["decode_mode"] == "ycbcr"
    assert stats["link"]["configured_decode_mode"] == "coefficients"
    assert stats["warming"] is False
    lines = [ln for ln in data.split(b"\r\n\r\n", 1)[1].splitlines() if ln]
    assert lines, "no detections delivered on the adapted path"
    rec = json.loads(lines[0])
    assert "detections" in rec and rec["width"] == 64
    assert served and set(served) == {"ycbcr"}
