"""The port's serving tier against the JAX package, live on the CPU.

Protocol bytes, stream keys, the bucket ladder and the presets must equal
the JAX package's exactly. The live tests start the port's server with
``device="cpu"`` (RFB-320, float32, the frozen weights), feed it with the
port's sender and read its HTTP endpoints; every listener binds port 0
and the tests read the port back from the socket.

Served ``/detections`` records of the four synthetic 640x480 pictures
must equal JAX ``Detector.detect_batch`` on the same decoded frames:
counts equal, boxes within 1e-5, confidences within 5e-5 (the tolerances
of ``tests/test_torch_port_detector.py``: the two CPU conv trunks sum in
different orders). An annotated part must be the port codec's encoding
of JAX ``draw_detections`` on those detections: the same JPEG bytes, or,
where a box edge or a label's last digit falls on the other side of a
pixel or rounding boundary within those tolerances, decoded pixels that
differ in at most 0.2% of the values.

In ``decode_mode="ycbcr"`` a published record must equal
``Detector.run_device_ycbcr_packed`` on the batch the worker dispatched,
exactly (the same CPU program on the same rows), and that batch must hold
the shim's packed rows; a /face_stream stream keeps the pixels path.

Tiled serving (frames of at least ``tile_min_pixels``, here the synthetic
pictures at 480x270): the records must equal JAX ``TiledDetector``'s on
the same frames (pixels units) or packed planes (``ycbcr_tiled`` and
``ycbcr_tiled_rows`` units) within the same tolerances, and a tiled
frame's annotated part must be the host's draw + encode of its record.
"""

import asyncio
import contextlib
import io
import json
import time

import numpy as np
import pytest
import torch
from PIL import Image

from infercam_onnx_tpu import codec as jcodec
from infercam_onnx_tpu import protocol as jproto
from infercam_onnx_tpu import serve as jserve
from infercam_onnx_tpu.client import sender as jsender
from infercam_onnx_tpu.config import DetectorConfig as JDetectorConfig
from infercam_onnx_tpu.detector import Detector as JDetector
from infercam_onnx_tpu.draw import draw_detections as jdraw_detections
from infercam_onnx_tpu.models import convert as jconvert
from infercam_onnx_tpu.serving.router import stream_key as jstream_key
from infercam_onnx_tpu_torch import codec
from infercam_onnx_tpu_torch import draw as tdraw
from infercam_onnx_tpu_torch import protocol as tproto
from infercam_onnx_tpu_torch import serve as tserve
from infercam_onnx_tpu_torch.client import sender as tsender
from infercam_onnx_tpu_torch.client.sender import ReplaySource, send_stream
from infercam_onnx_tpu_torch.config import (ClientConfig, DetectorConfig,
                                            EngineConfig, ServerConfig)
from infercam_onnx_tpu_torch.detector import Detector
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
from infercam_onnx_tpu_torch.serving.app import rss_watchdog, start_server
from infercam_onnx_tpu_torch.serving.broadcast import Broadcast
from infercam_onnx_tpu_torch.serving.inferer import InferenceWorker
from infercam_onnx_tpu_torch.serving.meter import METER
from infercam_onnx_tpu_torch.serving.router import InferJob, stream_key
from infercam_onnx_tpu_torch.utils.profiling import device_trace

from tests.test_goldens_fixtures import SYNTH_PICS, WEIGHTS
from torch_port_offline import offline_weights_chain  # noqa: E402,F401

CONFIG = DetectorConfig(compute_dtype="float32")
MJPEG_HEADER = b"--frame\r\nContent-Type: image/jpeg\r\n\r\n"


@pytest.fixture(scope="module")
def detector():
    return Detector(CONFIG, weights=str(WEIGHTS), device="cpu")


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    """Three 64x48 JPEGs of noise."""
    d = tmp_path_factory.mktemp("small")
    rng = np.random.default_rng(5)
    for i in range(3):
        frame = rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
        (d / f"f{i}.jpg").write_bytes(codec.encode_rgb(frame))
    return d


# -- the wire protocol ---------------------------------------------------

GOLDEN_FRAME = (b"\x01\x00\x00\x00" b"\x03\x00\x00\x00\x00\x00\x00\x00" b"bla"
                b"\x03\x00\x00\x00\x00\x00\x00\x00" b"\x01\x02\x03")
GOLDEN_CONNECT = (b"\x00\x00\x00\x00" b"\x05\x00\x00\x00\x00\x00\x00\x00"
                  b"simon")


@pytest.mark.parametrize("kind, args, golden", [
    ("FrameMsg", ("bla", b"\x01\x02\x03"), GOLDEN_FRAME),
    ("ConnectReq", ("simon",), GOLDEN_CONNECT),
    ("FrameMsg", ("caméra-1", b"\x00\x01\xff"), None),
    ("FrameMsg", ("", b""), None),
    ("ConnectReq", ("",), None),
    ("FrameMsg", ("x", bytes(range(256)) * 40), None),
])
def test_protocol_bytes_equal_jax(kind, args, golden):
    """Each package encodes the message to the same bytes (the golden
    bytes of tests/test_protocol.py where given) and decodes the other's
    bytes back to the message."""
    tmsg, jmsg = getattr(tproto, kind)(*args), getattr(jproto, kind)(*args)
    tbytes, jbytes = tproto.encode_proto_msg(tmsg), jproto.encode_proto_msg(jmsg)
    assert tbytes == jbytes
    if golden is not None:
        assert tbytes == golden
    assert tproto.frame_encode(tbytes) == jproto.frame_encode(jbytes)
    assert tproto.decode_proto_msg(jbytes) == tmsg
    assert jproto.decode_proto_msg(tbytes) == jmsg
    # trailing bytes are accepted by both (bincode 1.x AllowTrailing)
    assert tproto.decode_proto_msg(jbytes + b"zz") == tmsg


@pytest.mark.parametrize("buf", [
    b"", b"\x01\x00", b"\x07\x00\x00\x00rest", GOLDEN_FRAME[:-1],
    GOLDEN_CONNECT[:-1],
    b"\x01\x00\x00\x00\x02\x00\x00\x00\x00\x00\x00\x00\xff\xfe"
    b"\x00\x00\x00\x00\x00\x00\x00\x00",
])
def test_malformed_messages_decode_to_none_in_both(buf):
    assert tproto.decode_proto_msg(buf) is None
    assert jproto.decode_proto_msg(buf) is None


def test_framing_and_mjpeg_parts_equal_jax():
    assert tproto.MAX_FRAME_LEN == jproto.MAX_FRAME_LEN
    assert tproto.as_jpeg_stream_item(b"JPEG") == \
        jproto.as_jpeg_stream_item(b"JPEG")
    assert (tproto._MJPEG_HEADER, tproto._MJPEG_TRAILER) == (
        jproto._MJPEG_HEADER, jproto._MJPEG_TRAILER)
    payloads = [b"", b"x", b"hello world" * 100]
    stream = b"".join(jproto.frame_encode(p) for p in payloads)
    dec = tproto.FrameDecoder()
    got = []
    for i in range(0, len(stream), 7):
        got.extend(dec.feed(stream[i:i + 7]))
    assert got == payloads

    async def read_all():
        reader = asyncio.StreamReader()
        reader.feed_data(stream)
        reader.feed_eof()
        return [await tproto.read_frame(reader) for _ in payloads]

    assert asyncio.run(read_all()) == payloads
    with pytest.raises(ValueError):
        tproto.frame_encode(b"x" * (tproto.MAX_FRAME_LEN + 1))


@pytest.mark.parametrize("name", ["simon", "", "cam-1", "caméra-1",
                                  "x" * 300])
def test_stream_key_equals_jax(name):
    assert stream_key(name) == jstream_key(name)


def test_bucket_ladder_and_presets_equal_jax():
    for n in range(1, 34):
        assert tserve.bucket_ladder(n) == jserve.bucket_ladder(n)
    assert tserve.PRESETS == jserve.PRESETS


@pytest.mark.parametrize("n, channels", [(1, ["a"]), (3, ["a"]),
                                         (2, ["a", "b"]), (2, ["a", "b", "c"])])
def test_plan_channels_equals_jax(n, channels):
    try:
        want = jsender.plan_channels(n, channels)
    except ValueError:
        with pytest.raises(ValueError):
            tsender.plan_channels(n, channels)
        return
    assert tsender.plan_channels(n, channels) == want


# -- the codec and drawing the worker uses ------------------------------

def test_codec_matches_jax_pil_path():
    """The codec the worker uses is the native shim: its decodes equal the
    JAX codec's native ones and PIL's (the same libjpeg-turbo IDCT and
    fancy upsampling), at every scale, batched or not; its encodes equal
    the JAX codec's native bytes. The PIL half is kept as the oracle and
    equals the JAX codec's PIL half."""
    datas = [p.read_bytes() for p in sorted(SYNTH_PICS.glob("*.jpg"))]
    for scale in (1, 2, 4, 8):
        batch = codec.decode_batch(datas, scale)
        for data, got in zip(datas, batch):
            assert got.shape == (480 // scale, 640 // scale, 3)
            np.testing.assert_array_equal(got, codec.decode_rgb(data, scale))
            np.testing.assert_array_equal(got, jcodec.decode_rgb(data, scale))
            pil = codec._pil_decode(data, scale)
            np.testing.assert_array_equal(got, pil)
            np.testing.assert_array_equal(pil,
                                          jcodec._pil_decode(data, scale))
    frame = codec.decode_rgb(datas[0])
    for quality, sub in ((95, "420"), (80, "422"), (60, "444")):
        assert codec.encode_rgb(frame, quality, sub) == \
            jcodec.encode_rgb(frame, quality, sub)
        assert codec._pil_encode(frame, quality, sub) == \
            jcodec._pil_encode(frame, quality, sub)
    with pytest.raises(ValueError, match="corrupt"):
        codec.decode_batch([datas[0], b"\xff\xd8 not a jpeg"])


def test_draw_dims_match_jax():
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, size=(120, 160, 3), dtype=np.uint8)
    dets = [(np.array([0.1, 0.2, 0.5, 0.7], np.float32), 0.875),
            (np.array([0.4, 0.05, 0.95, 0.5], np.float32), 0.51234)]
    for dims in (None, (1280, 720), (80, 60)):
        np.testing.assert_array_equal(
            tdraw.draw_detections(frame, dets, dims),
            jdraw_detections(frame, dets, dims))


# -- configuration ---------------------------------------------------------

@pytest.mark.parametrize("annotate_mode", ["device", "host"])
@pytest.mark.parametrize("decode_mode", ["pixels", "ycbcr", "coefficients"])
def test_engine_accepts_every_jax_mode(decode_mode, annotate_mode):
    """Every decode and annotate mode of the JAX package is accepted, with
    the JAX package's splice block budget."""
    from infercam_onnx_tpu.config import EngineConfig as JEngineConfig

    cfg = EngineConfig(decode_mode=decode_mode, annotate_mode=annotate_mode)
    want = JEngineConfig(decode_mode=decode_mode, annotate_mode=annotate_mode)
    for field in ("decode_mode", "annotate_mode", "annotate_splice_blocks"):
        assert getattr(cfg, field) == getattr(want, field), field


def test_engine_defaults_and_bad_values():
    cfg = EngineConfig()
    assert (cfg.decode_mode, cfg.annotate_mode) == ("pixels", "device")
    assert cfg.annotate_splice_blocks == 768
    assert tuple(cfg.batch_buckets) == (1, 2, 4, 8, 16)
    for kwargs in ({"decode_mode": "rgb"}, {"annotate_mode": "gpu"},
                   {"decode_scale": 3}, {"batch_buckets": ()},
                   {"annotate_splice_blocks": 0}):
        with pytest.raises(ValueError):
            EngineConfig(**kwargs)


LOCKSTEP = ["--lockstep-address", "127.0.0.1:1"]
DISTRIBUTED = ["--distributed", "127.0.0.1:2,num_processes=2,process_id=0"]


GRAPH = ["--runtime", "graph", "--onnx", "m.onnx"]


@pytest.mark.parametrize("argv", [
    ["--runtime", "graph"], GRAPH + ["--tile-min-pixels", "921600"],
    LOCKSTEP, LOCKSTEP + DISTRIBUTED + ["--data-parallel", "off"],
    LOCKSTEP + DISTRIBUTED + ["--tile-min-pixels", "921600"],
    LOCKSTEP + DISTRIBUTED + GRAPH,
])
def test_serve_cli_refuses_unported_paths(argv, capsys, monkeypatch):
    """The JAX CLI's argument errors, each with the JAX CLI's message: the
    graph runtime without --onnx or with tiling, and a lockstep member
    without --distributed, without data-parallel serving, with tiling or
    on the graph runtime."""
    import faulthandler

    # the JAX CLI registers a stack dump on stderr, which capsys replaced
    monkeypatch.setattr(faulthandler, "register", lambda *a, **k: None)
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--device", "cpu", *argv])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "error" in err
    with pytest.raises(SystemExit) as jexc:
        jserve.main(list(argv))
    assert jexc.value.code == 2
    assert err.splitlines()[-1].split("error: ")[1] == \
        capsys.readouterr().err.splitlines()[-1].split("error: ")[1]


@pytest.mark.parametrize("argv", [
    ["--preset", "throughput"], ["--preset", "lossless"],
    ["--preset", "latency"], ["--decode-mode", "ycbcr"],
    ["--preset", "throughput", "--decode-scale", "1", "--max-batch", "8",
     "--warmup-sync"],
    ["--decode-mode", "coefficients"], ["--annotate", "device"],
    ["--annotate", "host"],
    ["--decode-mode", "coefficients", "--annotate-splice-blocks", "64"],
    ["--tile-min-pixels", "921600", "--tile-grid", "2x2",
     "--decode-mode", "ycbcr"],
    ["--tile-min-pixels", "1000000", "--tile-grid", "3x2",
     "--tiled-upload", "rows", "--preset", "throughput"],
    ["--tiled-upload", "stacked", "--link-adaptive", "off"],
    ["--link-healthy-mbps", "1000", "--link-probe-period", "30",
     "--link-annotate-floor-mbps", "20", "--link-tiled-crossover-mbps",
     "80", "--link-tiled-ab", "off", "--link-tiled-ab-tie-pct", "5"],
    ["--data-parallel", "off"], ["--data-parallel", "on", "--max-batch", "8"],
])
def test_serve_cli_builds_the_jax_engine_config(argv, monkeypatch):
    """Every decode and annotate mode, tiling, the link policy's flags and
    the three tuned presets run: each argv gives the server the
    EngineConfig fields, warm-up resolutions and warm-up mode the JAX CLI
    gives its own."""
    from infercam_onnx_tpu.serving import app as japp
    from infercam_onnx_tpu.utils import cache as jcache
    from infercam_onnx_tpu_torch.serving import app as tapp

    served = {}

    def capture(name):
        async def serve_forever(**kw):
            served[name] = kw
        return serve_forever

    monkeypatch.setattr(japp, "serve_forever", capture("jax"))
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(tapp, "serve_forever", capture("port"))
    assert jserve.main(list(argv)) == 0
    assert tserve.main(["--device", "cpu", *argv]) == 0
    got, want = served["port"], served["jax"]
    for key in ("warmup_resolutions", "warmup_async", "data_parallel",
                "lockstep_address"):
        assert got[key] == want[key]
    port_cfg, jax_cfg = got["engine_config"], want["engine_config"]
    for field in ("batch_buckets", "queue_capacity", "batch_window_ms",
                  "coalesce_streams", "decode_scale", "decode_mode",
                  "annotate_mode", "annotate_splice_blocks", "link_adaptive",
                  "link_healthy_h2d_mbps", "link_probe_period_s",
                  "link_annotate_floor_mbps", "link_tiled_rows_below_mbps",
                  "link_tiled_ab_probe", "link_tiled_ab_tie_pct",
                  "tiled_upload", "tile_min_pixels", "tile_grid",
                  "tile_overlap"):
        assert getattr(port_cfg, field) == getattr(jax_cfg, field), field
    assert port_cfg.annotate_mode == ("host" if "host" in argv
                                      else "device")


# -- live serving on the CPU ---------------------------------------------


@contextlib.asynccontextmanager
async def _serving(detector, server_kw=None, **engine_kw):
    engine_kw.setdefault("batch_buckets", (1, 2, 4))
    server = await start_server(
        ServerConfig(http_address="127.0.0.1:0",
                     socket_address="127.0.0.1:0", **(server_kw or {})),
        engine_config=EngineConfig(**engine_kw), detector=detector)
    try:
        yield server
    finally:
        await server.close()


class _Viewer:
    """An HTTP client of one endpoint that collects the response body as
    it arrives."""

    def __init__(self, reader, writer):
        self._reader, self._writer = reader, writer
        self.data = b""
        self._task = asyncio.ensure_future(self._read())

    @classmethod
    async def open(cls, port: int, path: str, method: str = "GET"):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                     "Connection: close\r\n\r\n".encode())
        await writer.drain()
        return cls(reader, writer)

    async def _read(self):
        while chunk := await self._reader.read(65536):
            self.data += chunk

    @property
    def head(self) -> bytes:
        return self.data.split(b"\r\n\r\n", 1)[0]

    @property
    def body(self) -> bytes:
        parts = self.data.split(b"\r\n\r\n", 1)
        return parts[1] if len(parts) == 2 else b""

    def records(self) -> list[dict]:
        """The complete NDJSON records so far."""
        return [json.loads(ln) for ln in self.body.split(b"\n")[:-1]
                if ln.strip()]

    def parts(self) -> list[bytes]:
        """The complete MJPEG parts' JPEG payloads so far."""
        return [c[:-4] for c in self.body.split(MJPEG_HEADER)[1:]
                if c.endswith(b"\xff\xd9\r\n\r\n")]

    async def wait(self, cond, timeout: float = 30.0, desc: str = ""):
        await _until(lambda: cond(self), timeout=timeout, desc=desc)

    async def finish(self, timeout: float = 10.0) -> bytes:
        """The whole response of a request that ends by itself."""
        await asyncio.wait_for(asyncio.shield(self._task), timeout)
        return self.data

    async def close(self):
        self._writer.close()
        self._task.cancel()
        await asyncio.gather(self._task, return_exceptions=True)


async def _until(cond, *, timeout=30.0, interval=0.02, desc=""):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"not met within {timeout}s: {desc}")
        await asyncio.sleep(interval)


def _subscribed(server, name, kind="inferred"):
    table = {"raw": server.router._raw, "inferred": server.router._inferred,
             "detections": server.router._detections}[kind]
    chan = table.get(stream_key(name))
    return chan is not None and chan.receiver_count >= 1


class _GatedSource:
    """A FrameSource that sends each frame only once ``gate(i)`` says the
    server answered the frames before it."""

    def __init__(self, datas, gate):
        self._datas, self._gate = datas, gate

    async def frames(self):
        for i, data in enumerate(self._datas):
            await _until(lambda: self._gate(i), desc=f"answer to frame {i}")
            yield data


@pytest.fixture(scope="module")
def jax_reference():
    """JAX Detector (float32, the same frozen weights) on the decoded
    synthetic pictures: (jpeg bytes, frames, detections)."""
    datas = [p.read_bytes() for p in sorted(SYNTH_PICS.glob("*.jpg"))]
    frames = [codec.decode_rgb(d) for d in datas]
    params = jconvert.params_from_state_dict(dict(np.load(WEIGHTS)))
    jdet = JDetector(JDetectorConfig(compute_dtype="float32"), params=params)
    return datas, frames, jdet.detect_batch(np.stack(frames))


def test_served_detections_and_annotations_match_jax(detector,
                                                     jax_reference):
    datas, frames, want = jax_reference

    async def run():
        async with _serving(detector, annotate_mode="host") as server:
            port = server.http_port
            dets = await _Viewer.open(port, "/detections?name=cam")
            faces = await _Viewer.open(port, "/face_stream?name=cam")
            await _until(lambda: _subscribed(server, "cam", "detections")
                         and _subscribed(server, "cam"), desc="viewers")
            # one frame at a time, so record i answers frame i
            source = _GatedSource(datas, lambda i: (
                len(dets.records()) >= i and len(faces.parts()) >= i))
            sent = await send_stream(
                source, ClientConfig(address=f"127.0.0.1:"
                                     f"{server.socket_port}", channel="cam"))
            await dets.wait(lambda v: len(v.records()) == len(datas))
            await faces.wait(lambda v: len(v.parts()) == len(datas))
            out = (sent, dets.head, dets.records(), faces.head, faces.parts())
            await dets.close()
            await faces.close()
            return out

    sent, det_head, records, face_head, parts = asyncio.run(run())
    assert sent == len(datas) == 4
    assert b"application/x-ndjson" in det_head
    assert b"multipart/x-mixed-replace; boundary=frame" in face_head
    assert sum(len(d) for d in want) >= 10  # the pictures have faces
    for rec, frame, wdets, part in zip(records, frames, want, parts):
        assert (rec["width"], rec["height"]) == (640, 480)
        assert len(rec["detections"]) == len(wdets)
        if wdets:
            np.testing.assert_allclose(
                [d["bbox"] for d in rec["detections"]],
                [b for b, _ in wdets], rtol=0, atol=1e-5)
            np.testing.assert_allclose(
                [d["confidence"] for d in rec["detections"]],
                [c for _, c in wdets], rtol=0, atol=5e-5)
        ref = codec.encode_rgb(jdraw_detections(frame, wdets, None))
        if part != ref:
            diff = codec.decode_rgb(part) != codec.decode_rgb(ref)
            assert diff.mean() <= 2e-3


@pytest.mark.parametrize("path, kind", [("/stream", "raw"),
                                        ("/face_stream", "inferred"),
                                        ("/snapshot", "inferred")])
def test_streams_serve_small_frames(detector, small_dir, path, kind):
    """/stream passes the sent JPEGs through unchanged; /face_stream and
    /snapshot serve annotated 64x48 JPEGs."""
    sent_jpegs = [p.read_bytes() for p in sorted(small_dir.glob("*.jpg"))]

    async def run():
        async with _serving(detector) as server:
            viewer = await _Viewer.open(server.http_port,
                                        f"{path}?name=s&timeout=20")
            await _until(lambda: _subscribed(server, "s", kind),
                         desc="viewer")
            sender = asyncio.ensure_future(send_stream(
                ReplaySource(str(small_dir), fps=30),
                ClientConfig(address=f"127.0.0.1:{server.socket_port}",
                             channel="s"), max_frames=30))
            if path == "/snapshot":
                await viewer.finish(timeout=30)
            else:
                await viewer.wait(lambda v: len(v.parts()) >= 2)
            await viewer.close()
            await sender
            return viewer

    viewer = asyncio.run(run())
    assert viewer.data.startswith(b"HTTP/1.1 200 OK")
    if path == "/snapshot":
        assert b"image/jpeg" in viewer.head
        jpegs = [viewer.body]
    else:
        jpegs = viewer.parts()
    for jpeg in jpegs:
        if kind == "raw":
            assert jpeg in sent_jpegs
        else:
            assert codec.decode_rgb(jpeg).shape == (48, 64, 3)


@pytest.mark.parametrize("method, path, status, body", [
    ("GET", "/healthcheck", b"200 OK", b"healthy"),
    ("GET", "/nope", b"404 Not Found", b"not found"),
    ("POST", "/stream", b"405 Method Not Allowed", b"method not allowed"),
    ("GET", "/", b"200 OK", b"infercam_onnx_tpu_torch"),
    ("GET", "/snapshot?name=idle&timeout=0.1", b"504 Gateway Timeout",
     b"no frame within timeout"),
])
def test_plain_endpoints(detector, method, path, status, body):
    async def run():
        async with _serving(detector) as server:
            viewer = await _Viewer.open(server.http_port, path, method)
            return await viewer.finish()

    resp = asyncio.run(run())
    assert resp.startswith(b"HTTP/1.1 " + status)
    assert body in resp.split(b"\r\n\r\n", 1)[1]


def test_stats_and_metrics_report_the_port(detector, small_dir):
    async def run():
        async with _serving(detector, {"meter_period_s": 0.1}) as server:
            port = server.http_port
            viewer = await _Viewer.open(port, "/detections?name=m")
            await _until(lambda: _subscribed(server, "m", "detections"),
                         desc="viewer")
            await send_stream(
                ReplaySource(str(small_dir), fps=50),
                ClientConfig(address=f"127.0.0.1:{server.socket_port}",
                             channel="m"), max_frames=6)
            await viewer.wait(lambda v: len(v.records()) >= 1)

            async def get(path):
                return await (await _Viewer.open(port, path)).finish()

            stats = None
            for _ in range(100):  # the totals fill on the meter's drain
                stats = json.loads((await get("/stats")).split(
                    b"\r\n\r\n", 1)[1])
                if stats["totals"].get("inferred_unique", 0) >= 1:
                    break
                await asyncio.sleep(0.05)
            metrics = await get("/metrics")
            await viewer.close()
            return stats, metrics

    stats, metrics = asyncio.run(run())
    assert stats["topology"] == {"devices": 1, "processes": 1,
                                 "lockstep": False, "platform": "cpu",
                                 "device": "cpu", "detector": "Detector"}
    assert stats["warming"] is False
    assert stats["totals"]["inferred_unique"] >= 1
    assert stats["totals"]["batches"] >= 1
    text = metrics.split(b"\r\n\r\n", 1)[1].decode()
    assert "infercam_inferred_unique_total" in text
    assert 'infercam_topology_info{detector="Detector",device="cpu",' \
           'devices="1",lockstep="False",platform="cpu",processes="1"} 1' \
        in text


def test_unwatched_stream_is_not_inferred(detector, small_dir):
    async def run():
        async with _serving(detector) as server:
            submitted = []
            server.router._submit_infer = submitted.append
            await send_stream(
                ReplaySource(str(small_dir), fps=100),
                ClientConfig(address=f"127.0.0.1:{server.socket_port}",
                             channel="nobody"), max_frames=8)
            await _until(lambda: "nobody" in server.router._seen,
                         desc="router saw the stream")
            return submitted

    assert asyncio.run(run()) == []


def test_corrupt_frame_does_not_kill_worker(detector, small_dir):
    good = (small_dir / "f0.jpg").read_bytes()

    async def run():
        async with _serving(detector) as server:
            viewer = await _Viewer.open(server.http_port, "/detections?name=c")
            await _until(lambda: _subscribed(server, "c", "detections"),
                         desc="viewer")
            _, writer = await asyncio.open_connection(
                "127.0.0.1", server.socket_port)

            def send(payload):
                writer.write(tproto.frame_encode(payload))

            send(tproto.encode_proto_msg(
                tproto.FrameMsg("c", b"\xff\xd8 this is not a jpeg")))
            send(tproto.encode_proto_msg(tproto.ConnectReq("c")))
            send(b"\x99garbage")
            await writer.drain()
            await asyncio.sleep(0.3)  # the corrupt frame's batch alone
            for _ in range(3):
                send(tproto.encode_proto_msg(tproto.FrameMsg("c", good)))
            await writer.drain()
            await viewer.wait(lambda v: len(v.records()) >= 1)
            writer.close()
            await viewer.close()
            return viewer.records()

    records = asyncio.run(run())
    assert records[0]["width"] == 64 and records[0]["height"] == 48


def _detections_of(packed_row: np.ndarray) -> list[dict]:
    """The "detections" of the NDJSON record of one packed output row."""
    return [{"bbox": [float(v) for v in packed_row[d, :4]],
             "confidence": float(packed_row[d, 4])}
            for d in range(int(packed_row[:, 5].sum()))]


def _tap_units(server) -> list[dict]:
    """Every unit the worker's device stage dispatches, from now on."""
    units, dispatch = [], server.worker._device_stage

    def tap(batch_units):
        units.extend(batch_units)
        return dispatch(batch_units)

    server.worker._device_stage = tap
    return units


def test_ycbcr_server_publishes_run_device_ycbcr_packed(detector):
    """A server in ycbcr mode serves detection-only frames through the
    packed-plane path: each published record equals
    run_device_ycbcr_packed on the same padded batch outside the worker,
    and the dispatched batch holds the shim's packed rows."""
    datas = [p.read_bytes() for p in sorted(SYNTH_PICS.glob("*.jpg"))]

    async def run():
        async with _serving(detector, decode_mode="ycbcr") as server:
            units = _tap_units(server)
            dets = await _Viewer.open(server.http_port, "/detections?name=y")
            await _until(lambda: _subscribed(server, "y", "detections"),
                         desc="viewer")
            # one frame at a time, so record i answers frame i
            source = _GatedSource(datas, lambda i: len(dets.records()) >= i)
            await send_stream(source, ClientConfig(
                address=f"127.0.0.1:{server.socket_port}", channel="y"))
            await dets.wait(lambda v: len(v.records()) == len(datas))
            await dets.close()
            return units, dets.records()

    units, records = asyncio.run(run())
    assert len(units) == len(records) == 4
    geom = native_jpeg.load().decode_ycbcr_batch(datas[:1])[1]
    assert sum(len(r["detections"]) for r in records) >= 10
    for unit, rec, data in zip(units, records, datas):
        assert unit["geom"] == geom and unit["n"] == 1
        packed, _ = native_jpeg.load().decode_ycbcr_batch([data])
        np.testing.assert_array_equal(unit["batch"].numpy(), packed)
        want = detector.run_device_ycbcr_packed(
            unit["batch"], unit["geom"], pack_output=True).numpy()
        assert (rec["width"], rec["height"]) == (640, 480)
        assert rec["detections"] == _detections_of(want[0])


def test_ycbcr_server_face_stream_takes_the_pixels_path(detector):
    """In ycbcr mode with host annotation a stream with a /face_stream
    viewer still gets annotated 640x480 parts: its frames take the pixels
    path, while a detection-only stream beside it takes the packed
    planes."""
    async def run():
        async with _serving(detector, decode_mode="ycbcr",
                            annotate_mode="host",
                            queue_capacity=8) as server:
            units = _tap_units(server)
            port = server.http_port
            faces = await _Viewer.open(port, "/face_stream?name=f")
            dets = await _Viewer.open(port, "/detections?name=d")
            await _until(lambda: _subscribed(server, "f")
                         and _subscribed(server, "d", "detections"),
                         desc="viewers")
            address = f"127.0.0.1:{server.socket_port}"
            await asyncio.gather(*(send_stream(
                ReplaySource(str(SYNTH_PICS), fps=20),
                ClientConfig(address=address, channel=name), max_frames=4)
                for name in ("f", "d")))
            await faces.wait(lambda v: len(v.parts()) >= 2)
            await dets.wait(lambda v: len(v.records()) >= 2)
            await faces.close()
            await dets.close()
            return units, faces.parts(), dets.records()

    units, parts, records = asyncio.run(run())
    for part in parts:
        assert codec.decode_rgb(part).shape == (480, 640, 3)
    assert all((r["width"], r["height"]) == (640, 480) for r in records)
    keys = {"f": stream_key("f"), "d": stream_key("d")}
    for unit in units:
        members = {job.key for job, _ in unit["members"]}
        if unit["geom"] is None:
            assert members == {keys["f"]}
            assert unit["batch"].shape[1:] == (480, 640, 3)
        else:
            assert members == {keys["d"]}
            assert unit["batch"].ndim == 2
    assert {u["geom"] is None for u in units} == {True, False}


def test_ycbcr_server_drops_and_counts_a_corrupt_frame(detector):
    """In ycbcr mode a corrupt frame is dropped and counted; a grayscale
    JPEG, which the packed-plane decode refuses, is pixel-decoded and
    served instead of dropped; a good frame takes the packed planes."""
    good = (SYNTH_PICS / "synthetic-0.jpg").read_bytes()
    buf = io.BytesIO()
    Image.new("L", (64, 48), 90).save(buf, "JPEG")
    gray = buf.getvalue()

    async def run():
        async with _serving(detector, {"meter_period_s": 3600.0},
                            decode_mode="ycbcr") as server:
            units = _tap_units(server)
            viewer = await _Viewer.open(server.http_port,
                                        "/detections?name=c")
            await _until(lambda: _subscribed(server, "c", "detections"),
                         desc="viewer")
            _, writer = await asyncio.open_connection(
                "127.0.0.1", server.socket_port)
            dropped = METER.dropped
            outcomes = []
            for data in (b"\xff\xd8 this is not a jpeg", gray, good):
                seen = len(viewer.records())
                writer.write(tproto.frame_encode(tproto.encode_proto_msg(
                    tproto.FrameMsg("c", data))))
                await writer.drain()
                await _until(lambda: len(viewer.records()) > seen
                             or METER.dropped > dropped, desc="outcome")
                outcomes.append((len(viewer.records()) - seen,
                                 METER.dropped - dropped))
                dropped = METER.dropped
            writer.close()
            await viewer.close()
            return outcomes, viewer.records(), units

    outcomes, records, units = asyncio.run(run())
    assert outcomes == [(0, 1), (1, 0), (1, 0)]
    assert [(r["width"], r["height"]) for r in records] == [(64, 48),
                                                           (640, 480)]
    assert [u["geom"] is None for u in units] == [True, False]


TILED = (480, 270)  # the tiled tests' frames, (width, height)
TILE_MIN = TILED[0] * TILED[1]  # they tile


@pytest.fixture(scope="module")
def jax_tiled():
    """The synthetic pictures resized to 480x270 and JPEG-encoded, and JAX
    TiledDetector (float32, the frozen weights, 2x2 at overlap 0.2) on
    them: (jpeg bytes, decoded frames, packed outputs of the pixels
    program, packed outputs of the packed YCbCr program on each JPEG's own
    planes). At this size the two packages' resize of the 267x150 tiles
    gives equal u8 levels (at 640x480, 356x267 tiles, C.2's edge-tap
    levels differ)."""
    from infercam_onnx_tpu.parallel.tiling import TiledDetector as JTiled

    from infercam_onnx_tpu_torch.eval.goldens import load_directory_frames

    datas = [codec.encode_rgb(f) for f in load_directory_frames(
        str(SYNTH_PICS), resize=TILED).values()]
    frames = [codec.decode_rgb(d) for d in datas]
    params = jconvert.params_from_state_dict(dict(np.load(WEIGHTS)))
    tiled = JTiled(JDetector(JDetectorConfig(compute_dtype="float32"),
                             params=params), TILED, grid=(2, 2))
    pixels = np.asarray(tiled.run_device(np.stack(frames), pack_output=True))
    ycbcr = np.concatenate([np.asarray(tiled.run_device_ycbcr_packed(
        *native_jpeg.load().decode_ycbcr_batch([d]), pack_output=True))
        for d in datas])
    return datas, frames, pixels, ycbcr


def _assert_records_close(records, want):
    """NDJSON records against packed [B, D, 6] rows: counts equal, boxes
    within 1e-5, confidences within 5e-5."""
    assert len(records) == len(want)
    for rec, row in zip(records, want):
        n = int(row[:, 5].sum())
        assert len(rec["detections"]) == n
        if n:
            np.testing.assert_allclose([d["bbox"] for d in rec["detections"]],
                                       row[:n, :4], rtol=0, atol=1e-5)
            np.testing.assert_allclose(
                [d["confidence"] for d in rec["detections"]], row[:n, 4],
                rtol=0, atol=5e-5)


@pytest.mark.parametrize("decode_mode", ["pixels", "ycbcr", "coefficients"])
def test_tiled_viewer_frames_match_jax_and_are_host_drawn(detector,
                                                          jax_tiled,
                                                          decode_mode):
    """Frames at the tiling threshold with a /face_stream viewer, device
    annotation configured: in every decode mode they take a pixels unit
    through TiledDetector.run_device with annotate off, their records are
    JAX TiledDetector's on the same frames, and each annotated part is the
    host's draw + encode of its record."""
    datas, frames, want, _ = jax_tiled

    async def run():
        async with _serving(detector, decode_mode=decode_mode,
                            tile_min_pixels=TILE_MIN) as server:
            units = _tap_units(server)
            port = server.http_port
            dets = await _Viewer.open(port, "/detections?name=t")
            faces = await _Viewer.open(port, "/face_stream?name=t")
            await _until(lambda: _subscribed(server, "t", "detections")
                         and _subscribed(server, "t"), desc="viewers")
            source = _GatedSource(datas, lambda i: (
                len(dets.records()) >= i and len(faces.parts()) >= i))
            await send_stream(source, ClientConfig(
                address=f"127.0.0.1:{server.socket_port}", channel="t"))
            await dets.wait(lambda v: len(v.records()) == len(datas))
            await faces.wait(lambda v: len(v.parts()) == len(datas))
            await dets.close()
            await faces.close()
            return units, dets.records(), faces.parts(), server.worker

    units, records, parts, worker = asyncio.run(run())
    assert [(u["kind"], u["annotate"], u["n"]) for u in units] == [
        ("pixels", False, 1)] * len(datas)
    assert set(worker._tiled) == {TILED[::-1]}
    _assert_records_close(records, want)
    assert sum(len(r["detections"]) for r in records) >= 10
    for rec, frame, part in zip(records, frames, parts):
        assert (rec["width"], rec["height"]) == TILED
        drawn = tdraw.draw_detections(frame, [
            (np.array(d["bbox"], np.float32), d["confidence"])
            for d in rec["detections"]])
        assert part == codec.encode_rgb(drawn)


@pytest.mark.parametrize("route", ["stacked", "rows"])
def test_ycbcr_tiled_units_match_jax(detector, jax_tiled, route):
    """Detection-only frames at the threshold in ycbcr mode take the
    ycbcr_tiled unit (route "stacked") or ycbcr_tiled_rows (one uploaded
    row a frame): their records equal the port's tiled program on the
    dispatched batch exactly, and JAX TiledDetector's packed-YCbCr program
    on the same planes within the detector tolerances."""
    datas, _, _, want = jax_tiled

    async def run():
        async with _serving(detector, decode_mode="ycbcr",
                            tile_min_pixels=TILE_MIN,
                            tiled_upload=route) as server:
            units = _tap_units(server)
            dets = await _Viewer.open(server.http_port, "/detections?name=y")
            await _until(lambda: _subscribed(server, "y", "detections"),
                         desc="viewer")
            source = _GatedSource(datas, lambda i: len(dets.records()) >= i)
            await send_stream(source, ClientConfig(
                address=f"127.0.0.1:{server.socket_port}", channel="y"))
            await dets.wait(lambda v: len(v.records()) == len(datas))
            await dets.close()
            return units, dets.records(), server.worker

    units, records, worker = asyncio.run(run())
    kind = "ycbcr_tiled" if route == "stacked" else "ycbcr_tiled_rows"
    assert [u["kind"] for u in units] == [kind] * len(datas)
    assert worker._effective_tiled_route == route
    tiled = worker._tiled[TILED[::-1]]
    for unit, rec, data in zip(units, records, datas):
        packed, geom = native_jpeg.load().decode_ycbcr_batch([data])
        assert unit["geom"] == geom
        if route == "rows":
            assert isinstance(unit["batch"], tuple)
            assert [r.shape for r in unit["batch"]] == [packed[0].shape]
            mine = tiled.run_device_ycbcr_rows(unit["batch"], geom,
                                               pack_output=True)
            batch = torch.stack(unit["batch"])
        else:
            batch = unit["batch"]
            mine = tiled.run_device_ycbcr_packed(batch, geom,
                                                 pack_output=True)
        np.testing.assert_array_equal(batch.numpy(), packed)
        assert rec["detections"] == _detections_of(mine.numpy()[0])
    _assert_records_close(records, want)
    assert sum(len(r["detections"]) for r in records) >= 10


def test_coefficients_detection_frames_do_not_tile(detector):
    """Detection-only coefficients frames at the threshold keep the
    untiled coef unit, as in the JAX worker."""
    datas = [p.read_bytes() for p in sorted(SYNTH_PICS.glob("*.jpg"))]

    async def run():
        async with _serving(detector, decode_mode="coefficients",
                            tile_min_pixels=TILE_MIN) as server:
            units = _tap_units(server)
            dets = await _Viewer.open(server.http_port, "/detections?name=c")
            await _until(lambda: _subscribed(server, "c", "detections"),
                         desc="viewer")
            source = _GatedSource(datas, lambda i: len(dets.records()) >= i)
            await send_stream(source, ClientConfig(
                address=f"127.0.0.1:{server.socket_port}", channel="c"))
            await dets.wait(lambda v: len(v.records()) == len(datas))
            await dets.close()
            return units, dets.records(), server.worker

    units, records, worker = asyncio.run(run())
    assert [u["kind"] for u in units] == ["coef"] * len(datas)
    assert worker._tiled == {}
    for unit, rec in zip(units, records):
        want = detector.run_device_coefficients_arrays(
            *unit["batch"], (unit["w"], unit["h"]),
            sampling=unit["sampling"], pack_output=True).numpy()
        assert rec["detections"] == _detections_of(want[0])
    assert sum(len(r["detections"]) for r in records) >= 10


def test_stats_show_the_link_decisions(detector):
    """/stats "link" holds the start-up probe's reading on the CPU, the
    A/B pair (tiling is on) and the decision table; the configured paths
    are kept on a healthy link."""
    async def run():
        async with _serving(detector, tile_min_pixels=TILE_MIN) as server:
            viewer = await _Viewer.open(server.http_port, "/stats")
            return json.loads((await viewer.finish()).split(b"\r\n\r\n",
                                                             1)[1])

    link = asyncio.run(run())["link"]
    assert link["probed"] is True and link["h2d_mbps"] > 0
    assert set(link["tiled_ab_ms"]) == {"stacked", "rows"}
    decisions = link["decisions"]
    assert set(decisions) == {"decode_mode", "tiled_upload", "annotate_mode"}
    assert [decisions[k]["configured"] for k in sorted(decisions)] == [
        "device", "pixels", "auto"]
    assert decisions["decode_mode"]["effective"] == "pixels"  # never moved
    assert decisions["tiled_upload"]["effective"] in ("rows", "stacked")


def test_submit_queue_drops_when_full(detector):
    async def run():
        worker = InferenceWorker(detector, EngineConfig(queue_capacity=2))
        try:
            chan = Broadcast()
            return [worker.submit(InferJob(i, b"x", chan)) for i in range(4)]
        finally:
            worker.close()

    assert asyncio.run(run()) == [True, True, False, False]


def test_live_server_drops_frames_when_the_queue_is_full(detector, small_dir):
    """A burst into a server whose infer queue holds one frame: the router
    drops what the queue refuses, counts it, and every frame sent is
    either inferred or dropped."""
    async def run():
        # no meter drain during the test: the counters only grow
        async with _serving(detector, {"meter_period_s": 3600.0},
                            queue_capacity=1, batch_buckets=(1,),
                            coalesce_streams=False) as server:
            viewer = await _Viewer.open(server.http_port,
                                        "/detections?name=burst")
            await _until(lambda: _subscribed(server, "burst", "detections"),
                         desc="viewer")
            base = (METER.inferred_unique, METER.dropped)

            def counts():
                return (METER.inferred_unique - base[0],
                        METER.dropped - base[1])

            sent = await send_stream(
                ReplaySource(str(small_dir), fps=0),
                ClientConfig(address=f"127.0.0.1:{server.socket_port}",
                             channel="burst"), max_frames=40)
            await _until(lambda: sum(counts()) >= sent,
                         desc="every frame inferred or dropped")
            await viewer.wait(lambda v: len(v.records()) >= counts()[0])
            await viewer.close()
            return sent, *counts(), viewer.records()

    sent, inferred, dropped, records = asyncio.run(run())
    assert sent == 40
    assert dropped >= 1 and inferred >= 1
    assert inferred + dropped == sent
    assert len(records) == inferred


@pytest.mark.parametrize("coalesce", [False, True])
def test_coalescing(detector, small_dir, coalesce):
    """Eight frames of one stream inside one gather window: without
    coalescing each gets its own record, with it the newest wins."""
    async def run():
        async with _serving(detector, batch_window_ms=1000.0,
                            coalesce_streams=coalesce, queue_capacity=32,
                            batch_buckets=(1, 2, 4, 8)) as server:
            viewer = await _Viewer.open(server.http_port,
                                        "/detections?name=nc")
            await _until(lambda: _subscribed(server, "nc", "detections"),
                         desc="viewer")
            sent = await send_stream(
                ReplaySource(str(small_dir), fps=100),
                ClientConfig(address=f"127.0.0.1:{server.socket_port}",
                             channel="nc"), max_frames=8)
            await viewer.wait(lambda v: len(v.records()) >= 1)
            await asyncio.sleep(0.5)  # any later batch's records
            await viewer.close()
            return sent, viewer.records()

    sent, records = asyncio.run(run())
    assert sent == 8
    if coalesce:
        assert 1 <= len(records) < 8
    else:
        assert len(records) == 8


# -- the process-level guards ----------------------------------------------

@pytest.mark.parametrize("readings, fired", [([100.0, 200.0, 900.0], 1),
                                             ([100.0] * 10, 0)])
def test_rss_watchdog(readings, fired):
    calls = []
    it = iter(readings)

    async def run():
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(rss_watchdog(
                500, period_s=0.01, read_rss=lambda: next(it, 100.0),
                on_breach=lambda: calls.append(True)), 0.3)

    asyncio.run(run())
    assert len(calls) == fired


def test_meter_loses_no_tick_to_a_concurrent_drain():
    """The worker's three stage threads tick the meter while the event
    loop drains it: every tick lands in exactly one drained window."""
    import sys
    import threading

    from infercam_onnx_tpu_torch.serving.meter import Meter

    meter, n_threads, n_ticks = Meter(), 8, 3000
    drained = []
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            (meter.tick_dropped(), meter.tick_batch(2, 0.0))
            for _ in range(n_ticks)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            drained.append(meter.drain())
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        drained.append(meter.drain())
    finally:
        sys.setswitchinterval(saved)
    assert sum(d["dropped"] for d in drained) == n_threads * n_ticks
    assert sum(d["batches"] for d in drained) == n_threads * n_ticks
    assert meter.totals["batched_frames"] == 2 * n_threads * n_ticks


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with device_trace(str(tmp_path)):
        torch.ones(4).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    with device_trace(None):
        pass
