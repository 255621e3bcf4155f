"""The port's ONNX graph detector, structural converter, CLIs and serving,
against the JAX package (``models/onnx_exec.py``'s ``GraphDetector``,
``models/convert.py``'s structural converter, ``detect.py``, ``serve.py``).

The committed export ``tests/fixtures/ultraface_twin_rfb320.onnx`` is the
frozen twin (``resources/weights/ultraface-twin.npz``) exported by
`write_twin_fixture`; ``python tests/test_torch_port_graph.py`` writes it
again. The card has no JAX and reads that file; the other exports here are
made on the fly with ``tests/onnx_export_util.py``.
"""

import asyncio
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infercam_onnx_tpu import detect as jdetect  # noqa: E402
from infercam_onnx_tpu.config import DetectorConfig as JConfig  # noqa: E402
from infercam_onnx_tpu.models import convert as jconvert  # noqa: E402
from infercam_onnx_tpu.models.onnx_exec import (  # noqa: E402
    GraphDetector as JGraphDetector)
from infercam_onnx_tpu.models.onnx_reader import (  # noqa: E402
    read_onnx_graph as jread)
from infercam_onnx_tpu.ops import jpeg_encode_device as jenc  # noqa: E402
from infercam_onnx_tpu_torch import codec, detect  # noqa: E402
from infercam_onnx_tpu_torch.client.sender import send_stream  # noqa: E402
from infercam_onnx_tpu_torch.config import (ClientConfig,  # noqa: E402
                                            DetectorConfig, EngineConfig,
                                            ServerConfig)
from infercam_onnx_tpu_torch.detector import Detector  # noqa: E402
from infercam_onnx_tpu_torch.models import convert  # noqa: E402
from infercam_onnx_tpu_torch.models.onnx_exec import (  # noqa: E402
    GraphDetector, GraphExecutor, ShardedGraphDetector)
from infercam_onnx_tpu_torch.models.onnx_reader import (  # noqa: E402
    read_onnx_graph)
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg  # noqa: E402
from infercam_onnx_tpu_torch.ops.jpeg_device import (  # noqa: E402
    read_coefficient_batch)
from infercam_onnx_tpu_torch.parallel.tiling import (  # noqa: E402
    TiledDetector)
from infercam_onnx_tpu_torch.serving.app import start_server  # noqa: E402
from infercam_onnx_tpu_torch.serving.inferer import (  # noqa: E402
    InferenceWorker)
from infercam_onnx_tpu_torch.serving.router import InferJob  # noqa: E402

from onnx_export_util import export_onnx  # noqa: E402
from test_torch_port_annotate import (_planes,  # noqa: E402
                                      assert_coefficients_match,
                                      assert_detections_match, frames_of,
                                      jax_tail, packed_coefficients)
from test_torch_port_serving import (_detections_of,  # noqa: E402
                                     _GatedSource, _serving, _subscribed,
                                     _tap_units, _until, _Viewer)
from torch_twin import UltraFaceTwin  # noqa: E402
from torch_port_offline import offline_weights_chain  # noqa: E402,F401

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / \
    "ultraface_twin_rfb320.onnx"
TWIN_WEIGHTS = pathlib.Path(__file__).parents[1] / "resources" / \
    "weights" / "ultraface-twin.npz"
SYNTH_PICS = pathlib.Path(__file__).parents[1] / "resources" / \
    "test_pics_synthetic"
CONFIG = DetectorConfig(compute_dtype="float32")
JCONFIG = JConfig(variant="RFB-320", compute_dtype="float32")
C3 = (1e-5, 5e-5)  # ROADMAP C.3: boxes, confidences


def write_twin_fixture(path=FIXTURE) -> None:
    """Export the frozen twin as the committed ONNX file: RFB-320, opset
    11, constant-folded, input ``input``, outputs ``scores``/``boxes``
    (the export of ``tests/test_onnx_graph.py``). The weights go through
    the JAX package's ``params_from_state_dict`` and
    ``state_dict_from_params`` into ``tests/torch_twin.py``."""
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from infercam_onnx_tpu.models import ultraface as juf
    from infercam_onnx_tpu.models.convert import (params_from_state_dict,
                                                  state_dict_from_params)
    from onnx_export_util import export_onnx
    from torch_twin import UltraFaceTwin

    with np.load(TWIN_WEIGHTS) as z:
        sd = state_dict_from_params(params_from_state_dict(
            {k: z[k] for k in z.files}))
    twin = UltraFaceTwin(torch.from_numpy(juf.generate_priors(320, 240)))
    twin.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=False)
    export_onnx(twin.eval(), path, torch.zeros(1, 3, 240, 320), opset=11,
                fold=True, input_names=["input"],
                output_names=["scores", "boxes"])




@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """A twin of random weights (seed 3, as ``tests/test_onnx_graph.py``)
    exported folded and unfolded, and the committed frozen twin."""
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from infercam_onnx_tpu.models import ultraface as juf

    d = tmp_path_factory.mktemp("graph")
    torch.manual_seed(3)
    twin = UltraFaceTwin(torch.from_numpy(
        juf.generate_priors(320, 240))).eval()
    paths = {"committed": str(FIXTURE)}
    for fold in (True, False):
        paths[f"fold{fold}"] = str(d / f"rfb320_fold{fold}.onnx")
        export_onnx(twin, paths[f"fold{fold}"], torch.zeros(1, 3, 240, 320),
                    opset=11, fold=fold, input_names=["input"],
                    output_names=["scores", "boxes"])
    return paths


def test_committed_fixture_is_the_frozen_twin(tmp_path):
    """The committed export equals a fresh export of the frozen twin, and
    its graph detector equals the native float32 detector on the frozen
    weights on the four synthetic pictures: counts equal, boxes and
    confidences within 1e-4 (the JAX bar of
    test_graph_detector_matches_native_detector)."""
    fresh = tmp_path / "twin.onnx"
    write_twin_fixture(fresh)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(1, 3, 240, 320)).astype(np.float32))
    for a, b in zip(GraphExecutor(read_onnx_graph(str(fresh)))(x),
                    GraphExecutor(read_onnx_graph(str(FIXTURE)))(x)):
        assert torch.equal(a, b)
    frames = np.stack(list(frames_of(640, 480)))
    got = GraphDetector(str(FIXTURE), CONFIG, device="cpu").run_device(
        frames, pack_output=True).numpy()
    want = Detector(CONFIG, weights=str(TWIN_WEIGHTS),
                    device="cpu").run_device(frames,
                                             pack_output=True).numpy()
    assert got[..., 5].sum() >= 10
    assert_detections_match(got, want, (1e-4, 1e-4))


def _frames(n: int) -> np.ndarray:
    """The synthetic pictures at the graph's 320x240, plain then
    mirrored."""
    pics = list(frames_of(320, 240))
    pics += [p[:, ::-1] for p in pics]
    return np.ascontiguousarray(np.stack(pics[:n]))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("which", ["committed", "foldTrue", "foldFalse"])
def test_graph_detector_matches_jax(exports, which, batch):
    """GraphDetector against JAX's on the folded and unfolded exports
    (ROADMAP C.3). A folded export pins batch 1 in its Reshape constants:
    a batch of 3 must equal the 3 single-image runs."""
    frames = _frames(batch)
    det = GraphDetector(exports[which], CONFIG, device="cpu")
    got = det.run_device(frames, pack_output=True).numpy()
    want = np.asarray(JGraphDetector(exports[which], JCONFIG).run_device(
        frames, pack_output=True))
    assert_detections_match(got, want, C3)
    singles = np.concatenate([det.run_device(f[None], pack_output=True)
                              .numpy() for f in frames])
    assert_detections_match(got, singles, C3)
    if which == "committed":
        assert got[..., 5].sum() >= batch


@pytest.fixture(scope="module")
def graph_pair():
    """The port's and JAX's graph detectors on the committed export."""
    return (GraphDetector(str(FIXTURE), CONFIG, device="cpu"),
            JGraphDetector(str(FIXTURE), JCONFIG))


def _jpegs(n: int = 2) -> list[bytes]:
    return [codec.encode_rgb(f, 92) for f in _frames(n)]


def test_graph_ycbcr_and_coefficient_programs_match_jax(graph_pair):
    det, jdet = graph_pair
    datas = _jpegs()
    packed, geom = native_jpeg.load().decode_ycbcr_batch(datas)
    got = det.run_device_ycbcr_packed(packed, geom, pack_output=True)
    want = jdet.run_device_ycbcr_packed(packed, geom, pack_output=True)
    assert_detections_match(got.numpy(), np.asarray(want), C3)
    y, cb, cr, q, wh, samp = read_coefficient_batch(datas)
    got = det.run_device_coefficients_arrays(y, cb, cr, q, wh,
                                             sampling=samp,
                                             pack_output=True)
    want = jdet.run_device_coefficients_arrays(y, cb, cr, q, wh,
                                               sampling=samp,
                                               pack_output=True)
    assert_detections_match(got.numpy(), np.asarray(want), C3)
    assert got.numpy()[..., 5].sum() >= 2


def test_graph_annotated_programs_match_jax(graph_pair):
    """The two annotate tails behind the graph: detections by C.3 against
    JAX's GraphDetector and equal to the detection-only program; the
    coefficients against JAX's overlay + encode of those detections (the
    share of .5 ties of tests/test_torch_port_annotate.py)."""
    det, jdet = graph_pair
    datas = _jpegs()
    _, jplanes, geom = _planes(datas)
    packed, _ = native_jpeg.load().decode_ycbcr_batch(datas)
    coefs, pdet = det.run_device_ycbcr_annotated(packed, geom, quality=95)
    _, jpdet = jdet.run_device_ycbcr_annotated(packed, geom, quality=95)
    assert_detections_match(pdet.numpy(), np.asarray(jpdet), C3)
    np.testing.assert_array_equal(pdet.numpy(), det.run_device_ycbcr_packed(
        packed, geom, pack_output=True).numpy())
    assert_coefficients_match(packed_coefficients(coefs.numpy()),
                              packed_coefficients(jax_tail(
                                  jplanes, pdet.numpy(), geom)))
    frames = np.stack([codec.decode_rgb(d) for d in datas])
    coefs, pdet = det.run_device_annotated(frames, quality=95)
    _, jpdet = jdet.run_device_annotated(frames, quality=95)
    assert_detections_match(pdet.numpy(), np.asarray(jpdet), C3)
    rgb_geom = dict(width=320, height=240, sampling=(2, 2))
    assert_coefficients_match(packed_coefficients(coefs.numpy()),
                              packed_coefficients(jax_tail(
                                  jenc.rgb_to_ycbcr_planes(
                                      jnp.asarray(frames), sampling=(2, 2)),
                                  pdet.numpy(), rgb_geom)))


PROGRAMS = ("run_device", "run_device_ycbcr_packed",
            "run_device_ycbcr_annotated", "run_device_annotated",
            "run_device_coefficients_arrays", "warmup", "detect_batch",
            "detect", "to_mesh")
NOT_GRAPH_PROGRAMS = ("run_device_ycbcr", "run_device_coefficients",
                      "run_device_coefficients_annotated",
                      "run_device_coefficients_annotated_packed")


def test_graph_detector_has_exactly_the_jax_programs(graph_pair):
    """The programs JAX's GraphDetector has, and none of the Detector
    programs it lacks (the splice transcode, the byte-decoding entry
    points); no tiled programs."""
    det, jdet = graph_pair
    for detector in (det, det.to_mesh(["cpu", "cpu"])):
        for name in PROGRAMS:
            assert hasattr(detector, name) and hasattr(jdet, name), name
        for name in NOT_GRAPH_PROGRAMS:
            assert not hasattr(detector, name), name
            assert not hasattr(jdet, name), name
    with pytest.raises(ValueError, match="no tiled programs"):
        TiledDetector(det, (1280, 720))
    with pytest.raises(ValueError, match="does not support tiling"):
        InferenceWorker(det, EngineConfig(tile_min_pixels=921600))


def test_graph_detector_input_contract_and_device():
    """A non-[N, 3, H, W] input raises JAX's ValueError; without a GPU and
    without device="cpu" the detector raises."""
    graph = read_onnx_graph(str(FIXTURE))
    graph.inputs[0].shape = [1, 4, 240, 320]
    jgraph = jread(str(FIXTURE))
    jgraph.inputs[0].shape = [1, 4, 240, 320]
    with pytest.raises(ValueError) as got:
        GraphDetector(graph, device="cpu")
    with pytest.raises(ValueError) as want:
        JGraphDetector(jgraph)
    assert str(got.value) == str(want.value)
    assert GraphDetector(str(FIXTURE), device="cpu").config.compute_dtype \
        == "float32"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GraphDetector(str(FIXTURE))


def test_graph_detector_to_mesh_matches_each_shard(graph_pair):
    """to_mesh over two CPU entries: one program call, the batch padded
    and split; each shard's rows bit-identical to the plain detector on
    them, and within C.3 of the whole batch at once (JAX's
    test_graph_detector_shards_over_mesh)."""
    det, _ = graph_pair
    two = det.to_mesh(["cpu", "cpu"])
    assert isinstance(two, ShardedGraphDetector)
    assert two.batch_granularity == 2 and two.graph is det.graph
    frames = _frames(4)
    got = two.run_device(frames, pack_output=True).numpy()
    want = np.concatenate([det.run_device(frames[r], pack_output=True)
                           .numpy() for r in (slice(0, 2), slice(2, 4))])
    np.testing.assert_array_equal(got, want)
    assert_detections_match(got, det.run_device(
        frames, pack_output=True).numpy(), C3)
    odd = two.run_device(frames[:3], pack_output=True).numpy()
    assert odd.shape[0] == 3
    np.testing.assert_array_equal(odd[:2], want[:2])


# -- the structural converter --------------------------------------------


@pytest.fixture(scope="module")
def converter_exports(exports, tmp_path_factory):
    """The twin's exports plus slim and the upstream interleaved order."""
    from infercam_onnx_tpu.models import ultraface as juf

    d = tmp_path_factory.mktemp("convert")
    priors = torch.from_numpy(juf.generate_priors(320, 240))
    paths = {k: v for k, v in exports.items() if k != "committed"}
    torch.manual_seed(4)
    for arch in ("RFB", "slim"):
        for interleaved in (False, True):
            torch.manual_seed(4)
            twin = UltraFaceTwin(priors, arch=arch,
                                 interleaved=interleaved).eval()
            for fold in (True, False):
                if arch == "RFB" and not interleaved:
                    continue  # the exports fixture's
                name = f"{arch}_inter{interleaved}_fold{fold}"
                paths[name] = str(d / f"{name}.onnx")
                export_onnx(twin, paths[name], torch.zeros(1, 3, 240, 320),
                            opset=11, fold=fold, input_names=["input"],
                            output_names=["scores", "boxes"])
    return paths


def test_params_from_onnx_equals_jax(converter_exports):
    """Exactly JAX's params, leaf for leaf, on every export: RFB and slim,
    folded and unfolded, grouped and upstream-interleaved order."""
    assert len(converter_exports) == 8
    for name, path in converter_exports.items():
        got = convert.params_from_onnx(path)
        want = jconvert.params_from_onnx(path)
        assert jax.tree.structure(got) == jax.tree.structure(want), name
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert isinstance(a, np.ndarray) and a.dtype == np.float32
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def test_converted_params_serve_the_native_detector(converter_exports):
    """params_from_onnx feeds Detector(params=): its float32 detections
    equal the graph detector's on the same export by the JAX bar
    (1e-4)."""
    path = converter_exports["foldTrue"]
    frames = _frames(2)
    native = Detector(CONFIG, params=convert.params_from_onnx(path),
                      device="cpu")
    got = native.run_device(frames, pack_output=True).numpy()
    want = GraphDetector(path, CONFIG, device="cpu").run_device(
        frames, pack_output=True).numpy()
    assert_detections_match(got, want, (1e-4, 1e-4))


def _break(graph, how: str):
    convs = [n for n in graph.nodes if n.op_type == "Conv"]
    if how == "dilation":
        next(n for n in convs if n.attrs.get("dilations") == [2, 2]) \
            .attrs["dilations"] = [4, 4]
    elif how == "count":
        graph.nodes.remove(convs[0])
    elif how == "pads":
        convs[0].attrs["pads"] = [0, 0, 0, 0]
    elif how == "inputs":
        graph.inputs[0].shape = [1, 1, 240, 320]
    return graph


@pytest.mark.parametrize("how", ["dilation", "count", "pads", "inputs"])
def test_validator_rejections_equal_jax(exports, how):
    path = exports["foldFalse"]
    with pytest.raises(ValueError) as got:
        convert.params_from_graph(_break(read_onnx_graph(path), how))
    with pytest.raises(ValueError) as want:
        jconvert.params_from_graph(_break(jread(path), how))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ["RFB", "slim"])
def test_conv_slots_equal_jax(arch):
    for ours, theirs in ((convert.expected_conv_slots,
                          jconvert.expected_conv_slots),
                         (convert.interleaved_conv_slots,
                          jconvert.interleaved_conv_slots)):
        assert [dataclasses.astuple(s) for s in ours(arch)] == \
            [dataclasses.astuple(s) for s in theirs(arch)]
    assert len(convert.expected_conv_slots(arch)) == \
        {"RFB": 52, "slim": 42}[arch]


# -- the CLIs -------------------------------------------------------------


def _picture(tmp_path) -> pathlib.Path:
    img = tmp_path / "in.jpg"
    img.write_bytes((SYNTH_PICS / "synthetic-0.jpg").read_bytes())
    return img


def test_detect_cli_graph_runtime_matches_jax(tmp_path, capsys):
    img, out = _picture(tmp_path), tmp_path / "out.jpg"
    assert detect.main([str(img), "-o", str(out), "--onnx", str(FIXTURE),
                        "--runtime", "graph", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert out.is_file() and got["device"] == "cpu"
    assert jdetect.main([str(img), "--onnx", str(FIXTURE), "--runtime",
                         "graph"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["faces"] == want["faces"] >= 1
    for a, b in zip(got["detections"], want["detections"]):
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=C3[0])
        assert abs(a["confidence"] - b["confidence"]) <= C3[1]


def test_detect_cli_native_runtime_takes_the_converted_params(tmp_path,
                                                              capsys):
    img = _picture(tmp_path)
    assert detect.main([str(img), "--onnx", str(FIXTURE), "--device",
                        "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    det = Detector(DetectorConfig(), device="cpu",
                   params=convert.params_from_onnx(str(FIXTURE)))
    want = det.detect(codec.decode_rgb(img.read_bytes()))
    assert got["faces"] == len(want)
    for a, (box, conf) in zip(got["detections"], want):
        assert a["bbox"] == [float(v) for v in box]
        assert a["confidence"] == conf


def test_detect_cli_graph_requires_onnx(tmp_path, capsys):
    img = _picture(tmp_path)
    with pytest.raises(SystemExit) as got:
        detect.main([str(img), "--runtime", "graph", "--device", "cpu"])
    err = capsys.readouterr().err
    with pytest.raises(SystemExit) as want:
        jdetect.main([str(img), "--runtime", "graph"])
    assert got.value.code == want.value.code == 2
    assert err.splitlines()[-1].split("error: ")[1] == \
        capsys.readouterr().err.splitlines()[-1].split("error: ")[1]


def test_serve_cli_builds_the_graph_detector(monkeypatch):
    """serve --runtime graph --onnx builds a float32 GraphDetector on the
    device asked for; --onnx alone a native Detector from the converter."""
    from infercam_onnx_tpu_torch import serve
    from infercam_onnx_tpu_torch.serving import app

    served = {}

    async def serve_forever(**kw):
        served.update(kw)

    monkeypatch.setattr(app, "serve_forever", serve_forever)
    assert serve.main(["--device", "cpu", "--runtime", "graph", "--onnx",
                       str(FIXTURE)]) == 0
    det = served["detector"]
    assert isinstance(det, GraphDetector) and det.device.type == "cpu"
    assert det.config.compute_dtype == "float32"
    assert serve.main(["--device", "cpu", "--onnx", str(FIXTURE)]) == 0
    det = served["detector"]
    assert type(det) is Detector and det.config.compute_dtype == "bfloat16"


# -- serving --------------------------------------------------------------


def _serve_graph(det, datas, name="g", *, face=False, **engine_kw):
    """Serve ``datas`` one at a time to a live server on port 0; returns
    (dispatched units, /detections records, /face_stream parts)."""
    async def run():
        async with _serving(det, **engine_kw) as server:
            units = _tap_units(server)
            port = server.http_port
            dets = await _Viewer.open(port, f"/detections?name={name}")
            faces = (await _Viewer.open(port, f"/face_stream?name={name}")
                     if face else None)
            await _until(lambda: _subscribed(server, name, "detections")
                         and (not face or _subscribed(server, name)),
                         desc="viewers")
            source = _GatedSource(datas, lambda i: len(dets.records()) >= i
                                  and (not face or len(faces.parts()) >= i))
            await send_stream(source, ClientConfig(
                address=f"127.0.0.1:{server.socket_port}", channel=name))
            await dets.wait(lambda v: len(v.records()) == len(datas))
            parts = []
            if face:
                await faces.wait(lambda v: len(v.parts()) == len(datas))
                parts = faces.parts()
                await faces.close()
            await dets.close()
            return units, dets.records(), parts

    return asyncio.run(run())


def _records_equal_programs(det, units, records):
    assert len(units) == len(records)
    for unit, rec in zip(units, records):
        if unit["kind"] == "pixels":
            want = det.run_device(unit["batch"], pack_output=True)
        else:
            want = det.run_device_ycbcr_annotated(
                unit["batch"], unit["geom"], quality=95)[1]
        assert rec["detections"] == _detections_of(want.numpy()[0])


@pytest.mark.parametrize("mesh", [None, ["cpu", "cpu"]],
                         ids=["one_device", "two_replicas"])
def test_graph_server_records_equal_run_device(graph_pair, mesh):
    """A served graph stream (pixels decode): each published record
    equals run_device of the serving detector on the batch the worker
    dispatched; on a mesh the server re-binds the graph detector with
    to_mesh."""
    det, _ = graph_pair
    datas = [p.read_bytes() for p in sorted(SYNTH_PICS.glob("*.jpg"))]

    async def run():
        server = await start_server(
            ServerConfig(http_address="127.0.0.1:0",
                         socket_address="127.0.0.1:0"),
            engine_config=EngineConfig(batch_buckets=(1, 2, 4),
                                       annotate_mode="host"),
            detector=det, mesh=mesh)
        try:
            worker_det = server.worker._detector
            units = _tap_units(server)
            dets = await _Viewer.open(server.http_port,
                                      "/detections?name=g")
            await _until(lambda: _subscribed(server, "g", "detections"),
                         desc="viewer")
            source = _GatedSource(datas, lambda i: len(dets.records()) >= i)
            await send_stream(source, ClientConfig(
                address=f"127.0.0.1:{server.socket_port}", channel="g"))
            await dets.wait(lambda v: len(v.records()) == len(datas))
            await dets.close()
            return worker_det, units, dets.records()
        finally:
            await server.close()

    worker_det, units, records = asyncio.run(run())
    if mesh is None:
        assert worker_det is det
    else:
        assert isinstance(worker_det, ShardedGraphDetector)
    assert {u["kind"] for u in units} == {"pixels"}
    assert sum(len(r["detections"]) for r in records) >= 10
    _records_equal_programs(worker_det, units, records)


def test_graph_coefficients_device_annotation_takes_the_ycbcr_tail(
        graph_pair):
    """Coefficients decode with device annotation: a graph detector has
    no splice transcode, so an annotated stream's frames take the ycbcr
    annotate tail (JAX inferer.py:323-325), while the native detector
    takes the splice; the served records equal the program's and the
    annotated parts decode at the frames' size."""
    det, _ = graph_pair
    datas = _jpegs(3)
    units, records, parts = _serve_graph(
        det, datas, face=True, decode_mode="coefficients",
        annotate_mode="device")
    assert {u["kind"] for u in units} == {"ycbcr_annot"}
    _records_equal_programs(det, units, records)
    assert [codec.decode_rgb(p).shape for p in parts] == [(240, 320, 3)] * 3

    def kinds(detector):
        worker = InferenceWorker(detector, EngineConfig(
            decode_mode="coefficients", annotate_mode="device",
            link_adaptive=False, batch_buckets=(1, 2, 4)))
        try:
            # a /face_stream viewer (reply) on the first frame's stream
            jobs = [InferJob(i, d, reply) for i, (d, reply) in
                    enumerate(zip(datas, (object(), None, None)))]
            return sorted(u["kind"] for u in worker._decode(jobs))
        finally:
            worker.close()

    assert kinds(det) == ["coef", "ycbcr_annot"]
    native = Detector(CONFIG, weights=str(TWIN_WEIGHTS), device="cpu")
    assert kinds(native) == ["coef", "coef_annot"]


if __name__ == "__main__":
    write_twin_fixture()
