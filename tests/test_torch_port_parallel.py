"""The port's data-parallel tier (``parallel/{mesh,data_parallel,
multihost}.py`` and `TiledDetector`'s mesh modes) against the JAX
package's, on the CPU.

The port's mesh is a list of devices; here 8 entries of the CPU stand
where the JAX tests use the 8 virtual CPU devices of ``tests/conftest.py``
(``make_mesh(8)``). The same frames (the synthetic pictures, or JPEGs of
them) and the frozen weights at float32 go through both. Tolerances are
ROADMAP C.3's: counts equal, boxes within 1e-5, confidences within 5e-5
(the two CPU conv trunks sum in different orders); annotated coefficients
as in ``tests/test_torch_port_annotate.py`` (at most 2e-3 of them one
off). The port's sharded output on each shard's rows is bit-identical to
its own `Detector` on those rows alone.

The two-process dry run joins two CPU processes in a gloo group, each
running its frame through its local `ShardedDetector`; the gathered
packed rows must match a one-process run.
"""

import asyncio
import json
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from infercam_onnx_tpu.config import DetectorConfig as JDetectorConfig
from infercam_onnx_tpu.detector import Detector as JDetector
from infercam_onnx_tpu.models import convert as jconvert
from infercam_onnx_tpu.parallel import data_parallel as jdp
from infercam_onnx_tpu.parallel import mesh as jmesh
from infercam_onnx_tpu.parallel import multihost as jmultihost
from infercam_onnx_tpu.parallel import tiling as jtiling
from infercam_onnx_tpu_torch import codec
from infercam_onnx_tpu_torch.config import DetectorConfig, resolve_device
from infercam_onnx_tpu_torch.detector import Detector
from infercam_onnx_tpu_torch.eval.goldens import load_directory_frames
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
from infercam_onnx_tpu_torch.ops.jpeg_device import read_coefficient_batch
from infercam_onnx_tpu_torch.parallel import (ShardedDetector, TiledDetector,
                                              make_mesh, shard_detect)
from infercam_onnx_tpu_torch.parallel import multihost

from tests.test_goldens_fixtures import SYNTH_PICS, WEIGHTS
from tests.test_torch_port_annotate import (assert_coefficients_match,
                                            assert_detections_match,
                                            packed_coefficients)

REPO = SYNTH_PICS.parents[1]


@pytest.fixture(scope="module")
def port_detector():
    return Detector(DetectorConfig(compute_dtype="float32"),
                    weights=str(WEIGHTS), device="cpu")


@pytest.fixture(scope="module")
def jax_detector():
    params = jconvert.params_from_state_dict(dict(np.load(WEIGHTS)))
    return JDetector(JDetectorConfig(compute_dtype="float32"), params=params)


@pytest.fixture(scope="module")
def port_sharded(port_detector):
    return ShardedDetector(port_detector, make_mesh(8, device="cpu"))


@pytest.fixture(scope="module")
def jax_sharded(jax_detector):
    return jdp.ShardedDetector(jax_detector, jmesh.make_mesh(8))


def frames(width: int, height: int, n: int) -> np.ndarray:
    """The synthetic pictures (plain, then mirrored) at width x height."""
    pics = list(load_directory_frames(str(SYNTH_PICS),
                                      resize=(width, height)).values())
    pics += [p[:, ::-1] for p in pics]
    return np.ascontiguousarray(np.stack(pics[:n]))


def jpegs(n: int) -> list[bytes]:
    return [codec.encode_rgb(f, 90) for f in frames(320, 240, n)]


def _np(out):
    return tuple(np.asarray(t) for t in out) if isinstance(out, tuple) \
        else np.asarray(out)


# -- the mesh -----------------------------------------------------------------


def test_make_mesh_lists_devices(monkeypatch):
    assert make_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    assert make_mesh(device="cpu") == [torch.device("cpu")]
    # a machine with 8 cards: the JAX package's count and message
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert make_mesh() == [torch.device("cuda", i) for i in range(8)]
    assert make_mesh(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError) as got:
        make_mesh(9)
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(9)
    assert str(got.value) == str(want.value)
    # an index beyond the cards is refused, not moved elsewhere
    with pytest.raises(RuntimeError, match="does not exist"):
        resolve_device("cuda:8")
    assert resolve_device("cuda:7") == torch.device("cuda", 7)


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedDetector(Detector(device="cpu"), [torch.device("cuda", 0)])


# -- ShardedDetector against the JAX package ----------------------------------


@pytest.mark.parametrize("b, pack_output", [(1, True), (3, True), (8, True),
                                           (3, False)])
def test_run_device_matches_jax(port_sharded, jax_sharded, b, pack_output):
    x = frames(320, 240, b)
    got = _np(port_sharded.run_device(x, pack_output=pack_output))
    want = _np(jax_sharded.run_device(x, pack_output=pack_output))
    if pack_output:
        assert got.shape == (b, 64, 6)  # sliced back to b rows
        assert_detections_match(got, want)
        assert got[..., 5].sum() >= b
        return
    (boxes, confs, counts), (jboxes, jconfs, jcounts) = got, want
    assert boxes.shape[0] == confs.shape[0] == counts.shape[0] == b
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_allclose(boxes, jboxes, rtol=0, atol=1e-5)
    np.testing.assert_allclose(confs, jconfs, rtol=0, atol=5e-5)


def test_ycbcr_accepts_list_valued_geom_and_matches_jax(port_sharded,
                                                       jax_sharded):
    """Geometries read back from JSON (the lockstep wire format) carry
    lists where the shim gives tuples; both run the same program."""
    packed, geom = native_jpeg.load().decode_ycbcr_batch(jpegs(3))
    listy = {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in geom.items()}
    got = port_sharded.run_device_ycbcr_packed(packed, listy,
                                               pack_output=True).numpy()
    np.testing.assert_array_equal(got, port_sharded.run_device_ycbcr_packed(
        packed, geom, pack_output=True).numpy())
    want = np.asarray(jax_sharded.run_device_ycbcr_packed(
        packed, listy, pack_output=True))
    assert_detections_match(got, want)
    assert got[..., 5].sum() >= 3


def test_coefficients_match_jax(port_sharded, jax_sharded):
    y, cb, cr, quant, wh, samp = read_coefficient_batch(jpegs(3))
    got = port_sharded.run_device_coefficients_arrays(
        y, cb, cr, quant, wh, sampling=samp, pack_output=True).numpy()
    want = np.asarray(jax_sharded.run_device_coefficients_arrays(
        y, cb, cr, quant, wh, sampling=samp, pack_output=True))
    assert_detections_match(got, want)
    assert got[..., 5].sum() >= 3


@pytest.mark.parametrize("program", ["rgb", "ycbcr"])
def test_annotated_programs_match_jax(port_sharded, jax_sharded, program):
    if program == "rgb":
        x = frames(320, 240, 3)
        got = port_sharded.run_device_annotated(x, quality=95)
        want = jax_sharded.run_device_annotated(x, quality=95)
    else:
        packed, geom = native_jpeg.load().decode_ycbcr_batch(jpegs(3))
        got = port_sharded.run_device_ycbcr_annotated(packed, geom,
                                                      quality=95)
        want = jax_sharded.run_device_ycbcr_annotated(packed, geom,
                                                      quality=95)
    (coefs, packed_det), (jcoefs, jpacked) = _np(got), _np(want)
    assert_detections_match(packed_det, jpacked)
    assert_coefficients_match(packed_coefficients(coefs),
                              packed_coefficients(jcoefs))


def test_splice_matches_jax(port_sharded, jax_sharded):
    """The splice transcode (tests/test_annotate_device.py:280 holds JAX's
    sharded splice to its plain one): meta and blocks as the annotated
    coefficients, detections within C.3."""
    y, cb, cr, quant, wh, samp = read_coefficient_batch(jpegs(3))
    got = _np(port_sharded.run_device_coefficients_annotated(
        y, cb, cr, quant, wh, sampling=samp, k=256))
    want = _np(jax_sharded.run_device_coefficients_annotated(
        y, cb, cr, quant, wh, sampling=samp, k=256))
    assert_detections_match(got[2], want[2])
    np.testing.assert_array_equal(got[1][:, 0], want[1][:, 0])
    assert_coefficients_match(got[0], want[0])


@pytest.mark.parametrize("program", [
    "run_device", "run_device_annotated", "run_device_ycbcr_packed",
    "run_device_ycbcr_annotated", "run_device_coefficients_arrays",
    "run_device_coefficients_annotated"])
def test_each_shard_is_bit_identical_to_the_plain_detector(port_detector,
                                                           program):
    """Two replicas, 4 rows: each replica's rows equal the plain detector
    on those 2 rows alone, output by output (the card check of the smoke
    at a small size)."""
    sharded = ShardedDetector(port_detector, make_mesh(2, device="cpu"))
    data = jpegs(4)
    args = {
        "run_device": (frames(320, 240, 4),),
        "run_device_annotated": (frames(320, 240, 4),),
        "run_device_ycbcr_packed": native_jpeg.load().decode_ycbcr_batch(
            data),
        "run_device_ycbcr_annotated": native_jpeg.load().decode_ycbcr_batch(
            data),
    }
    y, cb, cr, quant, wh, samp = read_coefficient_batch(data)
    kw = {}
    if program in args:
        got = getattr(sharded, program)(*args[program])
        halves = [getattr(port_detector, program)(
            *(a[i:i + 2] if not isinstance(a, dict) else a
              for a in args[program])) for i in (0, 2)]
    else:
        if program == "run_device_coefficients_annotated":
            kw = dict(k=256)
        got = getattr(sharded, program)(y, cb, cr, quant, wh, sampling=samp,
                                        **kw)
        halves = [getattr(port_detector, program)(
            y[i:i + 2], cb[i:i + 2], cr[i:i + 2], quant[i:i + 2], wh,
            sampling=samp, **kw) for i in (0, 2)]
    got = got if isinstance(got, tuple) else (got,)
    halves = [h if isinstance(h, tuple) else (h,) for h in halves]
    assert sharded.dispatches == 1
    for i, out in enumerate(got):
        assert torch.equal(out, torch.cat([halves[0][i], halves[1][i]])), i


def test_shard_detect_refuses_an_indivisible_batch(port_detector,
                                                   jax_detector):
    x = frames(320, 240, 8)
    with pytest.raises(ValueError, match="not divisible") as got:
        shard_detect(port_detector, make_mesh(8, device="cpu"))(x[:6])
    with pytest.raises(ValueError) as want:
        jdp.shard_detect(jax_detector, jmesh.make_mesh(8))(x[:6])
    assert str(got.value) == str(want.value)
    out = shard_detect(port_detector, make_mesh(8, device="cpu"))(x)
    assert [t.shape[0] for t in out] == [8, 8, 8]


def test_pad_keeps_arrays_where_they_are(port_sharded):
    """A tensor pads where it lies (on a card: no trip through the host);
    an array stays an array; the fill is the caller's."""
    t = torch.zeros((5, 4, 6, 3), dtype=torch.uint8)
    padded = port_sharded._pad(t, 5)
    assert isinstance(padded, torch.Tensor) and padded.device == t.device
    assert padded.shape[0] == 8 and padded.dtype == torch.uint8
    q = np.full((3, 3, 64), 7, np.int32)
    padded = port_sharded._pad(q, 3, fill=1)
    assert isinstance(padded, np.ndarray) and padded.shape[0] == 8
    assert (padded[3:] == 1).all() and (padded[:3] == 7).all()
    same = torch.zeros((16, 2))
    assert port_sharded._pad(same, 16) is same


# -- TiledDetector's mesh modes ----------------------------------------------


@pytest.mark.parametrize("batch_sharded_out, b, n", [
    (False, 1, 8), (False, 2, 8), (True, 2, 2)])
def test_tiled_mesh_modes_match_jax(port_detector, jax_detector,
                                    batch_sharded_out, b, n):
    """JAX's test_tiled_detection_single_vs_mesh, both modes, against the
    port's, over ``n`` entries (JAX's batch-sharded mode needs a batch
    that fills its mesh); one 16:9 frame (the 1080p shape at a small size)
    spreads its four tiles over the replicas in the default mode."""
    x = frames(480, 270, b)
    got = TiledDetector(port_detector, (480, 270), grid=(2, 2),
                        mesh=make_mesh(n, device="cpu"),
                        batch_sharded_out=batch_sharded_out)
    want = jtiling.TiledDetector(jax_detector, (480, 270), grid=(2, 2),
                                 mesh=jmesh.make_mesh(n),
                                 batch_sharded_out=batch_sharded_out)
    packed = got.run_device(x, pack_output=True).numpy()
    assert_detections_match(packed, np.asarray(
        want.run_device(x, pack_output=True)))
    assert packed[..., 5].sum() >= 4 * b
    boxes, confs, counts = got.run_device(x)
    np.testing.assert_array_equal(counts.numpy(), packed[..., 5].sum(-1))
    # the single-device tiled program on the same frames
    single = TiledDetector(port_detector, (480, 270), grid=(2, 2))
    assert_detections_match(packed, single.run_device(
        x, pack_output=True).numpy())


@pytest.mark.parametrize("batch_sharded_out", [False, True])
def test_tiled_mesh_ycbcr_matches_jax(port_detector, jax_detector,
                                      batch_sharded_out):
    datas = [codec.encode_rgb(f, 92) for f in frames(480, 270, 2)]
    packed, geom = native_jpeg.load().decode_ycbcr_batch(datas)
    got = TiledDetector(port_detector, (480, 270),
                        mesh=make_mesh(2, device="cpu"),
                        batch_sharded_out=batch_sharded_out)
    want = jtiling.TiledDetector(jax_detector, (480, 270),
                                 mesh=jmesh.make_mesh(2),
                                 batch_sharded_out=batch_sharded_out)
    out = got.run_device_ycbcr_packed(packed, geom, pack_output=True).numpy()
    assert_detections_match(out, np.asarray(want.run_device_ycbcr_packed(
        packed, geom, pack_output=True)))
    if batch_sharded_out:
        # per-row uploads are a one-device route (the JAX message)
        with pytest.raises(ValueError, match="single-host"):
            got.run_device_ycbcr_rows(list(packed), geom, pack_output=True)
    else:
        np.testing.assert_array_equal(got.run_device_ycbcr_rows(
            list(packed), geom, pack_output=True).numpy(), out)


def test_tiled_mesh_reuses_the_sharded_replicas(port_sharded):
    mesh = port_sharded.mesh
    assert TiledDetector(port_sharded, (480, 270),
                         mesh=mesh)._runner is port_sharded
    other = TiledDetector(port_sharded, (480, 270), mesh=list(mesh))
    assert other._runner is not port_sharded
    assert isinstance(other._runner, ShardedDetector)
    before = port_sharded.dispatches
    TiledDetector(port_sharded, (480, 270), mesh=mesh).run_device(
        frames(480, 270, 1), pack_output=True)
    assert port_sharded.dispatches == before + 1  # the tiles' one dispatch


# -- multihost ---------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "coord.example:1234,num_processes=4,process_id=2",
    "127.0.0.1:9,num_processes=1,process_id=0",
    " h:1 , process_id=3 , num_processes=5 ,",
    "noport,num_processes=1,process_id=0",
    "h:1,process_id=0",
    "h:1,num_processes=2",
    "h:1,num_processes=2,process_id",
    "h:1,num_processes=x,process_id=0",
    "",
    " , ",
])
def test_parse_distributed_spec_equals_jax(spec):
    def run(parse):
        try:
            s = parse(spec)
            return ("ok", s.coordinator, s.num_processes, s.process_id)
        except ValueError as e:
            return ("error", str(e))

    assert run(multihost.parse_distributed_spec) == run(
        jmultihost.parse_distributed_spec)


def test_process_index_and_count_without_a_group():
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# one member of the dry run: join the group, run this process's frame
# through its local ShardedDetector, gather the packed rows over the group
DRYRUN = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from infercam_onnx_tpu_torch.config import DetectorConfig
from infercam_onnx_tpu_torch.detector import Detector
from infercam_onnx_tpu_torch.parallel import ShardedDetector, make_mesh
from infercam_onnx_tpu_torch.parallel.multihost import (
    initialize, process_count, process_index)

port, pid, weights, frames = sys.argv[1:5]
initialize(f"127.0.0.1:{port},num_processes=2,process_id={pid}")
assert (process_index(), process_count()) == (int(pid), 2)
det = Detector(DetectorConfig(compute_dtype="float32"), weights=weights,
               device="cpu")
sharded = ShardedDetector(det, make_mesh(1, device="cpu"))
mine = np.load(frames)[process_index()::process_count()]
local = sharded.run_device(mine, pack_output=True)
parts = [torch.empty_like(local) for _ in range(process_count())]
dist.all_gather(parts, local)
dist.destroy_process_group()
print("DRYRUN " + json.dumps(torch.cat(parts).tolist()), flush=True)
"""


def test_two_process_gloo_dry_run(port_detector, tmp_path):
    x = frames(320, 240, 2)
    np.save(tmp_path / "frames.npy", x)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", DRYRUN, str(port), str(pid), str(WEIGHTS),
         str(tmp_path / "frames.npy")], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = [np.array(json.loads(o.split("DRYRUN ", 1)[1])) for o in outs]
    np.testing.assert_array_equal(got[0], got[1])  # both gathered the same
    want = port_detector.run_device(x, pack_output=True).numpy()
    assert_detections_match(got[0].astype(np.float32), want)
    assert want[..., 5].sum() >= 2


# -- the serving worker on a mesh --------------------------------------------


def test_bucket_size_rounds_to_the_mesh_multiple(port_detector,
                                                 jax_detector):
    from infercam_onnx_tpu.config import EngineConfig as JEngineConfig
    from infercam_onnx_tpu.serving.inferer import (InferenceWorker as
                                                   JInferenceWorker)
    from infercam_onnx_tpu_torch.config import EngineConfig
    from infercam_onnx_tpu_torch.serving.inferer import InferenceWorker

    buckets = (1, 2, 4, 16)
    worker = InferenceWorker(port_detector,
                             EngineConfig(batch_buckets=buckets),
                             mesh=make_mesh(8, device="cpu"))
    jworker = JInferenceWorker(jax_detector,
                               JEngineConfig(batch_buckets=buckets),
                               mesh=jmesh.make_mesh(8))
    got = [worker._bucket_size(n) for n in range(1, 17)]
    assert got == [jworker._bucket_size(n) for n in range(1, 17)]
    assert [worker._bucket_size(n) for n in (1, 3, 5, 16)] == [8, 8, 16, 16]
    assert isinstance(worker._detector, ShardedDetector)
    worker.close()
    jworker._decode_exec.shutdown()


def test_data_parallel_serving_on_a_mesh(port_detector, jax_detector):
    """JAX's test_data_parallel_serving_on_mesh on a 2-entry CPU mesh: the
    worker adopts the sharded detector as it is, two streams' frames go
    through the sharded programs, and every published record equals JAX
    detect_batch on its frame within C.3's tolerances."""
    from infercam_onnx_tpu_torch.client.sender import send_stream
    from infercam_onnx_tpu_torch.config import (ClientConfig, EngineConfig,
                                                ServerConfig)
    from infercam_onnx_tpu_torch.serving.app import start_server
    from tests.test_torch_port_serving import (_GatedSource, _subscribed,
                                               _until, _Viewer)

    datas = [p.read_bytes() for p in sorted(SYNTH_PICS.glob("*.jpg"))]
    want = jax_detector.detect_batch(np.stack([codec.decode_rgb(d)
                                               for d in datas]))
    mesh = make_mesh(2, device="cpu")
    sharded = ShardedDetector(port_detector, mesh)
    names = ["m0", "m1"]

    async def run():
        server = await start_server(
            ServerConfig(http_address="127.0.0.1:0",
                         socket_address="127.0.0.1:0"),
            engine_config=EngineConfig(batch_buckets=(1, 2, 4),
                                       batch_window_ms=20.0,
                                       annotate_mode="host",
                                       link_adaptive=False),
            detector=sharded, mesh=mesh, device="cpu")
        assert server.worker._detector is sharded
        try:
            port = server.http_port
            views = {n: await _Viewer.open(port, f"/detections?name={n}")
                     for n in names}
            faces = await _Viewer.open(port, "/face_stream?name=m0")
            await _until(lambda: all(_subscribed(server, n, "detections")
                                     for n in names)
                         and _subscribed(server, "m0"), desc="viewers")
            address = ClientConfig(address=f"127.0.0.1:{server.socket_port}")

            def source(n):
                # one frame at a time per stream, so record i answers
                # frame i
                return _GatedSource(datas, lambda i: len(
                    views[n].records()) >= i)

            await asyncio.gather(*(send_stream(
                source(n), ClientConfig(address=address.address,
                                        channel=n)) for n in names))
            for n in names:
                await views[n].wait(lambda v: len(v.records()) == len(datas))
            await faces.wait(lambda v: len(v.parts()) >= 1)
            records = {n: views[n].records() for n in names}
            for v in (*views.values(), faces):
                await v.close()
            return records
        finally:
            await server.close()

    records = asyncio.run(run())
    assert sharded.dispatches >= 1
    for n in names:
        for rec, wdets in zip(records[n], want):
            assert len(rec["detections"]) == len(wdets)
            if wdets:
                np.testing.assert_allclose(
                    [d["bbox"] for d in rec["detections"]],
                    [b for b, _ in wdets], rtol=0, atol=1e-5)
                np.testing.assert_allclose(
                    [d["confidence"] for d in rec["detections"]],
                    [c for _, c in wdets], rtol=0, atol=5e-5)
