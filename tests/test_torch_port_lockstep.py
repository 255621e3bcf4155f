"""The port's lockstep dispatch (``parallel/lockstep.py``) against the JAX
package's, on the CPU, and the serving tier's lockstep wiring.

- `merge_proposals`: equal to the JAX package's on the cases of
  ``tests/test_lockstep.py`` and on random proposals (hypothesis).
- `LockstepDetector` in a one-process session (``n_processes=1``, a round
  trip to a coordinator in the same process) over 8 entries of the CPU:
  every unit kind bit-identical to the port's `ShardedDetector` (or
  batch-sharded `TiledDetector`) over the same entries, and within
  ROADMAP C.3's tolerances (counts equal, boxes 1e-5, confidences 5e-5)
  of the plain detector and of the JAX package's `LockstepDetector` on its
  8-device virtual mesh (frozen weights, float32).
- Two member processes in a gloo group with the coordinator in member 0:
  member 0 has frames, member 1 none; both dispatch the round, and member
  0's rows match the plain detector.
- The server: a session's end is terminal, an RSS breach of a member exits
  with code 17, /stats shows the member's counts. The deployment tests
  (two serve processes, and the launcher's supervised restart) are slow.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from infercam_onnx_tpu.parallel import lockstep as jlockstep
from infercam_onnx_tpu.parallel import mesh as jmesh
from infercam_onnx_tpu_torch import codec
from infercam_onnx_tpu_torch.config import (DetectorConfig, EngineConfig,
                                            ServerConfig)
from infercam_onnx_tpu_torch.detector import Detector
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
from infercam_onnx_tpu_torch.ops.jpeg_device import read_coefficient_batch
from infercam_onnx_tpu_torch.parallel import (ShardedDetector, TiledDetector,
                                              make_mesh)
from infercam_onnx_tpu_torch.parallel.lockstep import (LockstepDetector,
                                                       LockstepSessionEnded,
                                                       merge_proposals)
from infercam_onnx_tpu_torch.serving import app as tapp
from infercam_onnx_tpu_torch.serving.broadcast import Broadcast
from infercam_onnx_tpu_torch.serving.router import InferJob

from tests.test_goldens_fixtures import WEIGHTS
from tests.test_torch_port_annotate import assert_detections_match
from tests.test_torch_port_parallel import (REPO, frames, free_port, jpegs)

CONFIG = DetectorConfig(compute_dtype="float32")


# -- merge_proposals ---------------------------------------------------------

A = [{"kind": "pixels", "h": 48, "w": 64, "pack": True, "n": 3}]
B = [{"kind": "pixels", "h": 48, "w": 64, "pack": True, "n": 5},
     {"kind": "pixels", "h": 24, "w": 32, "pack": True, "n": 1}]
DUP = [{"kind": "pixels", "h": 48, "w": 64, "pack": True, "n": 3},
       {"kind": "pixels", "h": 48, "w": 64, "pack": True, "n": 2}]


@pytest.mark.parametrize("proposals, ladder, granularity, rows", [
    ([A, B], (1, 2, 4, 8), 4, [4, 8]),  # union and buckets
    ([B, A], (1, 2, 4, 8), 4, [4, 8]),  # order does not matter
    ([[], []], (1, 2), 1, []),  # nothing proposed, nothing decided
    ([DUP], (1, 2, 4, 8), 1, [8]),  # one host's units of a geometry sum
    ([DUP, [dict(DUP[0], n=2)]], (1, 2, 4, 8), 1, [8]),  # max of sums
    ([[{"kind": "pixels", "h": 8, "w": 8, "pack": True, "n": 40}]],
     (1, 2, 4, 8, 16), 2, [16]),  # clamped to the ladder top
])
def test_merge_proposals_equals_jax(proposals, ladder, granularity, rows):
    got = merge_proposals(proposals, ladder, granularity)
    assert got == jlockstep.merge_proposals(proposals, ladder, granularity)
    assert [d["rows"] for d in got] == rows


_UNITS = st.lists(st.fixed_dictionaries({
    "kind": st.sampled_from(["pixels", "ycbcr", "coef"]),
    "h": st.sampled_from([24, 48]), "pack": st.booleans(),
    "n": st.integers(1, 40)}), max_size=5)


@settings(max_examples=60, deadline=None)
@given(proposals=st.lists(_UNITS, min_size=1, max_size=4),
       ladder=st.lists(st.integers(1, 32), min_size=1, max_size=5,
                       unique=True).map(sorted).map(tuple),
       granularity=st.integers(1, 8))
def test_merge_proposals_property(proposals, ladder, granularity):
    got = merge_proposals(proposals, ladder, granularity)
    assert got == jlockstep.merge_proposals(proposals, ladder, granularity)
    keys = [jlockstep._desc_key({k: v for k, v in d.items() if k != "rows"})
            for d in got]
    assert keys == sorted(set(keys))  # one decision a geometry, sorted
    for d in got:
        assert d["rows"] % granularity == 0


# -- one-process sessions ----------------------------------------------------


@pytest.fixture(scope="module")
def detector():
    return Detector(CONFIG, weights=str(WEIGHTS), device="cpu")


@pytest.fixture(scope="module")
def sharded(detector):
    return ShardedDetector(detector, make_mesh(8, device="cpu"))


def lockstep(detector, **kw) -> LockstepDetector:
    kw.setdefault("ladder", (1, 2, 4, 8, 16))
    return LockstepDetector(detector, make_mesh(8, device="cpu"),
                            f"127.0.0.1:{free_port()}", coordinator=True,
                            n_processes=1, tick_ms=5.0, **kw)


@pytest.fixture(scope="module")
def lock(detector):
    lock = lockstep(detector)
    yield lock
    lock.close()


def _equal(got, want) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pixels_units_match_the_plain_detector(detector, sharded, lock):
    x = frames(320, 240, 3)
    got = lock.run_device(x, pack_output=True)
    assert got.shape == (3, 64, 6)  # this member's rows, sliced back
    _equal(got, sharded.run_device(x, pack_output=True))
    assert_detections_match(got.numpy(), detector.run_device(
        x, pack_output=True).numpy())
    _equal(lock.run_device(x[:2]), sharded.run_device(x[:2]))


def test_units_match_jax_lockstep(lock):
    """The JAX package's LockstepDetector on its 8-device virtual mesh,
    pixels and ycbcr units, within C.3's tolerances."""
    from infercam_onnx_tpu.config import DetectorConfig as JDetectorConfig
    from infercam_onnx_tpu.detector import Detector as JDetector
    from infercam_onnx_tpu.models import convert as jconvert

    params = jconvert.params_from_state_dict(dict(np.load(WEIGHTS)))
    jdet = JDetector(JDetectorConfig(compute_dtype="float32"), params=params)
    jlock = jlockstep.LockstepDetector(
        jdet, jmesh.make_mesh(8), f"127.0.0.1:{free_port()}",
        coordinator=True, n_processes=1, tick_ms=5.0)
    try:
        x = frames(320, 240, 3)
        assert_detections_match(
            lock.run_device(x, pack_output=True).numpy(),
            np.asarray(jlock.run_device(x, pack_output=True)))
        packed, geom = native_jpeg.load().decode_ycbcr_batch(jpegs(2))
        got = lock.run_device_ycbcr_packed(packed, geom, pack_output=True)
        assert_detections_match(got.numpy(), np.asarray(
            jlock.run_device_ycbcr_packed(packed, geom, pack_output=True)))
        assert got[..., 5].sum() >= 2
    finally:
        jlock.close()


def test_ycbcr_and_coefficient_units(detector, sharded, lock):
    packed, geom = native_jpeg.load().decode_ycbcr_batch(jpegs(2))
    got = lock.run_device_ycbcr_packed(packed, geom, pack_output=True)
    _equal(got, sharded.run_device_ycbcr_packed(packed, geom,
                                                pack_output=True))
    assert_detections_match(got.numpy(), detector.run_device_ycbcr_packed(
        packed, geom, pack_output=True).numpy())
    y, cb, cr, q, wh, samp = read_coefficient_batch(jpegs(3))
    got = lock.run_device_coefficients_arrays(y, cb, cr, q, wh,
                                              sampling=samp,
                                              pack_output=True)
    _equal(got, sharded.run_device_coefficients_arrays(
        y, cb, cr, q, wh, sampling=samp, pack_output=True))
    assert_detections_match(got.numpy(), detector.run_device_coefficients_arrays(
        y, cb, cr, q, wh, sampling=samp, pack_output=True).numpy())


def test_annotated_and_splice_units(sharded, lock):
    packed, geom = native_jpeg.load().decode_ycbcr_batch(jpegs(2))
    _equal(lock.run_device_ycbcr_annotated(packed, geom),
           sharded.run_device_ycbcr_annotated(packed, geom))
    x = frames(320, 240, 2)
    _equal(lock.run_device_annotated(x), sharded.run_device_annotated(x))
    y, cb, cr, q, wh, samp = read_coefficient_batch(jpegs(2))
    _equal(lock.run_device_coefficients_annotated(y, cb, cr, q, wh,
                                                  sampling=samp, k=256),
           sharded.run_device_coefficients_annotated(y, cb, cr, q, wh,
                                                     sampling=samp, k=256))


def test_tiled_units(detector, lock):
    x = frames(480, 270, 2)
    want = TiledDetector(detector, (480, 270), mesh=lock.mesh,
                         batch_sharded_out=True)
    got = lock.run_device_tiled(x, (480, 270), grid=(2, 2))
    _equal(got, want.run_device(x, pack_output=True))
    assert_detections_match(got.numpy(), TiledDetector(
        detector, (480, 270)).run_device(x, pack_output=True).numpy())
    packed, geom = native_jpeg.load().decode_ycbcr_batch(
        [codec.encode_rgb(f, 92) for f in x])
    _equal(lock.run_device_tiled_ycbcr(packed, geom, grid=(2, 2)),
           want.run_device_ycbcr_packed(packed, geom, pack_output=True))


def test_concurrent_same_geometry_units(sharded, lock):
    x = [frames(320, 240, 4)[i:i + 2] for i in (0, 2)]
    results = [None, None]

    def run(i):
        results[i] = lock.run_device(x[i], pack_output=True)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for i in range(2):
        assert_detections_match(results[i].numpy(), sharded.run_device(
            x[i], pack_output=True).numpy())


def test_oversized_batch_refused(sharded, lock):
    big = np.zeros((17, 240, 320, 3), np.uint8)
    with pytest.raises(ValueError, match="ladder top"):
        lock.run_device(big, pack_output=True)
    # the session survives
    x = frames(320, 240, 2)
    _equal(lock.run_device(x, pack_output=True),
           sharded.run_device(x, pack_output=True))


def test_capacity_rounds_to_the_granularity(detector, sharded):
    lock = lockstep(detector, ladder=(1, 2))
    try:
        x = frames(320, 240, 5)
        _equal(lock.run_device(x, pack_output=True),
               sharded.run_device(x, pack_output=True))
        with pytest.raises(ValueError, match="capacity"):
            lock.run_device(np.zeros((9, 240, 320, 3), np.uint8),
                            pack_output=True)
    finally:
        lock.close()


def test_execute_failure_ends_the_session(detector):
    lock = lockstep(detector)
    try:
        def boom(desc, rows, matches):
            raise ValueError("injected execute failure")

        lock._execute = boom
        with pytest.raises(ValueError, match="injected"):
            lock.run_device(np.zeros((1, 48, 64, 3), np.uint8),
                            pack_output=True)
        deadline = time.time() + 10
        while not lock.session_ended and time.time() < deadline:
            time.sleep(0.05)
        assert lock.session_ended
        with pytest.raises(LockstepSessionEnded, match="ended"):
            lock.run_device(np.zeros((1, 48, 64, 3), np.uint8),
                            pack_output=True)
    finally:
        lock.close()


def test_closed_session_raises(detector):
    lock = lockstep(detector)
    lock.close()
    with pytest.raises(LockstepSessionEnded, match="ended"):
        lock.run_device(np.zeros((1, 48, 64, 3), np.uint8),
                        pack_output=True)


# -- the server ----------------------------------------------------------------


def _server_config(**kw) -> ServerConfig:
    return ServerConfig(http_address="127.0.0.1:0",
                        socket_address="127.0.0.1:0", **kw)


def test_session_end_is_terminal_for_the_server(detector):
    lock = lockstep(detector)
    jpeg = codec.encode_rgb(np.zeros((48, 64, 3), np.uint8))

    async def run():
        server = await tapp.start_server(
            _server_config(),
            engine_config=EngineConfig(batch_buckets=(1, 8),
                                       batch_window_ms=5.0,
                                       annotate_mode="host",
                                       link_adaptive=False),
            detector=lock, data_parallel="off", device="cpu")
        try:
            lock.close()  # the cluster session dies under the worker
            assert server.worker.submit(InferJob(1, jpeg, Broadcast(4)))
            inferer = next(t for t in server.tasks
                           if t.get_name() == "inferer")
            with pytest.raises(LockstepSessionEnded):
                await asyncio.wait_for(inferer, 30)
        finally:
            await server.close()

    asyncio.run(run())


def test_rss_breach_of_a_member_exits_for_the_supervisor(detector,
                                                         monkeypatch):
    """A lockstep member cannot re-exec into its session: a breach exits
    with RSS_RECYCLE_EXIT_CODE; a server on its own re-execs."""
    calls: list[str] = []
    monkeypatch.setattr(tapp, "_reexec", lambda: calls.append("reexec"))
    monkeypatch.setattr(tapp, "_exit_for_supervisor",
                        lambda: calls.append("exit"))

    async def run():
        server = await tapp.start_server(
            _server_config(max_rss_mb=1, rss_check_period_s=0.01),
            engine_config=EngineConfig(batch_buckets=(1,),
                                       annotate_mode="host",
                                       link_adaptive=False),
            detector=detector, data_parallel="off", device="cpu")
        try:
            await asyncio.sleep(0.5)  # the real RSS is far above 1 MiB
        finally:
            await server.close()

    detector.session_ended = False  # what marks a lockstep member
    try:
        asyncio.run(run())
    finally:
        del detector.session_ended
    assert calls == ["exit"]
    calls.clear()
    asyncio.run(run())
    assert calls == ["reexec"]
    assert tapp.RSS_RECYCLE_EXIT_CODE == 17


def test_exit_for_supervisor_exits_17():
    proc = subprocess.run(
        [sys.executable, "-c", "from infercam_onnx_tpu_torch.serving import "
         "app; app._exit_for_supervisor()"], cwd=REPO, timeout=120)
    assert proc.returncode == 17


def test_lockstep_without_a_mesh_is_refused(detector):
    async def run():
        await tapp.start_server(_server_config(), detector=detector,
                                data_parallel="off", device="cpu",
                                lockstep_address="127.0.0.1:1")

    with pytest.raises(ValueError, match="requires a mesh"):
        asyncio.run(run())


def test_stats_show_a_members_counts(detector):
    """A one-member cluster (the coordinator in this process) started
    through start_server: /stats topology and lockstep counts."""
    from tests.test_torch_port_serving import _Viewer

    async def run():
        server = await tapp.start_server(
            _server_config(),
            engine_config=EngineConfig(batch_buckets=(1, 2),
                                       annotate_mode="host",
                                       link_adaptive=False),
            detector=detector, mesh=make_mesh(2, device="cpu"),
            device="cpu", lockstep_address=f"127.0.0.1:{free_port()}",
            warmup_resolutions=[(240, 320)])
        try:
            body = await (await _Viewer.open(server.http_port,
                                             "/stats")).finish()
        finally:
            await server.close()
        return json.loads(body.split(b"\r\n\r\n", 1)[1]), server

    stats, server = asyncio.run(run())
    assert stats["topology"] == {
        "devices": 2, "processes": 1, "lockstep": True, "platform": "cpu",
        "device": "cpu", "detector": "LockstepDetector"}
    counts = stats["lockstep"]
    assert counts["process"] == 0 and counts["processes"] == 1
    # the warm-up's rounds: buckets 1 and 2, each padded to the 2 replicas
    assert counts["dispatches"] == 2 and counts["rounds"] >= 2
    assert counts["session_ended"] is False
    assert server.worker._detector.session_ended  # close() left it


# -- two member processes ------------------------------------------------------

# one member of a two-process cluster: member 0 runs the coordinator and
# submits frames, member 1 submits nothing but takes part in the round
MEMBER = """
import json, sys, time
import numpy as np, torch.distributed as dist
from infercam_onnx_tpu_torch.config import DetectorConfig
from infercam_onnx_tpu_torch.detector import Detector
from infercam_onnx_tpu_torch.parallel import make_mesh
from infercam_onnx_tpu_torch.parallel.lockstep import LockstepDetector
from infercam_onnx_tpu_torch.parallel.multihost import (
    initialize, process_count, process_index)

port, pid, lock_port, weights, frames = sys.argv[1:6]
initialize(f"127.0.0.1:{port},num_processes=2,process_id={pid}")
det = Detector(DetectorConfig(compute_dtype="float32"), weights=weights,
               device="cpu")
lock = LockstepDetector(det, make_mesh(1, device="cpu"),
                        f"127.0.0.1:{lock_port}",
                        coordinator=process_index() == 0,
                        n_processes=process_count(), ladder=(1, 2, 4),
                        tick_ms=5.0)
out = None
deadline = time.time() + 90
if process_index() == 0:
    out = lock.run_device(np.load(frames), pack_output=True).tolist()
    dispatches = lock.dispatches
    lock.close()
else:
    while not lock.session_ended and time.time() < deadline:
        time.sleep(0.01)
    dispatches = lock.dispatches
dist.destroy_process_group()
print("MEMBER " + json.dumps({"dispatches": dispatches,
                              "ended": lock.session_ended, "out": out}),
      flush=True)
"""


def test_two_member_processes_dispatch_together(detector, tmp_path):
    x = frames(320, 240, 3)
    np.save(tmp_path / "frames.npy", x)
    port, lock_port = free_port(), free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MEMBER, str(port), str(pid), str(lock_port),
         str(WEIGHTS), str(tmp_path / "frames.npy")], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            assert p.returncode == 0, out
            outs.append(json.loads(out.split("MEMBER ", 1)[1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    # member 1 had no frames, but ran the round's padding
    assert [o["dispatches"] for o in outs] == [1, 1]
    assert outs[1]["ended"] and outs[1]["out"] is None
    got = np.array(outs[0]["out"], np.float32)
    assert_detections_match(got, detector.run_device(
        x, pack_output=True).numpy())


# -- deployments (slow) ----------------------------------------------------------


def _wait_http(port: int, timeout: float = 180.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), 1):
                return True
        except OSError:
            time.sleep(0.5)
    return False


def _http_get(port: int, path: str, timeout: float = 20.0,
              stop_after_frames: int = 0) -> bytes:
    """A bounded read: a publishing MJPEG stream never closes."""
    s = socket.create_connection(("127.0.0.1", port), timeout)
    s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n"
              "Connection: close\r\n\r\n".encode())
    s.settimeout(2.0)
    data = b""
    deadline = time.time() + timeout
    try:
        while time.time() < deadline:
            if stop_after_frames and data.count(b"--frame") >= \
                    stop_after_frames:
                break
            try:
                chunk = s.recv(4096)
            except socket.timeout:
                continue
            if not chunk:
                break
            data += chunk
    finally:
        s.close()
    return data


def _face_parts(port: int, name: str, timeout: float) -> int:
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            got = _http_get(port, f"/face_stream?name={name}", timeout=15.0,
                            stop_after_frames=1)
        except OSError:  # between incarnations
            time.sleep(1.0)
            continue
        if got.count(b"--frame\r\nContent-Type"):
            return True
    return False


def _sender(port: int, channel: str, pics) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "infercam_onnx_tpu_torch.client.sender",
         "--address", f"127.0.0.1:{port}", "--channel", channel,
         "--replay-dir", str(pics), "--fps", "10"], cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _stop(procs: list, sig=signal.SIGTERM) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(sig)
    for p in procs:
        try:
            p.wait(30)
        except subprocess.TimeoutExpired:
            p.kill()


@pytest.mark.slow
def test_two_host_lockstep_deployment(tmp_path):
    """Two serve processes in one gloo group, lockstep dispatch, each with
    its own streams at another resolution (so every round unites two
    geometries, each member padding the other's unit); each serves its
    own annotated stream. Killing one ends the other with a non-zero
    status."""
    rng = np.random.default_rng(5)
    dirs = [tmp_path / "host0", tmp_path / "host1"]
    for d, size in zip(dirs, [(48, 64, 3), (32, 48, 3)]):
        d.mkdir()
        (d / "f.jpg").write_bytes(codec.encode_rgb(
            rng.integers(0, 256, size=size, dtype=np.uint8)))
    http = [free_port(), free_port()]
    sock = [free_port(), free_port()]
    coord, lock_port = free_port(), free_port()
    logs = [open(tmp_path / f"server{i}.log", "wb") for i in range(2)]
    servers = [subprocess.Popen(
        [sys.executable, "-m", "infercam_onnx_tpu_torch.serve",
         "--device", "cpu", "--server-address", f"127.0.0.1:{http[pid]}",
         "--socket-address", f"127.0.0.1:{sock[pid]}", "--distributed",
         f"127.0.0.1:{coord},num_processes=2,process_id={pid}",
         "--lockstep-address", f"127.0.0.1:{lock_port}",
         "--data-parallel", "on", "--max-batch", "2",
         "--batch-window-ms", "20", "--annotate", "host"],
        cwd=REPO, stdout=logs[pid], stderr=logs[pid]) for pid in range(2)]
    senders = []
    try:
        for pid in range(2):
            assert _wait_http(http[pid]), f"host {pid} never opened HTTP"
        senders = [_sender(sock[pid], f"cam{pid}", dirs[pid])
                   for pid in range(2)]
        for pid in range(2):
            assert _face_parts(http[pid], f"cam{pid}", 240), pid
        servers[1].kill()
        deadline = time.time() + 60
        while servers[0].poll() is None and time.time() < deadline:
            time.sleep(0.5)
        assert servers[0].returncode not in (None, 0)
    finally:
        _stop(senders, signal.SIGINT)
        _stop(servers)
        for f in logs:
            f.close()


@pytest.mark.slow
def test_supervised_cluster_restart_streams_resume(tmp_path):
    """Kill one member: cluster_launch re-forms the whole cluster as a new
    incarnation, the senders reconnect and the streams resume."""
    pics = tmp_path / "frames"
    pics.mkdir()
    (pics / "f.jpg").write_bytes(codec.encode_rgb(
        np.random.default_rng(9).integers(0, 256, size=(48, 64, 3),
                                          dtype=np.uint8)))
    while True:  # a base whose four serve ports are all free
        base = free_port()
        try:
            for port in (base + 1, base + 10, base + 11):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", port))
            break
        except OSError:
            continue
    state = tmp_path / "state.json"
    log = open(tmp_path / "supervisor.log", "wb")
    sup = subprocess.Popen(
        [sys.executable, "-m", "infercam_onnx_tpu_torch.cluster_launch",
         "--hosts", "2", "--device", "cpu", "--http-base", str(base),
         "--coordinator-port", str(free_port()),
         "--lockstep-port", str(free_port()), "--state-file", str(state),
         "--max-restarts", "2", "--", "--max-batch", "2",
         "--batch-window-ms", "20", "--annotate", "host"],
        cwd=REPO, stdout=log, stderr=log)

    def incarnation(n, timeout):
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                st = json.loads(state.read_text())
                if st["incarnation"] >= n:
                    return st
            except (OSError, json.JSONDecodeError):
                pass
            time.sleep(0.5)
        return None

    senders = []
    try:
        st = incarnation(1, 60)
        assert st, "no state file"
        assert all(_wait_http(base + 10 * pid) for pid in range(2))
        senders = [_sender(base + 10 * pid + 1, f"cam{pid}", pics)
                   for pid in range(2)]
        assert _face_parts(base, "cam0", 240), "no frames before the kill"
        os.kill(st["pids"][1], signal.SIGKILL)
        st2 = incarnation(2, 180)
        assert st2 and st2["pids"] != st["pids"]
        assert _face_parts(base, "cam0", 240), "streams did not resume"
        assert sup.poll() is None
    finally:
        _stop(senders, signal.SIGINT)
        _stop([sup])
        log.close()
