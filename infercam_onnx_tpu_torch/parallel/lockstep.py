"""Lockstep dispatch: one serving cluster of several processes (the port of
``infercam_onnx_tpu/parallel/lockstep.py``).

Every member of a cluster runs the same programs in the same order, a
round at a time, so that no member's micro-batcher runs ahead of the
others. The protocol is the JAX package's, unchanged:

- a small TCP **coordinator** (in process 0) runs dispatch rounds: each
  round it collects every member's proposal (the batch units its
  micro-batcher wants to run, possibly none), merges them into one agreed
  ordered list of (program, rows) decisions (`merge_proposals`) and
  broadcasts it;
- a **pump thread** in every member executes the decisions in order:
  members with frames for a unit contribute their rows, members without
  contribute padding rows, and every member runs the unit's program.

What changes is the data path. JAX assembles a global array over the
process-spanning mesh, of which each host feeds its addressable shard.
Here each member pads its own rows to the decided count and runs them on
its own `ShardedDetector` (its local replicas), and splits its own result
back per unit: no frame leaves the member's host. A member with no rows in
a round still runs its padding, so that every member runs the same
programs in the same order; ``batch_granularity`` is the member's replica
count, which the ``hello`` message carries.

Single-process sessions work too (``n_processes=1``: a round trip to a
coordinator in the same process), which is how the unit tests drive it.
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import threading
import time

import numpy as np
import torch

from infercam_onnx_tpu_torch.detector import as_tensor
from infercam_onnx_tpu_torch.parallel.data_parallel import ShardedDetector
from infercam_onnx_tpu_torch.parallel.multihost import process_index
from infercam_onnx_tpu_torch.parallel.tiling import TiledDetector

log = logging.getLogger("infercam.lockstep")

_IO_TIMEOUT_S = 600.0  # must outlast the slowest member's warm-up


class LockstepSessionEnded(RuntimeError):
    """The cluster-wide lockstep session has ended (a member left, or an
    agreed dispatch failed after its peers ran it). There is no rejoin
    path, so the hosting process must exit and the cluster restart as a
    unit; the serving supervisor treats this as terminal instead of
    restarting the worker into a loop that serves nothing."""


def _desc_key(desc: dict) -> str:
    return json.dumps(desc, sort_keys=True)


def merge_proposals(proposals: list[list[dict]], ladder: tuple[int, ...],
                    granularity: int) -> list[dict]:
    """One decision list from every member's proposals: the union of unit
    descriptors (keyed by kind/geometry/pack), each sized to the ladder
    bucket covering the LARGEST per-member row count (a member's row count
    is the SUM over its units of one descriptor, so one round serves every
    pending unit of a geometry), rounded up to the per-member replica
    granularity. Sorted by key, so every process dispatches identically."""
    want: dict[str, dict] = {}
    for units in proposals:
        per_host: dict[str, int] = {}
        descs: dict[str, dict] = {}
        for unit in units:
            desc = dict(unit)
            n = desc.pop("n")
            key = _desc_key(desc)
            per_host[key] = per_host.get(key, 0) + n
            descs[key] = desc
        for key, n in per_host.items():
            cur = want.setdefault(key, {"desc": descs[key], "n": 0})
            cur["n"] = max(cur["n"], n)
    decisions = []
    for key in sorted(want):
        desc = dict(want[key]["desc"])
        n = want[key]["n"]
        bucket = next((b for b in ladder if b >= n), ladder[-1])
        bucket = ((bucket + granularity - 1) // granularity) * granularity
        desc["rows"] = bucket
        decisions.append(desc)
    return decisions


class _Lines:
    """Newline-delimited JSON over a socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""
        sock.settimeout(_IO_TIMEOUT_S)

    def send(self, msg: dict) -> None:
        self._sock.sendall(json.dumps(msg).encode() + b"\n")

    def recv(self) -> dict:
        while b"\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("lockstep peer closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return json.loads(line)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class _Coordinator(threading.Thread):
    """Round broker in process 0: collect one proposal per member,
    broadcast the merged decision. Any member saying bye (or dying) ends
    the session for everyone."""

    def __init__(self, address: tuple[str, int], n_processes: int,
                 ladder: tuple[int, ...]):
        super().__init__(name="lockstep-coord", daemon=True)
        self._n = n_processes
        self._ladder = ladder
        self._listener = socket.create_server(address, reuse_port=False)
        self._listener.settimeout(_IO_TIMEOUT_S)
        self.rounds = 0  # decisions broadcast (the smoke reads it)

    def run(self) -> None:
        members: dict[int, _Lines] = {}
        granularity = None
        try:
            while len(members) < self._n:
                conn, _ = self._listener.accept()
                lines = _Lines(conn)
                hello = lines.recv()
                assert hello["t"] == "hello", hello
                if granularity is None:
                    granularity = hello["local_devices"]
                elif granularity != hello["local_devices"]:
                    raise ValueError(
                        "lockstep requires equal device counts per host:"
                        f" {granularity} != {hello['local_devices']}")
                members[hello["pid"]] = lines
            log.info("lockstep coordinator: %d member(s) joined", self._n)
            while True:
                proposals = []
                for pid in sorted(members):
                    msg = members[pid].recv()
                    if msg["t"] == "bye":
                        raise ConnectionError(f"member {pid} left")
                    proposals.append(msg["units"])
                decision = merge_proposals(proposals, self._ladder,
                                           granularity)
                for lines in members.values():
                    lines.send({"t": "decision", "units": decision})
                self.rounds += 1
        except (ConnectionError, OSError, ValueError) as e:
            log.info("lockstep coordinator stopping: %s", e)
            for lines in members.values():
                try:
                    lines.send({"t": "bye"})
                except OSError:
                    pass
                lines.close()
        finally:
            self._listener.close()


def _host(a) -> torch.Tensor:
    """A unit's input as a host tensor (`as_tensor`): the member's rows go
    to its own replicas from there."""
    if not isinstance(a, torch.Tensor):
        a = as_tensor(np.asarray(a))
    return a.cpu()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _json_geom(geom: dict) -> dict:
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in geom.items()}


def _plane_len(geom: dict) -> int:
    return geom["y_pw"] * geom["y_ph"] + 2 * geom["c_pw"] * geom["c_ph"]


class LockstepDetector(ShardedDetector):
    """A `ShardedDetector` whose dispatches run in cluster-wide rounds.

    The serving worker calls ``run_device`` / ``run_device_ycbcr_packed``
    / ... from its device thread exactly as on one process; each call
    blocks until the round that includes it has run, and returns its
    rows' outputs on the first device, ordered on the caller's current
    stream. Rounds with no local work still dispatch (padding rows)
    whenever another member has frames; fully idle rounds dispatch
    nothing. ``mesh`` is this member's own devices."""

    def __init__(self, detector, mesh: list, address: str, *,
                 coordinator: bool, n_processes: int,
                 ladder: tuple[int, ...] = (1, 2, 4, 8, 16),
                 tick_ms: float = 20.0):
        super().__init__(detector, mesh)
        host, _, port = address.rpartition(":")
        addr = (host or "127.0.0.1", int(port))
        self._local_devices = self.n
        # worker-side batches need only fill this member's replicas
        self.batch_granularity = max(self._local_devices, 1)
        self._ladder = tuple(sorted(ladder))
        self._tick_s = tick_ms / 1e3
        self._requests: queue.Queue = queue.Queue()
        self._stopped = threading.Event()
        self._n_processes = n_processes
        self._tiled_cache: dict = {}

        if coordinator:
            self._coord = _Coordinator(addr, n_processes, self._ladder)
            self._coord.start()
        else:
            self._coord = None
        deadline = 30.0
        t0 = time.time()
        while True:
            try:
                self._conn = _Lines(socket.create_connection(addr, 5.0))
                break
            except OSError:
                if time.time() - t0 > deadline:
                    raise
                time.sleep(0.2)
        self._conn.send({"t": "hello", "pid": process_index(),
                         "local_devices": self.batch_granularity})
        self._pump = threading.Thread(target=self._pump_loop,
                                      name="lockstep-pump", daemon=True)
        self._pump.start()

    # -- worker-facing API -------------------------------------------------

    def run_device(self, images, *, pack_output: bool = False):
        desc = {"kind": "pixels", "h": int(images.shape[1]),
                "w": int(images.shape[2]), "pack": pack_output}
        return self._submit(desc, int(images.shape[0]),
                            {"images": _host(images)})

    def run_device_ycbcr_packed(self, packed, geom: dict, *,
                                pack_output: bool = False):
        desc = {"kind": "ycbcr", "geom": _json_geom(geom),
                "pack": pack_output}
        return self._submit(desc, int(packed.shape[0]),
                            {"packed": _host(packed)})

    def run_device_ycbcr_annotated(self, packed, geom: dict, *,
                                   quality: int = 95,
                                   disp_dims: tuple | None = None):
        """The annotated program of the ycbcr mode as a lockstep unit:
        every member runs it in the agreed round; coefficient rows and
        detections come back per member."""
        desc = {"kind": "ycbcr_annot", "geom": _json_geom(geom),
                "quality": int(quality),
                "disp": list(disp_dims) if disp_dims else None}
        return self._submit(desc, int(packed.shape[0]),
                            {"packed": _host(packed)})

    def run_device_annotated(self, images, *, quality: int = 95,
                             subsampling: str = "420",
                             disp_dims: tuple | None = None):
        """The annotated program of the pixels mode as a lockstep unit."""
        desc = {"kind": "rgb_annot", "h": int(images.shape[1]),
                "w": int(images.shape[2]), "sub": subsampling,
                "quality": int(quality),
                "disp": list(disp_dims) if disp_dims else None}
        return self._submit(desc, int(images.shape[0]),
                            {"images": _host(images)})

    def run_device_coefficients_annotated_packed(
            self, packed12, quant, *, wh: tuple, shapes: tuple,
            sampling: tuple = (2, 2), k: int = 768,
            disp_dims: tuple | None = None):
        """The splice transcode as a lockstep unit."""
        quant = _host(quant)
        desc = {"kind": "coef_splice", "w": int(wh[0]),
                "h": int(wh[1]), "sampling": list(sampling),
                "y_shape": [int(v) for v in shapes[0]],
                "c_shape": [int(v) for v in shapes[1]],
                "quant_dtype": _dtype_name(quant),
                "k": int(k),
                "disp": list(disp_dims) if disp_dims else None}
        return self._submit(desc, int(packed12.shape[0]),
                            {"packed": _host(packed12), "quant": quant})

    def run_device_tiled(self, images, frame_size: tuple, *,
                         grid: tuple = (2, 2), overlap: float = 0.2):
        """High-resolution tiled detection as a lockstep unit: the agreed
        round runs the tiled program split by image over the member's
        replicas (`TiledDetector` with ``batch_sharded_out``). Returns
        packed [n, D, 6]."""
        w, h = frame_size
        desc = {"kind": "tiled", "w": int(w), "h": int(h),
                "grid": list(grid), "overlap": float(overlap)}
        return self._submit(desc, int(images.shape[0]),
                            {"images": _host(images)})

    def run_device_tiled_ycbcr(self, packed, geom: dict, *,
                               grid: tuple = (2, 2),
                               overlap: float = 0.2):
        """Packed-plane tiled detection as a lockstep unit."""
        desc = {"kind": "tiled_ycbcr", "geom": _json_geom(geom),
                "grid": list(grid), "overlap": float(overlap)}
        return self._submit(desc, int(packed.shape[0]),
                            {"packed": _host(packed)})

    def _tiled_detector(self, frame_size: tuple, grid: tuple,
                        overlap: float) -> TiledDetector:
        key = (tuple(frame_size), tuple(grid), overlap)
        tiled = self._tiled_cache.get(key)
        if tiled is None:
            tiled = self._tiled_cache[key] = TiledDetector(
                self, frame_size, grid=tuple(grid), overlap=overlap,
                mesh=self.mesh, axis=self.axis, batch_sharded_out=True)
        return tiled

    def run_device_coefficients_arrays(self, y, cb, cr, quant, wh, *,
                                       sampling=(2, 2),
                                       pack_output: bool = False):
        y, cb, cr, quant = (_host(a) for a in (y, cb, cr, quant))
        desc = {"kind": "coef", "w": int(wh[0]), "h": int(wh[1]),
                "sampling": list(sampling),
                "y_shape": [int(v) for v in y.shape[1:]],
                "c_shape": [int(v) for v in cb.shape[1:]],
                # dtypes must agree across members, or a padding member
                # would run another program in the same slot
                "dtypes": [_dtype_name(y), _dtype_name(quant)],
                "pack": pack_output}
        return self._submit(desc, int(y.shape[0]),
                            {"y": y, "cb": cb, "cr": cr, "quant": quant})

    @property
    def session_ended(self) -> bool:
        """True once the cluster session is over (a member left or an
        agreed dispatch failed); there is no rejoin path."""
        return self._stopped.is_set()

    def close(self) -> None:
        """Leave the session (ends it for the whole cluster)."""
        if not self._stopped.is_set():
            self._requests.put(None)
            self._pump.join(timeout=10.0)

    # -- pump ---------------------------------------------------------------

    def _submit(self, desc: dict, n: int, data: dict):
        if self._stopped.is_set():
            raise LockstepSessionEnded("lockstep session has ended")
        # merge_proposals clamps decisions to the ladder top and then
        # rounds UP to the per-member granularity (the serving worker's
        # buckets round the same way), so the real dispatch capacity is
        # the granularity-rounded top. A single unit above THAT could
        # never dispatch whole, and the pump's first match would hand an
        # oversized local share to the round, ending the session. Fail
        # the one caller loudly instead.
        g = max(self._local_devices, 1)
        top = -(-self._ladder[-1] // g) * g
        if n > top:
            raise ValueError(
                f"batch of {n} rows exceeds the lockstep dispatch "
                f"capacity {top} (ladder top rounded to the {g}-device "
                f"granularity); split the submission or raise the "
                f"ladder")
        slot: queue.Queue = queue.Queue(1)
        self._requests.put((desc, n, data, slot))
        deadline = _IO_TIMEOUT_S
        while True:
            try:
                out = slot.get(timeout=1.0)
                break
            except queue.Empty:
                deadline -= 1.0
                if self._stopped.is_set():
                    # the pump may have died between our put and its
                    # shutdown drain: don't wait the full timeout
                    try:
                        out = slot.get_nowait()
                        break
                    except queue.Empty:
                        raise LockstepSessionEnded(
                            "lockstep session has ended") from None
                if deadline <= 0:
                    raise TimeoutError("lockstep round timed out")
        if isinstance(out, Exception):
            raise out
        out, ready = out
        if ready is not None:
            # the pump thread ran the round on its own stream: order the
            # caller's current stream after it, and keep the outputs'
            # memory from being handed out again before that stream is
            # done with them
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in (out if isinstance(out, tuple) else (out,)):
                t.record_stream(stream)
        return out

    def _pump_loop(self) -> None:
        pending: list = []
        try:
            while True:
                try:
                    item = self._requests.get(timeout=self._tick_s)
                    if item is None:
                        self._conn.send({"t": "bye"})
                        return
                    pending.append(item)
                except queue.Empty:
                    pass
                while True:  # drain whatever else is already queued
                    try:
                        item = self._requests.get_nowait()
                        if item is None:
                            self._conn.send({"t": "bye"})
                            return
                        pending.append(item)
                    except queue.Empty:
                        break
                units = [dict(desc, n=n) for desc, n, _, _ in pending]
                self._conn.send({"t": "propose", "units": units})
                msg = self._conn.recv()
                if msg["t"] == "bye":
                    raise ConnectionError("coordinator ended session")
                for decision in msg["units"]:
                    rows = decision.pop("rows")
                    key = _desc_key(decision)
                    # every pending unit of this geometry rides this
                    # dispatch (the coordinator sized it for the member's
                    # SUM), up to the decided capacity; any overflow stays
                    # pending for the next round
                    matches, total = [], 0
                    for p in list(pending):
                        if _desc_key(p[0]) != key:
                            continue
                        if matches and total + p[1] > rows:
                            break
                        matches.append(p)
                        total += p[1]
                        pending.remove(p)
                    try:
                        outs = self._execute(decision, rows, matches)
                        ready = None
                        if self.device.type == "cuda":
                            ready = torch.cuda.Event()
                            ready.record(torch.cuda.current_stream(
                                self.device))
                        for p, out in zip(matches, outs):
                            p[3].put((out, ready))
                    except Exception as e:
                        # the peers ran (or are running) this slot's
                        # program; after such a divergence the cluster
                        # would hang until the socket timeout, so end the
                        # session now
                        for p in matches:
                            p[3].put(e)
                        log.error("lockstep execute failed; ending "
                                  "session: %s", e)
                        try:
                            self._conn.send({"t": "bye"})
                        except OSError:
                            pass
                        return
        except (ConnectionError, OSError) as e:
            log.info("lockstep pump stopping: %s", e)
        finally:
            self._stopped.set()
            self._conn.close()
            err = LockstepSessionEnded("lockstep session has ended")
            for p in pending:
                p[3].put(err)
            while True:
                try:
                    item = self._requests.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[3].put(err)

    # -- execution ----------------------------------------------------------

    def _local(self, datas: list[dict], field: str, rows: int, shape: tuple,
               dtype: torch.dtype, fill=0) -> torch.Tensor:
        """This member's rows of ``field`` over its matched units, padded
        with ``fill`` to the decided ``rows`` (pinned for a card); a unit
        that fills them alone goes as it is."""
        if len(datas) == 1 and datas[0][field].shape[0] == rows:
            return datas[0][field]
        out = torch.empty((rows, *shape), dtype=dtype,
                          pin_memory=self.device.type == "cuda")
        at = 0
        for d in datas:
            out[at:at + d[field].shape[0]] = d[field]
            at += d[field].shape[0]
        out[at:] = fill
        return out

    @staticmethod
    def _readback(out, counts_per_unit: list[int]) -> list:
        """Split this member's rows back into one result per served unit
        (a tuple of outputs splits into per-unit tuples)."""
        def split(t):
            outs, at = [], 0
            for n in counts_per_unit:
                outs.append(t[at:at + n])
                at += n
            return outs

        if isinstance(out, tuple):
            return list(zip(*(split(t) for t in out)))
        return split(out)

    def _execute(self, desc: dict, rows: int, matches: list) -> list:
        """Run one agreed dispatch on this member's replicas, fed with the
        concatenated rows of every locally matched unit (possibly none:
        padding only); returns one result per match, in order."""
        counts = [m[1] for m in matches]
        datas = [m[2] for m in matches]

        def local(field, shape, dtype=torch.uint8, fill=0):
            return self._local(datas, field, rows, tuple(shape), dtype, fill)

        kind = desc["kind"]
        disp = tuple(desc["disp"]) if desc.get("disp") else None
        geom = ({k: (tuple(v) if isinstance(v, list) else v)
                 for k, v in desc["geom"].items()} if "geom" in desc
                else None)
        if kind == "coef_splice":
            y_bh, y_bw = desc["y_shape"]
            c_bh, c_bw = desc["c_shape"]
            n_coef = (y_bh * y_bw + 2 * c_bh * c_bw) * 64
            # padding rows take quant tables of ones (finite
            # dequantize/requantize of their zero coefficients)
            out = super().run_device_coefficients_annotated_packed(
                local("packed", (n_coef * 3 // 2,)),
                local("quant", (3, 64), getattr(torch, desc["quant_dtype"]),
                      fill=1),
                wh=(desc["w"], desc["h"]),
                shapes=((y_bh, y_bw), (c_bh, c_bw)),
                sampling=tuple(desc["sampling"]), k=desc["k"],
                disp_dims=disp)
        elif kind == "tiled":
            tiled = self._tiled_detector((desc["w"], desc["h"]),
                                         desc["grid"], desc["overlap"])
            out = tiled.run_device(local("images", (desc["h"], desc["w"], 3)),
                                   pack_output=True)
        elif kind == "tiled_ycbcr":
            tiled = self._tiled_detector((geom["width"], geom["height"]),
                                         desc["grid"], desc["overlap"])
            out = tiled.run_device_ycbcr_packed(
                local("packed", (_plane_len(geom),)), geom, pack_output=True)
        elif kind == "ycbcr_annot":
            out = super().run_device_ycbcr_annotated(
                local("packed", (_plane_len(geom),)), geom,
                quality=desc["quality"], disp_dims=disp)
        elif kind == "rgb_annot":
            out = super().run_device_annotated(
                local("images", (desc["h"], desc["w"], 3)),
                quality=desc["quality"], subsampling=desc["sub"],
                disp_dims=disp)
        elif kind == "pixels":
            out = super().run_device(
                local("images", (desc["h"], desc["w"], 3)),
                pack_output=desc["pack"])
        elif kind == "ycbcr":
            out = super().run_device_ycbcr_packed(
                local("packed", (_plane_len(geom),)), geom,
                pack_output=desc["pack"])
        elif kind == "coef":
            coef_dt, quant_dt = (getattr(torch, d) for d in desc["dtypes"])
            out = super().run_device_coefficients_arrays(
                *(local(f, desc[s], coef_dt) for f, s in (
                    ("y", "y_shape"), ("cb", "c_shape"), ("cr", "c_shape"))),
                local("quant", (3, 64), quant_dt), (desc["w"], desc["h"]),
                sampling=tuple(desc["sampling"]), pack_output=desc["pack"])
        else:
            raise ValueError(f"unknown lockstep unit kind {kind!r}")
        return self._readback(out, counts)
