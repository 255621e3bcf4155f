"""Data-parallel detection: the batch split over replicas, one per mesh
entry (the port of ``infercam_onnx_tpu/parallel/data_parallel.py``).

The JAX package jits each program with the batch sharded over the mesh's
data axis, so XLA runs a conv trunk per chip. Here a mesh is a list of
devices (`parallel.mesh.make_mesh`), and `ShardedDetector` keeps one
replica per entry: the detector's module and priors copied once to the
entry's device (shared by the replicas of one device), the preprocessor's
resize matrices of that device, and a copy stream and a compute stream of
the replica's own. A call

1. zero-pads the batch to a multiple of the replica count ``n`` (a CUDA
   tensor on its device; padding quant tables of the splice take ones);
2. splits it into ``n`` equal contiguous shards, in order;
3. copies each shard that is not on its replica's device there with a
   non-blocking copy on the replica's copy stream (from pinned host memory
   for a host shard), and makes the compute stream wait on an event after
   it;
4. runs the same program function of ``detector.py`` (or
   ``parallel/tiling.py``) on each replica, on its compute stream;
5. gathers the outputs, in shard order, on the first entry's device: the
   caller's current stream there waits for each replica's event, so a
   readback enqueued on it after the call covers all of them;
6. returns without waiting for the device, sliced back to the batch's
   rows.

The replicas are enqueued one after another from the calling thread (the
serving worker's one device thread), so n replicas take n times the host
time of one; a thread per replica is ROADMAP B.3's work.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from infercam_onnx_tpu_torch.config import resolve_device
from infercam_onnx_tpu_torch.detector import Detector, as_tensor
from infercam_onnx_tpu_torch.ops.preprocess import Preprocessor


def shard_detect(detector: Detector, mesh: list, *, axis: str = "data"):
    """``run(images[B, H, W, 3]) -> (boxes, confs, counts)`` with B split
    over the replicas of ``mesh`` (B must be a multiple of its length)."""
    n = len(mesh)
    sharded = ShardedDetector(detector, mesh, axis=axis)

    def run(images):
        b = images.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by mesh size {n}")
        return sharded.run_device(images)

    return run


@dataclasses.dataclass
class Replica:
    """What one mesh entry runs a shard with."""

    device: torch.device
    model: torch.nn.Module
    priors: torch.Tensor
    preprocessor: Preprocessor
    copy_stream: torch.cuda.Stream | None  # None on the CPU
    compute_stream: torch.cuda.Stream | None


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current device>``, so that equal devices compare
    equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class ShardedDetector(Detector):
    """A `Detector` whose programs split the batch over the replicas of
    ``mesh`` (a list of devices; one may appear more than once).

    Built from a loaded detector, whose weights are copied, not loaded
    again. Every program of `Detector` runs sharded: batches that are not
    a multiple of the replica count are padded and the outputs sliced
    back, so the serving worker need not know. ``device`` is the first
    entry's, where the outputs land."""

    # pylint: disable=super-init-not-called  (adopts a loaded detector)
    def __init__(self, detector: Detector, mesh: list, *,
                 axis: str = "data"):
        if not mesh:
            raise ValueError("the mesh names no device")
        self.config = detector.config
        self.width, self.height = detector.width, detector.height
        self.mesh = [_indexed(resolve_device(d)) for d in mesh]
        self.axis = axis  # the name of the one axis the batch splits over
        self.n = len(self.mesh)
        # the multiple the serving worker pads its batches to (a lockstep
        # member's local replica count)
        self.batch_granularity = self.n
        self.dispatches = 0  # sharded program calls (tests, the smoke)
        own = _indexed(detector.device)
        placed = {own: (detector.model, detector.priors,
                        detector.preprocessor)}
        self.replicas: list[Replica] = []
        for dev in self.mesh:
            if dev not in placed:
                placed[dev] = (copy.deepcopy(detector.model).to(dev),
                               detector.priors.to(dev),
                               Preprocessor(self.width, self.height, dev))
            streams = ((torch.cuda.Stream(dev), torch.cuda.Stream(dev))
                       if dev.type == "cuda" else (None, None))
            self.replicas.append(Replica(dev, *placed[dev], *streams))
        first = self.replicas[0]
        self.device = first.device
        self.model, self.priors = first.model, first.priors
        self.preprocessor = first.preprocessor

    def _pad(self, arr, b: int, fill=0):
        """``arr`` with rows of ``fill`` up to the next multiple of ``n``
        after ``b``, where it lies: a tensor stays on its device (no trip
        through the host), an array stays an array."""
        pad = (-b) % self.n
        if pad == 0:
            return arr
        if isinstance(arr, torch.Tensor):
            return torch.cat([arr, arr.new_full((pad, *arr.shape[1:]),
                                                fill)])
        arr = np.asarray(arr)
        return np.concatenate([arr, np.full((pad, *arr.shape[1:]), fill,
                                            arr.dtype)])

    def _dispatch(self, inputs: list, call, fills: tuple | None = None):
        """One sharded program call (the module docstring's six steps):
        ``call(replica, *shards)`` on each replica; outputs (a tensor or a
        tuple of them) gathered on the first device."""
        b = inputs[0].shape[0]
        fills = fills or (0,) * len(inputs)
        inputs = [self._pad(as_tensor(a), b, f)
                  for a, f in zip(inputs, fills)]
        rows = inputs[0].shape[0] // self.n
        self.dispatches += 1
        # the callers' streams, read before any stream context changes them
        callers = {d: torch.cuda.current_stream(d)
                   for d in {*self.mesh, *(a.device for a in inputs)}
                   if d.type == "cuda"}
        outs = [self._run_replica(r, [a[i * rows:(i + 1) * rows]
                                      for a in inputs], call, callers)
                for i, r in enumerate(self.replicas)]
        gathered = self._gather(outs, callers)
        if gathered[0].shape[0] != b:
            gathered = [t[:b] for t in gathered]
        return tuple(gathered) if isinstance(outs[0][0], tuple) \
            else gathered[0]

    @staticmethod
    def _run_replica(r: Replica, shards: list, call, callers: dict):
        """Upload ``shards`` to replica ``r`` and enqueue its program: its
        outputs, the event after them (None on the CPU) and ``r``."""
        if r.compute_stream is None:
            return call(r, *(s.to(r.device) for s in shards)), None, r
        local, moved = [], []
        with torch.cuda.stream(r.copy_stream):
            for s in shards:
                if s.device == r.device:
                    local.append(s)
                    moved.append(s)
                    continue
                if s.device.type == "cuda":
                    r.copy_stream.wait_stream(callers[s.device])
                    s.record_stream(r.copy_stream)
                elif not s.is_pinned():
                    s = s.pin_memory()
                moved.append(s.to(r.device, non_blocking=True))
            ready = torch.cuda.Event()
            ready.record(r.copy_stream)
        r.compute_stream.wait_event(ready)
        if local:
            r.compute_stream.wait_stream(callers[r.device])
        for t in moved:
            # the caching allocator must not hand this memory out again
            # before the compute stream is done with it
            t.record_stream(r.compute_stream)
        with torch.cuda.stream(r.compute_stream):
            out = call(r, *moved)
            done = torch.cuda.Event()
            done.record(r.compute_stream)
        return out, done, r

    def _gather(self, outs: list, callers: dict) -> list[torch.Tensor]:
        """Each output, its replicas' rows concatenated in shard order on
        the first device, ordered on the caller's current stream there."""
        first = self.device
        parts = []
        for out, done, r in outs:
            tensors = out if isinstance(out, tuple) else (out,)
            if done is None:
                parts.append(tensors)
                continue
            callers[first].wait_event(done)
            here = []
            for t in tensors:
                if t.device == first:
                    t.record_stream(callers[first])
                else:
                    # a copy between cards orders both current streams:
                    # the replica's compute stream and the caller's
                    with torch.cuda.stream(r.compute_stream):
                        t = t.to(first, non_blocking=True)
                here.append(t)
            parts.append(tuple(here))
        if len(parts) == 1:
            return list(parts[0])
        return [torch.cat(column) for column in zip(*parts)]

    def warmup(self, batch_size: int, height: int, width: int, *,
               pack_output: bool = False) -> None:
        """One (B, H, W) batch of `run_device` (with ``pack_output``)
        through every replica, then wait for every card of the mesh."""
        dummy = np.zeros((batch_size, height, width, 3), np.uint8)
        self.run_device(dummy, pack_output=pack_output)
        for dev in set(self.mesh):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
