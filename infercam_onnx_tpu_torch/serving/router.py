"""Demand-driven frame router (``infercam_onnx_tpu/serving/router.py``;
reference infer_server/src/router.rs).

Consumes raw protocol frames from the ingest queue and fans them out:

- raw path: publish the MJPEG part to the stream's raw broadcast — only if
  someone subscribed;
- infer path: submit to the inference worker — only if someone subscribed
  to the inferred or detections stream, with drop-when-busy backpressure
  (the worker's bounded queue stands in for the reference's try_send).

Broadcast maps are pruned of subscriber-less channels every
``refresh_every`` processed frames. A ConnectReq is accepted and ignored
and malformed messages are skipped silently, as in the reference. Stream
names hash to keys with blake2b (the hash never leaves the process).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
from typing import Callable

from infercam_onnx_tpu_torch.config import ServerConfig
from infercam_onnx_tpu_torch.protocol import (
    FrameMsg,
    as_jpeg_stream_item,
    decode_proto_msg,
)
from infercam_onnx_tpu_torch.serving.broadcast import Broadcast, _Subscription
from infercam_onnx_tpu_torch.serving.meter import METER

log = logging.getLogger("infercam.router")

# a stream is listed as active this long after its last frame, and kept in
# the name registry this long; under a name flood the registry keeps only
# the freshest SEEN_CAP names
ACTIVE_S = 15.0
SEEN_MAX_AGE_S = 60.0
SEEN_CAP = 4096


def stream_key(name: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(name.encode("utf-8"), digest_size=8).digest(),
        "little")


class InferJob:
    __slots__ = ("key", "data", "reply", "det_reply", "enqueued_at")

    def __init__(self, key: int, data: bytes,
                 reply: Broadcast | None,
                 det_reply: Broadcast | None = None,
                 enqueued_at: float = 0.0):
        self.key = key
        self.data = data
        self.reply = reply  # annotated MJPEG viewers (None = none)
        self.det_reply = det_reply  # NDJSON detection viewers
        self.enqueued_at = enqueued_at


class FrameRouter:
    def __init__(
        self,
        submit_infer: Callable[[InferJob], bool],
        config: ServerConfig = ServerConfig(),
    ):
        self._submit_infer = submit_infer
        self._config = config
        self._raw: dict[int, Broadcast] = {}
        self._inferred: dict[int, Broadcast] = {}
        self._detections: dict[int, Broadcast] = {}
        # stream NAME registry (name -> last-seen loop time): the
        # broadcast tables key by hash, but the dashboard lists names
        self._seen: dict[str, float] = {}

    # -- subscriptions (called by HTTP handlers) ---------------------------

    def _subscribe(self, table: dict[int, Broadcast],
                   name: str) -> _Subscription:
        # prune on the subscription cadence too, so a scraper minting
        # distinct names on an idle ingest cannot grow the tables
        self._prune()
        key = stream_key(name)
        chan = table.get(key)
        if chan is None:
            chan = Broadcast(self._config.broadcast_capacity)
            table[key] = chan
        return chan.subscribe()

    def subscribe_raw(self, name: str) -> _Subscription:
        return self._subscribe(self._raw, name)

    def subscribe_inferred(self, name: str) -> _Subscription:
        return self._subscribe(self._inferred, name)

    def subscribe_detections(self, name: str) -> _Subscription:
        """Per-frame detections as NDJSON; the worker skips drawing when
        nobody watches the annotated video."""
        return self._subscribe(self._detections, name)

    # -- main loop ---------------------------------------------------------

    def active_streams(self) -> list[str]:
        """Names of streams with frames in the last ``ACTIVE_S``."""
        try:
            now = asyncio.get_running_loop().time()
        except RuntimeError:
            return sorted(self._seen)
        return sorted(n for n, t in self._seen.items()
                      if now - t <= ACTIVE_S)

    def _prune_seen(self, now: float) -> None:
        """Bound the name registry: drop stale entries each refresh
        cycle, and under a name flood keep only the freshest ones."""
        stale = [n for n, t in self._seen.items()
                 if now - t > SEEN_MAX_AGE_S]
        for n in stale:
            del self._seen[n]
        if len(self._seen) > SEEN_CAP:
            for n, _ in sorted(self._seen.items(),
                               key=lambda kv: kv[1])[:-SEEN_CAP]:
                del self._seen[n]

    def _prune(self) -> None:
        for table in (self._raw, self._inferred, self._detections):
            dead = [k for k, chan in table.items()
                    if chan.receiver_count == 0]
            for k in dead:
                del table[k]

    async def run(self, queue: asyncio.Queue) -> None:
        loop = asyncio.get_running_loop()
        while True:
            self._prune()
            self._prune_seen(loop.time())
            for _ in range(self._config.router_refresh_every):
                raw = await queue.get()
                msg = decode_proto_msg(raw)
                if not isinstance(msg, FrameMsg):
                    continue  # ConnectReq and garbage: accepted, ignored
                key = stream_key(msg.id)
                self._seen[msg.id] = loop.time()

                raw_chan = self._raw.get(key)
                if raw_chan is not None and raw_chan.receiver_count > 0:
                    raw_chan.publish(as_jpeg_stream_item(msg.data))
                    METER.tick_raw_unique()

                inf_chan = self._inferred.get(key)
                if inf_chan is not None and inf_chan.receiver_count == 0:
                    inf_chan = None
                det_chan = self._detections.get(key)
                if det_chan is not None and det_chan.receiver_count == 0:
                    det_chan = None
                if inf_chan is not None or det_chan is not None:
                    job = InferJob(key, msg.data, inf_chan, det_chan,
                                   enqueued_at=loop.time())
                    if not self._submit_infer(job):
                        METER.tick_dropped()
