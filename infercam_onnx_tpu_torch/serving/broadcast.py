"""Bounded broadcast channels (``infercam_onnx_tpu/serving/broadcast.py``;
the reference's ``tokio::sync::broadcast::channel(20)``).

Each subscriber has a ring of ``capacity`` items and a slow subscriber
misses older items: overflow drops the oldest (fresh frames win, as live
MJPEG wants). ``receiver_count`` drives the router's demand-driven
pruning. Event-loop objects: other threads publish through
``loop.call_soon_threadsafe``.
"""

from __future__ import annotations

import asyncio
from collections import deque


class _Subscription:
    def __init__(self, channel: "Broadcast", capacity: int):
        self._channel = channel
        self._ring: deque[bytes] = deque(maxlen=capacity)
        self._event = asyncio.Event()
        self._closed = False

    def _push(self, item: bytes) -> None:
        self._ring.append(item)  # deque drops oldest on overflow
        self._event.set()

    async def receive(self) -> bytes:
        """Next item; waits if empty. Raises BrokenPipeError if the
        subscription was closed."""
        while not self._ring:
            if self._closed:
                raise BrokenPipeError("subscription closed")
            self._event.clear()
            await self._event.wait()
        return self._ring.popleft()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._channel._drop(self)
            self._event.set()

    def __enter__(self) -> "_Subscription":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Broadcast:
    """Multi-subscriber fan-out with per-subscriber bounded rings."""

    def __init__(self, capacity: int = 20):
        self._capacity = capacity
        self._subs: list[_Subscription] = []

    @property
    def receiver_count(self) -> int:
        return len(self._subs)

    def subscribe(self) -> _Subscription:
        sub = _Subscription(self, self._capacity)
        self._subs.append(sub)
        return sub

    def publish(self, item: bytes) -> int:
        """Deliver to all current subscribers; returns receiver count."""
        for sub in self._subs:
            sub._push(item)
        return len(self._subs)

    def close_all(self) -> None:
        """Close every subscription: a reader gets what its ring still
        holds, then BrokenPipeError."""
        for sub in list(self._subs):
            sub.close()

    def _drop(self, sub: _Subscription) -> None:
        try:
            self._subs.remove(sub)
        except ValueError:
            pass
