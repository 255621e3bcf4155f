"""The load generator: the cameras and the viewers of a cell, in a process
of their own (a child of the run), so that they share neither the
server's interpreter lock nor its event loop.

    python benchmark/harness/loadgen.py --http-port P --socket-port Q \\
        --traffic benchmark/traffic/<mix>.json --seed N

It makes the streams' JPEGs from the seed (`frames.stream_jpegs`), opens a
``/detections`` viewer (NDJSON) per stream and a sender per stream (the
wire protocol of ``client/sender.py``: a ConnectReq, then one FrameMsg a
frame, frame ``j`` the stream's JPEG ``j % variants`` numbered ``j``),
and prints ``ready``. On ``start T_SEND T0 T1``
(``time.monotonic`` values, the clock the server's process reads too)
every sender sends on a schedule of due times from T_SEND to T1: stream
k's frame j is due at ``T_SEND + phase_k + j / fps``, the phases spread
evenly over one frame period in an order drawn from the seed. It is an
open loop: a sender that falls behind sends at once and records how late
it ran. On ``finish`` it closes everything and prints one JSON line: what
was sent in [T0, T1] and how late, how many records each viewer received
in [T0, T1], and for each stream the time every frame was sent and every
record its viewer received, with the time it arrived.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import pathlib
import struct
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from harness.frames import numbered, stream_jpegs  # noqa: E402

CONNECT_REQ, FRAME_MSG = 0, 1


def _bincode(data: bytes) -> bytes:
    return struct.pack("<Q", len(data)) + data


def _framed(payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + payload


def connect_msg(channel: str) -> bytes:
    return _framed(struct.pack("<I", CONNECT_REQ)
                   + _bincode(channel.encode()))


def frame_msg(channel: str, jpeg: bytes) -> bytes:
    return _framed(struct.pack("<I", FRAME_MSG) + _bincode(channel.encode())
                   + _bincode(jpeg))


def stream_name(k: int) -> str:
    return f"cam{k:03d}"


class Viewer:
    """One ``/detections`` viewer: every record it receives, with the time
    it arrived."""

    def __init__(self, port: int, path: str):
        self.port, self.path = port, path
        self.items: list[tuple[float, bytes]] = []
        self.task: asyncio.Task | None = None
        self.writer = None

    async def open(self) -> None:
        reader, self.writer = await asyncio.open_connection("127.0.0.1",
                                                            self.port)
        self.writer.write(f"GET {self.path} HTTP/1.1\r\nHost: x\r\n\r\n"
                          .encode())
        await self.writer.drain()
        self.task = asyncio.create_task(self._read(reader))

    async def _read(self, reader) -> None:
        loop = asyncio.get_running_loop()
        buf = b""
        headers_done = False
        try:
            while chunk := await reader.read(1 << 16):
                buf += chunk
                if not headers_done:
                    if b"\r\n\r\n" not in buf:
                        continue
                    buf = buf.split(b"\r\n\r\n", 1)[1]
                    headers_done = True
                now = loop.time()
                *items, buf = buf.split(b"\n")
                self.items.extend((now, i) for i in items if i)
        except (ConnectionError, OSError):
            pass

    async def close(self) -> None:
        self.writer.close()
        self.task.cancel()
        await asyncio.gather(self.task, return_exceptions=True)


class Sender:
    def __init__(self, port: int, channel: str, jpegs: list[bytes]):
        self.port = port
        self.channel = channel
        self.jpegs = jpegs
        self.writer = None
        # (due, sent) of every frame
        self.sends: list[tuple[float, float]] = []
        self.error: str | None = None

    async def open(self) -> None:
        _, self.writer = await asyncio.open_connection("127.0.0.1",
                                                       self.port)
        self.writer.write(connect_msg(self.channel))
        await self.writer.drain()

    async def run(self, t_send: float, phase: float, period: float,
                  t_end: float) -> None:
        loop = asyncio.get_running_loop()
        j = 0
        try:
            while (due := t_send + phase + j * period) < t_end:
                wait = due - loop.time()
                if wait > 0:
                    await asyncio.sleep(wait)
                msg = frame_msg(self.channel, numbered(
                    self.jpegs[j % len(self.jpegs)], j))
                self.sends.append((due, loop.time()))
                self.writer.write(msg)
                await self.writer.drain()
                j += 1
        except (ConnectionError, OSError) as e:
            self.error = repr(e)

    async def close(self) -> None:
        self.writer.close()
        try:
            await self.writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def main(args) -> None:
    traffic = json.loads(pathlib.Path(args.traffic).read_text())
    jpegs = stream_jpegs(traffic, args.seed)
    n = traffic["streams"]
    viewers = [Viewer(args.http_port, f"/detections?name={stream_name(k)}")
               for k in range(n)]
    senders = [Sender(args.socket_port, stream_name(k), jpegs[k])
               for k in range(n)]
    for v in viewers:
        await v.open()
    for s in senders:
        await s.open()
    loop = asyncio.get_running_loop()

    async def command() -> list[str]:
        line = await loop.run_in_executor(None, sys.stdin.readline)
        return line.split()

    print("ready", flush=True)
    cmd = await command()
    if cmd[:1] != ["start"]:
        raise SystemExit(f"load generator: expected start, got {cmd}")
    t_send, t0, t1 = map(float, cmd[1:4])
    period = 1.0 / traffic["fps_per_stream"]
    # phases spread evenly over a period, in an order drawn from the seed
    order = _permutation(n, args.seed)
    tasks = [asyncio.create_task(s.run(t_send, order[k] * period / n,
                                       period, t1))
             for k, s in enumerate(senders)]
    cmd = await command()
    await asyncio.gather(*tasks)
    for s in senders:
        await s.close()
    for v in viewers:
        await v.close()
    lags = [sent - due for s in senders for due, sent in s.sends
            if t0 <= due < t1]
    report = {
        "sent_window": len(lags),
        "sent": sum(len(s.sends) for s in senders),
        "lag_ms_mean": 1e3 * sum(lags) / max(len(lags), 1),
        "lag_ms_max": 1e3 * max(lags, default=0.0),
        "errors": [s.error for s in senders if s.error],
        "received": [sum(t0 <= t < t1 for t, _ in v.items)
                     for v in viewers],
        # records received in each second of the window, over all viewers
        "received_per_s": _per_second(
            [t for v in viewers for t, _ in v.items], t0, t1),
        # every frame's send time and every record with its arrival
        "sent_at": {stream_name(k): [sent for _, sent in s.sends]
                    for k, s in enumerate(senders)},
        "records": {stream_name(k): [[t, _payload(i)] for t, i in v.items]
                    for k, v in enumerate(viewers)},
    }
    sys.stdout.write(json.dumps(report) + "\n")
    sys.stdout.flush()


def _permutation(n: int, seed: int) -> list[int]:
    import numpy as np

    return [int(i) for i in
            np.random.default_rng(seed % (2 ** 63)).permutation(n)]


def _per_second(times: list[float], t0: float, t1: float) -> list[int]:
    counts = [0] * max(1, int(t1 - t0 + 0.5))
    for t in times:
        if t0 <= t < t1:
            counts[min(len(counts) - 1, int(t - t0))] += 1
    return counts


def _payload(raw: bytes) -> dict:
    """An NDJSON record without its timestamp."""
    rec = json.loads(raw)
    rec.pop("ts", None)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--http-port", type=int, required=True)
    ap.add_argument("--socket-port", type=int, required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    asyncio.run(main(ap.parse_args()))
