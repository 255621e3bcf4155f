"""Load generator: drive a running inference server and measure it (the
counterpart of ``tools/loadgen.py``).

Opens N viewer connections (``/detections`` NDJSON by default, or
``/face_stream`` MJPEG), streams N replay channels into the data socket
at a fixed rate through the port's sender (``client/sender.py``), and
reports the delivered throughput from the server's own ``/stats``
counters beside the client-side count of parts received. It measures
any deployment over the wire, the JAX server's too::

    python -m infercam_onnx_tpu_torch.serve --device cuda \\
        --preset throughput &
    python -m infercam_onnx_tpu_torch.loadgen --server 127.0.0.1:3000 \\
        --socket 127.0.0.1:3001 --streams 16 --fps 30 --seconds 12 \\
        [--endpoint detections|face_stream|stream] [--replay-dir PICS]

Prints one JSON line: the JAX tool's keys, and ``sender_errors``, the
senders that stopped on an error (without ``--reconnect`` a sender that
loses its connection stops).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


async def _http_json(host: str, port: int, path: str,
                     retries: int = 10) -> dict:
    last: Exception | None = None
    for _ in range(retries):
        try:
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n"
                         "Connection: close\r\n\r\n".encode())
            await writer.drain()
            data = await asyncio.wait_for(reader.read(-1), 10.0)
            writer.close()
            return json.loads(data.split(b"\r\n\r\n", 1)[1])
        except (ConnectionError, OSError, asyncio.TimeoutError) as e:
            last = e
            await asyncio.sleep(2.0)  # the server may be mid-recycle
    raise last  # type: ignore[misc]


async def _viewer(host: str, port: int, path: str, counts: list,
                  idx: int, marker: bytes,
                  reconnect: bool = False) -> None:
    while True:
        try:
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(
                f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
            await writer.drain()
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    break
                counts[idx] += chunk.count(marker)
        except (ConnectionError, OSError):
            pass
        except asyncio.CancelledError:
            return
        if not reconnect:
            return
        await asyncio.sleep(1.0)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Drive a running inference server and measure it.")
    ap.add_argument("--server", default="127.0.0.1:3000")
    ap.add_argument("--socket", default="127.0.0.1:3001")
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--warmup-seconds", type=float, default=3.0)
    ap.add_argument("--endpoint", default="detections",
                    choices=["detections", "face_stream", "stream"])
    ap.add_argument("--replay-dir", default=None,
                    help="JPEGs to stream (default: the repository's "
                         "resources/test_pics_synthetic)")
    ap.add_argument("--channel-prefix", default="load")
    ap.add_argument("--reconnect", action="store_true",
                    help="senders retry forever with backoff (soaks "
                         "across server restarts/recycles); viewers "
                         "re-subscribe too")
    args = ap.parse_args(argv)

    from infercam_onnx_tpu_torch.client.sender import (ReplaySource,
                                                       run_forever,
                                                       send_stream)
    from infercam_onnx_tpu_torch.config import ClientConfig

    replay_dir = args.replay_dir or str(REPO / "resources"
                                        / "test_pics_synthetic")
    shost, _, sport = args.server.rpartition(":")
    marker = (b"\n" if args.endpoint == "detections"
              else b"--frame\r\nContent-Type")

    async def run() -> dict:
        counts = [0] * args.streams
        viewers = [asyncio.create_task(_viewer(
            shost, int(sport),
            f"/{args.endpoint}?name={args.channel_prefix}{k}",
            counts, k, marker, reconnect=args.reconnect))
            for k in range(args.streams)]
        await asyncio.sleep(0.5)
        total_frames = int(args.fps
                           * (args.seconds + args.warmup_seconds + 5))

        def sender(k):
            cfg = ClientConfig(address=args.socket,
                               channel=f"{args.channel_prefix}{k}")
            src = ReplaySource(replay_dir, fps=args.fps)
            if args.reconnect:
                return run_forever(src, cfg)
            return send_stream(src, cfg, max_frames=total_frames)

        senders = [asyncio.create_task(sender(k))
                   for k in range(args.streams)]
        await asyncio.sleep(args.warmup_seconds)
        base = await _http_json(shost, int(sport), "/stats")
        base_counts = list(counts)
        t0 = time.time()
        await asyncio.sleep(args.seconds)
        elapsed = time.time() - t0
        cur = await _http_json(shost, int(sport), "/stats")
        recv = sum(c - b for c, b in zip(counts, base_counts))
        errors = sum(t.done() and not t.cancelled()
                     and t.exception() is not None for t in senders)
        for t in senders + viewers:
            t.cancel()
        await asyncio.gather(*senders, *viewers, return_exceptions=True)
        bt, ct = base["totals"], cur["totals"]

        def rate(key):
            return round((ct.get(key, 0) - bt.get(key, 0)) / elapsed, 1)

        return {
            "streams": args.streams,
            "input_fps": args.streams * args.fps,
            "endpoint": args.endpoint,
            "seconds": round(elapsed, 1),
            "server_inferred_fps": rate("inferred_unique"),
            "server_raw_fps": rate("raw_unique"),
            "server_dropped_fps": rate("dropped"),
            "server_batches_per_s": rate("batches"),
            "client_received_per_s": round(recv / elapsed, 1),
            "stages": cur.get("stages", {}),
            "sender_errors": errors,
        }

    print(json.dumps(asyncio.run(run())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
