"""Socket sender: streams JPEG frames to the inference server (the port
of ``infercam_onnx_tpu/client/sender.py``; the reference's
cam_sender/src/bin/socket_sender.rs).

Protocol-identical to the reference client: connect, send
``ProtoMsg::ConnectReq(channel)``, then a ``ProtoMsg::FrameMsg`` per
frame, all bincode-encoded inside u32-BE length-delimited frames. The
send loop retries forever with a 3 s backoff on any error.

Frame sources:

- ``ReplaySource``: loops the JPEG files of a directory at a fixed rate,
  the webcam-free source;
- ``CameraSource``: V4L2 MJPG capture (``client/camera.py``), the
  reference's rscam path (reference sensors.rs:18-68). ``--camera`` is
  repeatable: one process streams several cameras, each on its own
  channel with its own reconnect loop.

Usage::

    python -m infercam_onnx_tpu_torch.client.sender --channel simon \
        --replay-dir resources/test_pics_synthetic --fps 30
    python -m infercam_onnx_tpu_torch.client.sender --camera /dev/video0
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import pathlib
import sys
from typing import AsyncIterator, Protocol

from infercam_onnx_tpu_torch.config import ClientConfig
from infercam_onnx_tpu_torch.protocol import (
    ConnectReq,
    FrameMsg,
    encode_proto_msg,
    frame_encode,
)

log = logging.getLogger("infercam.sender")


class FrameSource(Protocol):
    def frames(self) -> AsyncIterator[bytes]: ...


class ReplaySource:
    """Loops JPEG files from a directory at ``fps`` frames per second
    (one pass when not ``loop_forever``)."""

    def __init__(self, directory: str, fps: float = 30.0,
                 loop_forever: bool = True):
        self._files = sorted(
            os.path.join(directory, f) for f in os.listdir(directory)
            if f.lower().endswith((".jpg", ".jpeg")))
        if not self._files:
            raise FileNotFoundError(f"no JPEGs in {directory}")
        self._frames = [pathlib.Path(f).read_bytes()
                        for f in self._files]
        self._fps = fps
        self._loop_forever = loop_forever

    async def frames(self) -> AsyncIterator[bytes]:
        period = 1.0 / self._fps if self._fps > 0 else 0.0
        while True:
            for data in self._frames:
                yield data
                if period:
                    await asyncio.sleep(period)
            if not self._loop_forever:
                return


async def send_stream(
    source: FrameSource,
    config: ClientConfig = ClientConfig(),
    *,
    max_frames: int | None = None,
) -> int:
    """One connection lifetime: connect, ConnectReq, frame loop.
    Returns frames sent; raises on connection errors (caller retries)."""
    host, _, port = config.address.rpartition(":")
    _, writer = await asyncio.open_connection(host, int(port))
    log.info("Client connected to %s", config.channel)
    sent = 0
    try:
        writer.write(frame_encode(
            encode_proto_msg(ConnectReq(config.channel))))
        await writer.drain()
        async for data in source.frames():
            writer.write(frame_encode(
                encode_proto_msg(FrameMsg(config.channel, data))))
            await writer.drain()
            sent += 1
            if max_frames is not None and sent >= max_frames:
                break
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass
    return sent


async def run_forever(source: FrameSource,
                      config: ClientConfig = ClientConfig()) -> None:
    """Reconnect forever with a backoff, as the reference does."""
    while True:
        try:
            await send_stream(source, config)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # the reference retries on ANY error: an oversized frame
            # failing its encode must reconnect, not kill every loop
            log.warning("Error in sender: %s. Reconnecting...", e)
        await asyncio.sleep(config.reconnect_backoff_s)


def plan_channels(n_sources: int, channels: list[str]) -> list[str]:
    """Per-source channel names: the explicit list when it matches, else
    a single base name fans out to ``base``, ``base-1``, ``base-2``, ...
    (the first keeps the bare name, so one camera streams as before)."""
    if len(channels) == n_sources:
        return list(channels)
    if len(channels) == 1:
        base = channels[0]
        return [base if i == 0 else f"{base}-{i}"
                for i in range(n_sources)]
    raise ValueError(
        f"{len(channels)} channel name(s) for {n_sources} camera(s) — "
        "pass one --channel per --camera, or a single base name")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Stream JPEG frames from files or V4L2 cameras to the "
                    "inference server.")
    ap.add_argument("--address", default="127.0.0.1:3001")
    ap.add_argument("--channel", action="append", default=None,
                    help="stream name (repeatable; one per --camera, "
                         "or a single base name that fans out as "
                         "base, base-1, ...; default simon)")
    ap.add_argument("--replay-dir",
                    help="stream the JPEG files of this directory")
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--camera", action="append", nargs="?",
                    const="/dev/video0",
                    help="capture from a V4L2 device (repeatable: one "
                         "edge process can stream several cameras, "
                         "each on its own channel with its own "
                         "reconnect loop; default /dev/video0)")
    ap.add_argument("--log-level", default="INFO")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s.%(msecs)03d %(levelname)s %(name)s: "
               "%(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S")

    sources: list[FrameSource] = []
    if args.camera:
        from infercam_onnx_tpu_torch.client.camera import CameraSource

        sources = [CameraSource(dev) for dev in args.camera]
    elif args.replay_dir:
        sources = [ReplaySource(args.replay_dir, fps=args.fps)]
    else:
        ap.error("one of --replay-dir or --camera is required")
    try:
        channels = plan_channels(len(sources), args.channel or ["simon"])
    except ValueError as e:
        ap.error(str(e))
    configs = [ClientConfig(address=args.address, channel=ch)
               for ch in channels]
    log.info("Launching socket sender for channel(s) %s",
             ", ".join(channels))

    async def run_all():
        await asyncio.gather(*(run_forever(src, cfg)
                               for src, cfg in zip(sources, configs)))

    try:
        asyncio.run(run_all())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
