"""TCP ingest socket (``infercam_onnx_tpu/serving/data_socket.py``;
reference infer_server/src/data_socket.rs).

Accept loop with one handler task per connection; each connection reads
length-delimited frames and pushes the raw payload into the bounded ingest
queue. ``await put`` blocks when the queue is full, so backpressure
reaches the TCP stream, as the reference's ``tx.send(...).await`` does.
"""

from __future__ import annotations

import asyncio
import logging

from infercam_onnx_tpu_torch.protocol import read_frame

log = logging.getLogger("infercam.data_socket")


class DataSocket:
    """Listener plus live-connection registry: a clean shutdown drops the
    existing sender connections so senders enter their reconnect loop
    (Python < 3.13 has no ``Server.close_clients``)."""

    def __init__(self) -> None:
        self.server: asyncio.AbstractServer | None = None
        self._writers: set[asyncio.StreamWriter] = set()
        self._tasks: set[asyncio.Task] = set()

    @property
    def port(self) -> int:
        """The bound port (the one asked for, or the free one port 0
        got)."""
        return self.server.sockets[0].getsockname()[1]

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter,
                      queue: asyncio.Queue) -> None:
        peer = writer.get_extra_info("peername")
        log.info("%s: New TCP connection", peer)
        self._writers.add(writer)
        task = asyncio.current_task()
        if task is not None:
            self._tasks.add(task)
        try:
            while True:
                frame = await read_frame(reader)
                await queue.put(frame)
        # OSError covers resets and dead links that are not resets
        # (keepalive ETIMEDOUT, EHOSTUNREACH, ...)
        except (asyncio.IncompleteReadError, OSError):
            pass
        except asyncio.CancelledError:
            pass  # shutdown while parked in queue.put
        except ValueError as e:
            log.warning("%s: protocol error: %s", peer, e)
        finally:
            self._writers.discard(writer)
            if task is not None:
                self._tasks.discard(task)
            writer.close()
            log.info("%s: connection closed", peer)

    async def start(self, queue: asyncio.Queue, host: str,
                    port: int) -> None:
        self.server = await asyncio.start_server(
            lambda r, w: self._handle(r, w, queue), host, port)
        log.info("data socket listening on %s:%d", host, self.port)

    def close(self) -> None:
        if self.server is not None:
            self.server.close()
        for w in list(self._writers):
            transport = w.transport
            if transport is not None:
                transport.abort()
        # a handler parked in `await queue.put()` (full ingest queue) is
        # not at a read, so the abort never wakes it: cancel the handler
        # tasks so wait_closed() cannot hang on them
        for t in list(self._tasks):
            t.cancel()

    async def wait_closed(self) -> None:
        if self.server is not None:
            await self.server.wait_closed()


async def handle_incoming(reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter,
                          queue: asyncio.Queue) -> None:
    """One connection read to its end into ``queue``, outside a listener
    (for direct use and tests)."""
    await DataSocket()._handle(reader, writer, queue)


async def spawn_data_socket(queue: asyncio.Queue, host: str,
                            port: int) -> DataSocket:
    sock = DataSocket()
    await sock.start(queue, host, port)
    return sock
