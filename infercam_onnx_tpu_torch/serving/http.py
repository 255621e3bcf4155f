"""Minimal asyncio HTTP/1.1 server with MJPEG streaming endpoints
(``infercam_onnx_tpu/serving/http.py``; the reference's axum app,
infer_server/src/endpoints.rs):

- ``GET /healthcheck`` -> 200 ``healthy``
- ``GET /stream?name=X`` -> ``multipart/x-mixed-replace; boundary=frame``
  over the raw broadcast
- ``GET /face_stream?name=X`` -> the same over the annotated broadcast
- ``GET /detections?name=X`` -> one NDJSON record per inferred frame
- ``GET /snapshot?name=X[&raw=1][&timeout=S]`` -> one JPEG
- ``GET /stats`` (JSON: the meter's counters, the topology, whether the
  warm-up runs, ``link``, the link probe's decision table, and on a
  lockstep member ``lockstep``, its dispatch counts),
  ``GET /metrics`` (Prometheus text), ``GET /`` (a status page listing
  the active streams)

``name`` defaults to ``"unknown"``. The meter ticks once per delivered
part per viewer. Streams run until the client disconnects; the
subscription closes then, so the router stops inferring a stream whose
last viewer left.
"""

from __future__ import annotations

import asyncio
import html
import json
import logging
import urllib.parse

from infercam_onnx_tpu_torch.protocol import _MJPEG_HEADER, _MJPEG_TRAILER
from infercam_onnx_tpu_torch.serving.meter import METER
from infercam_onnx_tpu_torch.serving.router import FrameRouter

log = logging.getLogger("infercam.http")


def _jpeg_from_part(part: bytes) -> bytes:
    """Payload of one MJPEG part (as_jpeg_stream_item framing)."""
    if part.startswith(_MJPEG_HEADER) and part.endswith(_MJPEG_TRAILER):
        return part[len(_MJPEG_HEADER):-len(_MJPEG_TRAILER)]
    return part


_MJPEG_HEADERS = (
    b"HTTP/1.1 200 OK\r\n"
    b"Content-Type: multipart/x-mixed-replace; boundary=frame\r\n"
    b"Cache-Control: no-cache\r\n"
    b"Connection: close\r\n"
    b"\r\n"
)

_NDJSON_HEADERS = (
    b"HTTP/1.1 200 OK\r\n"
    b"Content-Type: application/x-ndjson\r\n"
    b"Cache-Control: no-cache\r\n"
    b"Connection: close\r\n"
    b"\r\n"
)


def _simple_response(status: str, body: bytes,
                     content_type: str = "text/plain",
                     keep_alive: bool = False) -> bytes:
    conn = "keep-alive" if keep_alive else "close"
    return (
        f"HTTP/1.1 {status}\r\n"
        f"Content-Type: {content_type}\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"Connection: {conn}\r\n\r\n"
    ).encode() + body


class HttpServer:
    def __init__(self, router: FrameRouter, topology: dict | None = None,
                 warming=None, link=None, lockstep=None):
        self._router = router
        # serving topology ({"devices", "processes", "lockstep",
        # "platform", "device", "detector"}) shown in /stats, /metrics and
        # the status page
        self._topology = topology
        # callable -> bool: device warm-up still running
        self._warming = warming
        # callable -> dict | None: the link probe's verdict and the paths
        # in effect (serving/link.py), shown in /stats
        self._link = link
        # callable -> dict: a lockstep member's dispatch counts, in /stats
        self._lockstep = lockstep
        self._server: asyncio.AbstractServer | None = None
        self._tasks: set[asyncio.Task] = set()  # live connection handlers

    @property
    def port(self) -> int:
        """The bound port (the one asked for, or the free one port 0
        got)."""
        return self._server.sockets[0].getsockname()[1]

    async def start(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(
            self._handle, host, port)
        log.info("HTTP server listening on %s:%d", host, self.port)

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            # end the open streams: 3.12's wait_closed waits for every
            # handler, and a viewer holds its stream until it disconnects
            for t in list(self._tasks):
                t.cancel()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                pass

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """Request loop: non-streaming endpoints serve several requests
        per connection (HTTP/1.1 keep-alive); streaming endpoints hold the
        connection until the client disconnects, then close."""
        task = asyncio.current_task()
        self._tasks.add(task)
        try:
            while True:
                # the parse section has its own ValueError scope:
                # readline() raises it for header lines over the stream
                # limit, urlsplit for malformed bracket hosts. That is
                # hostile input: drop the connection quietly. A ValueError
                # from the endpoint logic below is a bug and reaches the
                # logged catch-all.
                try:
                    request_line = await asyncio.wait_for(
                        reader.readline(), 30.0)
                    if not request_line:
                        return
                    parts = request_line.decode("latin-1").split()
                    if len(parts) < 2:
                        writer.write(_simple_response("400 Bad Request",
                                                      b"bad"))
                        return
                    method, target = parts[0], parts[1]
                    version = (parts[2] if len(parts) >= 3
                               else "HTTP/1.0")
                    conn_hdr = ""
                    body_len = 0
                    chunked = False
                    while True:
                        line = await asyncio.wait_for(
                            reader.readline(), 30.0)
                        if line in (b"\r\n", b"\n", b""):
                            break
                        low = line.lower()
                        if low.startswith(b"connection:"):
                            conn_hdr = line.split(b":", 1)[1].strip(
                            ).decode("latin-1").lower()
                        elif low.startswith(b"content-length:"):
                            try:
                                body_len = int(line.split(b":", 1)[1])
                            except ValueError:
                                body_len = -1
                        elif low.startswith(b"transfer-encoding:"):
                            # a chunked body is not drained here; keeping
                            # the connection would parse leftover chunk
                            # data as the next request line
                            chunked = True
                    keep = (version == "HTTP/1.1" and conn_hdr != "close"
                            and not chunked)
                    # drain a request body so a keep-alive connection's
                    # next request line is not its leftover bytes
                    # (bounded: nothing here accepts uploads)
                    if body_len < 0 or body_len > 1 << 20:
                        keep = False
                    elif body_len:
                        await asyncio.wait_for(
                            reader.readexactly(body_len), 30.0)

                    url = urllib.parse.urlsplit(target)
                    query = urllib.parse.parse_qs(url.query)
                    name = query.get("name", ["unknown"])[0]
                except ValueError as e:
                    log.debug("dropping connection on unparseable "
                              "request: %s", e)
                    return

                if method != "GET":
                    writer.write(_simple_response(
                        "405 Method Not Allowed", b"method not allowed",
                        keep_alive=keep))
                elif url.path in ("/", "/index.html"):
                    writer.write(_simple_response(
                        "200 OK", self._dashboard(),
                        "text/html; charset=utf-8", keep_alive=keep))
                elif url.path == "/healthcheck":
                    writer.write(_simple_response("200 OK", b"healthy",
                                                  keep_alive=keep))
                elif url.path == "/stats":
                    payload = METER.stats()
                    if self._topology is not None:
                        payload["topology"] = self._topology
                    if self._warming is not None:
                        payload["warming"] = bool(self._warming())
                    if self._link is not None:
                        status = self._link()
                        if status is not None:
                            payload["link"] = status
                    if self._lockstep is not None:
                        payload["lockstep"] = self._lockstep()
                    writer.write(_simple_response(
                        "200 OK", json.dumps(payload).encode(),
                        "application/json", keep_alive=keep))
                elif url.path == "/metrics":
                    text = METER.prometheus()
                    if self._topology is not None:
                        labels = ",".join(
                            f'{k}="{v}"' for k, v in
                            sorted(self._topology.items()))
                        text += ("# TYPE infercam_topology_info gauge\n"
                                 f"infercam_topology_info{{{labels}}}"
                                 " 1\n")
                    writer.write(_simple_response(
                        "200 OK", text.encode(),
                        "text/plain; version=0.0.4",
                        keep_alive=keep))
                elif url.path == "/stream":
                    log.info("Stream for %s requested", name)
                    await self._stream(
                        reader, writer, self._router.subscribe_raw(name),
                        METER.tick_raw)
                    return
                elif url.path == "/face_stream":
                    log.info("Infered stream for %s requested", name)
                    await self._stream(
                        reader, writer,
                        self._router.subscribe_inferred(name),
                        METER.tick_inferred)
                    return
                elif url.path == "/snapshot":
                    # one JPEG of the stream's next frame; ?raw=1 takes
                    # the raw stream. The subscription itself makes the
                    # router infer, as a stream viewer does.
                    raw = query.get("raw", ["0"])[0] not in ("0", "")
                    try:
                        timeout_s = float(
                            query.get("timeout", ["10"])[0] or 10)
                    except ValueError:
                        writer.write(_simple_response(
                            "400 Bad Request", b"bad timeout",
                            keep_alive=keep))
                        await writer.drain()
                        if not keep:
                            return
                        continue
                    sub = (self._router.subscribe_raw(name) if raw
                           else self._router.subscribe_inferred(name))
                    try:
                        with sub:
                            part = await asyncio.wait_for(
                                sub.receive(), timeout_s)
                        jpeg = _jpeg_from_part(part)
                        (METER.tick_raw if raw
                         else METER.tick_inferred)()
                        writer.write(_simple_response(
                            "200 OK", jpeg, "image/jpeg",
                            keep_alive=keep))
                    except asyncio.TimeoutError:
                        writer.write(_simple_response(
                            "504 Gateway Timeout",
                            b"no frame within timeout",
                            keep_alive=keep))
                elif url.path == "/detections":
                    log.info("Detections stream for %s requested", name)
                    await self._stream(
                        reader, writer,
                        self._router.subscribe_detections(name),
                        METER.tick_inferred,
                        headers=_NDJSON_HEADERS)
                    return
                else:
                    writer.write(_simple_response("404 Not Found",
                                                  b"not found",
                                                  keep_alive=keep))
                await writer.drain()
                if not keep:
                    return
        except (asyncio.TimeoutError, ConnectionError,
                asyncio.IncompleteReadError):
            # a stalled or broken client socket, or a body cut short:
            # drop the connection without a stack trace
            pass
        except Exception:
            log.exception("HTTP handler error")
        finally:
            self._tasks.discard(task)
            try:
                await writer.drain()
            except (ConnectionError, asyncio.TimeoutError):
                pass
            writer.close()

    def _dashboard(self) -> bytes:
        """Status page: active streams with raw thumbnails and links to
        every per-stream surface. Refreshes itself every 5 s."""
        rows = []
        for n in self._router.active_streams():
            q = urllib.parse.quote(n)
            e = html.escape(n)
            rows.append(
                f'<div class="s"><h3>{e}</h3>'
                f'<a href="/face_stream?name={q}">'
                f'<img src="/snapshot?name={q}&raw=1&timeout=3" '
                f'alt="{e}" width="320"></a><p>'
                f'<a href="/stream?name={q}">raw</a> · '
                f'<a href="/face_stream?name={q}">annotated</a> · '
                f'<a href="/detections?name={q}">detections</a>'
                f'</p></div>')
        body = ("".join(rows)
                or "<p>No active streams. Point a sender at the "
                   "ingest socket.</p>")
        if self._warming is not None and self._warming():
            body = ("<p><b>Device warm-up in progress</b> — inference "
                    "starts when it ends.</p>") + body
        topo = ""
        if self._topology:
            topo = html.escape(" · ".join(
                f"{k}: {v}" for k, v in sorted(self._topology.items())))
        page = (
            "<!doctype html><html><head>"
            "<meta http-equiv='refresh' content='5'>"
            "<title>infercam_onnx_tpu_torch</title><style>"
            "body{font-family:sans-serif;margin:2em}"
            ".s{display:inline-block;margin:1em;vertical-align:top}"
            "img{background:#eee;min-height:60px}"
            "</style></head><body>"
            f"<h1>infercam_onnx_tpu_torch</h1><p>{topo}</p>"
            f"{body}"
            "<p><a href='/stats'>stats</a> · "
            "<a href='/metrics'>metrics</a> · "
            "<a href='/healthcheck'>healthcheck</a></p>"
            "</body></html>")
        return page.encode()

    async def _stream(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter, sub, tick,
                      headers: bytes = _MJPEG_HEADERS) -> None:
        writer.write(headers)
        # watch the read side so a client disconnect ends the stream even
        # while no parts flow (a prompt unsubscribe is what stops the
        # router inferring for a viewer that left)
        disconnect = asyncio.ensure_future(reader.read(1024))
        recv = None
        try:
            with sub:
                while True:
                    recv = asyncio.ensure_future(sub.receive())
                    done, _ = await asyncio.wait(
                        {recv, disconnect},
                        return_when=asyncio.FIRST_COMPLETED)
                    if disconnect in done:
                        # retrieve a reset's exception, or it is logged
                        # at GC for every viewer that dropped abruptly
                        disconnect.exception()
                        recv.cancel()
                        break
                    part = recv.result()
                    tick()
                    writer.write(part)
                    await writer.drain()
        except (ConnectionError, BrokenPipeError, asyncio.CancelledError):
            pass
        finally:
            for t in (disconnect, recv):
                if t is not None:
                    t.cancel()
                    if t.done() and not t.cancelled():
                        t.exception()  # retrieve, don't warn at GC
