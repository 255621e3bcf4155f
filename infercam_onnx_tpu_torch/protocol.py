"""Wire protocol for the data socket — byte-compatible with the reference.

The reference frames bincode-serialized ``ProtoMsg`` values with tokio's
``LengthDelimitedCodec`` (reference cam_sender/src/bin/socket_sender.rs:68,
infer_server/src/data_socket.rs:38; message enum at
common/src/protocol.rs:6-17). A sender built against the reference must be
able to talk to this server unchanged, so both layers are reproduced at
byte level:

- **bincode 1.x default config** (little-endian, fixed-width ints, u64
  length prefixes): enum = u32 variant tag (ConnectReq = 0, FrameMsg = 1);
  String / Vec<u8> = u64 length + raw bytes.
- **LengthDelimitedCodec default config**: each frame is prefixed with a
  u32 big-endian payload length (not counting the prefix itself), max
  frame size 8 MiB.

The port's own copy of ``infercam_onnx_tpu/protocol.py``;
tests/test_torch_port_serving.py holds the two byte-equal.
"""

from __future__ import annotations

import dataclasses
import struct

MAX_FRAME_LEN = 8 * 1024 * 1024  # tokio LengthDelimitedCodec default

CONNECT_REQ_TAG = 0
FRAME_MSG_TAG = 1


@dataclasses.dataclass(frozen=True)
class ConnectReq:
    """Initial message a sender emits (reference socket_sender.rs:71-74).
    The reference server accepts and ignores it (routing is purely by
    FrameMsg.id, reference router.rs:56-58) — preserved behavior."""

    channel: str


@dataclasses.dataclass(frozen=True)
class FrameMsg:
    """One JPEG frame on a named stream (reference protocol.rs:14-17)."""

    id: str
    data: bytes


ProtoMsg = ConnectReq | FrameMsg


def _bincode_bytes(data: bytes) -> bytes:
    return struct.pack("<Q", len(data)) + data


def encode_proto_msg(msg: ProtoMsg) -> bytes:
    """ProtoMsg -> bincode bytes (not yet length-framed)."""
    if isinstance(msg, ConnectReq):
        return struct.pack("<I", CONNECT_REQ_TAG) + _bincode_bytes(
            msg.channel.encode("utf-8"))
    if isinstance(msg, FrameMsg):
        return (struct.pack("<I", FRAME_MSG_TAG)
                + _bincode_bytes(msg.id.encode("utf-8"))
                + _bincode_bytes(msg.data))
    raise TypeError(f"not a ProtoMsg: {msg!r}")


def decode_proto_msg(buf: bytes) -> ProtoMsg | None:
    """bincode bytes -> ProtoMsg, or None on malformed input.

    The reference silently skips frames that fail to deserialize
    (reference router.rs:56 ``if let Ok(...)``); returning None lets the
    router do the same. Trailing bytes after a fully parsed message are
    accepted and ignored, matching bincode 1.x legacy ``deserialize``
    (AllowTrailing, used by reference router.rs:56).
    """
    try:
        if len(buf) < 4:
            return None
        (tag,) = struct.unpack_from("<I", buf, 0)
        pos = 4
        if tag == CONNECT_REQ_TAG:
            (n,) = struct.unpack_from("<Q", buf, pos)
            pos += 8
            if pos + n > len(buf):
                return None
            return ConnectReq(buf[pos:pos + n].decode("utf-8"))
        if tag == FRAME_MSG_TAG:
            (n,) = struct.unpack_from("<Q", buf, pos)
            pos += 8
            if pos + n > len(buf):
                return None
            ident = buf[pos:pos + n].decode("utf-8")
            pos += n
            (m,) = struct.unpack_from("<Q", buf, pos)
            pos += 8
            if pos + m > len(buf):
                return None
            return FrameMsg(ident, bytes(buf[pos:pos + m]))
        return None
    except (struct.error, UnicodeDecodeError):
        return None


def frame_encode(payload: bytes) -> bytes:
    """Length-delimited framing: u32 BE length + payload."""
    if len(payload) > MAX_FRAME_LEN:
        raise ValueError(f"frame too large: {len(payload)}")
    return struct.pack(">I", len(payload)) + payload


class FrameDecoder:
    """Incremental length-delimited frame reassembly (server side)."""

    def __init__(self, max_frame_len: int = MAX_FRAME_LEN):
        self._buf = bytearray()
        self._max = max_frame_len

    def feed(self, data: bytes) -> list[bytes]:
        """Append received bytes; return all complete frames."""
        self._buf.extend(data)
        out: list[bytes] = []
        while True:
            if len(self._buf) < 4:
                break
            (n,) = struct.unpack_from(">I", self._buf, 0)
            if n > self._max:
                raise ValueError(f"frame length {n} exceeds max {self._max}")
            if len(self._buf) < 4 + n:
                break
            out.append(bytes(self._buf[4:4 + n]))
            del self._buf[:4 + n]
        return out


async def read_frame(reader, max_frame_len: int = MAX_FRAME_LEN) -> bytes:
    """Read one length-delimited frame from an asyncio StreamReader.
    Raises IncompleteReadError at EOF."""
    header = await reader.readexactly(4)
    (n,) = struct.unpack(">I", header)
    if n > max_frame_len:
        raise ValueError(f"frame length {n} exceeds max {max_frame_len}")
    return await reader.readexactly(n)


# MJPEG part framing (reference infer_server/src/lib.rs:48-57)
MJPEG_BOUNDARY = b"frame"
_MJPEG_HEADER = b"--frame\r\nContent-Type: image/jpeg\r\n\r\n"
_MJPEG_TRAILER = b"\r\n\r\n"


def as_jpeg_stream_item(data: bytes) -> bytes:
    """Wrap JPEG bytes as one multipart/x-mixed-replace part."""
    return _MJPEG_HEADER + data + _MJPEG_TRAILER
