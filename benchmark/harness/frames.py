"""The cameras' frames, made from the run's seed.

Each stream is one camera on a scene of its own: a random scene whose
brightness is three octaves of value noise and whose colour is two smooth
octaves (a camera's chroma carries little fine detail), at a contrast at
which few pixels clip. Each frame of a stream carries sensor noise drawn
anew, cycling through ``variants`` draws (frame ``j`` shows draw
``j % variants``), so the detections of a stream's consecutive frames
differ and a published record tells which of them it answers (the
``/detections`` payload carries no frame id; `harness.cell.judge` pairs
records with frames). Every frame is JPEG-coded at the traffic's quality
with 4:2:0 chroma, so its size and decode cost are those of a camera
frame, and carries its index in a comment segment, so no two frames of a
run have the same bytes. Both the load generator and the reference make
the same bytes from the same seed.
"""

from __future__ import annotations

import io
import struct

import numpy as np
from PIL import Image

# (cells across the frame, amplitude) of each octave of brightness and
# of colour
LUMA_OCTAVES = ((4, 36.0), (16, 18.0), (64, 10.0))
CHROMA_OCTAVES = ((4, 16.0), (16, 6.0))
SENSOR_NOISE = 4.0


def _octaves(rng, octaves, width: int, height: int,
             channels: int) -> np.ndarray:
    out = np.zeros((height, width, channels), np.float32)
    for cells, amp in octaves:
        small = rng.standard_normal(
            (max(2, cells * height // width), cells, channels),
            np.float32) * amp
        for c in range(channels):
            out[:, :, c] += np.asarray(Image.fromarray(
                small[:, :, c], mode="F").resize((width, height),
                                                 Image.BICUBIC))
    return out


def pictures(seed: int, stream: int, variants: int, width: int,
             height: int) -> list[np.ndarray]:
    """[height, width, 3] uint8 frames of stream ``stream`` of ``seed``,
    one per sensor-noise draw."""
    rng = np.random.default_rng([seed % (2 ** 63), stream])
    luma = 128.0 + _octaves(rng, LUMA_OCTAVES, width, height, 1)
    chroma = _octaves(rng, CHROMA_OCTAVES, width, height, 2)
    cb, cr = chroma[:, :, :1], chroma[:, :, 1:]
    out = []
    for v in range(variants):
        noise = np.random.default_rng([seed % (2 ** 63), stream, v + 1])
        y = luma + noise.standard_normal((height, width, 1),
                                         np.float32) * SENSOR_NOISE
        rgb = np.concatenate([y + 1.402 * cr, y - 0.344 * cb - 0.714 * cr,
                              y + 1.772 * cb], axis=-1)
        out.append(np.clip(rgb, 0, 255).astype(np.uint8))
    return out


def jpeg(rgb: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=quality, subsampling=2)
    return buf.getvalue()


def stream_jpegs(traffic: dict, seed: int) -> list[list[bytes]]:
    """``[stream][variant]`` JPEGs of the traffic mix."""
    w, h = traffic["frame_width"], traffic["frame_height"]
    return [[jpeg(p, traffic["jpeg_quality"])
             for p in pictures(seed, k, traffic["variants"], w, h)]
            for k in range(traffic["streams"])]


def numbered(data: bytes, index: int) -> bytes:
    """The JPEG ``data`` with a comment segment holding ``index`` after
    its start-of-image marker; decoders skip it."""
    text = b"frame %d" % index
    return (data[:2] + b"\xff\xfe" + struct.pack(">H", len(text) + 2)
            + text + data[2:])
