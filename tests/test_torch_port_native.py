"""The port's native JPEG shim against the JAX package's.

Both shims are built from the same C++ (the port's copy keeps the C ABI)
against the same libjpeg here, so every decode must be bit-equal, with
the same geometry, and every encode byte-equal: RGB decode, batched RGB
decode and batched packed-YCbCr decode for 4:2:0, 4:2:2 and 4:4:4, at IDCT
scales 1, 2, 4 and 8, at 640x480, 333x251 and 130x97. The errors are
ported too, and the build: it lands under ``build/native/``, is reused,
raises when it fails (no PIL fallback), and builds with the headers
copied into the port against Pillow's bundled libjpeg, the way it builds
where the system has no libjpeg headers.
"""

import ctypes.util
import pathlib

import numpy as np
import pytest

from infercam_onnx_tpu.native import jpeg as jnative
from infercam_onnx_tpu_torch import codec
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZES = [(640, 480), (333, 251), (130, 97)]


def smooth_jpeg(seed: int, w: int, h: int, subsampling: str,
                quality: int = 90) -> bytes:
    """A JPEG of smooth colour waves plus noise, made from ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([127 + 120 * np.sin(xx / 9.0) * np.cos(yy / 7.0),
                     127 + 120 * np.cos(xx / 13.0),
                     127 + 120 * np.sin((xx + yy) / 11.0)], axis=-1)
    img = np.clip(base + rng.normal(0, 12, size=(h, w, 3)), 0, 255)
    return jnative.load().encode_rgb(img.astype(np.uint8), quality,
                                     subsampling)


def _visible(packed, geom):
    """The planes of a packed batch, cropped to the frame and its chroma
    share: what the device's colour pass reads."""
    w, h, (hs, vs) = geom["width"], geom["height"], geom["sampling"]
    ysz, csz = geom["y_pw"] * geom["y_ph"], geom["c_pw"] * geom["c_ph"]
    b = packed.shape[0]
    y = packed[:, :ysz].reshape(b, geom["y_ph"], geom["y_pw"])
    cb, cr = (packed[:, ysz + i * csz:ysz + (i + 1) * csz].reshape(
        b, geom["c_ph"], geom["c_pw"]) for i in (0, 1))
    ch, cw = -(-h // vs), -(-w // hs)
    return y[:, :h, :w], cb[:, :ch, :cw], cr[:, :ch, :cw]


@pytest.fixture(scope="module")
def port():
    return native_jpeg.load()


@pytest.fixture(scope="module")
def jax_shim():
    return jnative.load()


@pytest.mark.parametrize("scale", [1, 2, 4, 8])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sub", ["420", "422", "444"])
def test_decodes_bit_equal_jax(port, jax_shim, sub, size, scale):
    datas = [smooth_jpeg(seed, *size, sub) for seed in range(3)]
    got = port.decode_rgb(datas[0], scale)
    want = jax_shim.decode_rgb(datas[0], scale)
    assert got.shape == want.shape == (
        -(-size[1] // scale), -(-size[0] // scale), 3)
    np.testing.assert_array_equal(got, want)
    assert port.probe(datas[0], scale) == jax_shim.probe(datas[0], scale)
    for g, w in zip(port.decode_batch(datas, scale=scale),
                    jax_shim.decode_batch(datas, scale=scale)):
        np.testing.assert_array_equal(g, w)
    packed, geom = port.decode_ycbcr_batch(datas, scale=scale)
    want_packed, want_geom = jax_shim.decode_ycbcr_batch(datas, scale=scale)
    assert geom == want_geom
    assert packed.dtype == np.uint8 and packed.shape == want_packed.shape
    for g, w in zip(_visible(packed, geom), _visible(want_packed, geom)):
        np.testing.assert_array_equal(g, w)
    # the block rows libjpeg leaves unwritten in the iMCU padding are
    # zeros in the port, uninitialised memory in the JAX package
    np.testing.assert_array_equal(
        port.decode_ycbcr_batch(datas, scale=scale)[0], packed)
    assert packed.shape[1] == (geom["y_pw"] * geom["y_ph"]
                               + 2 * geom["c_pw"] * geom["c_ph"])
    # the chroma planes cover their share of the frame
    hs, vs = geom["sampling"]
    assert geom["c_pw"] >= -(-geom["width"] // hs)
    assert geom["c_ph"] >= -(-geom["height"] // vs)


@pytest.mark.parametrize("quality, sub", [(95, "420"), (80, "422"),
                                          (60, "444")])
def test_encode_rgb_bytes_equal_jax(port, jax_shim, quality, sub):
    rng = np.random.default_rng(quality)
    for frame in (rng.integers(0, 256, size=(251, 333, 3), dtype=np.uint8),
                  port.decode_rgb(smooth_jpeg(9, 640, 480, "420"))):
        got = port.encode_rgb(frame, quality, sub)
        assert got == jax_shim.encode_rgb(frame, quality, sub)
        assert got == codec.encode_rgb(frame, quality, sub)


def test_corrupt_bytes_raise_value_error(port):
    good = smooth_jpeg(0, 130, 97, "420")
    for bad in (b"", b"\xff\xd8 this is not a jpeg", good[:40]):
        with pytest.raises(ValueError):
            port.decode_rgb(bad)
        with pytest.raises(ValueError):
            port.decode_batch([good, bad])
        with pytest.raises(ValueError):
            port.decode_ycbcr_batch([good, bad])
    with pytest.raises(ValueError, match="empty"):
        port.decode_ycbcr_batch([])
    assert port.decode_batch([]) == []


def test_mixed_geometries_raise(port):
    a = smooth_jpeg(0, 128, 96, "420")
    for b in (smooth_jpeg(1, 64, 96, "420"), smooth_jpeg(1, 128, 96, "444")):
        with pytest.raises(ValueError, match="mixed JPEG geometries"):
            port.decode_ycbcr_batch([a, b])
    # the RGB batch decode takes frames of any size
    assert [f.shape for f in port.decode_batch(
        [a, smooth_jpeg(1, 64, 96, "420")])] == [(96, 128, 3), (96, 64, 3)]


def test_huge_claimed_dims_rejected_not_allocated(port):
    """A small JPEG whose SOF header claims 65500x65500 raises ValueError
    (the serving worker drops it) instead of driving a ~12.9 GB
    allocation; in slot 0 the clamp names it, in slot 1 too. The packed
    path's clamp is twice the RGB budget, so a real 12 MP 4:2:0 frame
    still decodes there."""
    data = bytearray(smooth_jpeg(0, 128, 96, "420"))
    i = data.find(b"\xff\xc0")  # SOF0: FF C0 len(2) precision(1) H(2) W(2)
    assert i > 0
    data[i + 5:i + 9] = (65500).to_bytes(2, "big") * 2
    huge = bytes(data)
    good = smooth_jpeg(1, 128, 96, "420")
    with pytest.raises(ValueError, match="too large"):
        port.decode_rgb(huge)
    with pytest.raises(ValueError, match="too large in batch slot 1"):
        port.decode_batch([good, huge])
    with pytest.raises(ValueError, match="too large in batch slot 0"):
        port.decode_ycbcr_batch([huge])
    with pytest.raises(ValueError):
        port.decode_ycbcr_batch([good, huge])
    big = port.encode_rgb(np.full((3024, 4032, 3), 128, np.uint8), 85, "420")
    _, geom = port.decode_ycbcr_batch([big])
    assert (geom["width"], geom["height"]) == (4032, 3024)
    with pytest.raises(ValueError, match="too large"):
        port.decode_rgb(big)


def test_build_lands_under_build_and_is_reused(port):
    path, info = native_jpeg.build()
    assert path.parent == REPO / "build" / "native"
    assert path.is_file() and str(path) == port.info["path"]
    mtime = path.stat().st_mtime_ns
    again, _ = native_jpeg.build()
    assert again == path and path.stat().st_mtime_ns == mtime
    assert native_jpeg.load() is port
    assert info["jpeg_lib_version"] >= 62
    assert port.info["threads"] == min(16, port.info["cpu_count"])


def test_failed_build_raises_and_codec_does_not_fall_back(tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "jpeg_shim.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_jpeg, "SOURCE", bad)
    monkeypatch.setattr(native_jpeg, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native_jpeg, "_instance", None)
    data = smooth_jpeg(0, 64, 48, "420")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_jpeg.build()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        codec.decode_rgb(data)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        codec.decode_batch([data])
    assert list((tmp_path / "native").iterdir()) == []  # no temporary left


def test_builds_with_the_bundled_headers_against_pillows_libjpeg(
        tmp_path, monkeypatch):
    """Where the compiler finds no jpeglib.h and the linker no libjpeg,
    the shim builds against the headers in csrc/include/ and Pillow's
    bundled libjpeg, passes its round trip, and decodes as PIL does."""
    real = native_jpeg._header_macros
    monkeypatch.setattr(native_jpeg, "_header_macros",
                        lambda include: real(include) if include else None)
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    monkeypatch.setattr(native_jpeg, "BUILD_DIR", tmp_path)
    path, info = native_jpeg.build()
    assert info["headers"] == "bundled" and info["jpeg_lib_version"] == 62
    assert "pillow.libs" in info["library"]
    shim = native_jpeg.NativeJpeg(ctypes.CDLL(str(path)), info)
    shim.check_round_trip()
    data = smooth_jpeg(2, 333, 251, "420")
    for scale in (1, 2):
        np.testing.assert_array_equal(shim.decode_rgb(data, scale),
                                      codec._pil_decode(data, scale))
