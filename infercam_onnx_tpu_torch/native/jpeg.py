"""The port's native JPEG shim, bound with ctypes and built at first use.

``csrc/jpeg_shim.cpp`` is the port's copy of the JAX package's shim, with
the same C ABI. `build` compiles it with g++ into ``build/native/`` beside
the package, under a name keyed by a hash of the source and the build
command, and `load` loads it once per process. Each process compiles
under a temporary name of its own and renames the result into place, so
concurrent first uses never load a half-written file. A failed build
raises; nothing falls back to PIL.

libjpeg (the jpeg62 ABI or any other the headers name): the headers on
the compiler's path where it has ``jpeglib.h``, else the libjpeg-turbo
2.1.5 headers copied into ``csrc/include/``; the library the linker finds
as ``libjpeg``, else Pillow's bundled ``pillow.libs/libjpeg-*.so.62*``,
linked by full path with an rpath. A header/library version mismatch makes
every ``jpeg_Create*`` call fail through the shim's error handler, which
would show only as "corrupt" frames, so `load` refuses a library that
fails one encode + decode round trip.

The batch decodes run on a ``std::thread`` pool of ``DEFAULT_THREADS``,
and each ctypes call releases the GIL while it runs. The coefficient side
(`NativeJpeg.read_coefficients`, `quant_tables`, `encode_coefs`) is the
host half of the coefficients decode mode and of the device annotate tail:
entropy decoding in, entropy coding out.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import glob
import hashlib
import logging
import os
import pathlib
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "jpeg_shim.cpp"
BUNDLED_INCLUDE = _HERE / "csrc" / "include"
BUILD_DIR = _HERE.parent.parent / "build" / "native"

# Largest decoded frame a header may claim: 4K RGB (3840*2160*3, ~24 MB).
MAX_FRAME_BYTES = 3840 * 2160 * 3
DEFAULT_THREADS = min(16, os.cpu_count() or 4)
_SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


def _header_macros(include: list[str]) -> dict[str, str] | None:
    """The macros ``jpeglib.h`` defines with these include flags, or None
    where the compiler does not find it."""
    proc = subprocess.run(
        ["g++", "-E", "-dM", "-x", "c++", *include, "-"],
        input="#include <cstdio>\n#include <jpeglib.h>\n",
        capture_output=True, text=True)
    if proc.returncode != 0:
        return None
    return {parts[1]: parts[2] for parts in
            (line.split(None, 2) for line in proc.stdout.splitlines())
            if len(parts) == 3 and parts[0] == "#define"}


def _library() -> tuple[list[str], str]:
    """The link flags for libjpeg, and the library they name."""
    name = ctypes.util.find_library("jpeg")
    if name:
        return [f"-l:{name}"], name
    import PIL

    bundled = sorted(glob.glob(os.path.join(
        os.path.dirname(PIL.__file__), os.pardir, "pillow.libs",
        "libjpeg-*.so.62*")))
    if not bundled:
        raise RuntimeError("no libjpeg to link: neither the linker's "
                           "libjpeg nor Pillow's bundled libjpeg was found")
    path = os.path.realpath(bundled[0])
    return [path, f"-Wl,-rpath,{os.path.dirname(path)}"], path


def build() -> tuple[pathlib.Path, dict]:
    """Compile the shim unless its library exists; returns its path and
    what it was built against."""
    include: list[str] = []
    macros = _header_macros(include)
    if macros is None:
        include = ["-I", str(BUNDLED_INCLUDE)]
        macros = _header_macros(include)
        if macros is None:
            raise RuntimeError(f"g++ finds no jpeglib.h, not even in "
                               f"{BUNDLED_INCLUDE}")
    link, library = _library()
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", *include]
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        flags + link).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libjpeg_shim_{digest}.so"
    info = {
        "library": library,
        "headers": "bundled" if include else "system",
        "jpeg_lib_version": int(macros["JPEG_LIB_VERSION"]),
        "libjpeg_turbo_version": macros.get("LIBJPEG_TURBO_VERSION"),
        "path": str(out),
    }
    if out.is_file():
        return out, info
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *flags, str(SOURCE), "-o", str(tmp), *link]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed to build the JPEG shim (rc {proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)  # atomic: no process loads a half-written file
    finally:
        tmp.unlink(missing_ok=True)
    return out, info


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i16(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _u16(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


class NativeJpeg:
    """The loaded shim. ``info`` says what it was built against, and the
    thread count of its batch decodes."""

    def __init__(self, lib: ctypes.CDLL, info: dict):
        self._lib = lib
        self.info = {**info, "threads": DEFAULT_THREADS,
                     "cpu_count": os.cpu_count()}
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ic_jpeg_decode_rgb_scaled.restype = ctypes.c_int
        lib.ic_jpeg_decode_rgb_scaled.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, u8p, ctypes.c_int64, i32p, i32p,
            ctypes.c_int32]
        lib.ic_jpeg_probe_scaled.restype = ctypes.c_int
        lib.ic_jpeg_probe_scaled.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, i32p, i32p, ctypes.c_int32]
        lib.ic_jpeg_encode_rgb.restype = ctypes.c_int64
        lib.ic_jpeg_encode_rgb.argtypes = [
            u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, u8p, ctypes.c_int64]
        lib.ic_jpeg_decode_batch.restype = None
        lib.ic_jpeg_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, u8p, ctypes.c_int64, i32p, i32p, i32p,
            ctypes.c_int32, ctypes.c_int32]
        lib.ic_jpeg_decode_ycbcr_batch.restype = None
        lib.ic_jpeg_decode_ycbcr_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, u8p, ctypes.c_int64, i32p, i32p, ctypes.c_int32,
            ctypes.c_int32]
        i16p = ctypes.POINTER(ctypes.c_int16)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.ic_jpeg_read_coefs.restype = ctypes.c_int
        lib.ic_jpeg_read_coefs.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, i16p, i16p, i16p,
            ctypes.c_int64, u16p, i32p]
        lib.ic_jpeg_quant_tables.restype = ctypes.c_int
        lib.ic_jpeg_quant_tables.argtypes = [ctypes.c_int32, u16p]
        lib.ic_jpeg_write_coefs.restype = ctypes.c_int64
        lib.ic_jpeg_write_coefs.argtypes = [
            i16p, i16p, i16p, *([ctypes.c_int32] * 8), u16p, u8p,
            ctypes.c_int64]

    @staticmethod
    def _check_claimed_dims(w: int, h: int, slot: int | None = None,
                            limit: int = MAX_FRAME_BYTES) -> None:
        """Reject a frame whose HEADER claims more than ``limit`` bytes.

        A 2 KB JPEG whose SOF marker claims 65500x65500 passes the 8 MiB
        wire cap (protocol.py) but would drive a ~12.9 GB allocation per
        batch slot. ValueError keeps the drop-not-die contract: the
        serving worker drops it as a corrupt frame."""
        if w * h * 3 > limit:
            where = "" if slot is None else f" in batch slot {slot}"
            raise ValueError(f"frame too large{where}: {w}x{h}")

    def probe(self, data: bytes, scale: int = 1) -> tuple[int, int]:
        w, h = ctypes.c_int32(), ctypes.c_int32()
        rc = self._lib.ic_jpeg_probe_scaled(data, len(data), ctypes.byref(w),
                                            ctypes.byref(h), scale)
        if rc != 0:
            raise ValueError("corrupt JPEG (probe failed)")
        return w.value, h.value

    def decode_rgb(self, data: bytes, scale: int = 1) -> np.ndarray:
        """JPEG bytes -> [H, W, 3] uint8 RGB at 1/``scale`` resolution."""
        w, h = self.probe(data, scale)
        self._check_claimed_dims(w, h)
        need = w * h * 3
        out = np.empty(need, np.uint8)
        ow, oh = ctypes.c_int32(), ctypes.c_int32()
        rc = self._lib.ic_jpeg_decode_rgb_scaled(
            data, len(data), _u8(out), need, ctypes.byref(ow),
            ctypes.byref(oh), scale)
        if rc != 0:
            raise ValueError(f"corrupt JPEG (decode rc={rc})")
        return out.reshape(oh.value, ow.value, 3)

    def decode_batch(self, datas: list[bytes], threads: int | None = None,
                     scale: int = 1) -> list[np.ndarray]:
        """Decode many JPEGs on the shim's thread pool; ValueError if any
        of them is corrupt or claims too large a frame."""
        n = len(datas)
        if n == 0:
            return []
        # probe sizes first so each slot gets a right-sized buffer
        dims = [self.probe(d, scale) for d in datas]
        for i, (w, h) in enumerate(dims):
            self._check_claimed_dims(w, h, i)
        max_bytes = max(w * h * 3 for w, h in dims)
        bufs = np.empty((n, max_bytes), np.uint8)
        ow, oh, st = ((ctypes.c_int32 * n)() for _ in range(3))
        self._lib.ic_jpeg_decode_batch(
            (ctypes.c_char_p * n)(*datas),
            (ctypes.c_int64 * n)(*[len(d) for d in datas]), n, _u8(bufs),
            max_bytes, ow, oh, st, threads or DEFAULT_THREADS, scale)
        out = []
        for i in range(n):
            if st[i] != 0:
                raise ValueError(f"corrupt JPEG in batch slot {i}")
            w, h = ow[i], oh[i]
            out.append(bufs[i, :w * h * 3].reshape(h, w, 3).copy())
        return out

    def decode_ycbcr_batch(self, datas: list[bytes],
                           threads: int | None = None, scale: int = 1):
        """Raw-plane batch decode: entropy decode and (scaled) IDCT on the
        host, no chroma upsampling and no colour conversion.

        Returns ``(packed [B, n] uint8, geom)``. Each row is
        ``Y[y_ph][y_pw] ++ Cb[c_ph][c_pw] ++ Cr[c_ph][c_pw]`` (iMCU-padded
        plane dims) and ``geom = dict(width, height, y_pw, y_ph, c_pw,
        c_ph, sampling)``; ``ops/jpeg_device.py`` does the rest on the
        device. At 4:2:0 a row is about 1.5 bytes a pixel against 3 for
        RGB, and the batch is one host->device copy. All frames must share
        one geometry, else ValueError("mixed JPEG geometries in batch").
        ``threads`` sizes the shim's pool for the call, as in
        `decode_batch`."""
        n = len(datas)
        if n == 0:
            raise ValueError("empty batch")
        # Every slot is probed and clamped here, so a crafted header is
        # refused the same way in every slot. The clamp is twice the RGB
        # budget, sized to this path's allocation: a real 12 MP 4:2:0
        # frame still decodes, a claimed 65500x65500 does not.
        dims_py = [self.probe(d, scale) for d in datas]
        for i, (w, h) in enumerate(dims_py):
            self._check_claimed_dims(w, h, i, limit=2 * MAX_FRAME_BYTES)
        w0, h0 = dims_py[0]
        # padded planes are at most (dim + 2 iMCU) wide; zeros, so the
        # padding rows libjpeg leaves unwritten hold no stale memory
        max_each = 3 * (w0 + 32) * (h0 + 32)
        bufs = np.zeros((n, max_each), np.uint8)
        dims = (ctypes.c_int32 * (8 * n))()
        st = (ctypes.c_int32 * n)()
        self._lib.ic_jpeg_decode_ycbcr_batch(
            (ctypes.c_char_p * n)(*datas),
            (ctypes.c_int64 * n)(*[len(d) for d in datas]), n, _u8(bufs),
            max_each, dims, st, threads or DEFAULT_THREADS, scale)
        geom0 = tuple(dims[0:8])
        for i in range(n):
            if st[i] != 0:
                raise ValueError(
                    f"YCbCr decode failed in batch slot {i} (rc={st[i]})")
            if tuple(dims[8 * i:8 * i + 8]) != geom0:
                raise ValueError("mixed JPEG geometries in batch")
        # on scaled 4:2:0 decodes the shim folds chroma back to half
        # resolution in place; the dims already describe the folded planes
        w, h, y_pw, y_ph, c_pw, c_ph, hs, vs = geom0
        used = y_pw * y_ph + 2 * c_pw * c_ph
        return bufs[:, :used], {
            "width": w, "height": h, "y_pw": y_pw, "y_ph": y_ph,
            "c_pw": c_pw, "c_ph": c_ph, "sampling": (hs, vs),
        }

    def encode_rgb(self, frame: np.ndarray, quality: int = 95,
                   subsampling: str = "420") -> bytes:
        """[H, W, 3] uint8 RGB -> JPEG bytes."""
        frame = np.ascontiguousarray(frame, np.uint8)
        h, w, c = frame.shape
        if c != 3:
            raise ValueError(f"want [H, W, 3] RGB, got {frame.shape}")
        cap = w * h * 3 + (1 << 16)
        for _ in range(3):
            out = np.empty(cap, np.uint8)
            n = self._lib.ic_jpeg_encode_rgb(
                _u8(frame), w, h, quality, _SUBSAMPLING[subsampling],
                _u8(out), cap)
            if n != -2:
                break
            cap *= 4  # worst-case Huffman output outgrew the buffer
        if n < 0:
            raise ValueError(f"JPEG encode failed (rc={n})")
        return out[:n].tobytes()

    def read_coefficients(self, data: bytes):
        """Entropy decode only: the quantized DCT blocks and quant tables.

        Returns ``(y [bh, bw, 64] int16, cb, cr, quant [3, 64] uint16,
        (width, height), (h_samp, v_samp))``, blocks and tables in natural
        order; ``ops/jpeg_device.py`` does the rest on the device.
        ValueError on a corrupt JPEG or one that is not 3-component YCbCr at
        4:2:0, 4:2:2 or 4:4:4."""
        # room for the blocks of a frame up to 4K
        max_each = (3840 // 8 + 2) * (2160 // 8 + 2) * 64
        planes = [np.empty(max_each, np.int16) for _ in range(3)]
        quant = np.empty(3 * 64, np.uint16)
        dims = (ctypes.c_int32 * 8)()
        rc = self._lib.ic_jpeg_read_coefs(
            data, len(data), *(_i16(p) for p in planes), max_each,
            _u16(quant), dims)
        if rc == -3:
            raise ValueError("unsupported JPEG layout for coefficient export "
                             "(need 3-component YCbCr 4:2:0/4:2:2/4:4:4)")
        if rc != 0:
            raise ValueError(f"corrupt JPEG (coef rc={rc})")
        w, h, ybw, ybh, cbw, cbh, hs, vs = dims
        y, cb, cr = planes
        return (y[:ybh * ybw * 64].reshape(ybh, ybw, 64).copy(),
                cb[:cbh * cbw * 64].reshape(cbh, cbw, 64).copy(),
                cr[:cbh * cbw * 64].reshape(cbh, cbw, 64).copy(),
                quant.reshape(3, 64), (w, h), (hs, vs))

    def quant_tables(self, quality: int) -> np.ndarray:
        """[2, 64] uint16 quant tables (luma, chroma) in natural order:
        libjpeg's baseline tables at this quality. The device encode tail
        quantizes with them, and `encode_coefs` embeds them verbatim."""
        out = np.empty(2 * 64, np.uint16)
        rc = self._lib.ic_jpeg_quant_tables(quality, _u16(out))
        if rc != 0:
            raise ValueError(f"quant table export failed (rc={rc})")
        return out.reshape(2, 64)

    def encode_coefs(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                     wh: tuple[int, int], sampling: tuple[int, int],
                     quant: np.ndarray) -> bytes:
        """Entropy-code quantized DCT blocks into a baseline JPEG.

        ``y``, ``cb``, ``cr``: [bh, bw, 64] int16 blocks in natural order
        (iMCU-padded dims are accepted: the device tail emits them);
        ``quant``: [2, 64] natural-order tables (`quant_tables`, or a
        stream's own). This is the only host work of the device-annotated
        output."""
        w, h = wh
        hs, vs = sampling
        y, cb, cr = (np.ascontiguousarray(p, np.int16) for p in (y, cb, cr))
        quant = np.ascontiguousarray(quant, np.uint16)
        # dense high-frequency blocks plus byte stuffing can outgrow 3 B/px
        cap = w * h * 3 + (1 << 16)
        for _ in range(3):
            out = np.empty(cap, np.uint8)
            n = self._lib.ic_jpeg_write_coefs(
                _i16(y), _i16(cb), _i16(cr), y.shape[1], y.shape[0],
                cb.shape[1], cb.shape[0], w, h, hs, vs, _u16(quant), _u8(out),
                cap)
            if n != -2:
                break
            cap *= 4  # worst-case Huffman output outgrew the buffer
        if n < 0:
            raise ValueError(f"coefficient JPEG encode failed (rc={n})")
        return out[:n].tobytes()

    def check_round_trip(self) -> None:
        """Encode and decode one small frame; RuntimeError if libjpeg
        refuses (a header/library version mismatch) or garbles it."""
        frame = np.full((16, 16, 3), 128, np.uint8)
        try:
            back = self.decode_rgb(self.encode_rgb(frame, 90, "444"))
        except ValueError as e:
            raise RuntimeError(
                f"libjpeg {self.info['library']} failed a round trip with "
                f"the shim built against JPEG_LIB_VERSION "
                f"{self.info['jpeg_lib_version']} headers: {e}") from e
        if back.shape != frame.shape or np.abs(
                back.astype(np.int16) - 128).max() > 2:
            raise RuntimeError(f"libjpeg {self.info['library']} garbled a "
                               f"round trip")


_instance: NativeJpeg | None = None
_lock = threading.Lock()


def load() -> NativeJpeg:
    """Build (once), load and check the shim; raises on any failure."""
    global _instance
    with _lock:
        if _instance is None:
            path, info = build()
            native = NativeJpeg(ctypes.CDLL(str(path)), info)
            native.check_round_trip()
            log.info("native JPEG shim: %s", native.info)
            _instance = native
        return _instance


@functools.lru_cache(maxsize=16)
def quant_tables_cached(quality: int) -> np.ndarray:
    """`NativeJpeg.quant_tables` of the loaded shim, once per quality per
    process: the tables the device encode tail and the host entropy coder
    share. Callers must not write to the array."""
    return load().quant_tables(quality)
