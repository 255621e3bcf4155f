"""V4L2 MJPG webcam capture through raw ioctls (the port's copy of
``infercam_onnx_tpu/client/camera.py``; reference cam_sender/src/sensors.rs).

The reference's rscam path, written directly on the V4L2 kernel ABI with
ctypes (no libv4l):

- enumerate pixel formats and pick MJPG (reference sensors.rs:22-26);
- enumerate discrete frame sizes and pick the largest (reference
  sensors.rs:28-38: max by width; stepwise -> max);
- enumerate frame intervals and pick the highest rate (reference
  sensors.rs:40-50);
- stream through mmap'd kernel buffers (VIDIOC_REQBUFS/QBUF/DQBUF/
  STREAMON), yielding raw MJPEG frames.

The structs follow the x86_64 ABI of linux/videodev2.h. ``Capturable`` is
the test seam the reference models with its trait (reference
sensors.rs:70-72); ``FakeCamera`` is a committed fake. No torch here: the
edge sender needs none.
"""

from __future__ import annotations

import ctypes
import fcntl
import mmap
import os
import select
from typing import Iterator, Protocol

# ---------------------------------------------------------------------------
# V4L2 ABI (from linux/videodev2.h)
# ---------------------------------------------------------------------------

_IOC_NRBITS, _IOC_TYPEBITS, _IOC_SIZEBITS = 8, 8, 14
_IOC_NRSHIFT = 0
_IOC_TYPESHIFT = _IOC_NRSHIFT + _IOC_NRBITS
_IOC_SIZESHIFT = _IOC_TYPESHIFT + _IOC_TYPEBITS
_IOC_DIRSHIFT = _IOC_SIZESHIFT + _IOC_SIZEBITS
_IOC_WRITE, _IOC_READ = 1, 2


def _iowr(type_: str, nr: int, size: int) -> int:
    return ((_IOC_READ | _IOC_WRITE) << _IOC_DIRSHIFT
            | ord(type_) << _IOC_TYPESHIFT
            | nr << _IOC_NRSHIFT | size << _IOC_SIZESHIFT)


def _iow(type_: str, nr: int, size: int) -> int:
    return (_IOC_WRITE << _IOC_DIRSHIFT
            | ord(type_) << _IOC_TYPESHIFT
            | nr << _IOC_NRSHIFT | size << _IOC_SIZESHIFT)


V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1
V4L2_PIX_FMT_MJPEG = 0x47504A4D  # 'MJPG'
V4L2_FRMSIZE_TYPE_DISCRETE = 1
V4L2_FRMIVAL_TYPE_DISCRETE = 1


class v4l2_fmtdesc(ctypes.Structure):
    _fields_ = [
        ("index", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("description", ctypes.c_char * 32),
        ("pixelformat", ctypes.c_uint32),
        ("mbus_code", ctypes.c_uint32),
        ("reserved", ctypes.c_uint32 * 3),
    ]


class _frmsize_discrete(ctypes.Structure):
    _fields_ = [("width", ctypes.c_uint32), ("height", ctypes.c_uint32)]


class _frmsize_stepwise(ctypes.Structure):
    _fields_ = [
        ("min_width", ctypes.c_uint32), ("max_width", ctypes.c_uint32),
        ("step_width", ctypes.c_uint32),
        ("min_height", ctypes.c_uint32), ("max_height", ctypes.c_uint32),
        ("step_height", ctypes.c_uint32),
    ]


class _frmsize_union(ctypes.Union):
    _fields_ = [("discrete", _frmsize_discrete),
                ("stepwise", _frmsize_stepwise)]


class v4l2_frmsizeenum(ctypes.Structure):
    _fields_ = [
        ("index", ctypes.c_uint32),
        ("pixel_format", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("u", _frmsize_union),
        ("reserved", ctypes.c_uint32 * 2),
    ]


class _fract(ctypes.Structure):
    _fields_ = [("numerator", ctypes.c_uint32),
                ("denominator", ctypes.c_uint32)]


class _frmival_stepwise(ctypes.Structure):
    _fields_ = [("min", _fract), ("max", _fract), ("step", _fract)]


class _frmival_union(ctypes.Union):
    _fields_ = [("discrete", _fract), ("stepwise", _frmival_stepwise)]


class v4l2_frmivalenum(ctypes.Structure):
    _fields_ = [
        ("index", ctypes.c_uint32),
        ("pixel_format", ctypes.c_uint32),
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("u", _frmival_union),
        ("reserved", ctypes.c_uint32 * 2),
    ]


class _pix_format(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_uint32), ("height", ctypes.c_uint32),
        ("pixelformat", ctypes.c_uint32), ("field", ctypes.c_uint32),
        ("bytesperline", ctypes.c_uint32), ("sizeimage", ctypes.c_uint32),
        ("colorspace", ctypes.c_uint32), ("priv", ctypes.c_uint32),
        ("flags", ctypes.c_uint32), ("enc", ctypes.c_uint32),
        ("quantization", ctypes.c_uint32), ("xfer_func", ctypes.c_uint32),
    ]


class _fmt_union(ctypes.Union):
    # kernel union contains pointer-bearing members (v4l2_window), forcing
    # 8-byte alignment; _align pins the ctypes layout to match (208 total)
    _fields_ = [("pix", _pix_format), ("raw_data", ctypes.c_uint8 * 200),
                ("_align", ctypes.c_uint64)]


class v4l2_format(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32), ("u", _fmt_union)]


class _captureparm(ctypes.Structure):
    _fields_ = [
        ("capability", ctypes.c_uint32), ("capturemode", ctypes.c_uint32),
        ("timeperframe", _fract), ("extendedmode", ctypes.c_uint32),
        ("readbuffers", ctypes.c_uint32), ("reserved", ctypes.c_uint32 * 4),
    ]


class _parm_union(ctypes.Union):
    _fields_ = [("capture", _captureparm),
                ("raw_data", ctypes.c_uint8 * 200)]


class v4l2_streamparm(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32), ("u", _parm_union)]


class v4l2_requestbuffers(ctypes.Structure):
    _fields_ = [
        ("count", ctypes.c_uint32), ("type", ctypes.c_uint32),
        ("memory", ctypes.c_uint32), ("capabilities", ctypes.c_uint32),
        ("flags", ctypes.c_uint8), ("reserved", ctypes.c_uint8 * 3),
    ]


class _timeval(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_usec", ctypes.c_long)]


class _timecode(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_uint32), ("flags", ctypes.c_uint32),
        ("frames", ctypes.c_uint8), ("seconds", ctypes.c_uint8),
        ("minutes", ctypes.c_uint8), ("hours", ctypes.c_uint8),
        ("userbits", ctypes.c_uint8 * 4),
    ]


class _buf_m_union(ctypes.Union):
    _fields_ = [("offset", ctypes.c_uint32), ("userptr", ctypes.c_ulong),
                ("planes", ctypes.c_void_p), ("fd", ctypes.c_int32)]


class v4l2_buffer(ctypes.Structure):
    _fields_ = [
        ("index", ctypes.c_uint32), ("type", ctypes.c_uint32),
        ("bytesused", ctypes.c_uint32), ("flags", ctypes.c_uint32),
        ("field", ctypes.c_uint32), ("timestamp", _timeval),
        ("timecode", _timecode), ("sequence", ctypes.c_uint32),
        ("memory", ctypes.c_uint32), ("m", _buf_m_union),
        ("length", ctypes.c_uint32), ("reserved2", ctypes.c_uint32),
        ("request_fd", ctypes.c_int32),
    ]


VIDIOC_ENUM_FMT = _iowr("V", 2, ctypes.sizeof(v4l2_fmtdesc))
VIDIOC_S_FMT = _iowr("V", 5, ctypes.sizeof(v4l2_format))
VIDIOC_REQBUFS = _iowr("V", 8, ctypes.sizeof(v4l2_requestbuffers))
VIDIOC_QUERYBUF = _iowr("V", 9, ctypes.sizeof(v4l2_buffer))
VIDIOC_QBUF = _iowr("V", 15, ctypes.sizeof(v4l2_buffer))
VIDIOC_DQBUF = _iowr("V", 17, ctypes.sizeof(v4l2_buffer))
VIDIOC_STREAMON = _iow("V", 18, ctypes.sizeof(ctypes.c_int))
VIDIOC_STREAMOFF = _iow("V", 19, ctypes.sizeof(ctypes.c_int))
VIDIOC_S_PARM = _iowr("V", 22, ctypes.sizeof(v4l2_streamparm))
VIDIOC_ENUM_FRAMESIZES = _iowr("V", 74, ctypes.sizeof(v4l2_frmsizeenum))
VIDIOC_ENUM_FRAMEINTERVALS = _iowr("V", 75,
                                   ctypes.sizeof(v4l2_frmivalenum))


def _ioctl(fd: int, req: int, arg) -> int:
    return fcntl.ioctl(fd, req, arg)


# ---------------------------------------------------------------------------
# Capture API
# ---------------------------------------------------------------------------


class Capturable(Protocol):
    """Test seam equivalent to the reference's Capturable trait
    (reference sensors.rs:70-72)."""

    def get_frame(self) -> bytes | None: ...


class FakeCamera:
    """Committed fake capture source: loops over provided JPEG frames."""

    def __init__(self, frames: list[bytes]):
        self._frames = frames
        self._i = 0

    def get_frame(self) -> bytes | None:
        f = self._frames[self._i % len(self._frames)]
        self._i += 1
        return f


class V4L2Camera:
    """MJPG capture at max resolution and max frame rate."""

    def __init__(self, device: str = "/dev/video0", n_buffers: int = 4):
        self.device = device
        self._fd = os.open(device, os.O_RDWR | os.O_NONBLOCK)
        self._maps: list[mmap.mmap] = []
        try:
            self._negotiate()
            self._start_streaming(n_buffers)
        except Exception:
            self.close()
            raise

    # -- negotiation (reference sensors.rs:18-67) --------------------------

    def _has_mjpg(self) -> bool:
        i = 0
        while True:
            desc = v4l2_fmtdesc()
            desc.index = i
            desc.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            try:
                _ioctl(self._fd, VIDIOC_ENUM_FMT, desc)
            except OSError:
                return False
            if desc.pixelformat == V4L2_PIX_FMT_MJPEG:
                return True
            i += 1

    def _max_resolution(self) -> tuple[int, int]:
        best = None
        i = 0
        while True:
            fs = v4l2_frmsizeenum()
            fs.index = i
            fs.pixel_format = V4L2_PIX_FMT_MJPEG
            try:
                _ioctl(self._fd, VIDIOC_ENUM_FRAMESIZES, fs)
            except OSError:
                break
            if fs.type == V4L2_FRMSIZE_TYPE_DISCRETE:
                cand = (fs.u.discrete.width, fs.u.discrete.height)
                # max by width, like the reference (sensors.rs:31)
                if best is None or cand[0] > best[0]:
                    best = cand
                i += 1
            else:
                best = (fs.u.stepwise.max_width, fs.u.stepwise.max_height)
                break
        if best is None:
            raise RuntimeError("no MJPG frame sizes")
        return int(best[0]), int(best[1])

    def _max_rate(self, width: int, height: int) -> tuple[int, int]:
        """(numerator, denominator) of the shortest frame interval."""
        best = None
        i = 0
        while True:
            fi = v4l2_frmivalenum()
            fi.index = i
            fi.pixel_format = V4L2_PIX_FMT_MJPEG
            fi.width, fi.height = width, height
            try:
                _ioctl(self._fd, VIDIOC_ENUM_FRAMEINTERVALS, fi)
            except OSError:
                break
            if fi.type == V4L2_FRMIVAL_TYPE_DISCRETE:
                cand = (fi.u.discrete.numerator,
                        fi.u.discrete.denominator)
                # max fps = max denominator (reference sensors.rs:42)
                if best is None or cand[1] > best[1]:
                    best = cand
                i += 1
            else:
                m = fi.u.stepwise.max
                best = (m.numerator, m.denominator)
                break
        return (int(best[0]), int(best[1])) if best else (1, 30)

    def _negotiate(self) -> None:
        if not self._has_mjpg():
            raise RuntimeError(
                f"{self.device}: required format MJPG not supported")
        self.width, self.height = self._max_resolution()
        interval = self._max_rate(self.width, self.height)

        fmt = v4l2_format()
        fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        fmt.u.pix.width = self.width
        fmt.u.pix.height = self.height
        fmt.u.pix.pixelformat = V4L2_PIX_FMT_MJPEG
        fmt.u.pix.field = 1  # V4L2_FIELD_NONE
        _ioctl(self._fd, VIDIOC_S_FMT, fmt)
        # VIDIOC_S_FMT writes the driver-ADJUSTED format back; adopt it
        # (drivers may clamp the requested size to the nearest mode)
        if fmt.u.pix.pixelformat != V4L2_PIX_FMT_MJPEG:
            raise RuntimeError(
                f"{self.device}: driver refused MJPG "
                f"(got fourcc {fmt.u.pix.pixelformat:#x})")
        self.width = int(fmt.u.pix.width)
        self.height = int(fmt.u.pix.height)

        parm = v4l2_streamparm()
        parm.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        parm.u.capture.timeperframe.numerator = interval[0]
        parm.u.capture.timeperframe.denominator = interval[1]
        _ioctl(self._fd, VIDIOC_S_PARM, parm)
        self.fps = interval[1] / max(interval[0], 1)

    # -- streaming ---------------------------------------------------------

    def _start_streaming(self, n_buffers: int) -> None:
        req = v4l2_requestbuffers()
        req.count = n_buffers
        req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        req.memory = V4L2_MEMORY_MMAP
        _ioctl(self._fd, VIDIOC_REQBUFS, req)
        for i in range(req.count):
            buf = v4l2_buffer()
            buf.index = i
            buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            buf.memory = V4L2_MEMORY_MMAP
            _ioctl(self._fd, VIDIOC_QUERYBUF, buf)
            self._maps.append(mmap.mmap(
                self._fd, buf.length, mmap.MAP_SHARED,
                mmap.PROT_READ | mmap.PROT_WRITE,
                offset=buf.m.offset))
            _ioctl(self._fd, VIDIOC_QBUF, buf)
        _ioctl(self._fd, VIDIOC_STREAMON,
               ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE))

    def get_frame(self, timeout: float = 2.0) -> bytes | None:
        """Blocking dequeue of one MJPEG frame (None on timeout)."""
        r, _, _ = select.select([self._fd], [], [], timeout)
        if not r:
            return None
        buf = v4l2_buffer()
        buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        buf.memory = V4L2_MEMORY_MMAP
        try:
            _ioctl(self._fd, VIDIOC_DQBUF, buf)
        except OSError as e:
            import errno

            if e.errno in (errno.EAGAIN, errno.EINTR):
                return None  # transient: no buffer ready yet
            # dead camera (ENODEV/EIO/...): select() will mark the fd
            # readable forever, so returning None here would busy-spin
            # the capture thread at 100% CPU with no frames and no
            # error — surface it to the sender's retry loop instead
            raise
        data = self._maps[buf.index][:buf.bytesused]
        _ioctl(self._fd, VIDIOC_QBUF, buf)
        return data

    def frames_blocking(self) -> Iterator[bytes]:
        while True:
            f = self.get_frame()
            if f is not None:
                yield f

    def close(self) -> None:
        try:
            _ioctl(self._fd, VIDIOC_STREAMOFF,
                   ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE))
        except OSError:
            pass
        for m in self._maps:
            m.close()
        self._maps.clear()
        os.close(self._fd)


class CameraSource:
    """Async frame source over a Capturable for the socket sender."""

    def __init__(self, device_or_cam="/dev/video0"):
        if isinstance(device_or_cam, str):
            import logging

            self._cam: Capturable = V4L2Camera(device_or_cam)
            logging.getLogger("infercam.camera").info(
                "Starting camera %s at %dx%d, %.0f fps", device_or_cam,
                self._cam.width, self._cam.height, self._cam.fps)
        else:
            self._cam = device_or_cam

    async def frames(self):
        import asyncio

        loop = asyncio.get_running_loop()
        while True:
            frame = await loop.run_in_executor(None, self._cam.get_frame)
            if frame is None:
                continue
            yield frame
