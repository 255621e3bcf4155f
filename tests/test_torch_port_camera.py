"""The port's V4L2 camera module and the sender's ``--camera`` against the
JAX package's.

The eight cases of ``tests/test_camera.py`` run on the port (its servers
bind port 0). Every ioctl number and struct size must equal the JAX
module's, and both must equal the x86_64 values of linux/videodev2.h.
``main --camera`` is driven with ``CameraSource`` wrapping a
``FakeCamera`` and ``run_forever`` recording what it was given, beside
the JAX sender's ``main`` on the same argv. Exact comparisons throughout.
"""

import asyncio
import ctypes

import pytest

from infercam_onnx_tpu.client import camera as jcamera
from infercam_onnx_tpu.client import sender as jsender
from infercam_onnx_tpu_torch import protocol as proto
from infercam_onnx_tpu_torch.client import camera
from infercam_onnx_tpu_torch.client import sender
from infercam_onnx_tpu_torch.config import ClientConfig

IOCTLS = ("VIDIOC_ENUM_FMT", "VIDIOC_S_FMT", "VIDIOC_REQBUFS",
          "VIDIOC_QUERYBUF", "VIDIOC_QBUF", "VIDIOC_DQBUF",
          "VIDIOC_STREAMON", "VIDIOC_STREAMOFF", "VIDIOC_S_PARM",
          "VIDIOC_ENUM_FRAMESIZES", "VIDIOC_ENUM_FRAMEINTERVALS")
CONSTANTS = ("V4L2_BUF_TYPE_VIDEO_CAPTURE", "V4L2_MEMORY_MMAP",
             "V4L2_PIX_FMT_MJPEG", "V4L2_FRMSIZE_TYPE_DISCRETE",
             "V4L2_FRMIVAL_TYPE_DISCRETE")
STRUCTS = ("v4l2_fmtdesc", "v4l2_frmsizeenum", "v4l2_frmivalenum",
           "v4l2_format", "v4l2_streamparm", "v4l2_requestbuffers",
           "v4l2_buffer")


def test_ioctl_codes_match_kernel_abi():
    # golden values from compiling against linux/videodev2.h on x86_64
    assert camera.VIDIOC_ENUM_FMT == 0xC0405602
    assert camera.VIDIOC_S_FMT == 0xC0D05605
    assert camera.VIDIOC_REQBUFS == 0xC0145608
    assert camera.VIDIOC_QUERYBUF == 0xC0585609
    assert camera.VIDIOC_QBUF == 0xC058560F
    assert camera.VIDIOC_DQBUF == 0xC0585611
    assert camera.VIDIOC_STREAMON == 0x40045612
    assert camera.VIDIOC_STREAMOFF == 0x40045613
    assert camera.VIDIOC_S_PARM == 0xC0CC5616
    assert camera.VIDIOC_ENUM_FRAMESIZES == 0xC02C564A
    assert camera.VIDIOC_ENUM_FRAMEINTERVALS == 0xC034564B
    assert camera.V4L2_PIX_FMT_MJPEG == 0x47504A4D


def test_struct_sizes_match_kernel_abi():
    # golden sizes from linux/videodev2.h on x86_64 (the mmap offset
    # handshake depends on the exact layout)
    assert ctypes.sizeof(camera.v4l2_buffer) == 88
    assert ctypes.sizeof(camera.v4l2_fmtdesc) == 64
    assert ctypes.sizeof(camera.v4l2_frmsizeenum) == 44
    assert ctypes.sizeof(camera.v4l2_frmivalenum) == 52
    assert ctypes.sizeof(camera.v4l2_format) == 208
    assert ctypes.sizeof(camera.v4l2_requestbuffers) == 20
    assert ctypes.sizeof(camera.v4l2_streamparm) == 204


@pytest.mark.parametrize("name", IOCTLS + CONSTANTS)
def test_ioctl_number_equals_jax(name):
    assert getattr(camera, name) == getattr(jcamera, name)


@pytest.mark.parametrize("name", STRUCTS)
def test_struct_layout_equals_jax(name):
    """Same size, alignment and field offsets as the JAX module's."""
    got, want = getattr(camera, name), getattr(jcamera, name)
    assert ctypes.sizeof(got) == ctypes.sizeof(want)
    assert ctypes.alignment(got) == ctypes.alignment(want)
    assert [f[0] for f in got._fields_] == [f[0] for f in want._fields_]
    for field, *_ in got._fields_:
        assert getattr(got, field).offset == getattr(want, field).offset
        assert getattr(got, field).size == getattr(want, field).size


def test_ioctl_encoders_equal_jax():
    for nr in (0, 2, 5, 74, 255):
        for size in (0, 4, 88, 208, (1 << 14) - 1):
            assert camera._iowr("V", nr, size) == jcamera._iowr("V", nr,
                                                                size)
            assert camera._iow("V", nr, size) == jcamera._iow("V", nr, size)


def test_fake_camera_loops():
    cam = camera.FakeCamera([b"a", b"b"])
    assert [cam.get_frame() for _ in range(5)] == [b"a", b"b", b"a",
                                                  b"b", b"a"]


def test_camera_source_with_fake():
    src = camera.CameraSource(camera.FakeCamera([b"jpeg1", b"jpeg2"]))

    async def run():
        out = []
        async for f in src.frames():
            out.append(f)
            if len(out) == 3:
                break
        return out

    assert asyncio.run(run()) == [b"jpeg1", b"jpeg2", b"jpeg1"]


def test_missing_device_raises():
    with pytest.raises(OSError):
        camera.V4L2Camera("/dev/video_does_not_exist")


async def _frame_server(handler):
    server = await asyncio.start_server(handler, "127.0.0.1", 0)
    return server, f"127.0.0.1:{server.sockets[0].getsockname()[1]}"


def test_sender_accepts_fake_camera_source():
    received = []

    async def run():
        async def handler(reader, writer):
            try:
                while True:
                    received.append(await proto.read_frame(reader))
            except (asyncio.IncompleteReadError, ConnectionError):
                writer.close()

        server, address = await _frame_server(handler)
        src = camera.CameraSource(camera.FakeCamera([b"\xff\xd8fake"]))
        sent = await sender.send_stream(
            src, ClientConfig(address=address, channel="cam"),
            max_frames=3)
        server.close()
        await server.wait_closed()
        return sent

    assert asyncio.run(run()) == 3
    msgs = [proto.decode_proto_msg(r) for r in received]
    assert isinstance(msgs[0], proto.ConnectReq)
    frame_msgs = [m for m in msgs if isinstance(m, proto.FrameMsg)]
    assert len(frame_msgs) == 3
    assert frame_msgs[0].data == b"\xff\xd8fake"


def test_plan_channels_fanout_and_explicit():
    assert sender.plan_channels(1, ["simon"]) == ["simon"]
    assert sender.plan_channels(3, ["cam"]) == ["cam", "cam-1", "cam-2"]
    assert sender.plan_channels(2, ["front", "back"]) == ["front", "back"]
    with pytest.raises(ValueError, match="channel name") as got:
        sender.plan_channels(3, ["a", "b"])
    with pytest.raises(ValueError) as want:
        jsender.plan_channels(3, ["a", "b"])
    assert str(got.value) == str(want.value)


def test_multi_camera_sender_streams_every_channel():
    """One sender process fans several cameras out to their own
    channels."""
    seen: dict[str, int] = {}

    async def run():
        async def handler(reader, writer):
            try:
                while True:
                    msg = proto.decode_proto_msg(
                        await proto.read_frame(reader))
                    if isinstance(msg, proto.FrameMsg):
                        seen[msg.id] = seen.get(msg.id, 0) + 1
            except (asyncio.IncompleteReadError, ConnectionError):
                writer.close()

        server, address = await _frame_server(handler)
        sources = [camera.CameraSource(camera.FakeCamera([b"\xff\xd8a"])),
                   camera.CameraSource(camera.FakeCamera([b"\xff\xd8b"]))]
        await asyncio.gather(*(
            sender.send_stream(src, ClientConfig(address=address,
                                                 channel=ch), max_frames=3)
            for src, ch in zip(sources, ["cam", "cam-1"])))
        server.close()
        await server.wait_closed()

    asyncio.run(run())
    assert seen == {"cam": 3, "cam-1": 3}


def _drive_main(module, camera_module, monkeypatch, argv):
    """Run ``module.main(argv)`` with every camera a FakeCamera named after
    its device and ``run_forever`` recording (device, channel, address)."""
    runs = []

    class FakeSource(camera_module.CameraSource):
        def __init__(self, device):
            super().__init__(camera_module.FakeCamera([device.encode()]))
            self.device = device

    async def run_forever(src, config):
        first = await anext(src.frames())
        runs.append((getattr(src, "device", None), first, config.channel,
                     config.address))

    monkeypatch.setattr(camera_module, "CameraSource", FakeSource)
    monkeypatch.setattr(module, "run_forever", run_forever)
    assert module.main(argv) == 0
    return runs


@pytest.mark.parametrize("argv", [
    ["--camera"],
    ["--camera", "/dev/video2"],
    ["--camera", "/dev/video0", "--camera", "/dev/video1"],
    ["--camera", "--camera", "/dev/video4", "--channel", "door"],
    ["--camera", "/dev/video0", "--camera", "/dev/video1", "--channel",
     "front", "--channel", "back", "--address", "10.0.0.2:3001"],
    ["--camera", "/dev/video3", "--replay-dir", "ignored"],
])
def test_main_camera_fanout_equals_jax(argv, monkeypatch):
    got = _drive_main(sender, camera, monkeypatch, argv)
    want = _drive_main(jsender, jcamera, monkeypatch, argv)
    assert got == want and got
    assert all(first == device.encode() for device, first, *_ in got)


def test_main_replay_dir_streams_one_channel(monkeypatch, tmp_path):
    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8a")
    runs = []

    async def run_forever(src, config):
        runs.append((type(src).__name__, await anext(src.frames()),
                     config.channel))

    monkeypatch.setattr(sender, "run_forever", run_forever)
    assert sender.main(["--replay-dir", str(tmp_path)]) == 0
    assert runs == [("ReplaySource", b"\xff\xd8a", "simon")]


@pytest.mark.parametrize("argv", [
    [],
    ["--camera", "/dev/video0", "--camera", "/dev/video1", "--channel", "a",
     "--channel", "b", "--channel", "c"],
])
def test_main_argument_errors_equal_jax(argv, monkeypatch, capsys):
    for cam in (camera, jcamera):
        monkeypatch.setattr(cam, "CameraSource",
                            lambda dev, c=cam, source=cam.CameraSource:
                            source(c.FakeCamera([b"x"])))
    with pytest.raises(SystemExit) as got:
        sender.main(argv)
    got_err = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as want:
        jsender.main(argv)
    want_err = capsys.readouterr().err.splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert got_err.split("error: ")[1] == want_err.split("error: ")[1]


def test_replay_source_one_pass(tmp_path):
    for name in ("a.jpg", "b.jpeg", "c.txt"):
        (tmp_path / name).write_bytes(name.encode())

    async def frames(src):
        return [f async for f in src.frames()]

    once = sender.ReplaySource(str(tmp_path), fps=0, loop_forever=False)
    assert asyncio.run(frames(once)) == [b"a.jpg", b"b.jpeg"]
    jonce = jsender.ReplaySource(str(tmp_path), fps=0, loop_forever=False)
    assert asyncio.run(frames(jonce)) == [b"a.jpg", b"b.jpeg"]
