"""The port's V4L2 capture on a real device: skips without /dev/video0, as
``tests/test_camera_hardware.py`` does (the reference gates its test
behind --cfg webcam, reference sensors.rs:120-152)."""

import os

import pytest


@pytest.mark.skipif(not os.path.exists("/dev/video0"),
                    reason="no V4L2 capture device")
def test_live_capture_yields_mjpeg_frames():
    from infercam_onnx_tpu_torch.client.camera import V4L2Camera

    cam = V4L2Camera("/dev/video0")
    try:
        frame = cam.get_frame(timeout=5.0)
        assert frame is not None and frame[:2] == b"\xff\xd8"
        assert cam.width > 0 and cam.height > 0
    finally:
        cam.close()
