"""The plain reference against the port, at a small size on the CPU: the
same network (float32 and bfloat16), priors, resize and suppression. The
reference imports nothing of the port; these tests do, to hold it."""

import json

import numpy as np
import pytest
import torch

from harness import frames, weights
from harness.spec import BENCH_DIR
from reference import ultraface as ref

CFG = json.loads((BENCH_DIR / "configs" / "rfb320.json").read_text())


@pytest.fixture(scope="module")
def params():
    jpegs = frames.stream_jpegs(dict(frame_width=640, frame_height=480,
                                     jpeg_quality=90, streams=2,
                                     variants=2), 7)
    x = ref.network_inputs(CFG, [j for s in jpegs for j in s], scale=2,
                           device=torch.device("cpu"))
    return weights.make_params(CFG, 7, torch.device("cpu"), x), x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_network_equals_the_ports(params, dtype):
    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import Detector

    p, x = params
    det = Detector(DetectorConfig(compute_dtype=dtype),
                   params=weights.as_numpy(p), device="cpu")
    pri = torch.from_numpy(ref.priors(CFG))
    assert torch.equal(pri, det.priors)
    with torch.no_grad():
        s_ref, b_ref = ref.Network(p, CFG, dtype=getattr(torch, dtype))(x, pri)
        s_port, b_port = det.model(x, det.priors)
    assert torch.equal(s_ref, s_port) and torch.equal(b_ref, b_port)


def test_weights_are_on_the_bfloat16_grid_and_follow_the_seed(params):
    p, x = params
    for _, leaf in ref.leaves(p):
        assert torch.equal(leaf, leaf.to(torch.bfloat16).float())
    again = weights.make_params(CFG, 7, torch.device("cpu"), x)
    other = weights.make_params(CFG, 8, torch.device("cpu"), x)
    a, b, c = (torch.cat([t.reshape(-1) for _, t in ref.leaves(t)])
               for t in (p, again, other))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_calibration_sets_the_density_of_candidates(params):
    p, x = params
    with torch.no_grad():
        scores, _ = ref.Network(p, CFG)(x, torch.from_numpy(ref.priors(CFG)))
    per_input = (scores[..., 1] > CFG["min_confidence"]).sum(1).float()
    # the bias is set in float32 and served on bfloat16's grid
    assert per_input.mean().item() == pytest.approx(
        CFG["candidates_per_input"], rel=0.25)


@pytest.mark.parametrize("size,scale", [((640, 480), 1), ((640, 480), 2),
                                        ((1920, 1080), 1)])
def test_decode_equals_the_serving_paths(size, scale):
    """The reference's plain decode equals the port's ycbcr path (raw
    planes on the host, chroma upsample and colour on the device) bit for
    bit."""
    from infercam_onnx_tpu_torch.native import jpeg as native
    from infercam_onnx_tpu_torch.ops import jpeg_device

    datas = [frames.jpeg(p, 90) for p in frames.pictures(3, 0, 2, *size)]
    packed, g = native.load().decode_ycbcr_batch(datas, scale=scale)
    y, cb, cr = jpeg_device.unpack_ycbcr_planes(
        torch.from_numpy(packed), y_pw=g["y_pw"], y_ph=g["y_ph"],
        c_pw=g["c_pw"], c_ph=g["c_ph"])
    port = jpeg_device.combine_ycbcr(y, cb, cr, width=g["width"],
                                     height=g["height"],
                                     sampling=g["sampling"])
    for i, data in enumerate(datas):
        assert torch.equal(ref.decode_rgb(data, scale), port[i])
    # the frame's number in a comment segment changes no pixel
    assert torch.equal(ref.decode_rgb(frames.numbered(datas[0], 12345),
                                      scale), port[0])


def test_resize_equals_the_ports():
    from infercam_onnx_tpu_torch.ops.preprocess import (preprocess_images,
                                                        triangle_resize_matrix)

    for a, b in ((480, 240), (240, 240), (1080, 600), (600, 240)):
        assert np.array_equal(ref.triangle_matrix(a, b),
                              triangle_resize_matrix(a, b))
    data = frames.jpeg(frames.pictures(3, 0, 1, 640, 480)[0], 90)
    rgb = ref.decode_rgb(data, 1)[None]
    r_h = torch.from_numpy(triangle_resize_matrix(480, 240))
    r_w = torch.from_numpy(triangle_resize_matrix(640, 320))
    assert torch.allclose(ref.preprocess(rgb, 320, 240),
                          preprocess_images(rgb, r_h, r_w), atol=1e-6)


def test_tf32_control_rounds_the_resize_operands():
    t = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -(1.0 + 2 ** -11), 255.0])
    assert torch.equal(ref._tf32(t), torch.tensor(
        [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 255.0]))
    data = frames.jpeg(frames.pictures(3, 0, 1, 640, 480)[0], 90)
    rgb = ref.decode_rgb(data, 1)[None]
    # a real resample moves some pixels by a level; an identity one none
    assert not torch.equal(ref.preprocess(rgb, 320, 240),
                           ref.preprocess(rgb, 320, 240, resample="tf32"))
    assert torch.equal(ref.preprocess(rgb, 640, 480),
                       ref.preprocess(rgb, 640, 480, resample="tf32"))
    # the chroma upsample's quarter levels are exact in TF32, not in
    # bfloat16
    assert torch.equal(ref.decode_rgb(data, 2),
                       ref.decode_rgb(data, 2, "tf32"))
    assert not torch.equal(ref.decode_rgb(data, 2),
                           ref.decode_rgb(data, 2, "bf16"))


def test_nms_equals_the_ports():
    from infercam_onnx_tpu_torch.ops.postprocess import batched_nms

    gen = torch.Generator().manual_seed(0)
    conf = torch.rand(2, 600, generator=gen)
    xy = torch.rand(2, 600, 2, generator=gen) * 0.8
    boxes = torch.cat([xy, xy + 0.05 + 0.2 * torch.rand(
        2, 600, 2, generator=gen)], -1)
    conf[0, 10] = conf[0, 11]  # a tie
    out_b, out_c, count = batched_nms(conf, boxes, impl="scan")
    for i in range(2):
        dets = ref.nms(conf[i].numpy(), boxes[i].numpy(), CFG)
        assert len(dets) == int(count[i])
        for d, (box, c) in enumerate(dets):
            assert np.array_equal(box.astype(np.float32), out_b[i, d].numpy())
            assert c == pytest.approx(float(out_c[i, d]))
