"""The port's tiled high-resolution detection against the JAX package's
``parallel/tiling.py`` (single device), on the CPU.

The same frames (the four synthetic pictures resized with the port's
goldens loader) and the same frozen weights at float32 go through JAX
``TiledDetector`` and the port's. Tolerances:

- `tile_grid_boxes`: equal (NumPy in both, ``linspace(...).round()``
  included);
- packed and tuple outputs: counts equal, boxes within 1e-5, confidences
  within 5e-5, the tolerances of ``tests/test_torch_port_detector.py``
  (the two CPU conv trunks sum in different orders, which moves a
  confidence near 0.5 by up to ~3e-5);
- the packed-YCbCr program on the same packed planes: the same; its rows
  form equal to its packed form bit for bit (the port's own two programs
  on the same rows);
- a 1x1 grid against the port's untiled ``detect_program``: counts equal,
  boxes within 1e-5 (the mapping is the identity, so bit-equal is
  expected);
- the mismatch errors: the JAX package's messages.
"""

import numpy as np
import pytest
import torch

from infercam_onnx_tpu.config import DetectorConfig as JDetectorConfig
from infercam_onnx_tpu.detector import Detector as JDetector
from infercam_onnx_tpu.models import convert as jconvert
from infercam_onnx_tpu.ops.reference_impl import iou as jiou
from infercam_onnx_tpu.parallel import tiling as jtiling
from infercam_onnx_tpu_torch import codec
from infercam_onnx_tpu_torch.config import DetectorConfig
from infercam_onnx_tpu_torch.detector import Detector
from infercam_onnx_tpu_torch.eval.goldens import load_directory_frames
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
from infercam_onnx_tpu_torch.ops import nms
from infercam_onnx_tpu_torch.parallel.tiling import (TiledDetector,
                                                     tile_grid_boxes)

from tests.test_goldens_fixtures import SYNTH_PICS, WEIGHTS
from torch_port_offline import offline_weights_chain  # noqa: E402,F401


@pytest.fixture(scope="module")
def port_detector():
    return Detector(DetectorConfig(compute_dtype="float32"),
                    weights=str(WEIGHTS), device="cpu")


@pytest.fixture(scope="module")
def jax_detector():
    params = jconvert.params_from_state_dict(dict(np.load(WEIGHTS)))
    return JDetector(JDetectorConfig(compute_dtype="float32"), params=params)


def _frames(width: int, height: int, n: int = 2) -> np.ndarray:
    """The first ``n`` synthetic pictures resized to width x height."""
    pics = list(load_directory_frames(str(SYNTH_PICS),
                                      resize=(width, height)).values())
    return np.ascontiguousarray(np.stack(pics[:n]))


def _assert_packed_close(got, want, min_faces: int = 10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 5], want[..., 5])  # counts
    assert want[..., 5].sum() >= min_faces
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0, atol=5e-5)


@pytest.mark.parametrize("width, height, grid, overlap", [
    (1920, 1080, (2, 2), 0.2), (960, 540, (2, 2), 0.2),
    (1920, 1080, (2, 2), 0.0), (1920, 1080, (2, 2), 0.5),
    (1920, 1080, (3, 2), 0.2), (1280, 720, (3, 2), 0.5),
    (640, 480, (1, 1), 0.2), (480, 270, (2, 2), 0.2),
    (480, 270, (2, 2), 0.5), (333, 251, (3, 3), 0.2),
    (1080, 1920, (2, 3), 0.2), (320, 240, (1, 1), 0.0),
])
def test_tile_grid_boxes_equal_jax(width, height, grid, overlap):
    got = tile_grid_boxes(width, height, grid, overlap)
    assert got == jtiling.tile_grid_boxes(width, height, grid, overlap)
    assert len({(x1 - x0, y1 - y0) for x0, y0, x1, y1 in got}) == 1
    assert all(isinstance(v, int) for box in got for v in box)


@pytest.mark.parametrize("pack_output", [True, False])
def test_pixels_output_matches_jax(port_detector, jax_detector,
                                   pack_output):
    frames = _frames(480, 270)
    got = TiledDetector(port_detector, (480, 270), grid=(2, 2)).run_device(
        frames, pack_output=pack_output)
    want = jtiling.TiledDetector(jax_detector, (480, 270),
                                 grid=(2, 2)).run_device(
        frames, pack_output=pack_output)
    if pack_output:
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        _assert_packed_close(got.numpy(), want)
        return
    boxes, confs, counts = (t.numpy() for t in got)
    jboxes, jconfs, jcounts = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(counts, jcounts)
    assert counts.dtype == np.int32 and counts.sum() >= 10
    np.testing.assert_allclose(boxes, jboxes, rtol=0, atol=1e-5)
    np.testing.assert_allclose(confs, jconfs, rtol=0, atol=5e-5)


def test_detect_batch_matches_jax(port_detector, jax_detector):
    frames = _frames(480, 270)
    got = TiledDetector(port_detector, (480, 270)).detect_batch(frames)
    want = jtiling.TiledDetector(jax_detector, (480, 270)).detect_batch(
        frames)
    assert [len(d) for d in got] == [len(d) for d in want]
    for gdets, wdets in zip(got, want):
        for (gb, gc), (wb, wc) in zip(gdets, wdets):
            np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-5)
            assert abs(gc - wc) <= 5e-5


@pytest.fixture(scope="module")
def packed_planes():
    """The port shim's packed 4:2:0 planes of two 480x270 frames."""
    datas = [codec.encode_rgb(f, 92, "420") for f in _frames(480, 270)]
    return native_jpeg.load().decode_ycbcr_batch(datas)


def test_ycbcr_packed_matches_jax_and_rows_equal_packed(
        port_detector, jax_detector, packed_planes):
    packed, geom = packed_planes
    port = TiledDetector(port_detector, (480, 270), grid=(2, 2))
    got = port.run_device_ycbcr_packed(packed, geom, pack_output=True)
    want = jtiling.TiledDetector(jax_detector, (480, 270),
                                 grid=(2, 2)).run_device_ycbcr_packed(
        packed, geom, pack_output=True)
    _assert_packed_close(got.numpy(), want)
    rows = port.run_device_ycbcr_rows(
        [torch.from_numpy(np.array(r)) for r in packed], geom,
        pack_output=True)
    assert torch.equal(rows, got)
    # host rows go through as well
    assert torch.equal(port.run_device_ycbcr_rows(list(packed), geom,
                                                  pack_output=True), got)
    # and the tuple form equals the packed one
    boxes, confs, counts = port.run_device_ycbcr_packed(packed, geom)
    assert torch.equal(counts, got[..., 5].sum(-1).to(torch.int32))
    assert torch.equal(boxes, got[..., :4]) and torch.equal(confs,
                                                           got[..., 4])


@pytest.mark.parametrize("size", [(320, 240), (480, 270)])
def test_one_by_one_grid_is_the_untiled_program(port_detector, size):
    frames = _frames(*size)
    got = TiledDetector(port_detector, size, grid=(1, 1)).run_device(
        frames, pack_output=True)
    want = port_detector.run_device(frames, pack_output=True)
    np.testing.assert_array_equal(got[..., 5].numpy(), want[..., 5].numpy())
    assert int(want[..., 5].sum()) >= 10
    np.testing.assert_allclose(got[..., :5].numpy(), want[..., :5].numpy(),
                               rtol=0, atol=1e-5)


def test_mismatched_frames_raise_the_jax_errors(port_detector, jax_detector,
                                                packed_planes):
    packed, geom = packed_planes
    port = TiledDetector(port_detector, (480, 270))
    ref = jtiling.TiledDetector(jax_detector, (480, 270))
    wrong = np.zeros((1, 540, 960, 3), np.uint8)
    bad_geom = dict(geom, width=100, height=50)
    for call in (lambda t: t.run_device(wrong, pack_output=True),
                 lambda t: t.run_device_ycbcr_packed(packed, bad_geom),
                 lambda t: t.run_device_ycbcr_rows(list(packed), bad_geom)):
        with pytest.raises(ValueError) as want:
            call(ref)
        with pytest.raises(ValueError) as got:
            call(port)
        assert str(got.value) == str(want.value)
        assert "!= tiled frame" in str(got.value)


def test_overlap_half_merges_duplicates(port_detector, jax_detector):
    """Heavy overlap: each face is seen by several tiles; the merged
    output holds no pair above max_iou, and equals JAX's."""
    frames = _frames(480, 270)
    got = TiledDetector(port_detector, (480, 270), grid=(2, 2),
                        overlap=0.5).run_device(frames, pack_output=True)
    want = jtiling.TiledDetector(jax_detector, (480, 270), grid=(2, 2),
                                 overlap=0.5).run_device(frames,
                                                         pack_output=True)
    _assert_packed_close(got.numpy(), want)
    got = got.numpy()
    for row in got:
        n = int(row[:, 5].sum())
        for i in range(n):
            for j in range(i + 1, n):
                assert jiou(row[i, :4], row[j, :4]) <= 0.5 + 1e-5


def test_shares_the_detectors_weights_and_runs_one_nms(port_detector,
                                                       monkeypatch):
    """No copy of the weights; the merge is one batched_nms over [B, T*K]
    candidates cut to top_k, one call of the suppression a program."""
    t = TiledDetector(port_detector, (480, 270))
    assert t.detector is port_detector
    assert t.tiles == tuple(tile_grid_boxes(480, 270, (2, 2), 0.2))
    calls = []
    real = nms.greedy_suppress_reference

    def spy(boxes_t, valid, **kw):
        calls.append(tuple(boxes_t.shape))
        return real(boxes_t, valid, **kw)

    # on CPU tensors the kernel's wrapper runs its plain version
    monkeypatch.setattr(nms, "greedy_suppress_reference", spy)
    t.run_device(_frames(480, 270), pack_output=True)
    assert calls == [(2, 4, 256)]
