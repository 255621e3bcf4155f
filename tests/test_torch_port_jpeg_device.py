"""The port's packed-YCbCr decode tail against the JAX package's.

The same JPEG bytes (made from a seed with numpy, or the synthetic
pictures) go through the port's shim, whose packed planes are bit-equal
to the JAX shim's (``tests/test_torch_port_native.py``), then through
each package's `unpack_ycbcr_planes` and `combine_ycbcr`, and through
each package's whole ``detect_from_ycbcr`` on the frozen weights.

Tolerances:

- `unpack_ycbcr_planes`: bit-equal.
- `combine_ycbcr`: equal u8 levels. The upsample products take exact
  0.75/0.25 taps on integer planes, so their float32 sums do not depend on
  the order; the BT.601 products run in JAX's order, and both round half
  to even.
- ``detect_from_ycbcr`` at float32: counts equal, boxes within 1e-5,
  confidences within 5e-5, the tolerances of
  ``tests/test_torch_port_detector.py`` (the two CPU conv trunks sum in
  different orders).
- the fused path against decode-then-detect: the same parity report as
  the JAX package's two paths give (IoU 0.8, confidence tolerance 0.05),
  and at decode scale 1 box parity >= 0.9, as ``tests/test_jpeg_device.py``
  holds the JAX package's own (on the four pictures both reach 0.95, on
  chip_smoke.py's batch of 16 0.935). At scale 2 the shim's chroma fold
  (a box average of the planes libjpeg scales less) moves the colours,
  and both packages find 18 faces where the pixels path finds 28 on the
  four pictures (box parity 0.57).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infercam_onnx_tpu import detector as jdet
from infercam_onnx_tpu.config import DetectorConfig as JDetectorConfig
from infercam_onnx_tpu.eval import parity as jparity
from infercam_onnx_tpu.models import convert as jconvert
from infercam_onnx_tpu.models import ultraface as juf
from infercam_onnx_tpu.ops import jpeg_device as jjd
from infercam_onnx_tpu.ops.preprocess import Preprocessor as JPreprocessor
from infercam_onnx_tpu_torch import codec
from infercam_onnx_tpu_torch.config import DetectorConfig
from infercam_onnx_tpu_torch.detector import Detector, unpack_detections
from infercam_onnx_tpu_torch.eval import goldens as tgoldens
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
from infercam_onnx_tpu_torch.ops import jpeg_device as tjd

from tests.test_goldens_fixtures import SYNTH_PICS, WEIGHTS
from tests.test_torch_port_native import smooth_jpeg
from torch_port_offline import offline_weights_chain  # noqa: E402,F401

CONFIG = DetectorConfig(compute_dtype="float32", top_k=512,
                        max_detections=256)
SAMPLINGS = {"420": (2, 2), "422": (2, 1), "444": (1, 1)}


def _planes(packed, geom):
    keys = ("y_pw", "y_ph", "c_pw", "c_ph")
    return (tjd.unpack_ycbcr_planes(torch.from_numpy(np.array(packed)),
                                    **{k: geom[k] for k in keys}),
            jjd.unpack_ycbcr_planes(jnp.asarray(packed),
                                    **{k: geom[k] for k in keys}))


@pytest.mark.parametrize("sub", sorted(SAMPLINGS))
def test_unpack_ycbcr_planes_bit_equal_jax(sub):
    packed, geom = native_jpeg.load().decode_ycbcr_batch(
        [smooth_jpeg(s, 333, 251, sub) for s in (1, 2)])
    assert geom["sampling"] == SAMPLINGS[sub]
    got, want = _planes(packed, geom)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("size", [(640, 480), (333, 251)])
@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("sub", sorted(SAMPLINGS))
def test_combine_ycbcr_matches_jax(sub, scale, size):
    packed, geom = native_jpeg.load().decode_ycbcr_batch(
        [smooth_jpeg(s, *size, sub) for s in (3, 4)], scale=scale)
    (y, cb, cr), (jy, jcb, jcr) = _planes(packed, geom)
    kw = dict(width=geom["width"], height=geom["height"],
              sampling=geom["sampling"])
    got = tjd.combine_ycbcr(y, cb, cr, **kw)
    want = np.asarray(jjd.combine_ycbcr(jy, jcb, jcr, **kw))
    assert got.shape == want.shape == (2, geom["height"], geom["width"], 3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # and close to the host's own RGB decode of the same bytes
    host = np.stack(native_jpeg.load().decode_batch(
        [smooth_jpeg(s, *size, sub) for s in (3, 4)], scale=scale))
    assert np.abs(got.numpy() - host).mean() < (1.0 if scale == 1 else 4.0)


@pytest.fixture(scope="module")
def synthetic_jpegs():
    return [p.read_bytes() for p in sorted(SYNTH_PICS.glob("*.jpg"))]


@pytest.fixture(scope="module")
def port_detector():
    return Detector(CONFIG, weights=str(WEIGHTS), device="cpu")


@pytest.mark.parametrize("scale", [1, 2])
def test_detect_from_ycbcr_matches_jax(synthetic_jpegs, port_detector,
                                       scale):
    packed, geom = native_jpeg.load().decode_ycbcr_batch(synthetic_jpegs,
                                                         scale=scale)
    w, h = geom["width"], geom["height"]
    params = jconvert.params_from_state_dict(dict(np.load(WEIGHTS)))
    r_h, r_w = JPreprocessor(320, 240).matrices(w, h)
    want = np.asarray(jdet.detect_from_ycbcr(
        params, jnp.asarray(juf.generate_priors(320, 240)),
        jnp.asarray(packed), r_h, r_w, width=w, height=h,
        y_pw=geom["y_pw"], y_ph=geom["y_ph"], c_pw=geom["c_pw"],
        c_ph=geom["c_ph"], sampling=geom["sampling"],
        compute_dtype=jnp.float32, min_confidence=CONFIG.min_confidence,
        max_iou=CONFIG.max_iou, top_k=CONFIG.top_k,
        max_detections=CONFIG.max_detections, pack_output=True))
    got = port_detector.run_device_ycbcr_packed(packed, geom,
                                                pack_output=True)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape == (4, 256, 6)
    np.testing.assert_array_equal(got[..., 5], want[..., 5])  # counts
    assert want[..., 5].sum() >= (10 if scale == 1 else 4)
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0, atol=5e-5)
    # the bytes-in entry point decodes the same planes
    np.testing.assert_array_equal(port_detector.run_device_ycbcr(
        synthetic_jpegs, scale=scale, pack_output=True).numpy(), got)


@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("batch", ["pictures", "smoke_batch"])
def test_fused_ycbcr_detection_matches_standard(synthetic_jpegs, batch,
                                                scale):
    """The pictures as stored (top_k 512), and the batch chip_smoke.py's
    ycbcr phase holds to parity (16 re-encoded frames, plain and
    mirrored, the detector's defaults)."""
    config = CONFIG
    datas = synthetic_jpegs
    if batch == "smoke_batch":
        import chip_smoke

        config = DetectorConfig(compute_dtype="float32")
        datas = chip_smoke.synthetic_jpegs(16)
    det = Detector(config, weights=str(WEIGHTS), device="cpu")
    frames = np.stack(codec.decode_batch(datas, scale))
    std = det.detect_batch(frames)
    fused = unpack_detections(det.run_device_ycbcr(
        datas, scale=scale, pack_output=True).numpy())
    report = tgoldens.parity_report(fused, std, iou_thresh=0.8,
                                    conf_tol=0.05)
    jax_det = jdet.Detector(
        JDetectorConfig(compute_dtype="float32", top_k=config.top_k,
                        max_detections=config.max_detections),
        params=jconvert.params_from_state_dict(dict(np.load(WEIGHTS))))
    jax_report = jparity.parity_report(
        jdet.unpack_detections(np.asarray(jax_det.run_device_ycbcr(
            datas, scale=scale, pack_output=True))),
        jax_det.detect_batch(frames), iou_thresh=0.8, conf_tol=0.05)
    assert report.as_dict() == jax_report.as_dict()
    assert report.want_total >= 20
    if scale == 1:
        assert report.box_parity >= 0.9, report.as_dict()


def test_parity_report_thresholds_match_jax():
    """The port's parity_report with the IoU and confidence thresholds
    the ycbcr parity checks use, and with its defaults, counts as the
    JAX package's does."""
    rng = np.random.default_rng(7)

    def dets(n):
        xy = rng.uniform(0, 0.7, size=(n, 2))
        wh = rng.uniform(0.05, 0.3, size=(n, 2))
        return [(np.concatenate([a, a + b]).astype(np.float32),
                 float(c)) for a, b, c in zip(xy, wh, rng.uniform(size=n))]

    want_sets = [dets(n) for n in (0, 3, 8)]
    got_sets = [[(b + rng.normal(0, 0.02, 4).astype(np.float32),
                  c + rng.normal(0, 0.03)) for b, c in ws] + dets(1)
                for ws in want_sets]
    for kw in ({}, {"iou_thresh": 0.8, "conf_tol": 0.05}):
        got = tgoldens.parity_report(got_sets, want_sets, **kw).as_dict()
        want = jparity.parity_report(got_sets, want_sets, **kw).as_dict()
        assert got == want
