"""The port's device annotate tail against the JAX package's
(``ops/jpeg_encode_device.py``, ``detect_annotate``,
``detect_annotate_from_ycbcr``), and the worker's annotated units, on the
CPU.

The same inputs, made from a seed with numpy or taken from the synthetic
pictures, go through both packages. Tolerances:

- exact: `glyph_atlas`, `_label_indices`, `pack12` / `unpack12` /
  `pack12_np` / `unpack12_device` over +-2047, `plane_geometry`,
  `split_coefs`, the shim's `quant_tables` and `encode_coefs` bytes;
- `render_overlay_ycbcr`: planes within 1e-4 and touched masks equal (the
  label layer sums one non-zero term a pixel where labels do not
  overlap), overlapping labels within 1e-5 of the JAX package's one-hot
  einsum chain;
- `fdct_quant` / `encode_planes`: coefficients off by at most 1; at most
  1e-4 of them off on random float planes, at most 2e-3 on the integer
  planes of a JPEG decode. Integer samples put coefficients exactly on .5
  ties (a DC coefficient is a sum of 64 samples over 8), where the port's
  float64 transform and XLA's float32 one round apart: even an exact
  float64 DCT differs from XLA's on 6.5e-4 of them (640x427, quality 95),
  the port's on 0.9e-3 to 1.3e-3;
- `rgb_to_ycbcr_planes`: within 1e-3;
- the annotated programs at float32 on the frozen weights: counts equal,
  boxes within 1e-5, confidences within 5e-5 (the tolerances of
  ``tests/test_torch_port_detector.py``) at 320x240; at 640x427 the
  preprocess resize (427 or 214 rows to 240) moves a few inputs one u8
  level (ROADMAP C): boxes within 5e-5, confidences within 2e-4. The coefficients
  against the JAX package's tail on the same planes and the port's
  detections, as above; the entropy-coded JPEG within a mean absolute
  difference of 4 of the host draw + encode (the JAX package's bar,
  ``tests/test_annotate_device.py``).

The worker tests serve with ``annotate_mode="device"`` on ``device="cpu"``
(every listener on port 0): a /face_stream part decodes to the frame's size
with more than 50 green overlay pixels the frame did not have (the JAX
package's bar), and its bytes equal `encode_coefs` of the annotated
program's output on the batch the worker dispatched.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infercam_onnx_tpu import detector as jdet
from infercam_onnx_tpu.config import DetectorConfig as JDetectorConfig
from infercam_onnx_tpu.draw import draw_detections as jdraw
from infercam_onnx_tpu.models import convert as jconvert
from infercam_onnx_tpu.native import jpeg as jnative
from infercam_onnx_tpu.ops import jpeg_device as jjd
from infercam_onnx_tpu.ops import jpeg_encode_device as jenc
from infercam_onnx_tpu_torch import codec
from infercam_onnx_tpu_torch import draw as tdraw
from infercam_onnx_tpu_torch.client.sender import send_stream
from infercam_onnx_tpu_torch.config import ClientConfig, DetectorConfig
from infercam_onnx_tpu_torch.detector import Detector, unpack_detections
from infercam_onnx_tpu_torch.eval.goldens import load_directory_frames
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
from infercam_onnx_tpu_torch.ops import jpeg_device as tjd
from infercam_onnx_tpu_torch.ops import jpeg_encode_device as tenc

from tests.test_goldens_fixtures import SYNTH_PICS, WEIGHTS
from tests.test_torch_port_native import smooth_jpeg
from tests.test_torch_port_serving import (_GatedSource, _serving,
                                           _subscribed, _tap_units, _until,
                                           _Viewer)
from torch_port_offline import offline_weights_chain  # noqa: E402,F401

CONFIG = DetectorConfig(compute_dtype="float32")
SAMPLINGS = {"420": (2, 2), "422": (2, 1), "444": (1, 1)}


# -- shared helpers (the coefficients tests use them too) ------------------


def frames_of(width: int, height: int) -> np.ndarray:
    """The four synthetic pictures at ``width`` x ``height``."""
    return np.stack(list(load_directory_frames(
        str(SYNTH_PICS), resize=(width, height)).values()))


def jax_detector() -> jdet.Detector:
    """The JAX Detector at float32 on the frozen weights."""
    params = jconvert.params_from_state_dict(dict(np.load(WEIGHTS)))
    return jdet.Detector(JDetectorConfig(compute_dtype="float32"),
                         params=params)


def assert_detections_match(got: np.ndarray, want: np.ndarray,
                            tols: tuple[float, float] = (1e-5, 5e-5)
                            ) -> None:
    """Packed [B, D, 6] detections: counts equal, boxes and confidences
    within ``tols``."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0,
                               atol=tols[0])
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0,
                               atol=tols[1])


# share of quantized coefficients that may be off by 1 from the JAX
# package's on the integer planes of a JPEG decode (module docstring)
TIES_SHARE = 2e-3


def assert_coefficients_match(got: np.ndarray, want: np.ndarray,
                              share: float = TIES_SHARE) -> None:
    """Quantized coefficients: at most ``share`` of them off, by 1."""
    got, want = got.astype(np.int32), want.astype(np.int32)
    assert got.shape == want.shape
    off = got != want
    assert off.mean() <= share, off.mean()
    assert np.abs(got - want).max(initial=0) <= 1


def packed_coefficients(coefs: np.ndarray) -> np.ndarray:
    """[B, m] pack12 rows -> [B, m*2//3] int16."""
    return np.stack([tenc.unpack12(row) for row in coefs])


def annotated_vs_host(jpeg: bytes, frame: np.ndarray, dets, quality: int = 95,
                      subsampling: str = "420") -> float:
    """Mean absolute difference between a device-annotated JPEG and the
    host's draw + encode of ``frame`` with ``dets``, both decoded."""
    host = codec.decode_rgb(codec.encode_rgb(
        tdraw.draw_detections(frame, dets), quality, subsampling))
    dev = codec.decode_rgb(jpeg)
    assert dev.shape == host.shape
    return float(np.abs(dev.astype(np.int32) - host).mean())


def greens(img: np.ndarray) -> int:
    """Pixels distinctly green: G above R and B by more than 60."""
    g = img[..., 1].astype(np.int32)
    return int(((g - img[..., 0] > 60) & (g - img[..., 2] > 60)).sum())


@pytest.fixture(scope="module")
def port_detector():
    return Detector(CONFIG, weights=str(WEIGHTS), device="cpu")


@pytest.fixture(scope="module")
def jax_det():
    return jax_detector()


# -- labels, packing, geometry ----------------------------------------------


def test_glyph_atlas_equals_jax_from_the_vendored_font():
    atlas, gh, gw = tenc.glyph_atlas()
    want, jgh, jgw = jenc.glyph_atlas()
    assert atlas.shape == (13, 20, 10) and (gh, gw) == (20, 10)
    assert (gh, gw) == (jgh, jgw)
    np.testing.assert_array_equal(atlas, want)
    assert tdraw._font().path == tdraw._FONT_PATH
    assert atlas[:12].max() == 1.0 and not atlas[12].any()  # blank cell


@pytest.mark.parametrize("conf, label", [
    (1.0, "100.00%"), (0.8765, "87.65%"), (0.0512, "5.12%"),
    (0.12345, "12.35%"), (0.99995, "100.00%")])
def test_label_indices_equal_jax(conf, label):
    c = np.array([[conf]], np.float32)
    got = tenc._label_indices(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jenc._label_indices(
        jnp.asarray(c))))
    chars = "0123456789.% "
    assert "".join(chars[i] for i in got[0, 0]).rstrip() == label


def _coefs_pm2047() -> np.ndarray:
    rng = np.random.default_rng(6)
    coefs = rng.integers(-2047, 2048, size=(3, 384)).astype(np.int16)
    coefs[0, :6] = [-2047, 2047, 0, -1, 1, -2048 + 1]
    return coefs


def test_pack12_and_unpack12_equal_jax():
    coefs = _coefs_pm2047()
    got = tenc.pack12(torch.from_numpy(coefs))
    assert got.dtype == torch.uint8 and got.shape == (3, 576)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jenc.pack12(jnp.asarray(coefs))))
    for row, want in zip(got.numpy(), coefs):
        np.testing.assert_array_equal(tenc.unpack12(row), want)
        np.testing.assert_array_equal(tenc.unpack12(row), jenc.unpack12(row))


def test_pack12_np_and_unpack12_device_equal_jax():
    coefs = _coefs_pm2047()
    packed = tenc.pack12_np(coefs)
    np.testing.assert_array_equal(packed, jenc.pack12_np(coefs))
    np.testing.assert_array_equal(packed, tenc.pack12(
        torch.from_numpy(coefs)).numpy())
    got = tenc.unpack12_device(torch.from_numpy(packed))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), coefs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jenc.unpack12_device(jnp.asarray(packed))))
    # out-of-range values clamp to the 12-bit range, as in JAX
    wide = np.array([[-3000, 3000, 5, -5]], np.int16)
    np.testing.assert_array_equal(tenc.pack12_np(wide), jenc.pack12_np(wide))


@pytest.mark.parametrize("size", [(320, 240), (640, 427), (130, 97)])
@pytest.mark.parametrize("sub", sorted(SAMPLINGS))
def test_plane_geometry_and_split_coefs_equal_jax(sub, size):
    geom = tenc.plane_geometry(*size, SAMPLINGS[sub])
    assert geom == jenc.plane_geometry(*size, SAMPLINGS[sub])
    blocks = (-(-geom["y_pw"] // 8) * -(-geom["y_ph"] // 8)
              + 2 * -(-geom["c_pw"] // 8) * -(-geom["c_ph"] // 8))
    packed = np.random.default_rng(1).integers(
        0, 256, size=blocks * 96, dtype=np.uint8)
    for got, want in zip(tenc.split_coefs(packed, geom),
                         jenc.split_coefs(packed, geom)):
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [95, 75, 50])
def test_quant_tables_and_encode_coefs_bytes_equal_jax(quality):
    port, jshim = native_jpeg.load(), jnative.load()
    tables = port.quant_tables(quality)
    assert tables.dtype == np.uint16 and tables.shape == (2, 64)
    np.testing.assert_array_equal(tables, jshim.quant_tables(quality))
    assert native_jpeg.quant_tables_cached(quality) is \
        native_jpeg.quant_tables_cached(quality)
    y, cb, cr, quant, wh, samp = jshim.read_coefficients(
        smooth_jpeg(quality, 333, 251, "420"))
    got = port.encode_coefs(y, cb, cr, wh, samp, tables)
    assert got == jshim.encode_coefs(y, cb, cr, wh, samp, tables)
    assert codec.decode_rgb(got).shape == (251, 333, 3)


# -- the overlay --------------------------------------------------------------


DETS = {
    # three boxes, labels apart
    "boxes": [[0.25, 0.25, 0.75, 0.75, 0.8765, 1.0],
              [0.05, 0.60, 0.35, 0.95, 0.5012, 1.0],
              [0.60, 0.05, 0.90, 0.30, 0.99995, 1.0]],
    # invalid, wholly offscreen, right edge clipped, every edge outside
    "culled": [[0.2, 0.2, 0.8, 0.8, 0.9, 0.0],
               [1.2, 0.2, 1.8, 0.8, 0.9, 1.0],
               [0.8, 0.3, 1.5, 0.7, 0.7123, 1.0],
               [-0.5, -0.5, 1.5, 1.5, 0.6, 1.0]],
}


def _planes(datas: bytes | list[bytes], scale: int = 1):
    """(port planes, JAX planes, geom) of the JPEGs' packed decode."""
    packed, geom = native_jpeg.load().decode_ycbcr_batch(
        [datas] if isinstance(datas, bytes) else datas, scale=scale)
    keys = {k: geom[k] for k in ("y_pw", "y_ph", "c_pw", "c_ph")}
    return (tjd.unpack_ycbcr_planes(torch.from_numpy(np.array(packed)),
                                    **keys),
            jjd.unpack_ycbcr_planes(jnp.asarray(packed), **keys), geom)


def _overlay_pair(tplanes, jplanes, dets, **kw):
    pdet = np.zeros((1, 8, 6), np.float32)
    pdet[0, :len(dets)] = dets
    got = tenc.render_overlay_ycbcr(*tplanes, torch.from_numpy(pdet),
                                    return_masks=True, **kw)
    want = jenc.render_overlay_ycbcr(*jplanes, jnp.asarray(pdet),
                                     return_masks=True, **kw)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("case", ["boxes", "culled", "disp_dims"])
@pytest.mark.parametrize("sub", sorted(SAMPLINGS))
def test_render_overlay_ycbcr_matches_jax(sub, case):
    tplanes, jplanes, geom = _planes(smooth_jpeg(2, 320, 240, sub))
    dets = DETS["culled" if case == "culled" else "boxes"]
    disp = (400, 300) if case == "disp_dims" else None
    got, want = _overlay_pair(tplanes, jplanes, dets, width=320, height=240,
                              sampling=geom["sampling"], disp_dims=disp)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    for g, w in zip(got[3:], want[3:]):
        assert g.dtype == np.bool_
        np.testing.assert_array_equal(g, w)
    assert got[3].sum() > 200  # something was drawn
    # the planes' iMCU padding (none at 320x240 for 4:2:0) stays untouched
    np.testing.assert_array_equal(got[0][:, 240:], tplanes[0].numpy()[:, 240:])
    if case == "culled":  # no phantom line at the right edge
        assert not got[3][0, 100:140, 319].any()


def test_edge_label_stays_inside_visible_frame():
    """A box at the right edge of a 100x100 frame (luma planes padded to
    112x112) puts its label inside the visible frame, not the padding."""
    tplanes, jplanes, geom = _planes(smooth_jpeg(3, 100, 100, "420"))
    got, want = _overlay_pair(tplanes, jplanes,
                              [[0.90, 0.40, 0.99, 0.60, 0.77, 1.0]],
                              width=100, height=100, sampling=(2, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    my, mc = got[3][0], got[4][0]
    assert my[:, :100].any()
    assert not my[:, 100:].any() and not my[100:].any()
    assert not mc[:, 50:].any()


def test_overlapping_labels_within_1e5_of_jax():
    tplanes, jplanes, geom = _planes(smooth_jpeg(4, 320, 240, "420"))
    dets = [[0.20, 0.20, 0.60, 0.60, 0.8765, 1.0],
            [0.25, 0.22, 0.70, 0.70, 0.5012, 1.0],
            [0.22, 0.21, 0.50, 0.50, 0.93, 1.0]]
    got, want = _overlay_pair(tplanes, jplanes, dets, width=320, height=240,
                              sampling=(2, 2))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g, w)


def test_stamp_labels_is_deterministic_and_exact_where_apart():
    """The label layer of labels that do not overlap holds each strip's
    alpha exactly, and a second call gives the same bits."""
    rng = np.random.default_rng(8)
    strips = torch.from_numpy(rng.uniform(0, 1, (2, 3, 20, 70)).astype(
        np.float32))
    xs = torch.tensor([[0, 100, 200], [10, 150, 30]])
    ys = torch.tensor([[0, 40, 100], [5, 5, 60]])
    plane = torch.zeros(2, 160, 320)
    _, layer = tenc._stamp_labels(plane, xs, ys, strips, 1.0)
    for b in range(2):
        for d in range(3):
            y, x = int(ys[b, d]), int(xs[b, d])
            assert torch.equal(layer[b, y:y + 20, x:x + 70], strips[b, d])
    again = tenc._stamp_labels(plane, xs, ys, strips, 1.0)[1]
    assert torch.equal(layer, again)


# -- FDCT, quantization, colour conversion ----------------------------------


@pytest.mark.parametrize("per_frame", [False, True])
def test_fdct_quant_matches_jax(per_frame):
    rng = np.random.default_rng(0)
    plane = rng.uniform(0, 255, size=(3, 48, 64)).astype(np.float32)
    tables = native_jpeg.load().quant_tables(95)[0].astype(np.float32)
    q = (rng.integers(1, 40, size=(3, 64)).astype(np.float32) if per_frame
         else tables)
    got = tenc.fdct_quant(torch.from_numpy(plane), torch.from_numpy(q))
    assert got.dtype == torch.int16 and got.shape == (3, 6, 8, 64)
    assert_coefficients_match(got.numpy(), np.asarray(jenc.fdct_quant(
        jnp.asarray(plane), jnp.asarray(q))), share=1e-4)
    # unit quant: the port's own IDCT takes the samples back, up to the
    # rounding of each coefficient to an integer
    ones = torch.ones(3, 64)
    err = np.abs(tjd.decode_plane(tenc.fdct_quant(
        torch.from_numpy(plane), ones[0]), ones).numpy() - plane)
    assert err.mean() < 0.5 and err.max() < 2.0


@pytest.mark.parametrize("scale", [1, 2])
def test_encode_planes_matches_jax(scale):
    """Real planes, unaligned at scale 2 (640x427: c_ph 108)."""
    tplanes, jplanes, geom = _planes(smooth_jpeg(5, 640, 427, "420"), scale)
    if scale == 2:
        assert any(geom[k] % 8 for k in ("y_pw", "y_ph", "c_pw", "c_ph"))
    quant = native_jpeg.load().quant_tables(95).astype(np.float32)
    got = tenc.encode_planes(*tplanes, torch.from_numpy(quant)).numpy()
    want = np.asarray(jenc.encode_planes(*jplanes, jnp.asarray(quant)))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert_coefficients_match(packed_coefficients(got),
                              packed_coefficients(want))


@pytest.mark.parametrize("size", [(320, 240), (130, 100)])
@pytest.mark.parametrize("sub", sorted(SAMPLINGS))
def test_rgb_to_ycbcr_planes_matches_jax(sub, size):
    rng = np.random.default_rng(size[0])
    rgb = rng.integers(0, 256, size=(2, size[1], size[0], 3), dtype=np.uint8)
    got = tenc.rgb_to_ycbcr_planes(torch.from_numpy(rgb),
                                   sampling=SAMPLINGS[sub])
    want = jenc.rgb_to_ycbcr_planes(jnp.asarray(rgb),
                                    sampling=SAMPLINGS[sub])
    geom = tenc.plane_geometry(*size, SAMPLINGS[sub])
    assert got[0].shape == (2, geom["y_ph"], geom["y_pw"])
    assert got[1].shape == (2, geom["c_ph"], geom["c_pw"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-3)


# -- the annotated programs -------------------------------------------------


def jax_tail(planes, packed_det: np.ndarray, geom: dict, quality: int = 95
             ) -> np.ndarray:
    """The JAX package's overlay + encode_planes on JAX planes and the
    port's detections: the reference of a program's coefficients, apart
    from the detections' own differences."""
    quant = jnp.asarray(native_jpeg.load().quant_tables(quality).astype(
        np.float32))
    drawn = jenc.render_overlay_ycbcr(
        *planes, jnp.asarray(packed_det), width=geom["width"],
        height=geom["height"], sampling=geom["sampling"])
    return np.asarray(jenc.encode_planes(*drawn, quant))


# (size, decode scale of the ycbcr program, (box, confidence) tolerance)
PROGRAM_CASES = [((320, 240), 1, (1e-5, 5e-5)), ((640, 427), 2, (5e-5, 2e-4))]


@pytest.mark.parametrize("size, scale, tols", PROGRAM_CASES)
def test_detect_annotate_matches_jax(port_detector, jax_det, size, scale,
                                     tols):
    frames = frames_of(*size)[:2]
    coefs, packed = port_detector.run_device_annotated(frames, quality=95)
    _, jpacked = jax_det.run_device_annotated(frames, quality=95)
    packed, coefs = packed.numpy(), coefs.numpy()
    assert_detections_match(packed, np.asarray(jpacked), tols)
    assert packed[..., 5].sum() >= 2
    geom = tenc.plane_geometry(*size, (2, 2))
    want = jax_tail(jenc.rgb_to_ycbcr_planes(jnp.asarray(frames),
                                             sampling=(2, 2)), packed, geom)
    assert_coefficients_match(packed_coefficients(coefs),
                              packed_coefficients(want))
    # the detections equal the detection-only program's
    np.testing.assert_array_equal(packed, port_detector.run_device(
        frames, pack_output=True).numpy())
    quant = native_jpeg.load().quant_tables(95)
    for i, frame in enumerate(frames):
        jpeg = native_jpeg.load().encode_coefs(
            *tenc.split_coefs(coefs[i], geom), size, (2, 2), quant)
        dets = unpack_detections(packed[i:i + 1])[0]
        assert annotated_vs_host(jpeg, frame, dets) < 4.0


@pytest.mark.parametrize("size, scale, tols", PROGRAM_CASES)
def test_detect_annotate_from_ycbcr_matches_jax(port_detector, jax_det, size,
                                                scale, tols):
    datas = [codec.encode_rgb(f, 92) for f in frames_of(*size)[:2]]
    tplanes, jplanes, geom = _planes(datas, scale)
    packed_planes, _ = native_jpeg.load().decode_ycbcr_batch(datas,
                                                             scale=scale)
    coefs, packed = port_detector.run_device_ycbcr_annotated(
        packed_planes, geom, quality=95)
    _, jpacked = jax_det.run_device_ycbcr_annotated(packed_planes, geom,
                                                    quality=95)
    packed, coefs = packed.numpy(), coefs.numpy()
    assert_detections_match(packed, np.asarray(jpacked), tols)
    assert_coefficients_match(packed_coefficients(coefs), packed_coefficients(
        jax_tail(jplanes, packed, geom)))
    np.testing.assert_array_equal(packed, port_detector.run_device_ycbcr_packed(
        packed_planes, geom, pack_output=True).numpy())
    quant = native_jpeg.load().quant_tables(95)
    wh = (geom["width"], geom["height"])
    for i, data in enumerate(datas):
        jpeg = native_jpeg.load().encode_coefs(
            *tenc.split_coefs(coefs[i], geom), wh, geom["sampling"], quant)
        frame = codec.decode_rgb(data, scale)
        assert frame.shape[1::-1] == wh
        dets = unpack_detections(packed[i:i + 1])[0]
        assert annotated_vs_host(jpeg, frame, dets) < 4.0


def test_annotated_programs_run_the_ported_jax_draw(port_detector):
    """The host reference of these tests is the JAX package's draw too:
    the port's draw_detections equals it on the detections found."""
    frames = frames_of(320, 240)[:1]
    dets = port_detector.detect_batch(frames)[0]
    assert dets
    np.testing.assert_array_equal(tdraw.draw_detections(frames[0], dets),
                                  jdraw(frames[0], dets))


# -- the worker ---------------------------------------------------------------


def _serve_face_stream(detector, decode_mode: str):
    """Send the four synthetic pictures one at a time to a device-annotate
    server with a /face_stream viewer; returns (units, parts, sent JPEGs)."""
    datas = [p.read_bytes() for p in sorted(SYNTH_PICS.glob("*.jpg"))]

    async def run():
        async with _serving(detector, decode_mode=decode_mode,
                            annotate_mode="device") as server:
            units = _tap_units(server)
            faces = await _Viewer.open(server.http_port,
                                       "/face_stream?name=a")
            await _until(lambda: _subscribed(server, "a"), desc="viewer")
            source = _GatedSource(datas, lambda i: len(faces.parts()) >= i)
            await send_stream(source, ClientConfig(
                address=f"127.0.0.1:{server.socket_port}", channel="a"))
            await faces.wait(lambda v: len(v.parts()) == len(datas))
            await faces.close()
            return units, faces.parts()

    units, parts = asyncio.run(run())
    return units, parts, datas


@pytest.mark.parametrize("decode_mode, kind", [("pixels", "pixels"),
                                               ("ycbcr", "ycbcr_annot")])
def test_device_annotate_server_serves_encoded_coefficients(
        port_detector, decode_mode, kind):
    units, parts, datas = _serve_face_stream(port_detector, decode_mode)
    assert len(units) == len(parts) == 4
    quant = native_jpeg.load().quant_tables(95)
    for unit, part, data in zip(units, parts, datas):
        assert unit["kind"] == kind and unit["n"] == 1
        frame = codec.decode_rgb(data)
        img = codec.decode_rgb(part)
        assert img.shape == (480, 640, 3)
        assert greens(img) - greens(frame) > 50
        # the part is the annotated program's output on the dispatched
        # batch, entropy-coded
        if kind == "pixels":
            assert unit["annotate"]
            coefs, _ = port_detector.run_device_annotated(unit["batch"])
            geom = tenc.plane_geometry(640, 480, (2, 2))
        else:
            coefs, _ = port_detector.run_device_ycbcr_annotated(
                unit["batch"], unit["geom"])
            geom = unit["geom"]
        want = native_jpeg.load().encode_coefs(
            *tenc.split_coefs(coefs.numpy()[0], geom), (640, 480),
            geom["sampling"], quant)
        assert part == want


@pytest.mark.parametrize("decode_mode", ["pixels", "ycbcr", "coefficients"])
def test_device_annotation_raises_without_the_shim(port_detector, decode_mode,
                                                   tmp_path, monkeypatch):
    """Where the shim cannot build, a worker asked for device annotation
    raises the build's error instead of serving the host draw path, as
    the JAX worker falls back to (ROADMAP C); host annotation of pixels
    needs no shim at construction."""
    from infercam_onnx_tpu_torch.config import EngineConfig
    from infercam_onnx_tpu_torch.serving.inferer import InferenceWorker

    bad = tmp_path / "jpeg_shim.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_jpeg, "SOURCE", bad)
    monkeypatch.setattr(native_jpeg, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native_jpeg, "_instance", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        InferenceWorker(port_detector, EngineConfig(
            decode_mode=decode_mode, annotate_mode="device"))
    InferenceWorker(port_detector, EngineConfig(annotate_mode="host")).close()
