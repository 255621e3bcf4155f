"""The port's coefficients decode mode and splice transcode against the
JAX package's (``ops/jpeg_device.py``, ``ops/jpeg_encode_device.py``,
``detect_from_coefficients``, ``detect_annotate_splice``), and the
worker's coefficient units, on the CPU.

The same JPEG bytes (made from a seed with numpy, or the synthetic
pictures) go through both packages. Tolerances:

- exact: `read_coefficient_batch` (its errors too),
  `pack_coefficient_batch`, `block_touch_mask`, `select_changed_blocks`
  given equal coefficients and masks, `splice_blocks`;
- `decode_plane`: within 1e-3 (the port's IDCT runs in float64, XLA's in
  float32);
- `decode_rgb_device`: equal u8 levels except at most 1e-3 of the
  values, one level apart;
- `detect_from_coefficients` and `detect_annotate_splice` at float32 on
  the frozen weights: counts equal, boxes within 1e-5 and confidences
  within 5e-5 at 320x240, within 5e-5 and 2e-4 at 640x427 (the
  preprocess resize, ROADMAP C, on top of the RGB levels the IDCT moves);
  the splice's meta equal to the JAX package's tail on the
  same coefficients and the port's detections, its blocks off by at most
  1 in at most 2e-3 of the coefficients (the .5 ties of
  ``tests/test_torch_port_annotate.py``), every block it did not touch
  bit-exact to the input, and the entropy-coded JPEG within a mean
  absolute difference of 4 of the host draw + encode.

The worker tests serve on ``device="cpu"`` (every listener on port 0):
detection-only records equal `run_device_coefficients_arrays` on the
dispatched batch; a /face_stream part of the splice transcode equals
`splice_blocks` + `encode_coefs` of the program's output on that batch,
keeps every untouched block of the sent JPEG, and shows more than 50 green
overlay pixels; with a budget of 8 blocks every part comes from the host
fallback.
"""

import asyncio
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from infercam_onnx_tpu import detector as jdet
from infercam_onnx_tpu.native import jpeg as jnative
from infercam_onnx_tpu.ops import jpeg_device as jjd
from infercam_onnx_tpu.ops import jpeg_encode_device as jenc
from infercam_onnx_tpu_torch import codec
from infercam_onnx_tpu_torch import detector as tdet
from infercam_onnx_tpu_torch.client.sender import send_stream
from infercam_onnx_tpu_torch.config import ClientConfig
from infercam_onnx_tpu_torch.detector import Detector, unpack_detections
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
from infercam_onnx_tpu_torch.ops import jpeg_device as tjd
from infercam_onnx_tpu_torch.ops import jpeg_encode_device as tenc

from tests.test_goldens_fixtures import SYNTH_PICS, WEIGHTS
from tests.test_torch_port_annotate import (CONFIG, PROGRAM_CASES, SAMPLINGS,
                                            annotated_vs_host,
                                            assert_coefficients_match,
                                            assert_detections_match,
                                            frames_of, greens, jax_detector)
from tests.test_torch_port_native import smooth_jpeg
from tests.test_torch_port_serving import (_GatedSource, _detections_of,
                                           _serving, _subscribed, _tap_units,
                                           _until, _Viewer)
from torch_port_offline import offline_weights_chain  # noqa: E402,F401


@pytest.fixture(scope="module")
def port_detector():
    return Detector(CONFIG, weights=str(WEIGHTS), device="cpu")


@pytest.fixture(scope="module")
def jax_det():
    return jax_detector()


def _jpegs(size, n: int = 2) -> list[bytes]:
    """The synthetic pictures at ``size`` as quality-92 4:2:0 JPEGs."""
    return [codec.encode_rgb(f, 92) for f in frames_of(*size)[:n]]


# -- the host half ------------------------------------------------------------


@pytest.mark.parametrize("size", [(640, 427), (333, 251)])
@pytest.mark.parametrize("sub", sorted(SAMPLINGS))
def test_read_coefficient_batch_equals_jax(sub, size):
    datas = [smooth_jpeg(s, *size, sub) for s in (0, 1, 2)]
    got = tjd.read_coefficient_batch(datas)
    want = jjd.read_coefficient_batch(datas)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[4:] == want[4:] == (size, SAMPLINGS[sub])
    # and the shim's one-frame export equals the JAX shim's
    for g, w in zip(native_jpeg.load().read_coefficients(datas[0]),
                    jnative.load().read_coefficients(datas[0])):
        np.testing.assert_array_equal(g, w)


def test_read_coefficient_batch_refuses_what_jax_refuses():
    a = smooth_jpeg(0, 128, 96, "420")
    buf = io.BytesIO()
    Image.new("L", (64, 48), 90).save(buf, "JPEG")
    cases = [([a, smooth_jpeg(1, 64, 96, "420")], "mixed JPEG geometries"),
             ([a, smooth_jpeg(1, 128, 96, "444")], "mixed JPEG geometries"),
             ([], "empty"), ([b"\xff\xd8 not a jpeg"], "corrupt"),
             ([buf.getvalue()], "unsupported")]
    for datas, match in cases:
        with pytest.raises(ValueError, match=match):
            tjd.read_coefficient_batch(datas)
        with pytest.raises(ValueError, match=match):
            jjd.read_coefficient_batch(datas)


def test_pack_coefficient_batch_equals_jax():
    y, cb, cr, quant, _, _ = tjd.read_coefficient_batch(
        [smooth_jpeg(s, 333, 251, "420") for s in (0, 1)])
    got = tdet.pack_coefficient_batch(y, cb, cr, quant)
    want = jdet.pack_coefficient_batch(y, cb, cr, quant)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == ((32, 42), (16, 21))


# -- the device decode ----------------------------------------------------------


def test_decode_plane_matches_jax():
    rng = np.random.default_rng(3)
    coefs = rng.integers(-60, 60, size=(2, 5, 7, 64)).astype(np.int16)
    coefs[..., 0] = rng.integers(-120, 120, size=(2, 5, 7))
    quant = rng.integers(1, 30, size=(2, 64)).astype(np.uint16)
    got = tjd.decode_plane(torch.from_numpy(coefs),
                           torch.from_numpy(quant.astype(np.int32)))
    assert got.dtype == torch.float32 and got.shape == (2, 40, 56)
    np.testing.assert_allclose(got.numpy(), np.asarray(jjd.decode_plane(
        jnp.asarray(coefs), jnp.asarray(quant))), rtol=0, atol=1e-3)


@pytest.mark.parametrize("size", [(640, 427), (333, 251)])
@pytest.mark.parametrize("sub", sorted(SAMPLINGS))
def test_decode_rgb_device_matches_jax(sub, size):
    datas = [smooth_jpeg(s, *size, sub) for s in (4, 5)]
    y, cb, cr, quant, (w, h), samp = tjd.read_coefficient_batch(datas)
    got = tjd.decode_rgb_device(
        *(torch.from_numpy(a) for a in (y, cb, cr, quant.astype(np.int32))),
        width=w, height=h, sampling=samp).numpy()
    want = np.asarray(jjd.decode_rgb_device(
        *(jnp.asarray(a) for a in (y, cb, cr, quant)), width=w, height=h,
        sampling=samp))
    assert got.shape == want.shape == (2, h, w, 3)
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()
    # and close to the host's own decode of the same bytes
    host = np.stack(codec.decode_batch(datas))
    assert np.abs(got - host).mean() < 1.0


# -- block selection and the splice ---------------------------------------------


def _masks(seed: int, b: int, shape, c_shape):
    rng = np.random.default_rng(seed)
    my = rng.uniform(size=(b, *shape)) < 0.002
    mc = rng.uniform(size=(b, *c_shape)) < 0.002
    my[0, :3, :40] = True  # a drawn line
    return my, mc


@pytest.mark.parametrize("shape", [(48, 64), (107, 160), (30, 41)])
def test_block_touch_mask_equals_jax(shape):
    mask, _ = _masks(1, 2, shape, shape)
    got = tenc.block_touch_mask(torch.from_numpy(mask))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jenc.block_touch_mask(jnp.asarray(mask))))


@pytest.mark.parametrize("k", [8, 64, 100000])
def test_select_changed_blocks_equals_jax(k):
    rng = np.random.default_rng(k)
    yq = rng.integers(-2047, 2048, size=(2, 14, 20, 64)).astype(np.int16)
    cbq, crq = (rng.integers(-2047, 2048, size=(2, 7, 10, 64)).astype(
        np.int16) for _ in range(2))
    my, mc = _masks(k, 2, (112, 160), (56, 80))
    got = tenc.select_changed_blocks(
        *(torch.from_numpy(a) for a in (yq, cbq, crq, my, mc)), k)
    want = jenc.select_changed_blocks(
        *(jnp.asarray(a) for a in (yq, cbq, crq, my, mc)), k)
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    meta = got[1].numpy()
    assert meta[0, 0] > 0 and (k < 64 or (meta[:, 1:] >= 0).sum()
                               == meta[:, 0].sum())


def test_splice_blocks_equals_jax():
    y, cb, cr, _, _, _ = tjd.read_coefficient_batch(
        [smooth_jpeg(2, 200, 120, "420")])
    rng = np.random.default_rng(2)
    nb = y[0].shape[0] * y[0].shape[1] + 2 * cb[0].shape[0] * cb[0].shape[1]
    idx = rng.choice(nb, size=12, replace=False)
    meta = np.concatenate([[12], idx, [-1, -1]]).astype(np.int32)
    blocks = tenc.pack12_np(rng.integers(-500, 500, size=(1, 14 * 64)))[0]
    got = tenc.splice_blocks(y[0], cb[0], cr[0], meta, blocks)
    want = jenc.splice_blocks(y[0], cb[0], cr[0], meta, blocks)
    for g, w, o in zip(got, want, (y[0], cb[0], cr[0])):
        np.testing.assert_array_equal(g, w)
        assert g.shape == o.shape
    # the originals are not written to
    np.testing.assert_array_equal(y[0], tjd.read_coefficient_batch(
        [smooth_jpeg(2, 200, 120, "420")])[0][0])


# -- the programs -----------------------------------------------------------------


@pytest.mark.parametrize("size, scale, tols", PROGRAM_CASES)
def test_detect_from_coefficients_matches_jax(port_detector, jax_det, size,
                                              scale, tols):
    datas = _jpegs(size)
    y, cb, cr, quant, wh, samp = tjd.read_coefficient_batch(datas)
    got = port_detector.run_device_coefficients_arrays(
        y, cb, cr, quant, wh, sampling=samp, pack_output=True)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want = np.asarray(jax_det.run_device_coefficients_arrays(
        y, cb, cr, quant, wh, sampling=samp, pack_output=True))
    assert_detections_match(got.numpy(), want, tols)
    assert want[..., 5].sum() >= 2
    # the bytes-in entry point entropy-decodes the same blocks
    np.testing.assert_array_equal(port_detector.run_device_coefficients(
        datas, pack_output=True).numpy(), got.numpy())


def _jax_splice_tail(y, cb, cr, quant, packed_det, wh, samp, k):
    """The JAX package's splice tail on the same coefficients and the
    port's detections: u8-snapped IDCT planes, overlay with masks,
    requantization with the input's tables, block selection."""
    jq = jnp.asarray(quant)
    planes = [jnp.clip(jnp.round(jjd.decode_plane(jnp.asarray(c), jq[:, i])),
                       0.0, 255.0) for i, c in enumerate((y, cb, cr))]
    *drawn, my, mc = jenc.render_overlay_ycbcr(
        *planes, jnp.asarray(packed_det), width=wh[0], height=wh[1],
        sampling=samp, return_masks=True)
    qs = [jenc.fdct_quant(p, jq[:, i]) for i, p in enumerate(drawn)]
    blocks, meta = jenc.select_changed_blocks(*qs, my, mc, k)
    return np.asarray(blocks), np.asarray(meta)


@pytest.mark.parametrize("size, scale, tols", PROGRAM_CASES)
def test_detect_annotate_splice_matches_jax(port_detector, jax_det, size,
                                            scale, tols):
    datas = _jpegs(size)
    y, cb, cr, quant, wh, samp = tjd.read_coefficient_batch(datas)
    blocks, meta, packed = port_detector.run_device_coefficients_annotated(
        y, cb, cr, quant, wh, sampling=samp, k=768)
    blocks, meta, packed = blocks.numpy(), meta.numpy(), packed.numpy()
    _, _, jpacked = jax_det.run_device_coefficients_annotated(
        y, cb, cr, quant, wh, sampling=samp, k=768)
    assert_detections_match(packed, np.asarray(jpacked), tols)
    assert packed[..., 5].sum() >= 2
    want_blocks, want_meta = _jax_splice_tail(y, cb, cr, quant, packed, wh,
                                              samp, 768)
    np.testing.assert_array_equal(meta, want_meta)
    assert_coefficients_match(
        np.stack([tenc.unpack12(r) for r in blocks]),
        np.stack([tenc.unpack12(r) for r in want_blocks]))
    nb = y.shape[1] * y.shape[2] + 2 * cb.shape[1] * cb.shape[2]
    quant2 = quant[0, :2]
    for i, data in enumerate(datas):
        assert 0 < meta[i, 0] <= 768 < nb
        spliced = tenc.splice_blocks(y[i], cb[i], cr[i], meta[i], blocks[i])
        touched = set(meta[i, 1:][meta[i, 1:] >= 0].tolist())
        untouched = [j for j in range(nb) if j not in touched]
        flat = [np.concatenate([p.reshape(-1, 64) for p in planes])
                for planes in ((y[i], cb[i], cr[i]), spliced)]
        np.testing.assert_array_equal(flat[0][untouched], flat[1][untouched])
        jpeg = native_jpeg.load().encode_coefs(*spliced, wh, samp, quant2)
        dets = unpack_detections(packed[i:i + 1])[0]
        assert annotated_vs_host(jpeg, codec.decode_rgb(data), dets) < 4.0


def test_splice_overflow_is_flagged(port_detector):
    y, cb, cr, quant, wh, samp = tjd.read_coefficient_batch(
        _jpegs((320, 240), 1))
    _, meta, _ = port_detector.run_device_coefficients_annotated(
        y, cb, cr, quant, wh, sampling=samp, k=8)
    assert meta.shape == (1, 9) and int(meta[0, 0]) > 8


# -- the worker ---------------------------------------------------------------------


def _serve(detector, *, faces: bool, **engine_kw):
    """Send the four synthetic pictures one at a time to a coefficients
    server with a /face_stream (else /detections) viewer on stream "c";
    returns (worker, units, parts or records, sent JPEGs)."""
    datas = [p.read_bytes() for p in sorted(SYNTH_PICS.glob("*.jpg"))]
    path = "/face_stream?name=c" if faces else "/detections?name=c"

    async def run():
        async with _serving(detector, decode_mode="coefficients",
                            **engine_kw) as server:
            units = _tap_units(server)
            viewer = await _Viewer.open(server.http_port, path)
            await _until(lambda: _subscribed(
                server, "c", "inferred" if faces else "detections"),
                desc="viewer")

            def got():
                return viewer.parts() if faces else viewer.records()

            source = _GatedSource(datas, lambda i: len(got()) >= i)
            await send_stream(source, ClientConfig(
                address=f"127.0.0.1:{server.socket_port}", channel="c"))
            await viewer.wait(lambda v: len(got()) == len(datas))
            await viewer.close()
            return server.worker, units, got()

    return (*asyncio.run(run()), datas)


def test_coefficients_server_publishes_run_device_coefficients(
        port_detector):
    _, units, records, datas = _serve(port_detector, faces=False)
    assert len(units) == len(records) == 4
    for unit, rec, data in zip(units, records, datas):
        assert unit["kind"] == "coef" and unit["n"] == 1
        y, cb, cr, quant, wh, samp = tjd.read_coefficient_batch([data])
        for got, want in zip(unit["batch"], (y, cb, cr, quant)):
            np.testing.assert_array_equal(got.numpy(), want)
        want = port_detector.run_device_coefficients_arrays(
            *unit["batch"], wh, sampling=samp, pack_output=True).numpy()
        assert (rec["width"], rec["height"]) == (640, 480)
        assert rec["detections"] == _detections_of(want[0])
    assert sum(len(r["detections"]) for r in records) >= 10


def test_splice_server_serves_the_spliced_input(port_detector):
    worker, units, parts, datas = _serve(port_detector, faces=True)
    assert len(units) == len(parts) == 4 and worker.splice_fallbacks == 0
    for unit, part, data in zip(units, parts, datas):
        assert unit["kind"] == "coef_annot" and unit["n"] == 1
        blocks, meta, _ = port_detector.run_device_coefficients_annotated_packed(
            *unit["batch"], wh=(640, 480), shapes=unit["shapes"],
            sampling=unit["sampling"], k=768)
        y, cb, cr, quant, wh, samp = tjd.read_coefficient_batch([data])
        meta, blocks = meta.numpy()[0], blocks.numpy()[0]
        spliced = tenc.splice_blocks(y[0], cb[0], cr[0], meta, blocks)
        assert part == native_jpeg.load().encode_coefs(*spliced, wh, samp,
                                                       quant[0, :2])
        # every block the overlay did not touch is the sent JPEG's own
        out = tjd.read_coefficient_batch([part])
        touched = meta[1:][meta[1:] >= 0]
        for got, want in ((out[:3], (y, cb, cr)),):
            flat_got = np.concatenate([p[0].reshape(-1, 64) for p in got])
            flat_want = np.concatenate([p[0].reshape(-1, 64) for p in want])
            keep = np.ones(len(flat_got), bool)
            keep[touched] = False
            np.testing.assert_array_equal(flat_got[keep], flat_want[keep])
            assert (flat_got[~keep] != flat_want[~keep]).any()
        img = codec.decode_rgb(part)
        assert img.shape == (480, 640, 3)
        assert greens(img) - greens(codec.decode_rgb(data)) > 50


def test_splice_overflow_falls_back_to_the_host(port_detector):
    worker, units, parts, datas = _serve(port_detector, faces=True,
                                         annotate_splice_blocks=8)
    assert len(parts) == 4 and worker.splice_fallbacks == 4
    assert all(u["kind"] == "coef_annot" for u in units)
    for part, data in zip(parts, datas):
        img = codec.decode_rgb(part)
        assert img.shape == (480, 640, 3)
        assert greens(img) - greens(codec.decode_rgb(data)) > 50
