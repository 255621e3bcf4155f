"""The detect path: uint8 frames in, packed detections out, on one device.

The counterpart of ``infercam_onnx_tpu/detector.py``'s
``detect_program_impl``: preprocess (resize + normalize), the UltraFace
forward, and filter + greedy NMS over a whole batch of frames. The raw
uint8 frames are the only host->device copy, and with
``pack_output=True`` one ``[B, D, 6]`` array is the only copy back.
`detect_from_ycbcr` (``detect_from_ycbcr_impl``) takes the host's packed
YCbCr planes instead, upsamples chroma and converts to RGB on the device,
and runs the same program; `detect_from_coefficients` takes the JPEGs'
quantized DCT coefficients and runs the IDCT on the device too.

The annotated programs (``detector.py:187-380`` there) run the same detect
program and then the device annotate tail (``ops/jpeg_encode_device.py``):
`detect_annotate` (pixels mode) and `detect_annotate_from_ycbcr` return
the output JPEG's packed quantized coefficients beside the detections;
`detect_annotate_splice` (coefficients mode) returns only the blocks its
overlay touched. Each program launches the NMS kernel once.
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from infercam_onnx_tpu_torch.config import (DetectorConfig, full_float32,
                                            resolve_device)
from infercam_onnx_tpu_torch.models import checkpoint
from infercam_onnx_tpu_torch.models import ultraface as uf
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
from infercam_onnx_tpu_torch.ops.jpeg_device import (combine_ycbcr,
                                                     decode_plane,
                                                     decode_rgb_device,
                                                     read_coefficient_batch,
                                                     unpack_ycbcr_planes)
from infercam_onnx_tpu_torch.ops.jpeg_encode_device import (
    SUBSAMPLING_FACTORS, encode_planes, fdct_quant, pack12_np,
    render_overlay_ycbcr, rgb_to_ycbcr_planes, select_changed_blocks,
    unpack12_device)
from infercam_onnx_tpu_torch.ops.postprocess import batched_postprocess
from infercam_onnx_tpu_torch.ops.preprocess import Preprocessor, preprocess_images

log = logging.getLogger(__name__)

# A detection: (relative corner bbox [x_tl, y_tl, x_br, y_br], confidence)
Detection = tuple[np.ndarray, float]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@torch.inference_mode()
@full_float32()
def detect_program(
    model: uf.UltraFace,
    priors: torch.Tensor,
    images: torch.Tensor,  # [B, H, W, 3] uint8
    r_h: torch.Tensor,
    r_w: torch.Tensor,
    *,
    min_confidence: float,
    max_iou: float,
    top_k: int,
    max_detections: int,
    pack_output: bool = False,
    nms_impl: str = "kernel",
):
    """uint8 frames in, padded detections out, all on ``images.device``.

    The convs run in the model's parameter dtype, a float32 trunk in IEEE
    float32 whatever the process's TF32 settings. Returns
    ``(boxes [B,D,4], confs [B,D], counts [B])``, or with ``pack_output``
    one [B, D, 6] array of rows (x_tl, y_tl, x_br, y_br, confidence,
    valid). ``nms_impl`` is `batched_nms`'s ``impl``."""
    x = preprocess_images(images, r_h, r_w)
    scores, boxes = model(x, priors)
    sel_boxes, sel_conf, count = batched_postprocess(
        scores, boxes, min_confidence=min_confidence, max_iou=max_iou,
        top_k=top_k, max_detections=max_detections, impl=nms_impl)
    if not pack_output:
        return sel_boxes, sel_conf, count
    return pack_detections(sel_boxes, sel_conf, count)


@torch.inference_mode()
def detect_from_ycbcr(
    model: uf.UltraFace,
    priors: torch.Tensor,
    packed: torch.Tensor,  # [B, n] uint8: Y ++ Cb ++ Cr padded planes
    r_h: torch.Tensor,
    r_w: torch.Tensor,
    *,
    width: int,
    height: int,
    y_pw: int,
    y_ph: int,
    c_pw: int,
    c_ph: int,
    sampling: tuple[int, int],
    min_confidence: float,
    max_iou: float,
    top_k: int,
    max_detections: int,
    pack_output: bool = False,
):
    """Packed YCbCr planes in (``decode_ycbcr_batch``'s layout and
    geometry), padded detections out, all on ``packed.device``: unpack,
    chroma upsample + BT.601 to float RGB on the u8 grid, then
    `detect_program`."""
    y, cb, cr = unpack_ycbcr_planes(packed, y_pw=y_pw, y_ph=y_ph,
                                    c_pw=c_pw, c_ph=c_ph)
    rgb = combine_ycbcr(y, cb, cr, width=width, height=height,
                        sampling=sampling)
    return detect_program(
        model, priors, rgb, r_h, r_w, min_confidence=min_confidence,
        max_iou=max_iou, top_k=top_k, max_detections=max_detections,
        pack_output=pack_output)


@torch.inference_mode()
def detect_from_coefficients(
    model: uf.UltraFace,
    priors: torch.Tensor,
    y_coefs: torch.Tensor,  # [B, ybh, ybw, 64] int16, entropy-decoded
    cb_coefs: torch.Tensor,
    cr_coefs: torch.Tensor,
    quant: torch.Tensor,  # [B, 3, 64]
    r_h: torch.Tensor,
    r_w: torch.Tensor,
    *,
    width: int,
    height: int,
    sampling: tuple[int, int],
    min_confidence: float,
    max_iou: float,
    top_k: int,
    max_detections: int,
    pack_output: bool = False,
):
    """JPEG DCT coefficients in, padded detections out, all on the
    device: dequantize, 8x8 IDCT, chroma upsample, BT.601, then
    `detect_program`. The host only entropy-decodes. ``sampling`` is the
    stream's luma (h, v) factor pair."""
    rgb = decode_rgb_device(y_coefs, cb_coefs, cr_coefs, quant, width=width,
                            height=height, sampling=sampling)
    return detect_program(
        model, priors, rgb, r_h, r_w, min_confidence=min_confidence,
        max_iou=max_iou, top_k=top_k, max_detections=max_detections,
        pack_output=pack_output)


@torch.inference_mode()
def detect_annotate_from_ycbcr(
    model: uf.UltraFace,
    priors: torch.Tensor,
    packed: torch.Tensor,  # [B, n] uint8 packed planes
    r_h: torch.Tensor,
    r_w: torch.Tensor,
    quant2: torch.Tensor,  # [2, 64] encode quant tables (luma, chroma)
    *,
    width: int,
    height: int,
    y_pw: int,
    y_ph: int,
    c_pw: int,
    c_ph: int,
    sampling: tuple[int, int],
    disp_dims: tuple[int, int] | None,
    min_confidence: float,
    max_iou: float,
    top_k: int,
    max_detections: int,
):
    """The annotated program of the ycbcr mode: packed YCbCr planes in;
    the output JPEG's quantized coefficients (`encode_planes`' packed
    [B, m] uint8) and the packed [B, D, 6] detections out. Detection, the
    overlay and the FDCT + quantize all run on the device; the host
    entropy-codes (``native/jpeg.py`` `encode_coefs`)."""
    y, cb, cr = unpack_ycbcr_planes(packed, y_pw=y_pw, y_ph=y_ph,
                                    c_pw=c_pw, c_ph=c_ph)
    rgb = combine_ycbcr(y, cb, cr, width=width, height=height,
                        sampling=sampling)
    packed_det = detect_program(
        model, priors, rgb, r_h, r_w, min_confidence=min_confidence,
        max_iou=max_iou, top_k=top_k, max_detections=max_detections,
        pack_output=True)
    y, cb, cr = render_overlay_ycbcr(y, cb, cr, packed_det, width=width,
                                     height=height, sampling=sampling,
                                     disp_dims=disp_dims)
    return encode_planes(y, cb, cr, quant2), packed_det


@torch.inference_mode()
def detect_annotate_splice(
    model: uf.UltraFace,
    priors: torch.Tensor,
    packed_coefs: torch.Tensor,  # [B, N*3//2] uint8 (pack12_np upload)
    quant: torch.Tensor,  # [B, 3, 64] the input stream's quant tables
    r_h: torch.Tensor,
    r_w: torch.Tensor,
    *,
    width: int,
    height: int,
    y_bw: int,
    y_bh: int,
    c_bw: int,
    c_bh: int,
    sampling: tuple[int, int],
    k: int,
    disp_dims: tuple[int, int] | None,
    min_confidence: float,
    max_iou: float,
    top_k: int,
    max_detections: int,
):
    """The splice transcode of the coefficients mode: 12-bit packed
    entropy-decoded coefficients in; the packed detections and only the
    blocks the overlay touched, re-quantized with the input's own tables,
    out (`select_changed_blocks`: blocks [B, k*96] uint8, meta [B, k+1]
    int32). The host splices them into its own coefficients and
    entropy-codes, so the annotated JPEG is bit-exact to the input outside
    the drawn blocks, and the readback is bounded by k blocks."""
    b = packed_coefs.shape[0]
    coefs = unpack12_device(packed_coefs)
    y_n, c_n = y_bw * y_bh * 64, c_bw * c_bh * 64
    yc = coefs[:, :y_n].reshape(b, y_bh, y_bw, 64)
    cbc = coefs[:, y_n:y_n + c_n].reshape(b, c_bh, c_bw, 64)
    crc = coefs[:, y_n + c_n:].reshape(b, c_bh, c_bw, 64)
    # dequantize + IDCT, snapped to the u8 grid a host decode gives: the
    # overlay and the re-quantization both see pixels
    y, cb, cr = (torch.clamp(torch.round(decode_plane(c, quant[:, i])),
                             0.0, 255.0)
                 for i, c in enumerate((yc, cbc, crc)))
    rgb = combine_ycbcr(y, cb, cr, width=width, height=height,
                        sampling=sampling)
    packed_det = detect_program(
        model, priors, rgb, r_h, r_w, min_confidence=min_confidence,
        max_iou=max_iou, top_k=top_k, max_detections=max_detections,
        pack_output=True)
    y, cb, cr, my, mc = render_overlay_ycbcr(
        y, cb, cr, packed_det, width=width, height=height, sampling=sampling,
        disp_dims=disp_dims, return_masks=True)
    yq, cbq, crq = (fdct_quant(p, quant[:, i])
                    for i, p in enumerate((y, cb, cr)))
    blocks, meta = select_changed_blocks(yq, cbq, crq, my, mc, k)
    return blocks, meta, packed_det


@torch.inference_mode()
def detect_annotate(
    model: uf.UltraFace,
    priors: torch.Tensor,
    images: torch.Tensor,  # [B, H, W, 3] uint8
    r_h: torch.Tensor,
    r_w: torch.Tensor,
    quant2: torch.Tensor,
    *,
    out_sampling: tuple[int, int],
    disp_dims: tuple[int, int] | None,
    min_confidence: float,
    max_iou: float,
    top_k: int,
    max_detections: int,
):
    """The annotated program of the pixels mode: detect, convert the
    frames to YCbCr planes at ``out_sampling`` on the device, draw the
    overlay, FDCT + quantize; returns (`encode_planes`' packed
    coefficients, packed detections). The host entropy-codes instead of
    drawing and encoding the whole JPEG."""
    _, h, w, _ = images.shape
    packed_det = detect_program(
        model, priors, images, r_h, r_w, min_confidence=min_confidence,
        max_iou=max_iou, top_k=top_k, max_detections=max_detections,
        pack_output=True)
    y, cb, cr = rgb_to_ycbcr_planes(images, sampling=out_sampling)
    y, cb, cr = render_overlay_ycbcr(y, cb, cr, packed_det, width=w,
                                     height=h, sampling=out_sampling,
                                     disp_dims=disp_dims)
    return encode_planes(y, cb, cr, quant2), packed_det


def pack_coefficient_batch(y, cb, cr, quant):
    """Host upload preparation of the splice path: the entropy-decoded
    block arrays, concatenated and 12-bit packed. Returns (packed [B,
    N*3//2] uint8, quant, ((y_bh, y_bw), (c_bh, c_bw)))."""
    y, cb, cr = (np.asarray(p, np.int16) for p in (y, cb, cr))
    b = y.shape[0]
    flat = np.concatenate(
        [y.reshape(b, -1), cb.reshape(b, -1), cr.reshape(b, -1)], axis=1)
    return (pack12_np(flat), np.asarray(quant),
            (tuple(y.shape[1:3]), tuple(cb.shape[1:3])))


@functools.lru_cache(maxsize=None)
def _encode_quant(quality: int, device: torch.device) -> torch.Tensor:
    """[2, 64] float32 copy on ``device`` of libjpeg's encode quant tables
    at ``quality``."""
    tables = native_jpeg.quant_tables_cached(quality)
    return torch.from_numpy(tables.astype(np.float32)).to(device)


def as_tensor(a: torch.Tensor | np.ndarray) -> torch.Tensor:
    """A host array as a tensor where it lies (uint16 quant tables as
    int32: torch's uint16 has few ops); a tensor as it is."""
    if isinstance(a, np.ndarray):  # torch wants writable memory
        if a.dtype == np.uint16:
            a = a.astype(np.int32)
        a = torch.from_numpy(np.require(a, requirements="WC"))
    return a


def pack_detections(sel_boxes, sel_conf, count) -> torch.Tensor:
    """(boxes [B,D,4], confs [B,D], count [B]) -> ONE [B, D, 6] array
    (x0, y0, x1, y1, conf, valid); `unpack_detections` is the host-side
    inverse."""
    d = sel_boxes.shape[1]
    rows = torch.arange(d, device=sel_boxes.device)
    valid = (rows[None, :] < count[:, None]).to(torch.float32)
    return torch.cat([sel_boxes, sel_conf[..., None], valid[..., None]],
                     dim=-1)


def unpack_detections(packed: np.ndarray) -> list[list[Detection]]:
    """Host-side inverse of ``pack_output=True``."""
    out: list[list[Detection]] = []
    for row in np.asarray(packed):
        n = int(row[:, 5].sum())
        out.append([(row[i, :4], float(row[i, 4])) for i in range(n)])
    return out


class Detector:
    """UltraFace detector on one device.

    Weights, in order: ``params`` (a JAX-layout pytree), else the .npz at
    ``weights`` (either layout `models.checkpoint.load_params` reads),
    else deterministic random weights ``init_params(rng,
    background_bias=0.75)``. There is no download path.
    """

    def __init__(self, config: DetectorConfig = DetectorConfig(),
                 params=None, *, weights: str | None = None, rng: int = 0,
                 device: str | torch.device = "cuda"):
        if config.variant not in uf.VARIANTS:
            raise ValueError(f"unknown variant {config.variant!r}; have "
                             f"{list(uf.VARIANTS)}")
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {config.compute_dtype!r}")
        self.config = config
        self.device = resolve_device(device)
        if params is None and weights is not None:
            params = checkpoint.load_params(weights)
        if params is None:
            log.warning("no UltraFace weights given; using deterministic "
                        "random weights (seed %d)", rng)
            params = uf.init_params(rng, background_bias=0.75,
                                    arch=uf.arch_of(config.variant))
        self.width, self.height = uf.VARIANTS[config.variant]
        self.model = uf.UltraFace.from_params(params).to(
            device=self.device, dtype=_DTYPES[config.compute_dtype])
        self.priors = torch.from_numpy(
            uf.generate_priors(self.width, self.height)).to(self.device)
        self.preprocessor = Preprocessor(self.width, self.height,
                                         self.device)

    # -- device program ----------------------------------------------------

    def _on_device(self, a: torch.Tensor | np.ndarray) -> torch.Tensor:
        """``a`` as a tensor on the detector's device (`as_tensor`)."""
        return as_tensor(a).to(self.device)

    def _dispatch(self, inputs: list, call, fills: tuple | None = None):
        """Run one program: ``call(replica, *inputs)``, where the replica
        (the detector itself here) has ``model``, ``priors``,
        ``preprocessor`` and ``device``, and the batch-major ``inputs`` are
        on its device. `parallel.data_parallel.ShardedDetector` overrides
        this to split the batch over replicas (``fills``: the value each
        input's padding rows take there)."""
        return call(self, *(self._on_device(a) for a in inputs))

    def _thresholds(self) -> dict:
        """The filter + NMS keyword arguments of every program."""
        c = self.config
        return dict(min_confidence=c.min_confidence, max_iou=c.max_iou,
                    top_k=c.top_k, max_detections=c.max_detections)

    def run_device(self, images: torch.Tensor | np.ndarray, *,
                   pack_output: bool = False):
        """[B, H, W, 3] uint8 -> (boxes [B,D,4], confs [B,D], counts [B])
        as tensors on the device, or with ``pack_output`` one [B, D, 6]
        tensor. Returns without waiting for the device."""
        _, h, w, _ = images.shape

        def call(r, images):
            return detect_program(r.model, r.priors, images,
                                  *r.preprocessor.matrices(w, h),
                                  pack_output=pack_output,
                                  **self._thresholds())
        return self._dispatch([images], call)

    def run_device_ycbcr(self, datas: list[bytes], *, scale: int = 1,
                         pack_output: bool = False):
        """JPEG bytes of one geometry -> detections: the host decodes
        them to packed YCbCr planes at 1/``scale`` (one batched call on the
        shim's thread pool), and `run_device_ycbcr_packed` does the rest."""
        packed, geom = native_jpeg.load().decode_ycbcr_batch(datas,
                                                             scale=scale)
        return self.run_device_ycbcr_packed(packed, geom,
                                            pack_output=pack_output)

    def run_device_ycbcr_packed(self, packed: torch.Tensor | np.ndarray,
                                geom: dict, *, pack_output: bool = False):
        """[B, n] uint8 packed planes and their ``geom`` (from
        ``decode_ycbcr_batch``) -> detections as `run_device` gives them,
        on the device, one host->device copy. Returns without waiting for
        the device."""
        w, h = geom["width"], geom["height"]

        def call(r, packed):
            return detect_from_ycbcr(
                r.model, r.priors, packed, *r.preprocessor.matrices(w, h),
                width=w, height=h, y_pw=geom["y_pw"], y_ph=geom["y_ph"],
                c_pw=geom["c_pw"], c_ph=geom["c_ph"],
                sampling=tuple(geom["sampling"]), pack_output=pack_output,
                **self._thresholds())
        return self._dispatch([packed], call)

    def run_device_coefficients(self, datas: list[bytes], *,
                                pack_output: bool = False):
        """JPEG bytes of one geometry -> detections: the host only
        entropy-decodes (`read_coefficient_batch`), and
        `run_device_coefficients_arrays` does the rest."""
        y, cb, cr, quant, wh, sampling = read_coefficient_batch(datas)
        return self.run_device_coefficients_arrays(
            y, cb, cr, quant, wh, sampling=sampling, pack_output=pack_output)

    def run_device_coefficients_arrays(self, y, cb, cr, quant,
                                       wh: tuple[int, int], *,
                                       sampling: tuple[int, int] = (2, 2),
                                       pack_output: bool = False):
        """Stacked coefficient blocks ([B, bh, bw, 64] int16 each), quant
        tables [B, 3, 64], the frames' (width, height) and the stream's
        luma sampling -> detections as `run_device` gives them (IDCT to
        NMS on the device, `detect_from_coefficients`)."""
        w, h = wh

        def call(r, y, cb, cr, quant):
            return detect_from_coefficients(
                r.model, r.priors, y, cb, cr, quant,
                *r.preprocessor.matrices(w, h), width=w, height=h,
                sampling=tuple(sampling), pack_output=pack_output,
                **self._thresholds())
        return self._dispatch([y, cb, cr, quant], call)

    def run_device_ycbcr_annotated(self, packed, geom: dict, *,
                                   quality: int = 95,
                                   disp_dims: tuple | None = None):
        """Packed planes and their geometry -> (packed quantized
        coefficients [B, m] uint8, packed detections [B, D, 6]) on the
        device (`detect_annotate_from_ycbcr`); the host finishes each frame
        with `split_coefs` and `encode_coefs`. Planes that are not
        multiples of 8 (scaled decodes) are edge-padded on the device."""
        w, h = geom["width"], geom["height"]

        def call(r, packed):
            return detect_annotate_from_ycbcr(
                r.model, r.priors, packed, *r.preprocessor.matrices(w, h),
                _encode_quant(quality, r.device), width=w, height=h,
                y_pw=geom["y_pw"], y_ph=geom["y_ph"], c_pw=geom["c_pw"],
                c_ph=geom["c_ph"], sampling=tuple(geom["sampling"]),
                disp_dims=tuple(disp_dims) if disp_dims else None,
                **self._thresholds())
        return self._dispatch([packed], call)

    def run_device_coefficients_annotated(
            self, y, cb, cr, quant, wh: tuple[int, int], *,
            sampling: tuple[int, int] = (2, 2), k: int = 768,
            disp_dims: tuple | None = None):
        """The splice transcode from stacked coefficient blocks: packs them
        (`pack_coefficient_batch`) and calls
        `run_device_coefficients_annotated_packed`. Returns (blocks, meta,
        packed detections); meta[i, 0] > k means frame i overflowed the
        budget and needs a full-frame path."""
        packed, quant, shapes = pack_coefficient_batch(y, cb, cr, quant)
        return self.run_device_coefficients_annotated_packed(
            packed, quant, wh=wh, shapes=shapes, sampling=sampling, k=k,
            disp_dims=disp_dims)

    def run_device_coefficients_annotated_packed(
            self, packed12, quant, *, wh: tuple[int, int], shapes: tuple,
            sampling: tuple[int, int] = (2, 2), k: int = 768,
            disp_dims: tuple | None = None):
        """The device half of the splice transcode, packing done:
        ``shapes`` = ((y_bh, y_bw), (c_bh, c_bw)) (`detect_annotate_splice`).
        The serving worker packs and uploads on its decode thread. Padding
        rows get quant tables of ones, so they stay finite through the
        dequantize/requantize round trip."""
        (y_bh, y_bw), (c_bh, c_bw) = shapes
        w, h = wh

        def call(r, packed12, quant):
            return detect_annotate_splice(
                r.model, r.priors, packed12, quant,
                *r.preprocessor.matrices(w, h), width=w, height=h, y_bw=y_bw,
                y_bh=y_bh, c_bw=c_bw, c_bh=c_bh, sampling=tuple(sampling),
                k=k, disp_dims=tuple(disp_dims) if disp_dims else None,
                **self._thresholds())
        return self._dispatch([packed12, quant], call, fills=(0, 1))

    def run_device_annotated(self, images, *, quality: int = 95,
                             subsampling: str = "420",
                             disp_dims: tuple | None = None):
        """[B, H, W, 3] uint8 frames -> (packed quantized coefficients of
        the annotated output JPEG at ``subsampling``, packed detections)
        on the device (`detect_annotate`)."""
        _, h, w, _ = images.shape

        def call(r, images):
            return detect_annotate(
                r.model, r.priors, images, *r.preprocessor.matrices(w, h),
                _encode_quant(quality, r.device),
                out_sampling=SUBSAMPLING_FACTORS[subsampling],
                disp_dims=tuple(disp_dims) if disp_dims else None,
                **self._thresholds())
        return self._dispatch([images], call)

    def warmup(self, batch_size: int, height: int, width: int) -> None:
        """Run one (B, H, W) batch so the kernel build, cuDNN's algorithm
        choice and the resize matrices happen ahead of traffic."""
        dummy = np.zeros((batch_size, height, width, 3), np.uint8)
        self.run_device(dummy, pack_output=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- host API ----------------------------------------------------------

    def detect_batch(self, frames: np.ndarray) -> list[list[Detection]]:
        """[B, H, W, 3] uint8 frames -> per-frame detection lists
        (relative corner bboxes + confidences, descending confidence)."""
        packed = self.run_device(frames, pack_output=True)
        return unpack_detections(packed.cpu().numpy())

    def detect(self, frame: np.ndarray) -> list[Detection]:
        """Single [H, W, 3] uint8 frame -> detections."""
        return self.detect_batch(frame[None])[0]
