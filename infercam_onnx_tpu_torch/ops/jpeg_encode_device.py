"""The device annotate tail: overlay + FDCT + quantize + 12-bit pack
(``infercam_onnx_tpu/ops/jpeg_encode_device.py``).

The host draw path decodes a frame, draws green hollow rectangles and a
"{:.2f}%" confidence label with PIL and encodes the whole JPEG again.
Here everything of that but the entropy coding runs on the device, after
the detect program, on the frame's YCbCr planes:

- each box's hollow rectangle is a mask made of two matmuls over the
  detection axis (row edge x column span + row span x column edge);
- each label is a strip of glyphs from an atlas rendered with the host
  draw path's font (16 px DejaVu Sans Mono, ``draw.py``), moved to its
  box's corner by a gather along the columns and a one-hot matmul along
  the rows, and alpha-blended in;
- the forward 8x8 DCT runs as two matmuls per block (the mirror of
  ``ops/jpeg_device.py``'s IDCT), then quantization with libjpeg's tables;
- the quantized coefficients go back packed 12 bits each (`pack12`), and
  the host entropy-codes them (``native/jpeg.py`` `encode_coefs`).

The splice transcode of the coefficients mode ships only the blocks the
overlay touched (`select_changed_blocks`), re-quantized with the input's
own tables; the host splices them into the stream's own coefficients
(`splice_blocks`), so the output is bit-exact to the input elsewhere.

The JAX package computes all this with XLA einsums outside any Pallas
kernel; here the products are ``torch.matmul`` in IEEE float32 whatever
the process's TF32 settings (`config.full_float32`): TF32 would move DCT
coefficients across the .5 rounding boundary. The label layer is summed in
another order than the JAX package's one-hot einsum chain (columns by
gather, then rows by matmul: 12.6 GFLOP at B=16, D=64 on a 480x640 luma
plane where the literal chain takes 44), which is exact wherever labels do
not overlap, and deterministic on the card. Divergences from the host
draw, as in the JAX package: labels that would overflow the frame edge
are moved inside it (PIL clips them), overlapping labels add their alpha,
and glyph antialiasing matches PIL's to within a few u8 steps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from infercam_onnx_tpu_torch.config import full_float32
from infercam_onnx_tpu_torch.ops.jpeg_device import dct_basis

# JPEG subsampling name -> (h_samp, v_samp) luma factors.
SUBSAMPLING_FACTORS = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}

# BT.601 full-range YCbCr of pure green, Rgb(0, 255, 0) (libjpeg's
# jccolor constants).
GREEN_Y = 0.587 * 255.0
GREEN_CB = 128.0 - 0.331264 * 255.0
GREEN_CR = 128.0 - 0.418688 * 255.0

_DOT, _PCT, _BLANK = 10, 11, 12


@functools.lru_cache(maxsize=1)
def glyph_atlas() -> tuple[np.ndarray, int, int]:
    """([13, gh, gw] float32 alpha in 0..1, gh, gw) for "0123456789.%" and
    a blank cell, rendered with the host draw path's font (``draw._font``).
    Cell dims are padded to even, so 4:2:0 chroma stamps subsample
    cleanly."""
    from PIL import Image, ImageDraw

    from infercam_onnx_tpu_torch.draw import FONT_SIZE, _font

    font = _font()
    try:
        gw = int(np.ceil(font.getlength("0")))
        ascent, descent = font.getmetrics()
        gh = ascent + descent
    except AttributeError:  # PIL's bitmap default font
        left, _, right, bottom = font.getbbox("0")
        gw, gh = right - left, bottom + 2
    gh = max(gh, FONT_SIZE)
    gh += gh % 2
    gw += gw % 2
    atlas = np.zeros((13, gh, gw), np.float32)
    for i, ch in enumerate("0123456789.%"):
        img = Image.new("L", (gw, gh), 0)
        ImageDraw.Draw(img).text((0, 0), ch, fill=255, font=font)
        atlas[i] = np.asarray(img, np.float32) / 255.0
    return atlas, gh, gw


@functools.lru_cache(maxsize=None)
def _atlas_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(glyph_atlas()[0]).to(device)


def _label_indices(conf: torch.Tensor) -> torch.Tensor:
    """[...] confidences -> [..., 7] int64 glyph indices of
    "{:.2f}%" of conf * 100, left-aligned and blank-padded. Rounds half up
    as Python's format of the float64 value does for typical scores (an
    exact float32 tie can still show one hundredth off the host label)."""
    v = torch.floor(conf * 10000.0 + 0.5).to(torch.int64)  # percent * 100
    hund = v // 10000
    tens = (v // 1000) % 10
    unit = (v // 100) % 10
    tenth = (v // 10) % 10
    hundredth = v % 10
    blank, dot, pct = (torch.full_like(v, c) for c in (_BLANK, _DOT, _PCT))
    # three layouts: "100.00%", "99.99%", "9.99%"
    a = torch.stack([hund, tens, unit, dot, tenth, hundredth, pct], -1)
    b = torch.stack([tens, unit, dot, tenth, hundredth, pct, blank], -1)
    c = torch.stack([unit, dot, tenth, hundredth, pct, blank, blank], -1)
    return torch.where(hund[..., None] > 0, a,
                       torch.where(tens[..., None] > 0, b, c))


def _label_strips(conf: torch.Tensor) -> torch.Tensor:
    """[B, D] confidences -> [B, D, gh, 7 * gw] float32 alpha strips."""
    _, gh, gw = glyph_atlas()
    strips = _atlas_on(conf.device)[_label_indices(conf)]  # [B, D, 7, gh, gw]
    b, d = conf.shape
    return strips.permute(0, 1, 3, 2, 4).reshape(b, d, gh, 7 * gw)


def _border_mask(x0, y0, x1, y1, valid, ph: int, pw: int,
                 exists=None) -> torch.Tensor:
    """[B, ph, pw] bool hollow-rectangle mask from per-detection inclusive
    corners [B, D], as two matmuls over the detection axis. ``exists``:
    optional (top, bottom, left, right) [B, D] 0/1 flags; an edge whose
    true coordinate fell outside the frame is not drawn (PIL draws only
    the in-frame part of a clipped rectangle)."""
    rows = torch.arange(ph, dtype=torch.float32,
                        device=x0.device)[None, :, None]  # [1, H, 1]
    cols = torch.arange(pw, dtype=torch.float32,
                        device=x0.device)[None, :, None]
    y0e, y1e = y0[:, None, :], y1[:, None, :]
    x0e, x1e = x0[:, None, :], x1[:, None, :]
    v = valid[:, None, :]
    if exists is None:
        top = bot = left = right = torch.ones_like(valid)
    else:
        top, bot, left, right = exists
    in_r = ((rows >= y0e) & (rows <= y1e)).to(torch.float32) * v
    edge_r = ((rows == y0e).to(torch.float32) * top[:, None, :]
              + (rows == y1e).to(torch.float32) * bot[:, None, :]) * v
    in_c = ((cols >= x0e) & (cols <= x1e)).to(torch.float32)
    edge_c = ((cols == x0e).to(torch.float32) * left[:, None, :]
              + (cols == x1e).to(torch.float32) * right[:, None, :])
    border = (torch.matmul(edge_r, in_c.transpose(1, 2))
              + torch.matmul(in_r, edge_c.transpose(1, 2)))
    return border > 0.0


def _stamp_labels(plane: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                  strips: torch.Tensor, value: float):
    """Alpha-blend label strips [B, D, gh, sw] into [B, h, w] planes with
    their top-left corners at (ys, xs) [B, D] int (validity already in the
    strips, corners already inside the plane). Returns the blended plane
    and the label layer.

    The layer is ``sum_d`` of each strip moved to its corner: a gather
    along the columns gives ``u [B, D, gh, w]``, then a one-hot row shift
    ``[B, h, D*gh] @ u`` sums it over the detections. Where labels do not
    overlap, each pixel gets one non-zero term, so any summation order
    gives the same value; the matmul's fixed order keeps it deterministic
    where they do. Overlapping labels add their alpha (clipped to 1),
    where PIL would draw the later one over the earlier."""
    b, d, gh, sw = strips.shape
    if gh > plane.shape[1] or sw > plane.shape[2]:
        # a frame smaller than one label gets no text (PIL would draw a
        # clipped fragment)
        return plane, torch.zeros_like(plane)
    _, h, w = plane.shape
    dev = plane.device
    s = torch.arange(w, device=dev)[None, None, :] - xs[:, :, None]  # [B,D,w]
    inside = ((s >= 0) & (s < sw)).to(torch.float32)
    idx = s.clamp(0, sw - 1)[:, :, None, :].expand(b, d, gh, w)
    u = torch.gather(strips, 3, idx) * inside[:, :, None, :]
    g = torch.arange(h, device=dev)[None, :, None] - ys[:, None, :]  # [B,h,D]
    sy = (g[..., None] == torch.arange(gh, device=dev)).to(torch.float32)
    layer = torch.matmul(sy.reshape(b, h, d * gh), u.reshape(b, d * gh, w))
    layer = torch.clamp(layer, 0.0, 1.0)
    return plane * (1.0 - layer) + value * layer, layer


@full_float32()
def render_overlay_ycbcr(
    y: torch.Tensor,  # [B, y_ph, y_pw] float (0..255)
    cb: torch.Tensor,  # [B, c_ph, c_pw]
    cr: torch.Tensor,
    packed_det: torch.Tensor,  # [B, D, 6] (x0, y0, x1, y1, conf, valid)
    *,
    width: int,
    height: int,
    sampling: tuple[int, int],
    disp_dims: tuple[int, int] | None = None,
    return_masks: bool = False,
):
    """Draw the host path's annotation (green hollow rectangles and
    confidence labels) into the YCbCr planes of ``width`` x ``height``
    frames; returns (y, cb, cr).

    ``disp_dims`` (ServerConfig.assume_frame_dims) scales the relative
    coords instead of the frame's own size. ``return_masks`` also returns
    the bool masks of the luma and chroma pixels the overlay touched
    (y, cb, cr, my, mc), which the splice transcode selects blocks by."""
    hs, vs = sampling
    dw, dh = disp_dims if disp_dims is not None else (width, height)
    boxes = packed_det[..., :4]
    conf = packed_det[..., 4]
    valid = packed_det[..., 5]

    # pixel corners as the host path takes them: int() truncation, the
    # rectangle spans [x_tl, x_br - 1] inclusive
    x0 = torch.floor(boxes[..., 0] * dw)
    y0 = torch.floor(boxes[..., 1] * dh)
    x1 = torch.floor(boxes[..., 2] * dw) - 1.0
    y1 = torch.floor(boxes[..., 3] * dh) - 1.0
    # a box wholly outside the frame draws nothing (PIL culls it; clipped,
    # it would collapse into a phantom line at the edge)
    offscreen = ((x0 > width - 1.0) | (x1 < 0.0)
                 | (y0 > height - 1.0) | (y1 < 0.0))
    valid = valid * (1.0 - offscreen.to(valid.dtype))
    # a partly clipped box keeps only its in-frame edges
    exists = tuple(f.to(torch.float32) for f in (
        y0 >= 0.0, y1 <= height - 1.0,  # top, bottom
        x0 >= 0.0, x1 <= width - 1.0))  # left, right
    # clip to the frame: the planes' iMCU padding stays untouched
    x0 = torch.clamp(x0, 0.0, width - 1.0)
    x1 = torch.clamp(x1, 0.0, width - 1.0)
    y0 = torch.clamp(y0, 0.0, height - 1.0)
    y1 = torch.clamp(y1, 0.0, height - 1.0)

    yb = _border_mask(x0, y0, x1, y1, valid, y.shape[1], y.shape[2], exists)
    y = torch.where(yb, GREEN_Y, y)
    cbb = _border_mask(torch.floor(x0 / hs), torch.floor(y0 / vs),
                       torch.floor(x1 / hs), torch.floor(y1 / vs),
                       valid, cb.shape[1], cb.shape[2], exists)
    # the host encoder's box downsampling averages a subsampled 1-px
    # line about half and half with the background; blend the same way
    ca = 1.0 if (hs == 1 and vs == 1) else 0.5
    cb = torch.where(cbb, ca * GREEN_CB + (1 - ca) * cb, cb)
    cr = torch.where(cbb, ca * GREEN_CR + (1 - ca) * cr, cr)

    # labels at the box's top-left corner, moved wholly inside the visible
    # frame: never into the iMCU padding, which no viewer sees and which
    # would spend splice block budget
    strips = _label_strips(conf) * valid[..., None, None]
    b, d, gh, sw = strips.shape
    lx = torch.clamp(x0, 0.0, float(max(min(width, y.shape[2]) - sw, 0))
                     ).to(torch.int64)
    ly = torch.clamp(y0, 0.0, float(max(min(height, y.shape[1]) - gh, 0))
                     ).to(torch.int64)
    y, ylab = _stamp_labels(y, lx, ly, strips, GREEN_Y)
    if hs == 2 or vs == 2:
        cstrips = strips.reshape(b, d, gh // vs, vs, sw // hs, hs).mean(
            dim=(3, 5))
        cw, chh = -(-width // hs), -(-height // vs)
        clx = torch.clamp(lx // hs, 0, max(min(cw, cb.shape[2]) - sw // hs, 0))
        cly = torch.clamp(ly // vs, 0,
                          max(min(chh, cb.shape[1]) - gh // vs, 0))
        cb, clab = _stamp_labels(cb, clx, cly, cstrips, GREEN_CB)
        cr, _ = _stamp_labels(cr, clx, cly, cstrips, GREEN_CR)
    else:
        cb, clab = _stamp_labels(cb, lx, ly, strips, GREEN_CB)
        cr, _ = _stamp_labels(cr, lx, ly, strips, GREEN_CR)
    if not return_masks:
        return y, cb, cr
    return y, cb, cr, yb | (ylab > 0.0), cbb | (clab > 0.0)


@full_float32()
def fdct_quant(plane: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """[B, ph, pw] float samples (0..255; dims multiples of 8) and a [64]
    quant table (or [B, 64], one a frame) -> [B, bh, bw, 64] int16
    quantized DCT blocks in natural order, rounded half to even.

    The orthonormal 2D DCT of level-shifted samples in [-128, 127] is at
    most 1024 in magnitude and quant divisors are >= 1, so every value
    fits 12 signed bits, which is what lets `pack12` send 1.5 B each."""
    b, ph, pw = plane.shape
    bh, bw = ph // 8, pw // 8
    p = (plane.to(torch.float64).reshape(b, bh, 8, bw, 8)
         .permute(0, 1, 3, 2, 4) - 128.0)
    a = dct_basis(plane.device)  # float64: ties round alike everywhere
    # C = A^T P A (A orthonormal; the decode is P = A C A^T), computed as
    # C^T = (P A)^T A: each product folds the blocks into one matmul
    ct = torch.matmul(torch.matmul(p, a).transpose(-1, -2), a)  # [.., v, u]
    q = qtable.to(torch.float64)
    if q.ndim == 2:  # a table a frame (the splice path: the input's)
        q = q[:, None, None, :]
    c = ct.transpose(-1, -2).reshape(b, bh, bw, 64) / q
    return torch.clamp(torch.round(c), -2047.0, 2047.0).to(torch.int16)


def pack12(coefs: torch.Tensor) -> torch.Tensor:
    """[B, N] int16 quantized coefficients (N even, |v| <= 2047) ->
    [B, N*3//2] uint8, two 12-bit values in 3 bytes: the readback costs
    1.5 B a coefficient instead of 2. The bit arithmetic runs in int32."""
    v = coefs.to(torch.int32) + 2048
    a, bb = v[:, 0::2], v[:, 1::2]
    b0 = a & 0xFF
    b1 = ((a >> 8) & 0x0F) | ((bb & 0x0F) << 4)
    b2 = (bb >> 4) & 0xFF
    return torch.stack([b0, b1, b2], dim=-1).reshape(
        coefs.shape[0], -1).to(torch.uint8)


def unpack12(data: np.ndarray) -> np.ndarray:
    """Host inverse of `pack12` for ONE frame: [M] uint8 -> [M*2//3]
    int16."""
    t = np.asarray(data, np.uint8).reshape(-1, 3).astype(np.int32)
    a = (t[:, 0] | ((t[:, 1] & 0x0F) << 8)) - 2048
    b = (((t[:, 1] >> 4) & 0x0F) | (t[:, 2] << 4)) - 2048
    out = np.empty(t.shape[0] * 2, np.int16)
    out[0::2] = a
    out[1::2] = b
    return out


def pack12_np(coefs: np.ndarray) -> np.ndarray:
    """Host `pack12`: [B, N] int16 -> [B, N*3//2] uint8, values clamped to
    the 12-bit JPEG range (baseline streams never exceed it): the splice
    path's upload of the entropy-decoded coefficients."""
    v = (np.clip(np.asarray(coefs, np.int32), -2047, 2047)
         + 2048).astype(np.uint32)
    a, b = v[:, 0::2], v[:, 1::2]
    out = np.empty((v.shape[0], v.shape[1] // 2, 3), np.uint8)
    out[..., 0] = a & 0xFF
    out[..., 1] = ((a >> 8) & 0x0F) | ((b & 0x0F) << 4)
    out[..., 2] = (b >> 4) & 0xFF
    return out.reshape(v.shape[0], -1)


def unpack12_device(packed: torch.Tensor) -> torch.Tensor:
    """Device inverse of `pack12_np`: [B, M] uint8 -> [B, M*2//3] int16,
    in int32 arithmetic."""
    b = packed.shape[0]
    t = packed.reshape(b, -1, 3).to(torch.int32)
    lo = (t[..., 0] | ((t[..., 1] & 0x0F) << 8)) - 2048
    hi = (((t[..., 1] >> 4) & 0x0F) | (t[..., 2] << 4)) - 2048
    return torch.stack([lo, hi], dim=-1).reshape(b, -1).to(torch.int16)


def block_touch_mask(mask_plane: torch.Tensor) -> torch.Tensor:
    """[B, ph, pw] bool pixel mask -> [B, bh*bw] bool 8x8-block mask: a
    block is touched if any of its pixels is."""
    m = _pad8(mask_plane.to(torch.float32))
    b, ph, pw = m.shape
    return (m.reshape(b, ph // 8, 8, pw // 8, 8).amax(dim=(2, 4))
            > 0.0).reshape(b, -1)


def select_changed_blocks(yq: torch.Tensor, cbq: torch.Tensor,
                          crq: torch.Tensor, my: torch.Tensor,
                          mc: torch.Tensor, k: int):
    """The splice transcode's selection: of the re-quantized blocks, only
    those the overlay touched go back; every other block stays as the
    stream's own entropy-decoded one.

    Returns (`pack12` blocks [B, K*64*3//2] uint8, meta int32 [B, K+1] =
    [n_touched, idx_0 .. idx_{K-1}]), idx a block's place in the
    concatenated (y ++ cb ++ cr) block order, -1 for an unused slot.
    n_touched > K means the budget overflowed: the caller falls back to a
    full-frame path for that frame."""
    b = yq.shape[0]
    all_q = torch.cat([yq.reshape(b, -1, 64), cbq.reshape(b, -1, 64),
                       crq.reshape(b, -1, 64)], dim=1)
    cm = block_touch_mask(mc)
    bm = torch.cat([block_touch_mask(my), cm, cm], dim=1)  # [B, NB]
    nb = bm.shape[1]
    k = min(k, nb)
    # touched blocks first; the index penalty makes every score distinct,
    # so the top k come in one order on every device
    score = (bm.to(torch.float32) * 2.0
             - torch.arange(nb, dtype=torch.float32, device=bm.device) / nb)
    idx = torch.topk(score, k, dim=1, sorted=True).indices
    sel = torch.gather(all_q, 1, idx[..., None].expand(b, k, 64))
    idx = torch.where(torch.gather(bm, 1, idx), idx, -1)
    count = bm.sum(dim=1)
    meta = torch.cat([count[:, None], idx], dim=1).to(torch.int32)
    return pack12(sel.reshape(b, -1)), meta


def splice_blocks(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                  meta: np.ndarray, blocks_packed: np.ndarray):
    """Host half of the splice path for ONE frame: the device's touched
    blocks written into copies of the stream's own block arrays ([bh, bw,
    64] int16 each). Returns the spliced (y, cb, cr). The caller has
    checked meta[0] <= K."""
    idx = np.asarray(meta[1:], np.int64)
    coefs = unpack12(blocks_packed).reshape(idx.shape[0], 64)
    out = np.concatenate(
        [y.reshape(-1, 64), cb.reshape(-1, 64), cr.reshape(-1, 64)])
    chosen = idx >= 0
    out[idx[chosen]] = coefs[chosen]
    y_n, c_n = y.shape[0] * y.shape[1], cb.shape[0] * cb.shape[1]
    return (out[:y_n].reshape(y.shape),
            out[y_n:y_n + c_n].reshape(cb.shape),
            out[y_n + c_n:].reshape(cr.shape))


def _pad8(plane: torch.Tensor) -> torch.Tensor:
    """Edge-replicate a [B, h, w] plane up to multiples of 8 (a scaled
    decode can fold chroma to dims that are not)."""
    _, h, w = plane.shape
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        plane = F.pad(plane[:, None], (0, pw, 0, ph), mode="replicate")[:, 0]
    return plane


def encode_planes(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                  quant2: torch.Tensor) -> torch.Tensor:
    """Quantize the three planes with ``quant2`` [2, 64] (luma, chroma)
    and pack them into ONE [B, (y_blocks + 2 * c_blocks) * 96] uint8 array:
    one readback a batch, which `split_coefs` takes apart on the host.
    Dims that are not multiples of 8 are edge-padded first."""
    b = y.shape[0]
    yq = fdct_quant(_pad8(y), quant2[0])
    cbq = fdct_quant(_pad8(cb), quant2[1])
    crq = fdct_quant(_pad8(cr), quant2[1])
    return pack12(torch.cat([yq.reshape(b, -1), cbq.reshape(b, -1),
                             crq.reshape(b, -1)], dim=1))


def rgb_to_ycbcr_planes(rgb: torch.Tensor, *, sampling: tuple[int, int]):
    """[B, H, W, 3] frames (0..255) -> (y, cb, cr) float32 planes padded to
    whole iMCUs by edge replication, chroma box-averaged down: libjpeg's
    colour conversion and h2v2 (h2v1) downsampling, so the pixels decode
    mode rides the device encode tail too."""
    hs, vs = sampling
    b, h, w, _ = rgb.shape
    rgb = rgb.to(torch.float32)
    r, g, bch = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * bch
    cb = -0.168736 * r - 0.331264 * g + 0.5 * bch + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * bch + 128.0
    geom = plane_geometry(w, h, sampling)
    pad = (0, geom["y_pw"] - w, 0, geom["y_ph"] - h)
    y, cb, cr = (F.pad(p[:, None], pad, mode="replicate")[:, 0]
                 for p in (y, cb, cr))
    if hs == 2 or vs == 2:
        c_pw, c_ph = geom["c_pw"], geom["c_ph"]
        cb, cr = (p.reshape(b, c_ph, vs, c_pw, hs).mean(dim=(2, 4))
                  for p in (cb, cr))
    return y, cb, cr


def plane_geometry(width: int, height: int,
                   sampling: tuple[int, int]) -> dict:
    """The geometry dict (``decode_ycbcr_batch``'s keys) of the planes
    `rgb_to_ycbcr_planes` gives."""
    hs, vs = sampling
    mcu_w, mcu_h = 8 * hs, 8 * vs
    y_pw = -(-width // mcu_w) * mcu_w
    y_ph = -(-height // mcu_h) * mcu_h
    return {"width": width, "height": height, "y_pw": y_pw, "y_ph": y_ph,
            "c_pw": y_pw // hs, "c_ph": y_ph // vs, "sampling": (hs, vs)}


def split_coefs(packed: np.ndarray, geom: dict):
    """Host inverse of `encode_planes`' packing for ONE frame: [n*3//2]
    uint8 -> ([y_bh, y_bw, 64], cb, cr) int16 blocks (ceil block dims:
    `encode_planes` edge-pads planes that are not multiples of 8)."""
    coefs = unpack12(packed)
    y_bw, y_bh = -(-geom["y_pw"] // 8), -(-geom["y_ph"] // 8)
    c_bw, c_bh = -(-geom["c_pw"] // 8), -(-geom["c_ph"] // 8)
    y_n, c_n = y_bw * y_bh * 64, c_bw * c_bh * 64
    return (coefs[:y_n].reshape(y_bh, y_bw, 64),
            coefs[y_n:y_n + c_n].reshape(c_bh, c_bw, 64),
            coefs[y_n + c_n:y_n + 2 * c_n].reshape(c_bh, c_bw, 64))
