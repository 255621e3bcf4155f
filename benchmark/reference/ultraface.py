"""Plain PyTorch reference of UltraFace version-RFB and of the detect
path around it: the JPEG decode to raw planes with the chroma upsample and
colour conversion, the Triangle resize, the network, the SSD box decode,
the confidence filter and greedy NMS, and the tiled high-resolution merge.

It follows the published network (Linzaer's Ultra-Light-Fast-Generic-Face-
Detector-1MB, ``vision/nn/mb_tiny_RFB.py``, ``vision/ssd/config/
fd_config.py``) with its BatchNorms folded into a per-channel scale and
bias, and runs every float32 product in IEEE float32 (TF32 off). The
controls run a precision below the configuration's: the resample's
products (the chroma upsample and the resize) with their operands rounded
to TF32 (``resample="tf32"``), or their operands and each pass's output
in bfloat16 (``resample="bf16"``), or the trunk's convolutions in float8
e4m3 (``fp8``). It imports nothing of the program under test: the sizes
come from the configuration file and the weights from the caller, as a
pytree in the HWIO layout (``base``, ``extras``, ``cls_heads``,
``reg_heads``).
"""

from __future__ import annotations

import contextlib
import io
import math

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
EPS = 1e-7

# strides of the 13 base blocks; block 7 (the RFB) has 1
BASE_STRIDES = (2, 1, 2, 1, 2, 1, 1, 1, 2, 1, 1, 2, 1)
# (cin, cout) of the conv_dw blocks 1..6 and 8..12, in base channels
DW_PLAN = ((1, 2), (2, 2), (2, 2), (2, 4), (4, 4), (4, 4))
DW_PLAN2 = ((4, 8), (8, 8), (8, 8), (8, 16), (16, 16))
HEAD_IN = (4, 8, 16, 16)


@contextlib.contextmanager
def ieee_float32():
    """Every float32 matmul and conv in IEEE float32 within the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# -- parameters -----------------------------------------------------------


def param_shapes(cfg: dict) -> dict:
    """The network's parameter pytree with each leaf a tuple
    ``(kind, shape, fan_in)``: kind "w" a conv weight (HWIO), "scale" the
    folded BatchNorm's scale, "bias" its shift or a conv's bias, "cls_bias"
    a classification head's bias."""
    c = cfg["base_channel"]
    anchors = [len(m) for m in cfg["min_boxes"]]
    ncls = cfg["num_classes"]

    def cbr(k, cin, cout, groups=1):
        fan = k * k * (cin // groups)
        return {"w": ("w", (k, k, cin // groups, cout), fan),
                "scale": ("scale", (cout,), 0),
                "bias": ("bias", (cout,), 0)}

    def biased(k, cin, cout, groups=1, cls=False):
        fan = k * k * (cin // groups)
        return {"w": ("w", (k, k, cin // groups, cout), fan),
                "b": ("cls_bias" if cls else "bias", (cout,), 0)}

    def conv_dw(cin, cout):
        return {"dw": cbr(3, cin, cin, groups=cin), "pw": cbr(1, cin, cout)}

    def separable(cin, cout, cls=False):
        return {"dw": biased(3, cin, cin, groups=cin),
                "pw": biased(1, cin, cout, cls=cls)}

    base = [cbr(3, 3, c)]
    base += [conv_dw(a * c, b * c) for a, b in DW_PLAN]
    cin, inter = 4 * c, (4 * c) // 8
    base.append({
        "branch0": [cbr(1, cin, inter), cbr(3, inter, 2 * inter),
                    cbr(3, 2 * inter, 2 * inter)],
        "branch1": [cbr(1, cin, inter), cbr(3, inter, 2 * inter),
                    cbr(3, 2 * inter, 2 * inter)],
        "branch2": [cbr(1, cin, inter), cbr(3, inter, (inter // 2) * 3),
                    cbr(3, (inter // 2) * 3, 2 * inter),
                    cbr(3, 2 * inter, 2 * inter)],
        "conv_linear": cbr(1, 6 * inter, cin),
        "shortcut": cbr(1, cin, cin),
    })
    base += [conv_dw(a * c, b * c) for a, b in DW_PLAN2]
    extras = {"proj": biased(1, 16 * c, 4 * c),
              "sep": separable(4 * c, 16 * c)}
    cls_heads, reg_heads = [], []
    for level in range(4):
        cin = HEAD_IN[level] * c
        if level < 3:
            cls_heads.append(separable(cin, anchors[level] * ncls, cls=True))
            reg_heads.append(separable(cin, anchors[level] * 4))
        else:
            cls_heads.append(biased(3, cin, anchors[level] * ncls, cls=True))
            reg_heads.append(biased(3, cin, anchors[level] * 4))
    return {"base": base, "extras": extras, "cls_heads": cls_heads,
            "reg_heads": reg_heads}


def leaves(tree, path=()):
    """(path, leaf) pairs of a pytree of dicts and lists, in a fixed
    order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


# -- the network ------------------------------------------------------------


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (amax to the
    format's largest value), back in float32: what an fp8 GEMM reads."""
    amax = t.abs().max()
    if amax == 0:
        return t
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Network:
    """The forward pass over a pytree of float32 tensors (HWIO weights).

    ``dtype``: the trunk's compute type. In bfloat16 every conv reads and
    writes bfloat16 (accumulating in float32) and the folded affine and
    biases run in it, as the configuration states; the softmax and the box
    decode run in float32. ``fp8``: every conv reads its input and weight
    rounded to float8 e4m3 (per-tensor scales) and accumulates in float32,
    the control's precision."""

    def __init__(self, params: dict, cfg: dict, *,
                 dtype: torch.dtype = torch.float32, fp8: bool = False):
        self.cfg = cfg
        self.fp8 = fp8
        self.dtype = dtype
        self.p = map_tree(self._oihw, params)

    def _oihw(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.dtype)
        return t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t

    def _conv(self, x, w, stride=1, padding=0, dilation=1, groups=1):
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        return F.conv2d(x, w, None, stride, padding, dilation, groups)

    def cbr(self, p, x, *, stride=1, padding=0, dilation=1, groups=1,
            relu=True):
        x = self._conv(x, p["w"], stride, padding, dilation, groups)
        x = x * p["scale"][:, None, None] + p["bias"][:, None, None]
        return F.relu(x) if relu else x

    def biased(self, p, x, *, stride=1, padding=0, groups=1):
        return (self._conv(x, p["w"], stride, padding, 1, groups)
                + p["b"][:, None, None])

    def conv_dw(self, p, x, stride):
        cin = x.shape[1]
        x = self.cbr(p["dw"], x, stride=stride, padding=1, groups=cin)
        return self.cbr(p["pw"], x)

    def separable(self, p, x, stride=1):
        cin = x.shape[1]
        x = F.relu(self.biased(p["dw"], x, stride=stride, padding=1,
                               groups=cin))
        return self.biased(p["pw"], x)

    def rfb(self, p, x):
        def branch(layers, dilation):
            y = self.cbr(layers[0], x, relu=False)
            for layer in layers[1:-1]:
                y = self.cbr(layer, y, padding=1)
            return self.cbr(layers[-1], y, padding=dilation,
                            dilation=dilation, relu=False)

        outs = [branch(p["branch0"], 2), branch(p["branch1"], 3),
                branch(p["branch2"], 5)]
        out = self.cbr(p["conv_linear"], torch.cat(outs, dim=1), relu=False)
        return F.relu(out + self.cbr(p["shortcut"], x, relu=False))

    def head_outputs(self, x: torch.Tensor, heads: str) -> list:
        """The raw outputs [B, K_level, n] of ``heads`` ("cls_heads" or
        "reg_heads") at each level."""
        out = []
        for level, feat in enumerate(self.features(x)):
            p = self.p[heads][level]
            y = (self.separable(p, feat) if level < 3
                 else self.biased(p, feat, padding=1))
            n = self.cfg["num_classes"] if heads == "cls_heads" else 4
            out.append(y.permute(0, 2, 3, 1).reshape(x.shape[0], -1, n))
        return out

    def features(self, x: torch.Tensor) -> list:
        """The four source feature maps (strides 8, 16, 32, 64)."""
        p = self.p
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = self.cbr(p["base"][0], x, stride=2, padding=1)
        feats = []
        for i in range(1, 13):
            if i == 7:
                x = self.rfb(p["base"][7], x)
            else:
                x = self.conv_dw(p["base"][i], x, BASE_STRIDES[i])
            if i in (7, 10, 12):
                feats.append(x)
        e = p["extras"]
        y = F.relu(self.biased(e["proj"], x))
        feats.append(F.relu(self.separable(e["sep"], y, stride=2)))
        return feats

    def __call__(self, x: torch.Tensor, priors: torch.Tensor):
        """[B, H, W, 3] normalized float32 -> (scores [B, K, 2] softmax,
        boxes [B, K, 4] relative corners)."""
        confs, locs = [], []
        for level, feat in enumerate(self.features(x)):
            ch, rh = self.p["cls_heads"][level], self.p["reg_heads"][level]
            if level < 3:
                c, r = self.separable(ch, feat), self.separable(rh, feat)
            else:
                c = self.biased(ch, feat, padding=1)
                r = self.biased(rh, feat, padding=1)
            b = x.shape[0]
            confs.append(c.permute(0, 2, 3, 1).reshape(
                b, -1, self.cfg["num_classes"]))
            locs.append(r.permute(0, 2, 3, 1).reshape(b, -1, 4))
        scores = torch.softmax(torch.cat(confs, dim=1).float(), dim=-1)
        loc = torch.cat(locs, dim=1).float()
        cv, sv = self.cfg["center_variance"], self.cfg["size_variance"]
        centers = loc[..., :2] * cv * priors[:, 2:] + priors[:, :2]
        wh = torch.exp(loc[..., 2:] * sv) * priors[:, 2:]
        return scores, torch.cat([centers - wh / 2, centers + wh / 2], -1)


def priors(cfg: dict) -> np.ndarray:
    """SSD priors [K, 4] (cx, cy, w, h), clipped to [0, 1]: cell centres
    over ``size / shrinkage``, cell counts by ``ceil``."""
    w, h = cfg["input_width"], cfg["input_height"]
    out = []
    for shrink, boxes in zip(cfg["shrinkage"], cfg["min_boxes"]):
        fw, fh = math.ceil(w / shrink), math.ceil(h / shrink)
        for j in range(fh):
            for i in range(fw):
                for m in boxes:
                    out.append([(i + 0.5) / (w / shrink),
                                (j + 0.5) / (h / shrink), m / w, m / h])
    return np.clip(np.asarray(out, np.float32), 0.0, 1.0)


# -- around the network -------------------------------------------------------


def _ycbcr(data: bytes, scale: int) -> np.ndarray:
    """[H, W, 3] uint8 Y, Cb, Cr of a JPEG from libjpeg's scaled IDCT at
    1/``scale`` (PIL's draft mode), no colour conversion."""
    with Image.open(io.BytesIO(data)) as im:
        im.draft("YCbCr", (im.width // scale, im.height // scale))
        return np.asarray(im)


def _fold(c: torch.Tensor) -> torch.Tensor:
    """A plane at half its size: each 2x2 block's mean, rounded half up."""
    h, w = c.shape
    return torch.floor((c.reshape(h // 2, 2, w // 2, 2).sum((1, 3)) + 2) / 4)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest
    with ties away from zero: what a TF32 tensor-core product reads."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _resample(matrix: torch.Tensor, x: torch.Tensor, equation: str,
              precision: str) -> torch.Tensor:
    """One resample pass, ``einsum(equation, matrix, x)``, in
    ``precision``: "float32" (IEEE), "tf32" (operands rounded to TF32) or
    "bf16" (operands and output rounded to bfloat16)."""
    if precision == "tf32":
        return torch.einsum(equation, _tf32(matrix), _tf32(x))
    if precision == "bf16":
        return _bf16(torch.einsum(equation, _bf16(matrix), _bf16(x)))
    return torch.einsum(equation, matrix, x)


def decode_rgb(data: bytes, scale: int,
               resample: str = "float32") -> torch.Tensor:
    """[H, W, 3] float32 RGB on the u8 grid of a 4:2:0 JPEG decoded at
    1/``scale`` as the serving path decodes it: luma from libjpeg's
    scaled IDCT; chroma at half the luma's size (libjpeg's chroma IDCT,
    which at ``scale`` 2 or more comes out at the luma's size and is
    folded back by 2x2 means), upsampled by the Triangle filter (libjpeg's
    "fancy" upsampling, in ``resample``'s precision) and converted with
    BT.601's full-range constants, rounded half to even and clamped."""
    y = torch.from_numpy(_ycbcr(data, scale)[..., 0].astype(np.float32))
    chroma = _ycbcr(data, max(scale, 2))
    cb, cr = (torch.from_numpy(chroma[..., i].astype(np.float32))
              for i in (1, 2))
    if scale > 1:
        cb, cr = _fold(cb), _fold(cr)
    height, width = y.shape
    ch, cw = cb.shape
    up_h = torch.from_numpy(triangle_matrix(ch, 2 * ch))
    up_w = torch.from_numpy(triangle_matrix(cw, 2 * cw))

    def up(c):
        c = _resample(up_h, c, "oh,hw->ow", resample)
        return _resample(up_w, c, "ow,hw->ho", resample)[:height, :width]

    cb, cr = up(cb) - 128.0, up(cr) - 128.0
    rgb = torch.stack([y + 1.402 * cr,
                       y - 0.344136286 * cb - 0.714136286 * cr,
                       y + 1.772 * cb], dim=-1)
    return torch.clamp(torch.round(rgb), 0.0, 255.0)


def triangle_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] Triangle (bilinear, antialiased when minifying) resample
    weights: centre ``(o + 0.5) * in / out``, support scaled by the ratio
    when minifying, taps outside the image dropped and the rest
    renormalized."""
    ratio = in_size / out_size
    sratio = max(ratio, 1.0)
    m = np.zeros((out_size, in_size), np.float64)
    for o in range(out_size):
        centre = (o + 0.5) * ratio
        lo = max(int(np.floor(centre - sratio)), 0)
        hi = min(int(np.ceil(centre + sratio)), in_size - 1)
        for i in range(lo, hi + 1):
            t = abs((i + 0.5 - centre) / sratio)
            if t < 1.0:
                m[o, i] = 1.0 - t
        m[o] /= m[o].sum()
    return m.astype(np.float32)


def preprocess(rgb: torch.Tensor, width: int, height: int, *,
               resample: str = "float32") -> torch.Tensor:
    """[B, H, W, 3] RGB on the u8 grid -> [B, height, width, 3] normalized
    float32: the vertical then the horizontal resize pass (in
    ``resample``'s precision), rounded half up to the u8 grid, then the
    MobileNet mean and std."""
    b, hin, win, _ = rgb.shape
    dev = rgb.device
    r_h = torch.from_numpy(triangle_matrix(hin, height)).to(dev)
    r_w = torch.from_numpy(triangle_matrix(win, width)).to(dev)
    x = _resample(r_h, rgb.to(torch.float32), "oh,bhwc->bowc", resample)
    x = _resample(r_w, x, "ow,bhwc->bhoc", resample)
    x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0) / 255.0
    mean = torch.from_numpy(MEAN).to(dev)
    std = torch.from_numpy(STD).to(dev)
    return (x - mean) / std


def tiles(width: int, height: int, grid, overlap: float):
    """Pixel boxes (x0, y0, x1, y1) of an overlapping cols x rows grid of
    equal tiles, adjacent tiles sharing ``overlap`` of a tile."""
    cols, rows = grid
    tw = int(np.ceil(width / (cols - (cols - 1) * overlap)))
    th = int(np.ceil(height / (rows - (rows - 1) * overlap)))
    xs = (np.linspace(0, width - tw, cols).round().astype(int)
          if cols > 1 else [0])
    ys = (np.linspace(0, height - th, rows).round().astype(int)
          if rows > 1 else [0])
    return [(int(x), int(y), int(x) + tw, int(y) + th)
            for y in ys for x in xs]


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of box ``a`` [4] against boxes ``b`` [N, 4]; ill-formed boxes
    have zero area, EPS in the denominator."""
    def area(x):
        w, h = x[..., 2] - x[..., 0], x[..., 3] - x[..., 1]
        return np.where((w < 0) | (h < 0), 0.0, w * h)

    lt = np.maximum(a[:2], b[:, :2])
    rb = np.minimum(a[2:], b[:, 2:])
    inter = area(np.concatenate([lt, rb], -1))
    return inter / (area(a) + area(b) - inter + EPS)


def nms(conf: np.ndarray, boxes: np.ndarray, cfg: dict) -> list:
    """Filter (strictly above ``min_confidence``), the ``top_k`` best in
    descending confidence (ties to the higher index), greedy suppression
    (strictly above ``max_iou``), at most ``max_detections`` kept:
    [(box [4], confidence)]."""
    k = len(conf)
    order = (k - 1) - np.argsort(-conf[::-1], kind="stable")
    order = order[:cfg["top_k"]]
    order = order[conf[order] > cfg["min_confidence"]]
    kept: list[int] = []
    for i in order:
        if kept and (iou(boxes[i], boxes[kept]) > cfg["max_iou"]).any():
            continue
        kept.append(int(i))
        if len(kept) == cfg["max_detections"]:
            break
    return [(boxes[i].astype(np.float64), float(conf[i])) for i in kept]


@torch.inference_mode()
def candidates(net: Network, cfg: dict, rgb: torch.Tensor, *,
               device: torch.device, tile_grid=None,
               tile_overlap: float = 0.2, resample: str = "float32"):
    """Every prior's face confidence [K'] and box [K', 4] (relative to the
    frame) for one decoded frame (`decode_rgb`): the whole frame resized
    to the network, or each tile of the grid resized and its boxes mapped
    into the frame (K' = tiles x K)."""
    w, h = cfg["input_width"], cfg["input_height"]
    pri = torch.from_numpy(priors(cfg)).to(device)
    frame = rgb.to(device)
    height, width = rgb.shape[:2]
    with ieee_float32():
        if tile_grid is None:
            scores, boxes = net(preprocess(frame[None], w, h, resample=resample), pri)
            return scores[0, :, 1].cpu().numpy(), boxes[0].cpu().numpy()
        confs, out = [], []
        for x0, y0, x1, y1 in tiles(width, height, tile_grid, tile_overlap):
            scores, boxes = net(preprocess(frame[None, y0:y1, x0:x1], w, h,
                                           resample=resample), pri)
            scale = np.array([(x1 - x0) / width, (y1 - y0) / height] * 2,
                             np.float32)
            shift = np.array([x0 / width, y0 / height] * 2, np.float32)
            confs.append(scores[0, :, 1].cpu().numpy())
            out.append(boxes[0].cpu().numpy() * scale + shift)
        return np.concatenate(confs), np.concatenate(out)


def network_inputs(cfg: dict, jpegs: list, *, scale: int,
                   device: torch.device, tile_grid=None,
                   tile_overlap: float = 0.2) -> torch.Tensor:
    """[N, h, w, 3] normalized inputs of the network for ``jpegs``: each
    frame decoded at 1/``scale`` and resized whole, or cut into the tile
    grid's tiles first."""
    w, h = cfg["input_width"], cfg["input_height"]
    out = []
    with ieee_float32():
        for data in jpegs:
            rgb = decode_rgb(data, scale).to(device)
            height, width = rgb.shape[:2]
            boxes = ([(0, 0, width, height)] if tile_grid is None else
                     tiles(width, height, tile_grid, tile_overlap))
            for x0, y0, x1, y1 in boxes:
                out.append(preprocess(rgb[None, y0:y1, x0:x1], w, h))
    return torch.cat(out)
