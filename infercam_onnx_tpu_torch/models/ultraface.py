"""UltraFace (RFB and slim, 320 and 640) as a PyTorch ``nn.Module``.

The counterpart of ``infercam_onnx_tpu/models/ultraface.py``. Priors and
parameter init are pure NumPy and give bit-identical arrays to the JAX
package for the same seed. The module keeps the JAX package's layout at
its public edge: ``[B, H, W, 3]`` in, ``scores [B, K, 2]`` and
``boxes [B, K, 4]`` out. Inside it runs NCHW/OIHW, the layout PyTorch's
convolutions take.

Numerics follow the JAX forward in every compute dtype: each conv's
output is in the compute dtype (cuDNN accumulates in float32), the
folded-BatchNorm affine is applied in that dtype, and softmax and the box
decode run in float32. Running in bfloat16 is done by casting the whole
module (``model.to(torch.bfloat16)``), which equals the JAX code's
per-call ``astype`` of every weight, scale and bias.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from infercam_onnx_tpu_torch.models.convert import params_from_jax

# Variant name -> (width, height) of the model input.
VARIANTS: dict[str, tuple[int, int]] = {
    "RFB-320": (320, 240),
    "RFB-640": (640, 480),
    "slim-320": (320, 240),
    "slim-640": (640, 480),
}

NUM_CLASSES = 2
BASE_CHANNEL = 16  # upstream Mb_Tiny_RFB base_channel = 8 * 2

# SSD prior-grid hyperparameters of the upstream network (K = 4420 at 320,
# 17640 at 640).
MIN_BOXES = ((10, 16, 24), (32, 48), (64, 96), (128, 192, 256))
SHRINKAGE = (8, 16, 32, 64)
CENTER_VARIANCE = 0.1
SIZE_VARIANCE = 0.2

Params = Any  # nested dict/list pytree of NumPy arrays, JAX (HWIO) layout


def arch_of(variant: str) -> str:
    return "slim" if variant.lower().startswith("slim") else "RFB"


# ---------------------------------------------------------------------------
# Priors (NumPy)
# ---------------------------------------------------------------------------


def feature_map_sizes(width: int, height: int) -> list[tuple[int, int]]:
    """(w, h) of each SSD source feature map for the given input size."""
    return [
        (math.ceil(width / s), math.ceil(height / s)) for s in SHRINKAGE
    ]


def generate_priors(width: int, height: int) -> np.ndarray:
    """SSD prior boxes in center form ``[cx, cy, w, h]``, shape [K, 4].

    Cell centers are normalized by ``size / shrinkage`` (a float) while
    the number of cells uses ``ceil``, as upstream does, so edge priors of
    odd-sized maps sit beyond 1.0 before the final clamp.
    """
    priors = []
    for level, (fw, fh) in enumerate(feature_map_sizes(width, height)):
        scale_w = width / SHRINKAGE[level]
        scale_h = height / SHRINKAGE[level]
        for j in range(fh):
            for i in range(fw):
                cx = (i + 0.5) / scale_w
                cy = (j + 0.5) / scale_h
                for mb in MIN_BOXES[level]:
                    priors.append([cx, cy, mb / width, mb / height])
    return np.clip(np.asarray(priors, dtype=np.float32), 0.0, 1.0)


def num_priors(width: int, height: int) -> int:
    fmaps = feature_map_sizes(width, height)
    return sum(fw * fh * len(mb) for (fw, fh), mb in zip(fmaps, MIN_BOXES))


def decode_locations(loc: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """SSD location decode -> relative corner-form boxes.

    centers = loc[..., :2] * center_variance * prior_wh + prior_cxcy
    wh      = exp(loc[..., 2:] * size_variance) * prior_wh
    """
    centers = loc[..., :2] * CENTER_VARIANCE * priors[..., 2:] + priors[..., :2]
    wh = torch.exp(loc[..., 2:] * SIZE_VARIANCE) * priors[..., 2:]
    return torch.cat([centers - wh / 2.0, centers + wh / 2.0], dim=-1)


# ---------------------------------------------------------------------------
# Parameter init (NumPy; same draws as the JAX package's init_params)
# ---------------------------------------------------------------------------


def _init_cbr(gen, kh, kw, cin, cout, *, groups: int = 1) -> dict:
    fan_in = kh * kw * (cin // groups)
    w = gen.standard_normal((kh, kw, cin // groups, cout), np.float32)
    w = w * np.float32(np.sqrt(2.0 / fan_in))
    return {
        "w": w,
        "scale": np.ones((cout,), np.float32),
        "bias": np.zeros((cout,), np.float32),
    }


def _init_biased(gen, kh, kw, cin, cout, *, groups: int = 1) -> dict:
    fan_in = kh * kw * (cin // groups)
    w = gen.standard_normal((kh, kw, cin // groups, cout), np.float32)
    w = w * np.float32(np.sqrt(2.0 / fan_in))
    return {"w": w, "b": np.zeros((cout,), np.float32)}


def _init_separable(gen, cin, cout) -> dict:
    return {
        "dw": _init_biased(gen, 3, 3, cin, cin, groups=cin),
        "pw": _init_biased(gen, 1, 1, cin, cout),
    }


def _init_conv_dw(gen, cin, cout) -> dict:
    return {
        "dw": _init_cbr(gen, 3, 3, cin, cin, groups=cin),
        "pw": _init_cbr(gen, 1, 1, cin, cout),
    }


def _init_rfb_block(gen, c: int) -> dict:
    inter = (4 * c) // 8
    return {
        "branch0": [
            _init_cbr(gen, 1, 1, 4 * c, inter),
            _init_cbr(gen, 3, 3, inter, 2 * inter),
            _init_cbr(gen, 3, 3, 2 * inter, 2 * inter),
        ],
        "branch1": [
            _init_cbr(gen, 1, 1, 4 * c, inter),
            _init_cbr(gen, 3, 3, inter, 2 * inter),
            _init_cbr(gen, 3, 3, 2 * inter, 2 * inter),
        ],
        "branch2": [
            _init_cbr(gen, 1, 1, 4 * c, inter),
            _init_cbr(gen, 3, 3, inter, (inter // 2) * 3),
            _init_cbr(gen, 3, 3, (inter // 2) * 3, 2 * inter),
            _init_cbr(gen, 3, 3, 2 * inter, 2 * inter),
        ],
        "conv_linear": _init_cbr(gen, 1, 1, 6 * inter, 4 * c),
        "shortcut": _init_cbr(gen, 1, 1, 4 * c, 4 * c),
    }


# (cin, cout) of the conv_dw blocks 1..6 and 8..12, in units of BASE_CHANNEL
_DW_PLAN = ((1, 2), (2, 2), (2, 2), (2, 4), (4, 4), (4, 4))
_DW_PLAN2 = ((4, 8), (8, 8), (8, 8), (8, 16), (16, 16))
_HEAD_IN = (4, 8, 16, 16)
_ANCHORS = tuple(len(mb) for mb in MIN_BOXES)  # (3, 2, 2, 3)


def init_params(
    rng: int = 0,
    *,
    background_bias: float = 0.0,
    arch: str = "RFB",
) -> Params:
    """Random (He-normal) parameters with the exact UltraFace structure,
    in the JAX package's pytree layout (HWIO weights).

    ``background_bias`` is added to the background-class logits of every
    classification head, which makes random-weight detections sparse.
    ``arch`` is "RFB" (BasicRFB at block 7) or "slim" (conv_dw).
    """
    gen = np.random.default_rng(rng)
    c = BASE_CHANNEL
    base: list[dict] = [_init_cbr(gen, 3, 3, 3, c)]
    base += [_init_conv_dw(gen, ci * c, co * c) for ci, co in _DW_PLAN]
    if arch == "slim":
        base.append(_init_conv_dw(gen, 4 * c, 4 * c))
    else:
        base.append(_init_rfb_block(gen, c))
    base += [_init_conv_dw(gen, ci * c, co * c) for ci, co in _DW_PLAN2]

    extras = {
        "proj": _init_biased(gen, 1, 1, 16 * c, 4 * c),
        "sep": _init_separable(gen, 4 * c, 16 * c),
    }

    cls_heads, reg_heads = [], []
    for level in range(4):
        cin = _HEAD_IN[level] * c
        cout_c = _ANCHORS[level] * NUM_CLASSES
        cout_r = _ANCHORS[level] * 4
        if level < 3:
            cls_heads.append(_init_separable(gen, cin, cout_c))
            reg_heads.append(_init_separable(gen, cin, cout_r))
        else:
            cls_heads.append(_init_biased(gen, 3, 3, cin, cout_c))
            reg_heads.append(_init_biased(gen, 3, 3, cin, cout_r))

    if background_bias:
        for level in range(4):
            h = cls_heads[level]
            tgt = h["pw"] if level < 3 else h
            tgt["b"] = tgt["b"].copy()
            tgt["b"][0::NUM_CLASSES] += background_bias

    return {
        "base": base,
        "extras": extras,
        "cls_heads": cls_heads,
        "reg_heads": reg_heads,
    }


# ---------------------------------------------------------------------------
# Layers (NCHW, OIHW)
# ---------------------------------------------------------------------------


def _weight(cout: int, cin: int, k: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(cout, cin, k, k), requires_grad=False)


def _vector(n: int, value: float) -> nn.Parameter:
    return nn.Parameter(torch.full((n,), value), requires_grad=False)


class ConvAffine(nn.Module):
    """conv (no bias) + folded-BatchNorm affine + optional ReLU: upstream
    BasicConv / conv_bn / each half of conv_dw."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 relu: bool = True):
        super().__init__()
        self.w = _weight(cout, cin // groups, k)
        self.scale = _vector(cout, 1.0)
        self.bias = _vector(cout, 0.0)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups, self.relu = dilation, groups, relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x, self.w, None, self.stride, self.padding,
                     self.dilation, self.groups)
        x = x * self.scale[:, None, None] + self.bias[:, None, None]
        return F.relu(x) if self.relu else x


class BiasedConv(nn.Module):
    """conv + bias, the bias added in the compute dtype after the conv
    (as the JAX forward does; cuDNN's fused bias would round once less)."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 padding: int = 0, groups: int = 1):
        super().__init__()
        self.w = _weight(cout, cin // groups, k)
        self.b = _vector(cout, 0.0)
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x, self.w, None, self.stride, self.padding, 1,
                     self.groups)
        return x + self.b[:, None, None]


class ConvDW(nn.Module):
    """Upstream conv_dw: depthwise 3x3 + BN + ReLU, pointwise 1x1 + BN +
    ReLU."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.dw = ConvAffine(cin, cin, 3, stride=stride, padding=1,
                             groups=cin)
        self.pw = ConvAffine(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))


class Separable(nn.Module):
    """Upstream SeperableConv2d: depthwise 3x3 (bias) + ReLU + 1x1 (bias)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.dw = BiasedConv(cin, cin, 3, stride=stride, padding=1,
                             groups=cin)
        self.pw = BiasedConv(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(F.relu(self.dw(x)))


class RFB(nn.Module):
    """Upstream BasicRFB (stride 1, vision 1, scale 1). Dilated 3x3 convs
    pad by their dilation, so every branch keeps the input's size."""

    def __init__(self, c: int):
        super().__init__()
        inter = c // 8

        def cbr(cin, cout, k, padding=0, dilation=1, relu=True):
            return ConvAffine(cin, cout, k, padding=padding,
                              dilation=dilation, relu=relu)

        self.branch0 = nn.ModuleList([
            cbr(c, inter, 1, relu=False),
            cbr(inter, 2 * inter, 3, padding=1),
            cbr(2 * inter, 2 * inter, 3, padding=2, dilation=2, relu=False),
        ])
        self.branch1 = nn.ModuleList([
            cbr(c, inter, 1, relu=False),
            cbr(inter, 2 * inter, 3, padding=1),
            cbr(2 * inter, 2 * inter, 3, padding=3, dilation=3, relu=False),
        ])
        self.branch2 = nn.ModuleList([
            cbr(c, inter, 1, relu=False),
            cbr(inter, (inter // 2) * 3, 3, padding=1),
            cbr((inter // 2) * 3, 2 * inter, 3, padding=1),
            cbr(2 * inter, 2 * inter, 3, padding=5, dilation=5, relu=False),
        ])
        self.conv_linear = cbr(6 * inter, c, 1, relu=False)
        self.shortcut = cbr(c, c, 1, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for branch in (self.branch0, self.branch1, self.branch2):
            y = x
            for layer in branch:
                y = layer(y)
            outs.append(y)
        out = self.conv_linear(torch.cat(outs, dim=1))
        return F.relu(out + self.shortcut(x))


class Extras(nn.Module):
    """1x1 conv (bias) + ReLU, then separable stride-2 + ReLU."""

    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.proj = BiasedConv(cin, mid, 1)
        self.sep = Separable(mid, cout, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.sep(F.relu(self.proj(x))))


# Strides of the 13 base-net blocks (block 7 is the RFB, stride 1).
_BASE_STRIDES = (2, 1, 2, 1, 2, 1, 1, None, 2, 1, 1, 2, 1)


class UltraFace(nn.Module):
    """The UltraFace network. Its state-dict keys are the JAX parameter
    pytree's paths joined by "." (``base.7.branch0.0.w``), with OIHW
    weights; `from_params` loads a JAX-layout pytree."""

    def __init__(self, arch: str = "RFB"):
        super().__init__()
        if arch not in ("RFB", "slim"):
            raise ValueError(f"unknown arch {arch!r}")
        c = BASE_CHANNEL
        base: list[nn.Module] = [ConvAffine(3, c, 3, stride=2, padding=1)]
        plan = [(ci * c, co * c) for ci, co in _DW_PLAN]
        base += [ConvDW(ci, co, _BASE_STRIDES[i])
                 for i, (ci, co) in enumerate(plan, start=1)]
        base.append(RFB(4 * c) if arch == "RFB" else ConvDW(4 * c, 4 * c, 1))
        plan2 = [(ci * c, co * c) for ci, co in _DW_PLAN2]
        base += [ConvDW(ci, co, _BASE_STRIDES[i])
                 for i, (ci, co) in enumerate(plan2, start=8)]
        self.base = nn.ModuleList(base)
        self.extras = Extras(16 * c, 4 * c, 16 * c)
        cls, reg = [], []
        for level in range(4):
            cin = _HEAD_IN[level] * c
            cout_c = _ANCHORS[level] * NUM_CLASSES
            cout_r = _ANCHORS[level] * 4
            if level < 3:
                cls.append(Separable(cin, cout_c))
                reg.append(Separable(cin, cout_r))
            else:  # the last level uses plain 3x3 convs
                cls.append(BiasedConv(cin, cout_c, 3, padding=1))
                reg.append(BiasedConv(cin, cout_r, 3, padding=1))
        self.cls_heads = nn.ModuleList(cls)
        self.reg_heads = nn.ModuleList(reg)

    @classmethod
    def from_params(cls, params: Params) -> "UltraFace":
        """Build from a JAX-layout pytree (`init_params`, the converters
        or a checkpoint); the arch follows the structure of block 7."""
        arch = "RFB" if "branch0" in params["base"][7] else "slim"
        model = cls(arch)
        state = {k: torch.from_numpy(v)
                 for k, v in params_from_jax(params).items()}
        model.load_state_dict(state, strict=True)
        return model.eval()

    def forward(self, x: torch.Tensor,
                priors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``x`` [B, H, W, 3] normalized input, ``priors`` [K, 4] float32
        center-form. Returns float32 ``scores`` [B, K, 2] (softmax, face
        prob at [..., 1]) and ``boxes`` [B, K, 4] relative corners. Convs
        run in the dtype of the module's parameters."""
        dtype = self.base[0].w.dtype
        x = x.to(dtype).permute(0, 3, 1, 2)
        feats = []
        for i in range(13):
            x = self.base[i](x)
            if i in (7, 10, 12):  # strides 8, 16, 32
                feats.append(x)
        feats.append(self.extras(x))  # stride 64

        batch = x.shape[0]
        confs, locs = [], []
        for feat, ch, rh in zip(feats, self.cls_heads, self.reg_heads):
            # NHWC before the reshape: y-major, x, anchor, the prior order
            confs.append(ch(feat).permute(0, 2, 3, 1)
                         .reshape(batch, -1, NUM_CLASSES))
            locs.append(rh(feat).permute(0, 2, 3, 1).reshape(batch, -1, 4))
        conf = torch.cat(confs, dim=1).float()
        loc = torch.cat(locs, dim=1).float()
        scores = torch.softmax(conf, dim=-1)
        return scores, decode_locations(loc, priors.float())
