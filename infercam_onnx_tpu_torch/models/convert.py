"""Weight conversion, all in NumPy.

- `params_from_state_dict`: upstream-named tensors (``base_net.0.0.weight``,
  ``base_net.7.branch0.0.conv.weight``, ...; the names PyTorch checkpoints
  and ONNX initializers of the upstream network carry, and the names of
  the committed ``resources/weights/ultraface-twin.npz``) -> the JAX
  package's parameter pytree, with BatchNorm folded to a per-channel
  affine. A copy of ``infercam_onnx_tpu/models/convert.py``'s loader.
- `params_from_jax`: that pytree (HWIO weights) -> the state dict of
  ``models.ultraface.UltraFace`` (OIHW weights, "."-joined pytree paths).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

Array = np.ndarray
StateDict = Mapping[str, Array]

BN_EPS = 1e-5  # upstream BatchNorm2d default


def fold_bn(gamma: Array, beta: Array, mean: Array,
            var: Array) -> tuple[Array, Array]:
    """Inference-mode BatchNorm as ``x * scale + bias``."""
    scale = gamma / np.sqrt(var + BN_EPS)
    bias = beta - mean * scale
    return scale.astype(np.float32), bias.astype(np.float32)


def _oihw_to_hwio(w: Array) -> Array:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _hwio_to_oihw(w: Array) -> Array:
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


class _Getter:
    """Fetches tensors from a state dict, tracking what was consumed."""

    def __init__(self, sd: StateDict):
        self.sd = dict(sd)
        self.used: set[str] = set()

    def __call__(self, name: str) -> Array:
        if name not in self.sd:
            raise KeyError(
                f"missing parameter {name!r}; available keys start with: "
                f"{sorted(self.sd)[:8]}")
        self.used.add(name)
        return np.asarray(self.sd[name], dtype=np.float32)

    def unused(self) -> list[str]:
        return [k for k in self.sd if k not in self.used
                and "num_batches_tracked" not in k and k != "priors"]


def _cbr(g: _Getter, conv: str, bn: str) -> dict:
    scale, bias = fold_bn(
        g(f"{bn}.weight"), g(f"{bn}.bias"),
        g(f"{bn}.running_mean"), g(f"{bn}.running_var"))
    return {"w": _oihw_to_hwio(g(f"{conv}.weight")),
            "scale": scale, "bias": bias}


def _basic_conv(g: _Getter, prefix: str) -> dict:
    return _cbr(g, f"{prefix}.conv", f"{prefix}.bn")


def _conv_dw(g: _Getter, prefix: str) -> dict:
    return {
        "dw": _cbr(g, f"{prefix}.0", f"{prefix}.1"),
        "pw": _cbr(g, f"{prefix}.3", f"{prefix}.4"),
    }


def _biased(g: _Getter, prefix: str) -> dict:
    return {"w": _oihw_to_hwio(g(f"{prefix}.weight")),
            "b": g(f"{prefix}.bias")}


def _separable(g: _Getter, prefix: str) -> dict:
    # upstream SeperableConv2d = Sequential(dw conv, ReLU, pw conv)
    return {"dw": _biased(g, f"{prefix}.0"), "pw": _biased(g, f"{prefix}.2")}


def params_from_state_dict(sd: StateDict) -> dict:
    """Upstream-named tensors -> JAX-layout parameter pytree (NumPy).

    Raises on missing tensors and on tensors the mapping did not consume."""
    g = _Getter(sd)
    # block 7: BasicRFB (RFB family) or conv_dw (slim family)
    if "base_net.7.branch0.0.conv.weight" in g.sd:
        block7 = {
            "branch0": [_basic_conv(g, f"base_net.7.branch0.{j}")
                        for j in range(3)],
            "branch1": [_basic_conv(g, f"base_net.7.branch1.{j}")
                        for j in range(3)],
            "branch2": [_basic_conv(g, f"base_net.7.branch2.{j}")
                        for j in range(4)],
            "conv_linear": _basic_conv(g, "base_net.7.ConvLinear"),
            "shortcut": _basic_conv(g, "base_net.7.shortcut"),
        }
    else:
        block7 = _conv_dw(g, "base_net.7")
    base: list[dict] = [
        _cbr(g, "base_net.0.0", "base_net.0.1"),
        *(_conv_dw(g, f"base_net.{i}") for i in range(1, 7)),
        block7,
        *(_conv_dw(g, f"base_net.{i}") for i in range(8, 13)),
    ]
    extras = {
        "proj": _biased(g, "extras.0.0"),
        "sep": _separable(g, "extras.0.2"),
    }
    cls_heads, reg_heads = [], []
    for level in range(4):
        if level < 3:
            cls_heads.append(
                _separable(g, f"classification_headers.{level}"))
            reg_heads.append(_separable(g, f"regression_headers.{level}"))
        else:
            cls_heads.append(_biased(g, f"classification_headers.{level}"))
            reg_heads.append(_biased(g, f"regression_headers.{level}"))
    if g.unused():
        raise ValueError(f"unconsumed parameters: {g.unused()[:10]}")
    return {"base": base, "extras": extras,
            "cls_heads": cls_heads, "reg_heads": reg_heads}


def params_from_jax(params: Any, prefix: str = "") -> dict[str, Array]:
    """JAX-layout pytree -> ``UltraFace`` state dict (NumPy arrays).

    Keys are the pytree paths joined by "."; 4-D conv weights go from HWIO
    to OIHW (a depthwise ``(3, 3, 1, C)`` becomes ``(C, 1, 3, 3)``)."""
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = enumerate(params)
    else:
        a = np.asarray(params, dtype=np.float32)
        return {prefix: _hwio_to_oihw(a) if a.ndim == 4 else a}
    out: dict[str, Array] = {}
    for k, v in items:
        out.update(params_from_jax(v, f"{prefix}.{k}" if prefix else str(k)))
    return out
