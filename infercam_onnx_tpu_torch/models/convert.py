"""Weight conversion, all in NumPy.

- `params_from_state_dict`: upstream-named tensors (``base_net.0.0.weight``,
  ``base_net.7.branch0.0.conv.weight``, ...; the names PyTorch checkpoints
  and ONNX initializers of the upstream network carry, and the names of
  the committed ``resources/weights/ultraface-twin.npz``) -> the JAX
  package's parameter pytree, with BatchNorm folded to a per-channel
  affine. A copy of ``infercam_onnx_tpu/models/convert.py``'s loader.
- `params_from_jax`: that pytree (HWIO weights) -> the state dict of
  ``models.ultraface.UltraFace`` (OIHW weights, "."-joined pytree paths).
- `params_from_onnx` / `params_from_graph`: the structural converter. It
  walks an UltraFace ONNX graph's Conv nodes in traced order, checks each
  one's signature (kernel, stride, pads, dilations, groups, channels)
  against the published architecture (`expected_conv_slots`, or the
  upstream SSD's `interleaved_conv_slots`) and places the weights by
  structure, not by name, so BN-folded exports (renamed initializers) load
  too. A copy of the JAX converter (``convert.py:253-558`` there).
- `state_dict_from_params`: the inverse of `params_from_state_dict`, the
  folded affine written as an identity-statistics BatchNorm.
- `load_or_download_params`: the ONNX file the reference downloads, read
  from the user cache (`cached_model_path`) and fetched on a miss. The
  cache is the JAX package's own folder, so both packages share it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable, Mapping

import numpy as np

from infercam_onnx_tpu_torch.models.onnx_reader import read_onnx_graph
from infercam_onnx_tpu_torch.utils.cache import cache_dir

log = logging.getLogger("infercam.convert")

Array = np.ndarray
StateDict = Mapping[str, Array]

BN_EPS = 1e-5  # upstream BatchNorm2d default

# Download links used by the reference (reference nn.rs:21-22) plus the
# slim family from the same upstream project.
ULTRAFACE_URLS = {
    "RFB-640": "https://github.com/onnx/models/raw/main/vision/body_analysis/ultraface/models/version-RFB-640.onnx",
    "RFB-320": "https://github.com/onnx/models/raw/main/vision/body_analysis/ultraface/models/version-RFB-320.onnx",
    "slim-640": "https://github.com/Linzaer/Ultra-Light-Fast-Generic-Face-Detector-1MB/raw/master/models/onnx/version-slim-640.onnx",
    "slim-320": "https://github.com/Linzaer/Ultra-Light-Fast-Generic-Face-Detector-1MB/raw/master/models/onnx/version-slim-320.onnx",
}


def fold_bn(gamma: Array, beta: Array, mean: Array, var: Array,
            eps: float = BN_EPS) -> tuple[Array, Array]:
    """Inference-mode BatchNorm as ``x * scale + bias``."""
    scale = gamma / np.sqrt(var + eps)
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


def params_from_state_dict(sd: StateDict, *, strict: bool = True) -> dict:
    """Upstream-named tensors -> JAX-layout parameter pytree (NumPy).

    Raises on missing tensors, and with ``strict`` on tensors the mapping
    did not consume (``strict=False`` ignores them)."""
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
    if strict and g.unused():
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


def state_dict_from_params(params: Any) -> dict[str, Array]:
    """JAX-layout pytree -> upstream-named state dict.

    The folded conv affine (scale, bias) becomes an identity-statistics
    BatchNorm (mean 0, var 1 - eps, gamma = scale, beta = bias), so
    `params_from_state_dict` reads it back exactly and a torch model with
    the upstream module structure can ``load_state_dict`` it."""
    out: dict[str, Array] = {}

    def inv_cbr(p: dict, conv: str, bn: str) -> None:
        out[f"{conv}.weight"] = _hwio_to_oihw(np.asarray(p["w"]))
        n = np.asarray(p["scale"]).shape[0]
        out[f"{bn}.weight"] = np.asarray(p["scale"], np.float32)
        out[f"{bn}.bias"] = np.asarray(p["bias"], np.float32)
        out[f"{bn}.running_mean"] = np.zeros(n, np.float32)
        out[f"{bn}.running_var"] = np.full(n, 1.0 - BN_EPS, np.float32)

    def inv_conv_dw(p: dict, prefix: str) -> None:
        inv_cbr(p["dw"], f"{prefix}.0", f"{prefix}.1")
        inv_cbr(p["pw"], f"{prefix}.3", f"{prefix}.4")

    def inv_biased(p: dict, prefix: str) -> None:
        out[f"{prefix}.weight"] = _hwio_to_oihw(np.asarray(p["w"]))
        out[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)

    def inv_separable(p: dict, prefix: str) -> None:
        inv_biased(p["dw"], f"{prefix}.0")
        inv_biased(p["pw"], f"{prefix}.2")

    base = params["base"]
    inv_cbr(base[0], "base_net.0.0", "base_net.0.1")
    for i in (*range(1, 7), *range(8, 13)):
        inv_conv_dw(base[i], f"base_net.{i}")
    if "branch0" in base[7]:
        for bname in ("branch0", "branch1", "branch2"):
            for j, blk in enumerate(base[7][bname]):
                inv_cbr(blk, f"base_net.7.{bname}.{j}.conv",
                        f"base_net.7.{bname}.{j}.bn")
        inv_cbr(base[7]["conv_linear"], "base_net.7.ConvLinear.conv",
                "base_net.7.ConvLinear.bn")
        inv_cbr(base[7]["shortcut"], "base_net.7.shortcut.conv",
                "base_net.7.shortcut.bn")
    else:
        inv_conv_dw(base[7], "base_net.7")
    inv_biased(params["extras"]["proj"], "extras.0.0")
    inv_separable(params["extras"]["sep"], "extras.0.2")
    for level in range(4):
        for head, key in (("classification_headers", "cls_heads"),
                          ("regression_headers", "reg_heads")):
            if level < 3:
                inv_separable(params[key][level], f"{head}.{level}")
            else:
                inv_biased(params[key][level], f"{head}.{level}")
    return out


# -- structural graph conversion + topology validation ---------------------


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Expected signature of one Conv slot in traced graph order."""

    path: tuple  # pytree placement, e.g. ("base", 3, "dw")
    kind: str  # "cbr" (conv+foldable BN) or "biased" (conv with bias)
    in_ch: int
    out_ch: int
    k: int = 3
    s: int = 1
    p: int = 0
    d: int = 1
    depthwise: bool = False


def _conv_dw_slots(i: int, inp: int, oup: int, stride: int):
    return [
        ConvSpec(("base", i, "dw"), "cbr", inp, inp, 3, stride, 1,
                 depthwise=True),
        ConvSpec(("base", i, "pw"), "cbr", inp, oup, 1),
    ]


def _sep_slots(path: tuple, in_ch: int, out_ch: int, stride: int = 1):
    return [
        ConvSpec(path + ("dw",), "biased", in_ch, in_ch, 3, stride, 1,
                 depthwise=True),
        ConvSpec(path + ("pw",), "biased", in_ch, out_ch, 1),
    ]


def expected_conv_slots(arch: str, base: int = 16) -> list[ConvSpec]:
    """All Conv slots of the UltraFace graph in traced (export) order: the
    upstream Mb_Tiny_RFB / Mb_Tiny + SSD structure, heads grouped after the
    backbone."""
    c = base
    slots: list[ConvSpec] = [
        ConvSpec(("base", 0), "cbr", 3, c, 3, 2, 1),
        *_conv_dw_slots(1, c, 2 * c, 1),
        *_conv_dw_slots(2, 2 * c, 2 * c, 2),
        *_conv_dw_slots(3, 2 * c, 2 * c, 1),
        *_conv_dw_slots(4, 2 * c, 4 * c, 2),
        *_conv_dw_slots(5, 4 * c, 4 * c, 1),
        *_conv_dw_slots(6, 4 * c, 4 * c, 1),
    ]
    if arch == "RFB":
        t = 4 * c // 8  # BasicRFB inter channels (map_reduce=8)
        b7 = ("base", 7)
        slots += [
            # branch0: 1x1 -> 3x3 -> 3x3 dilation 2
            ConvSpec(b7 + ("branch0", 0), "cbr", 4 * c, t, 1),
            ConvSpec(b7 + ("branch0", 1), "cbr", t, 2 * t, 3, 1, 1),
            ConvSpec(b7 + ("branch0", 2), "cbr", 2 * t, 2 * t, 3, 1, 2,
                     d=2),
            # branch1: 1x1 -> 3x3 -> 3x3 dilation 3
            ConvSpec(b7 + ("branch1", 0), "cbr", 4 * c, t, 1),
            ConvSpec(b7 + ("branch1", 1), "cbr", t, 2 * t, 3, 1, 1),
            ConvSpec(b7 + ("branch1", 2), "cbr", 2 * t, 2 * t, 3, 1, 3,
                     d=3),
            # branch2: 1x1 -> 3x3 -> 3x3 -> 3x3 dilation 5
            ConvSpec(b7 + ("branch2", 0), "cbr", 4 * c, t, 1),
            ConvSpec(b7 + ("branch2", 1), "cbr", t, (t // 2) * 3, 3, 1, 1),
            ConvSpec(b7 + ("branch2", 2), "cbr", (t // 2) * 3, 2 * t, 3,
                     1, 1),
            ConvSpec(b7 + ("branch2", 3), "cbr", 2 * t, 2 * t, 3, 1, 5,
                     d=5),
            ConvSpec(b7 + ("conv_linear",), "cbr", 6 * t, 4 * c, 1),
            ConvSpec(b7 + ("shortcut",), "cbr", 4 * c, 4 * c, 1),
        ]
    else:  # slim
        slots += _conv_dw_slots(7, 4 * c, 4 * c, 1)
    slots += [
        *_conv_dw_slots(8, 4 * c, 8 * c, 2),
        *_conv_dw_slots(9, 8 * c, 8 * c, 1),
        *_conv_dw_slots(10, 8 * c, 8 * c, 1),
        *_conv_dw_slots(11, 8 * c, 16 * c, 2),
        *_conv_dw_slots(12, 16 * c, 16 * c, 1),
        ConvSpec(("extras", "proj"), "biased", 16 * c, 4 * c, 1),
        *_sep_slots(("extras", "sep"), 4 * c, 16 * c, 2),
    ]
    # SSD heads: traced per level, classification then regression
    feat_ch = [4 * c, 8 * c, 16 * c, 16 * c]
    priors_per_cell = [3, 2, 2, 3]
    for level in range(4):
        ch = feat_ch[level]
        n = priors_per_cell[level]
        for head, out_mult in (("cls_heads", 2), ("reg_heads", 4)):
            if level < 3:
                slots += _sep_slots((head, level), ch, n * out_mult)
            else:
                slots.append(ConvSpec((head, level), "biased", ch,
                                      n * out_mult, 3, 1, 1))
    return slots


def interleaved_conv_slots(arch: str, base: int = 16) -> list[ConvSpec]:
    """The SAME slots in the upstream SSD's execution order: each level's
    heads run AT its source layer (source_layer_indexes = [8, 11, 13]:
    base[0:8] -> heads0 -> base[8:11] -> heads1 -> base[11:13] -> heads2
    -> extras -> heads3), the conv order of the real version-RFB
    artifacts. `params_from_graph` accepts both orders."""
    slots = expected_conv_slots(arch, base)

    def take(prefix: tuple) -> list[ConvSpec]:
        return [s for s in slots if s.path[:len(prefix)] == prefix]

    def heads(level: int) -> list[ConvSpec]:
        return (take(("cls_heads", level)) + take(("reg_heads", level)))

    attach = {7: 0, 10: 1, 12: 2}  # base index -> head level
    ordered: list[ConvSpec] = []
    for i in range(13):
        ordered += take(("base", i))
        if i in attach:
            ordered += heads(attach[i])
    ordered += take(("extras",))
    ordered += heads(3)
    assert len(ordered) == len(slots)
    return ordered


def _check_conv(node, spec: ConvSpec, w: Array) -> None:
    got = {
        "kernel_shape": (node.attrs.get("kernel_shape")
                         or list(w.shape[2:4])),
        "strides": node.attrs.get("strides", [1, 1]),
        "pads": node.attrs.get("pads", [0, 0, 0, 0]),
        "dilations": node.attrs.get("dilations", [1, 1]),
        "group": node.attrs.get("group", 1),
        "out_ch": int(w.shape[0]),
        "in_ch": int(w.shape[1]) * int(node.attrs.get("group", 1)),
    }
    want = {
        "kernel_shape": [spec.k, spec.k],
        "strides": [spec.s, spec.s],
        "pads": [spec.p] * 4,
        "dilations": [spec.d, spec.d],
        "group": spec.in_ch if spec.depthwise else 1,
        "out_ch": spec.out_ch,
        "in_ch": spec.in_ch,
    }
    for key, expect in want.items():
        if got[key] != expect:
            raise ValueError(
                f"ONNX graph mismatch at {'.'.join(map(str, spec.path))} "
                f"(node {node.name!r}): {key} = {got[key]}, expected "
                f"{expect} — the export does not match the published "
                f"UltraFace architecture")


def _place(tree: dict, path: tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value


def infer_graph_arch(graph) -> str:
    """RFB (has dilated convs) vs slim, from topology alone."""
    for node in graph.nodes:
        if (node.op_type == "Conv"
                and node.attrs.get("dilations", [1, 1]) != [1, 1]):
            return "RFB"
    return "slim"


def params_from_graph(graph) -> dict:
    """Validate the graph's topology and convert its weights by STRUCTURE
    into the JAX-layout pytree (NumPy leaves) `Detector(params=)` takes.

    Accepts both torch export styles: eval exports with BatchNormalization
    nodes intact (original initializer names) and constant-folded exports
    (BN fused into renamed Conv initializers). Raises ValueError naming
    the offending slot on any signature mismatch."""
    arch = infer_graph_arch(graph)
    slots = expected_conv_slots(arch)
    convs = [n for n in graph.nodes if n.op_type == "Conv"]
    if len(convs) != len(slots):
        raise ValueError(
            f"ONNX graph has {len(convs)} Conv nodes; the {arch} "
            f"architecture has {len(slots)}")
    # the IO contract: one NCHW image input; scores [1,K,2] + boxes
    # [1,K,4] outputs
    if len(graph.inputs) != 1 or len(graph.outputs) != 2:
        raise ValueError(
            f"expected 1 input / 2 outputs, got {len(graph.inputs)} / "
            f"{len(graph.outputs)}")
    in_shape = graph.inputs[0].shape
    if len(in_shape) != 4 or in_shape[1] != 3:
        raise ValueError(f"expected NCHW image input, got {in_shape}")

    consumers: dict[str, list] = {}
    producers: dict[str, object] = {}
    for node in graph.nodes:
        for name in node.inputs:
            consumers.setdefault(name, []).append(node)
        for name in node.outputs:
            producers[name] = node

    def tensor(name: str) -> Array:
        # follow Identity chains (torch exports route some weights
        # through Identity nodes) and accept Constant-node weights
        seen = 0
        while name not in graph.initializers and seen < 16:
            prod = producers.get(name)
            if prod is not None and prod.op_type == "Identity":
                name = prod.inputs[0]
                seen += 1
            elif prod is not None and prod.op_type == "Constant":
                return np.asarray(prod.attrs["value"], np.float32)
            else:
                raise ValueError(
                    f"graph value {name!r} is not an initializer "
                    "(dynamic weights unsupported)")
        if name not in graph.initializers:
            raise ValueError(f"graph value {name!r} is not an "
                             "initializer (dynamic weights unsupported)")
        return np.array(graph.initializers[name], np.float32)

    def attempt(ordered_slots: list[ConvSpec]) -> dict:
        tree: dict = {
            "base": [{"dw": {}, "pw": {}} for _ in range(13)],
            "extras": {"sep": {}},
            "cls_heads": [{} for _ in range(4)],
            "reg_heads": [{} for _ in range(4)],
        }
        if arch == "RFB":
            tree["base"][7] = {"branch0": [{}, {}, {}],
                               "branch1": [{}, {}, {}],
                               "branch2": [{}, {}, {}, {}]}
        for node, spec in zip(convs, ordered_slots):
            w = tensor(node.inputs[1])
            _check_conv(node, spec, w)
            if spec.kind == "cbr":
                bn = [n for n in consumers.get(node.outputs[0], [])
                      if n.op_type == "BatchNormalization"]
                if bn:
                    if len(node.inputs) > 2:
                        raise ValueError(
                            f"conv {node.name!r} has both a bias and a "
                            "following BatchNorm — unexpected export")
                    gamma, beta, mean, var = (tensor(i) for i in
                                              bn[0].inputs[1:5])
                    eps = bn[0].attrs.get("epsilon", BN_EPS)
                    scale, bias = fold_bn(gamma, beta, mean, var, eps)
                elif len(node.inputs) > 2:  # BN folded into the conv
                    scale = np.ones(spec.out_ch, np.float32)
                    bias = tensor(node.inputs[2])
                else:
                    raise ValueError(
                        f"conv {node.name!r} "
                        f"({'.'.join(map(str, spec.path))})"
                        " has neither a bias nor a following BatchNorm")
                value = {"w": _oihw_to_hwio(w), "scale": scale,
                         "bias": bias}
            else:
                bias = (tensor(node.inputs[2]) if len(node.inputs) > 2
                        else np.zeros(spec.out_ch, np.float32))
                value = {"w": _oihw_to_hwio(w), "b": bias}
            _place(tree, spec.path, value)
        return tree

    # the upstream SSD traces head convs interleaved with the backbone;
    # grouped forwards (the torch twin, many re-implementations) put them
    # at the end: accept both orders, preferring the upstream one
    errors = []
    for order in (interleaved_conv_slots(arch), slots):
        try:
            return attempt(order)
        except ValueError as e:
            errors.append(str(e))
    raise ValueError(
        "ONNX graph matches neither the upstream-interleaved nor "
        "the grouped UltraFace conv order:\n  interleaved: "
        f"{errors[0]}\n  grouped: {errors[1]}")


def params_from_onnx(path: str, *, strict: bool = True) -> dict:
    """Load an UltraFace ONNX file: parse the graph, check its topology
    against the published architecture and convert its weights
    structurally (`params_from_graph`). ``strict`` is accepted as the JAX
    package accepts it: the structural conversion is strict whatever its
    value (every Conv slot must match)."""
    return params_from_graph(read_onnx_graph(path))


# -- the downloaded-model cache (reference nn.rs:143-162) ------------------


def cached_model_path(variant: str) -> str:
    """Cache path of the ONNX file of ``variant``:
    ``$XDG_CACHE_HOME/infercam_onnx_tpu/ultraface-<variant>.onnx``."""
    return os.path.join(cache_dir(), f"ultraface-{variant}.onnx")


def load_or_download_params(
    variant: str, *, download: Callable[[str, str], None] | None = None,
) -> dict | None:
    """The real UltraFace weights of ``variant``, from the cached ONNX file
    or, on a miss, downloaded into it (``download(url, path)``, by
    default `utils.download.download_file`).

    Returns None where the file is absent and the download fails (offline),
    and where the cached file does not convert: that file is moved to
    ``.bad``, so the next run downloads it again."""
    path = cached_model_path(variant)
    if not os.path.isfile(path):
        if download is None:
            from infercam_onnx_tpu_torch.utils.download import download_file

            download = download_file
        try:
            download(ULTRAFACE_URLS[variant], path)
        except Exception:  # offline, refused, or a failing downloader
            return None
    if not os.path.isfile(path):
        return None
    try:
        return params_from_onnx(path)
    except ValueError as e:
        log.warning("cached ONNX %s failed to load (%s); quarantined as "
                    ".bad", path, e)
        try:
            os.replace(path, path + ".bad")
        except OSError:
            pass
        return None
