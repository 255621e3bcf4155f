"""Execute an ONNX graph with PyTorch: the port of
``infercam_onnx_tpu/models/onnx_exec.py``'s CNN op set.

The reference loads the downloaded ONNX graph and *runs* it (tract). The
JAX package does the same with an interpreter over ``jax.numpy``; this is
its counterpart over torch. `GraphExecutor` walks the graph's nodes in
order and calls one plain function per op; `GraphDetector` runs a graph
that maps ``[1, 3, H, W]`` images to ``(scores, boxes)`` inside the port's
detect programs (preprocess, the graph, filter + greedy NMS through
``csrc/nms.cu``).

The op set is the JAX table's convolutional slice: the 76 entries from
``Conv`` to ``ArgMin`` plus ``Range`` and ``Tile``. Every other op, and the
control flow ops ``If``/``Loop``/``Scan``, raises when the executor is
built (ROADMAP A.8b lists them), as the JAX executor raises on an op it
does not know.

Values are NumPy where they are concrete and tensors where they are data,
as in the JAX interpreter: ``Shape -> Gather -> Unsqueeze -> Concat ->
Reshape`` chains stay NumPy and resolve to static shapes, and a NumPy value
that meets a tensor becomes a tensor on the tensor's device, float64 as
float32 (the JAX package runs without x64). The graph's constants (its
initializers, ``Constant`` nodes and the nodes computed from them alone,
which the build evaluates once) are registered buffers of the executor:
they reach a device with ``.to(device)`` or a deep copy, once, and no call
copies them from the host again.
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from infercam_onnx_tpu_torch.config import DetectorConfig, resolve_device
from infercam_onnx_tpu_torch.detector import Detector
from infercam_onnx_tpu_torch.models.onnx_reader import (OnnxGraph, OnnxNode,
                                                        read_onnx_graph)
from infercam_onnx_tpu_torch.ops.preprocess import Preprocessor
from infercam_onnx_tpu_torch.parallel.data_parallel import ShardedDetector

_ONNX_NP_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
# tensor casts as the JAX package's do without x64: float64 is float32;
# torch has few ops on uint16/32/64, so those are int64
_ONNX_TORCH_DTYPES = {
    1: torch.float32, 2: torch.uint8, 3: torch.int8, 4: torch.int64,
    5: torch.int16, 6: torch.int32, 7: torch.int64, 9: torch.bool,
    10: torch.float16, 11: torch.float32, 12: torch.int64, 13: torch.int64,
}

# the device a NumPy value goes to when it meets a tensor, and the count
# of such per-call conversions (constants are buffers and never count)
_STATE = threading.local()


def _device() -> torch.device:
    return getattr(_STATE, "device", None) or torch.device("cpu")


def _is_concrete(*vals) -> bool:
    return all(isinstance(v, (np.ndarray, np.generic, int, float))
               for v in vals)


def _t(v) -> torch.Tensor:
    """``v`` as a tensor: a tensor as it is; a NumPy value or a Python
    number copied to the executor's device, float64 as float32."""
    if isinstance(v, torch.Tensor):
        return v
    _STATE.converted = getattr(_STATE, "converted", 0) + 1
    return _to_tensor(v, _device())


def _to_tensor(v, device: torch.device) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype in (np.uint16, np.uint32, np.uint64):
        a = a.astype(np.int64)
    return torch.tensor(np.ascontiguousarray(a), device=device)


def _is_int(v) -> bool:
    """Integer dtype (not bool, not float), for NumPy values and tensors
    alike: a torch dtype is no NumPy dtype."""
    if isinstance(v, torch.Tensor):
        return not (v.dtype.is_floating_point or v.dtype.is_complex
                    or v.dtype == torch.bool)
    return np.issubdtype(np.asarray(v).dtype, np.integer)


def _eltwise(np_fn, torch_fn):
    """An elementwise op: NumPy on concrete inputs, else torch on
    tensors."""
    def op(node, *xs):
        if _is_concrete(*xs):
            return np_fn(*xs)
        return torch_fn(*(_t(x) for x in xs))
    return op


def _perm(x, axes):
    return np.transpose(x, axes) if _is_concrete(x) else x.permute(*axes)


def _pad_arg(width) -> list[int]:
    """[(lo, hi)] per axis -> `F.pad`'s flat list, last axis first."""
    out: list[int] = []
    for lo, hi in reversed(width):
        out += [int(lo), int(hi)]
    return out


def _auto_pads(node: OnnxNode, spatial: tuple[int, ...],
               kernel, strides, dilations) -> list[int]:
    """Resolve pads for the explicit or auto_pad forms. Returns ONNX
    layout [begin..., end...]. SAME_UPPER puts the odd pad at the end,
    SAME_LOWER at the start."""
    mode = node.attrs.get("auto_pad", b"NOTSET")
    n = len(kernel)
    if mode in (b"", b"NOTSET"):
        return list(node.attrs.get("pads", [0] * (2 * n)))
    if mode == b"VALID":
        return [0] * (2 * n)
    if mode not in (b"SAME_UPPER", b"SAME_LOWER"):
        raise ValueError(
            f"auto_pad {mode!r} unsupported ({node.name})")
    begin, end = [], []
    for i in range(n):
        eff = dilations[i] * (kernel[i] - 1) + 1
        out_dim = -(-int(spatial[i]) // strides[i])  # ceil
        total = max((out_dim - 1) * strides[i] + eff - int(spatial[i]), 0)
        small, big = total // 2, total - total // 2
        if mode == b"SAME_UPPER":
            begin.append(small)
            end.append(big)
        else:
            begin.append(big)
            end.append(small)
    return begin + end


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _conv(node: OnnxNode, x, w, b=None):
    x, w = _t(x), _t(w)
    n = w.ndim - 2
    strides = node.attrs.get("strides", [1] * n)
    dilations = node.attrs.get("dilations", [1] * n)
    group = int(node.attrs.get("group", 1))
    pads = _auto_pads(node, x.shape[2:], w.shape[2:], strides, dilations)
    begin, end = pads[:n], pads[n:]
    if begin != end:  # asymmetric: zero-pad first
        x = F.pad(x, _pad_arg([(0, 0), (0, 0)] + list(zip(begin, end))))
        begin = [0] * n
    return _CONV[n](x, w, None if b is None else _t(b), tuple(strides),
                    tuple(begin), tuple(dilations), group)


def _batch_norm(node: OnnxNode, x, scale, bias, mean, var):
    if not node.attrs.get("spatial", 1):
        raise ValueError(
            f"BatchNormalization spatial=0 unsupported ({node.name})")
    eps = node.attrs.get("epsilon", 1e-5)
    x, scale, bias, mean, var = (_t(v) for v in (x, scale, bias, mean, var))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = scale * (var + eps) ** -0.5
    return (x - mean.reshape(shape)) * inv.reshape(shape) \
        + bias.reshape(shape)


def _pool_geometry(node: OnnxNode, x):
    """Window geometry of the pool family: kernel/stride/dilation/pads
    plus output dims and the ceil_mode right-extension (windows starting
    entirely in the right padding are dropped: the torch/ONNX rule). One
    definition for the values (`_pool`) and the indices
    (`_max_pool_indices`)."""
    ks = node.attrs["kernel_shape"]
    n = len(ks)
    strides = node.attrs.get("strides", [1] * n)
    dilations = node.attrs.get("dilations", [1] * n)
    pads = list(_auto_pads(node, x.shape[2:], ks, strides, dilations))
    ceil = node.attrs.get("ceil_mode", 0)
    out_dims, extra = [], []
    for i in range(n):
        span = (ks[i] - 1) * dilations[i] + 1
        total = int(x.shape[2 + i]) + pads[i] + pads[i + n]
        if ceil:
            o = -((span - total) // strides[i]) + 1
            if (o - 1) * strides[i] >= int(x.shape[2 + i]) + pads[i]:
                o -= 1
            extra.append(max((o - 1) * strides[i] + span - total, 0))
        else:
            o = (total - span) // strides[i] + 1
            extra.append(0)
        out_dims.append(o)
    return ks, strides, dilations, pads, out_dims, extra


def _lowest(dtype: torch.dtype):
    """The max reduction's identity in ``dtype``."""
    if dtype.is_floating_point:
        return -float("inf")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


def _window_sum(x: torch.Tensor, ks, strides, dilations) -> torch.Tensor:
    """Sum over each window of an already padded ``x`` [N, C, *D]."""
    n = len(ks)
    if all(d == 1 for d in dilations) and n in (2, 3):
        pool = F.avg_pool2d if n == 2 else F.avg_pool3d
        return pool(x, tuple(ks), tuple(strides), divisor_override=1)
    # dilated or 1-D windows: a depthwise convolution with ones
    c = x.shape[1]
    ones = torch.ones((c, 1, *ks), dtype=x.dtype, device=x.device)
    return _CONV[n](x, ones, None, tuple(strides), 0, tuple(dilations), c)


def _pool(node: OnnxNode, x, kind: str, indices_ok: bool = False):
    if len(node.outputs) > 1 and not indices_ok:
        raise ValueError(
            f"pool with indices output unsupported ({node.name})")
    # ceil_mode's `extra` = right padding with the reduction's identity
    # (padded cells never affect the result); see _pool_geometry
    ks, strides, dilations, pads, _, extra = _pool_geometry(node, x)
    n = len(ks)
    x = _t(x)
    width = [(0, 0), (0, 0)] + [(pads[i], pads[i + n] + extra[i])
                                for i in range(n)]
    if kind == "max":
        xp = F.pad(x, _pad_arg(width), value=_lowest(x.dtype))
        if n == 1:
            return F.max_pool1d(xp, ks, strides, 0, dilations)
        pool = F.max_pool2d if n == 2 else F.max_pool3d
        return pool(xp, tuple(ks), tuple(strides), 0, tuple(dilations))
    out = _window_sum(F.pad(x, _pad_arg(width)), ks, strides, dilations)
    include_pad = node.attrs.get("count_include_pad", 0)
    if include_pad and not any(extra):
        return out / float(np.prod(ks))
    if not include_pad and not any(pads) and not any(extra):
        return out / float(np.prod(ks))
    # divisor = elements each window actually covers: real cells only
    # (count_include_pad=0), or real + EXPLICIT padding but never the
    # ceil_mode extension (count_include_pad=1, torch semantics)
    if include_pad:
        ones = torch.ones((1, 1) + tuple(
            int(x.shape[2 + i]) + pads[i] + pads[i + n] for i in range(n)),
            dtype=torch.float32, device=x.device)
        div_width = [(0, 0), (0, 0)] + [(0, extra[i]) for i in range(n)]
    else:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=torch.float32,
                          device=x.device)
        div_width = width
    div = _window_sum(F.pad(ones, _pad_arg(div_width)), ks, strides,
                      dilations)
    return out / div.to(out.dtype)


def _max_pool_indices(node: OnnxNode, x):
    """MaxPool's second output (torch return_indices=True exports):
    ONNX-convention GLOBAL flat indices (row-major over [N, C, *D],
    storage_order=0) of each window's max, from statically shifted slices
    over the kernel offsets."""
    if node.attrs.get("storage_order", 0):
        raise ValueError(
            f"MaxPool storage_order=1 unsupported ({node.name})")
    ks, strides, dilations, pads, out_dims, extra = _pool_geometry(node, x)
    n = len(ks)
    spatial = [int(s) for s in x.shape[2:]]
    x = _t(x)
    dev = x.device
    # pad with the dtype's own identity so padding never wins, and
    # compare in the input dtype
    xp = F.pad(x, _pad_arg([(0, 0), (0, 0)] + [
        (pads[i], pads[i + n] + extra[i]) for i in range(n)]),
        value=_lowest(x.dtype))
    slabs, flat_pos, valid = [], [], []
    for offs in itertools.product(*(range(k) for k in ks)):
        sl = [slice(None), slice(None)]
        for i in range(n):
            start = offs[i] * dilations[i]
            sl.append(slice(start,
                            start + (out_dims[i] - 1) * strides[i] + 1,
                            strides[i]))
        slabs.append(xp[tuple(sl)])
        # input coordinate of this tap for every output cell, as the
        # per-axis contribution to the global flat index + validity
        pos = torch.zeros((1, 1) + tuple(out_dims), dtype=torch.int64,
                          device=dev)
        ok = torch.ones((1, 1) + tuple(out_dims), dtype=torch.bool,
                        device=dev)
        mult = 1
        for i in reversed(range(n)):
            shape = [1] * (n + 2)
            shape[2 + i] = out_dims[i]
            coord = (torch.arange(out_dims[i], dtype=torch.int64,
                                  device=dev) * strides[i] - pads[i]
                     + offs[i] * dilations[i]).reshape(shape)
            ok = ok & (coord >= 0) & (coord < spatial[i])
            pos = pos + coord * mult
            mult *= spatial[i]
        flat_pos.append(pos)
        valid.append(ok)
    stack = torch.stack(slabs)  # [K, N, C, *out]
    # first VALID tap among the maxima: torch's tie rule, and the only
    # right answer when every real value is -inf
    m = torch.amax(stack, dim=0, keepdim=True)
    is_best = (stack == m) & torch.stack(valid)
    best = torch.argmax(is_best.to(torch.uint8), dim=0)
    pos = torch.gather(torch.stack(flat_pos).expand(stack.shape), 0,
                       best[None])[0]
    plane = int(np.prod(spatial))
    nb, c = x.shape[0], x.shape[1]
    base = (torch.arange(nb, dtype=torch.int64, device=dev)[:, None] * c
            + torch.arange(c, dtype=torch.int64, device=dev)[None, :]) \
        * plane
    return pos + base.reshape((nb, c) + (1,) * n)


def _max_pool(node: OnnxNode, x):
    out = _pool(node, x, "max", indices_ok=True)
    if len(node.outputs) < 2:
        return out
    return out, _max_pool_indices(node, x)


def _max_unpool(node: OnnxNode, x, idx, output_shape=None):
    """MaxUnpool: scatter pooled values back to the indices' positions
    (ONNX global flat indices: one scatter)."""
    ks = node.attrs["kernel_shape"]
    n = len(ks)
    strides = node.attrs.get("strides", [1] * n)
    pads = node.attrs.get("pads", [0] * (2 * n))
    if output_shape is not None:
        if not _is_concrete(output_shape):
            raise ValueError(
                f"MaxUnpool with traced output_shape ({node.name})")
        shape = tuple(int(v) for v in np.asarray(output_shape)
                      .reshape(-1))
    else:
        shape = tuple(x.shape[:2]) + tuple(
            (int(x.shape[2 + i]) - 1) * strides[i] - pads[i]
            - pads[i + n] + ks[i] for i in range(n))
    x, idx = _t(x), _t(idx)
    flat = torch.zeros((int(np.prod(shape)),), dtype=x.dtype,
                       device=x.device)
    flat = flat.scatter(0, idx.reshape(-1).to(torch.int64), x.reshape(-1))
    return flat.reshape(shape)


def _global_pool(node: OnnxNode, x, is_avg: bool):
    axes = tuple(range(2, x.ndim))
    if _is_concrete(x):
        return (np.mean if is_avg else np.max)(x, axis=axes, keepdims=True)
    if is_avg:
        return x.mean(dim=axes, keepdim=True)
    return torch.amax(x, dim=axes, keepdim=True)


def _gemm(node: OnnxNode, a, b, c=None):
    alpha = node.attrs.get("alpha", 1.0)
    beta = node.attrs.get("beta", 1.0)
    a, b = _t(a), _t(b)
    if node.attrs.get("transA", 0):
        a = a.T
    if node.attrs.get("transB", 0):
        b = b.T
    out = alpha * (a @ b)
    if c is not None:
        out = out + beta * _t(c)
    return out


def _conv_transpose(node: OnnxNode, x, w, b=None):
    """ONNX ConvTranspose: torch's transposed convolution at padding 0 (the
    full output; the kernel layout (C_in, C_out/group, *k) is torch's),
    then the pads cropped and ``output_padding`` added as zeros, which is
    the JAX package's input-dilated convolution."""
    x, w = _t(x), _t(w)
    n = w.ndim - 2
    group = int(node.attrs.get("group", 1))
    ks = list(w.shape[2:])
    strides = node.attrs.get("strides", [1] * n)
    dil = node.attrs.get("dilations", [1] * n)
    pads = node.attrs.get("pads", [0] * (2 * n))
    opad = node.attrs.get("output_padding", [0] * n)
    auto = node.attrs.get("auto_pad", b"NOTSET") or b"NOTSET"
    oshape = node.attrs.get("output_shape")
    if oshape is not None or auto in (b"SAME_UPPER", b"SAME_LOWER"):
        # spec: pads are DERIVED from the requested output size
        # (output_shape overrides pads; SAME_* implies out = in*stride),
        # split per the SAME_UPPER/other distribution rule
        if oshape is not None:
            osp = [int(v) for v in np.asarray(oshape).reshape(-1)][-n:]
        else:
            osp = [int(x.shape[2 + i]) * strides[i] for i in range(n)]
        pads = [0] * (2 * n)
        for i in range(n):
            total = (strides[i] * (int(x.shape[2 + i]) - 1) + opad[i]
                     + (ks[i] - 1) * dil[i] + 1 - osp[i])
            if auto == b"SAME_UPPER":
                pads[i], pads[i + n] = total // 2, total - total // 2
            else:
                pads[i], pads[i + n] = total - total // 2, total // 2
    elif auto not in (b"", b"NOTSET", b"VALID"):
        raise ValueError(
            f"ConvTranspose auto_pad {auto!r} unsupported "
            f"({node.name})")
    full = _CONV_T[n](x, w, None, tuple(strides), 0, 0, group, tuple(dil))
    # a negative F.pad crops
    out = F.pad(full, _pad_arg([(0, 0), (0, 0)] + [
        (-pads[i], -pads[i + n] + opad[i]) for i in range(n)]))
    if b is not None:
        out = out + _t(b).reshape((1, -1) + (1,) * n)
    return out


_TORCH_PAD_INDEX_MODES = ("edge", "reflect", "wrap")


def _pad(node: OnnxNode, x, pads=None, value=None, axes=None):
    mode = node.attrs.get("mode", b"constant").decode()
    if pads is None:  # opset < 11: attributes (plain int lists)
        pads = node.attrs["pads"]
        value = node.attrs.get("value", 0.0)
    elif not _is_concrete(pads):
        raise ValueError(f"Pad with traced pads ({node.name})")
    pads = np.asarray(pads).reshape(-1).tolist()
    ax = (list(range(x.ndim)) if axes is None
          else np.asarray(axes).reshape(-1).tolist())
    n = len(pads) // 2
    width = [(0, 0)] * x.ndim
    for i, a in enumerate(ax):
        width[a] = (int(pads[i]), int(pads[i + n]))
    # negative pads mean CROPPING (ONNX spec); slice those off first
    if any(lo < 0 or hi < 0 for lo, hi in width):
        sl = tuple(
            slice(max(-lo, 0), x.shape[d] - max(-hi, 0))
            for d, (lo, hi) in enumerate(width))
        x = x[sl]
        width = [(max(lo, 0), max(hi, 0)) for lo, hi in width]
    if mode not in ("constant",) + _TORCH_PAD_INDEX_MODES:
        raise ValueError(f"Pad mode {mode!r} unsupported ({node.name})")
    if _is_concrete(x):
        if mode == "constant":
            cval = 0.0 if value is None else float(np.asarray(value))
            return np.pad(x, width, constant_values=cval)
        return np.pad(x, width, mode=mode)
    if mode == "constant":
        cval = 0.0 if value is None else np.asarray(value).item()
        return F.pad(x, _pad_arg(width), value=cval)
    # edge/reflect/wrap: each padded axis gathers the source index that
    # NumPy's own padding of an index ramp names
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            src = np.pad(np.arange(x.shape[d]), (lo, hi), mode=mode)
            x = torch.index_select(x, d, torch.from_numpy(src).to(x.device))
    return x


def _torch_reduce(x: torch.Tensor, kind: str, axes, keep: bool):
    if axes is None:
        axes = tuple(range(x.ndim))
    if kind == "mean":
        return x.mean(dim=axes, keepdim=keep)
    if kind == "sum":
        return x.sum(dim=axes, keepdim=keep)
    if kind == "max":
        return torch.amax(x, dim=axes, keepdim=keep)
    if kind == "min":
        return torch.amin(x, dim=axes, keepdim=keep)
    for a in sorted((a % x.ndim for a in axes), reverse=True):  # prod
        x = torch.prod(x, dim=a, keepdim=keep)
    return x


def _reduce(node: OnnxNode, x, axes=None, *, kind: str):
    if axes is None:
        axes = node.attrs.get("axes")
    elif not _is_concrete(axes):
        raise ValueError(f"Reduce with traced axes ({node.name})")
    if axes is not None:
        axes = tuple(int(a) for a in np.asarray(axes).reshape(-1))
    if not axes and node.attrs.get("noop_with_empty_axes", 0):
        return x
    axes = axes or None
    keep = bool(node.attrs.get("keepdims", 1))
    if _is_concrete(x):
        return getattr(np, kind)(x, axis=axes, keepdims=keep)
    return _torch_reduce(x, kind, axes, keep)


def _split(node: OnnxNode, x, split=None):
    axis = node.attrs.get("axis", 0)
    if split is None:
        split = node.attrs.get("split")
    if split is None:
        k = node.attrs.get("num_outputs", len(node.outputs))
        # opset-18 semantics: chunk = ceil(dim/k), last chunk smaller
        # (possibly zero) when the axis does not divide evenly
        dim = x.shape[axis]
        chunk = -(-dim // k) if dim else 0
        split = [min(chunk, max(0, dim - i * chunk)) for i in range(k)]
    else:
        split = np.asarray(split).reshape(-1).tolist()
    offsets = np.cumsum([0] + [int(s) for s in split])
    sl = [slice(None)] * x.ndim
    outs = []
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        sl[axis] = slice(int(lo), int(hi))
        outs.append(x[tuple(sl)])
    return tuple(outs) if len(outs) > 1 else outs[0]


def _dropout(node: OnnxNode, x, *_ignored):
    # inference mode: identity (+ all-true mask if the export kept it)
    if len(node.outputs) > 1:
        if _is_concrete(x):
            return x, np.ones(x.shape, bool)
        return x, torch.ones(x.shape, dtype=torch.bool, device=x.device)
    return x


def _resize_matrix(n_in: int, n_out: int, mode: str, coord: str,
                   nearest_mode: str, cubic_a: float = -0.75,
                   antialias: bool = False,
                   exclude_outside: bool = False) -> np.ndarray:
    """[n_out, n_in] interpolation matrix for one axis (the JAX package's,
    copied): a resize is one matrix product per resized axis."""
    i = np.arange(n_out, dtype=np.float64)
    scale = n_in / n_out
    if coord == "half_pixel":
        src = (i + 0.5) * scale - 0.5
    elif coord == "asymmetric":
        src = i * scale
    elif coord == "align_corners":
        src = i * ((n_in - 1) / max(n_out - 1, 1))
    elif coord == "pytorch_half_pixel":
        src = (i + 0.5) * scale - 0.5 if n_out > 1 else np.zeros_like(i)
    else:
        raise ValueError(f"Resize coordinate mode {coord!r} unsupported")
    if antialias and mode in ("linear", "cubic") and n_in > n_out:
        # antialias=1 downscale (torch interpolate(antialias=True) / PIL):
        # stretch the filter support by the scale factor, drop
        # out-of-range taps, renormalize each row; the tap argument is
        # (j + 0.5 - fscale*(i + 0.5)) / fscale, only the SCALE follows
        # align_corners
        if coord == "align_corners":
            fscale = max((n_in - 1) / max(n_out - 1, 1), 1.0)
        else:
            fscale = scale
        radius = 1.0 if mode == "linear" else 2.0
        src_aa = fscale * (i + 0.5) - 0.5
        d = np.abs(np.arange(n_in)[None, :] - src_aa[:, None]) / fscale
        if mode == "linear":
            w = np.maximum(0.0, 1.0 - d)
        else:
            a = cubic_a
            w = np.where(
                d <= 1, (a + 2) * d**3 - (a + 3) * d**2 + 1,
                np.where(d < 2,
                         a * d**3 - 5 * a * d**2 + 8 * a * d - 4 * a,
                         0.0))
        w[d >= radius] = 0.0
        w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
        return w.astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    if mode == "nearest":
        if nearest_mode == "floor":
            idx = np.floor(src)
        elif nearest_mode == "ceil":
            idx = np.ceil(src)
        elif nearest_mode == "round_prefer_ceil":
            idx = np.floor(src + 0.5)
        else:  # round_prefer_floor
            idx = np.ceil(src - 0.5)
        idx = np.clip(idx, 0, n_in - 1).astype(np.int64)
        m[np.arange(n_out), idx] = 1.0
    elif mode == "cubic":
        # 4-tap Keys kernel with any cubic_coeff_a (ONNX default -0.75,
        # torch bicubic; -0.5 Catmull-Rom)
        a = cubic_a
        base = np.floor(src).astype(np.int64)
        frac = src - base
        for tap in range(-1, 3):
            d = np.abs(frac - tap)
            w = np.where(
                d <= 1, (a + 2) * d**3 - (a + 3) * d**2 + 1,
                np.where(d < 2,
                         a * d**3 - 5 * a * d**2 + 8 * a * d - 4 * a,
                         0.0))
            raw = base + tap
            if exclude_outside:
                # out-of-range taps get weight 0 and each row
                # renormalizes, instead of clamp-to-edge accumulation
                w = np.where((raw < 0) | (raw >= n_in), 0.0, w)
            idx = np.clip(raw, 0, n_in - 1)
            np.add.at(m, (np.arange(n_out), idx), w.astype(np.float32))
        if exclude_outside:
            m /= np.maximum(m.sum(axis=1, keepdims=True), 1e-12)
    else:  # linear
        lo = np.floor(src).astype(np.int64)
        hi = lo + 1
        frac = np.clip(src - lo, 0.0, 1.0).astype(np.float32)
        w_lo, w_hi = 1.0 - frac, frac
        if exclude_outside:
            w_lo = np.where((lo < 0) | (lo >= n_in), 0.0, w_lo)
            w_hi = np.where((hi < 0) | (hi >= n_in), 0.0, w_hi)
        m[np.arange(n_out), np.clip(lo, 0, n_in - 1)] += w_lo
        m[np.arange(n_out), np.clip(hi, 0, n_in - 1)] += w_hi
        if exclude_outside:
            m /= np.maximum(m.sum(axis=1, keepdims=True), 1e-12)
    return m


# resize matrices on their device, per geometry (a host->device copy per
# call would synchronize the stream)
_RESIZE_MATRICES: dict[tuple, torch.Tensor] = {}


def _resize_matrix_on(key: tuple, device: torch.device,
                      dtype: torch.dtype) -> torch.Tensor:
    full = key + (device, dtype)
    m = _RESIZE_MATRICES.get(full)
    if m is None:
        m = torch.from_numpy(_resize_matrix(*key)).to(device=device,
                                                       dtype=dtype)
        _RESIZE_MATRICES[full] = m
    return m


def _resize(node: OnnxNode, x, roi=None, scales=None, sizes=None):
    legacy = node.attrs.get("_opset", 13) < 11
    if legacy and scales is None and sizes is None \
            and roi is not None:
        # opset-10 Resize has inputs (X, scales): no roi slot
        roi, scales = None, roi
    mode = node.attrs.get("mode", b"nearest").decode()
    if legacy:
        # opset-10 semantics: asymmetric coordinates, floor rounding
        coord, nearest = "asymmetric", "floor"
    else:
        coord = node.attrs.get(
            "coordinate_transformation_mode", b"half_pixel").decode()
        nearest = node.attrs.get(
            "nearest_mode", b"round_prefer_floor").decode()
    if mode not in ("nearest", "linear", "cubic"):
        raise ValueError(f"Resize mode {mode!r} unsupported ({node.name})")
    cubic_a = float(node.attrs.get("cubic_coeff_a", -0.75))
    antialias = bool(node.attrs.get("antialias", 0))
    exclude = bool(node.attrs.get("exclude_outside", 0))
    if scales is not None and np.asarray(scales).size == 0:
        scales = None
    if not _is_concrete(scales if sizes is None else sizes):
        raise ValueError(f"Resize with traced geometry ({node.name})")
    # opset 18+: scales/sizes may cover only the named axes
    axes = node.attrs.get("axes")
    axes = (list(range(x.ndim)) if axes is None
            else [int(a) % x.ndim for a in axes])
    if sizes is not None:
        out_shape = list(x.shape)
        for a, s in zip(axes, np.asarray(sizes).reshape(-1)):
            out_shape[a] = int(s)
    elif scales is not None:
        sc = np.asarray(scales, np.float64).reshape(-1)
        out_shape = list(x.shape)
        for a, s in zip(axes, sc):
            out_shape[a] = int(np.floor(x.shape[a] * s))
    else:
        raise ValueError(f"Resize without scales/sizes ({node.name})")
    if list(out_shape[:2]) != list(x.shape[:2]):
        raise ValueError(
            f"Resize over batch/channel axes unsupported ({node.name})")
    out = _t(x)
    for ax in range(2, out.ndim):
        if out_shape[ax] == out.shape[ax]:
            continue
        m = _resize_matrix_on(
            (int(out.shape[ax]), out_shape[ax], mode, coord, nearest,
             cubic_a, antialias, exclude), out.device, out.dtype)
        out = torch.movedim(
            torch.tensordot(out, m, dims=([ax], [1])), -1, ax)
    return out


def _upsample(node: OnnxNode, x, scales=None):
    if scales is None:  # opset <= 8: attribute (plain float list)
        scales = np.asarray(node.attrs["scales"], np.float64)
    node = OnnxNode("Resize", node.name, node.inputs, node.outputs,
                    {"mode": node.attrs.get("mode", b"nearest"),
                     "coordinate_transformation_mode": b"asymmetric",
                     "nearest_mode": b"floor"})
    return _resize(node, x, None, scales, None)


def _depth_to_space(node: OnnxNode, x):
    b, c, h, w = x.shape
    k = int(node.attrs["blocksize"])
    if node.attrs.get("mode", b"DCR") == b"DCR":
        y = _perm(x.reshape(b, k, k, c // (k * k), h, w),
                  (0, 3, 4, 1, 5, 2))
    else:  # CRD
        y = _perm(x.reshape(b, c // (k * k), k, k, h, w),
                  (0, 1, 4, 2, 5, 3))
    return y.reshape(b, c // (k * k), h * k, w * k)


def _space_to_depth(node: OnnxNode, x):
    b, c, h, w = x.shape
    k = int(node.attrs["blocksize"])
    y = x.reshape(b, c, h // k, k, w // k, k)
    return _perm(y, (0, 3, 5, 1, 2, 4)).reshape(
        b, c * k * k, h // k, w // k)


def _lrn(node: OnnxNode, x):
    alpha = node.attrs.get("alpha", 1e-4)
    beta = node.attrs.get("beta", 0.75)
    bias = node.attrs.get("bias", 1.0)
    size = int(node.attrs["size"])
    x = _t(x)
    # sum over a size-window along C, centered (ONNX: floor((size-1)/2)
    # before, the rest after)
    lo = (size - 1) // 2
    sq = F.pad(x ** 2, _pad_arg([(0, 0), (lo, size - 1 - lo)]
                                + [(0, 0)] * (x.ndim - 2)))
    c = x.shape[1]
    acc = sq[:, 0:c]
    for i in range(1, size):
        acc = acc + sq[:, i:i + c]
    return x / (bias + (alpha / size) * acc) ** beta


def _constant_of_shape(node: OnnxNode, shape):
    if not _is_concrete(shape):
        raise ValueError(f"ConstantOfShape traced shape ({node.name})")
    val = node.attrs.get("value")
    val = np.zeros(1, np.float32) if val is None else np.asarray(val)
    return np.full([int(s) for s in np.asarray(shape).reshape(-1)],
                   val.reshape(-1)[0], val.dtype)


def _expand(node: OnnxNode, x, shape):
    if not _is_concrete(shape):
        raise ValueError(f"Expand with traced shape ({node.name})")
    target = [int(s) for s in np.asarray(shape).reshape(-1)]
    # ONNX Expand = numpy broadcasting, but dims of 1 in `shape` keep
    # the input's size
    xs = list(x.shape)
    while len(xs) < len(target):
        xs.insert(0, 1)
    out = [max(a, b) for a, b in zip(xs, target)]
    if _is_concrete(x):
        return np.broadcast_to(np.reshape(x, xs), out)
    return torch.broadcast_to(x.reshape(xs), out)


def _reshape(node: OnnxNode, x, shape):
    if not _is_concrete(shape):
        raise ValueError(f"Reshape with traced shape ({node.name})")
    shape = np.asarray(shape).reshape(-1).tolist()
    out = []
    for i, s in enumerate(shape):
        out.append(int(x.shape[i]) if s == 0 else int(s))
    return x.reshape(out)


def _slice(node: OnnxNode, x, starts=None, ends=None, axes=None,
           steps=None):
    if starts is None:  # opset < 10: attributes
        starts = node.attrs["starts"]
        ends = node.attrs["ends"]
        axes = node.attrs.get("axes")
    starts = np.asarray(starts).tolist()
    ends = np.asarray(ends).tolist()
    axes = (list(range(len(starts))) if axes is None
            else np.asarray(axes).tolist())
    steps = ([1] * len(starts) if steps is None
             else np.asarray(steps).tolist())
    slices = [slice(None)] * x.ndim
    backwards = []
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        # ONNX clamps out-of-range ends (INT_MAX idiom)
        en = min(en, np.iinfo(np.int32).max)
        slices[ax] = slice(int(st), int(en), int(sp))
        if sp < 0:
            backwards.append(ax % x.ndim)
    if _is_concrete(x) or not backwards:
        return x[tuple(slices)]
    # torch slices only forwards: a negative step gathers its indices
    for ax in backwards:
        idx = np.arange(int(x.shape[ax]))[slices[ax]]
        slices[ax] = slice(None)
        x = torch.index_select(
            x, ax, torch.from_numpy(np.ascontiguousarray(idx)).to(x.device))
    return x[tuple(slices)]


def _softmax(node: OnnxNode, x):
    # opset < 13: flattened-2D semantics: softmax over ALL dims from
    # `axis` on (default axis 1), not just one axis. The executor records
    # the model opset on the node at build time.
    opset = node.attrs.get("_opset", 13)
    if opset < 13:
        axis = int(node.attrs.get("axis", 1)) % max(x.ndim, 1)
        shape = tuple(x.shape)
        lead = int(np.prod(shape[:axis])) if axis else 1
        return torch.softmax(_t(x).reshape(lead, -1), dim=-1).reshape(shape)
    axis = node.attrs.get("axis", -1)
    if _is_concrete(x):
        e = np.exp(x - x.max(axis=axis, keepdims=True))
        return e / e.sum(axis=axis, keepdims=True)
    return torch.softmax(x, dim=axis)


def _div(a, b):
    """ONNX Div: true division for floats, C-style TRUNCATING integer
    division for integer values (exporters lean on it for shape math:
    torch.chunk emits (size+k-1) Div k on int64)."""
    if not (_is_int(a) and _is_int(b)):
        return a / b if _is_concrete(a, b) else _t(a) / _t(b)
    if not _is_concrete(a, b):
        return torch.div(_t(a), _t(b), rounding_mode="trunc")
    q = a // b
    # floor -> trunc adjustment for mixed signs with a remainder
    return q + ((a - q * b != 0) & ((a < 0) != (b < 0)))


def _gather(node: OnnxNode, x, idx):
    axis = node.attrs.get("axis", 0)
    if _is_concrete(x, idx):
        return np.take(x, np.asarray(idx), axis=axis)
    x, idx = _t(x), _t(idx).to(torch.int64)
    axis %= x.ndim
    dim = x.shape[axis]
    idx = torch.where(idx < 0, idx + dim, idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


def _unsqueeze(node: OnnxNode, x, axes=None):
    axes = (node.attrs["axes"] if axes is None
            else np.asarray(axes).tolist())
    for ax in sorted(axes):
        x = (np.expand_dims(x, ax) if _is_concrete(x)
             else torch.unsqueeze(x, ax))
    return x


def _squeeze(node: OnnxNode, x, axes=None):
    axes = (node.attrs.get("axes") if axes is None
            else np.asarray(axes).tolist())
    if axes is None:
        return x.squeeze()
    return x.squeeze(tuple(int(a) for a in axes))


def _clip(node: OnnxNode, x, lo=None, hi=None):
    lo = node.attrs.get("min") if lo is None else lo
    hi = node.attrs.get("max") if hi is None else hi
    if _is_concrete(x):
        return np.clip(x, lo, hi)
    if lo is None and hi is None:  # torch.clamp wants a bound
        return x
    lo, hi = (np.asarray(v).item() if _is_concrete(v) else v
              for v in (lo, hi))
    return torch.clamp(x, lo, hi)


def _cast(node: OnnxNode, x):
    to = node.attrs["to"]
    if _is_concrete(x):
        return np.asarray(x).astype(_ONNX_NP_DTYPES[to])
    return x.to(_ONNX_TORCH_DTYPES[to])


def _concat(node: OnnxNode, *xs):
    axis = node.attrs.get("axis", 0)
    if _is_concrete(*xs):
        return np.concatenate(xs, axis=axis)
    return torch.cat([_t(x) for x in xs], dim=axis)


def _transpose(node: OnnxNode, x):
    perm = node.attrs.get("perm")
    if perm is None:
        perm = list(reversed(range(x.ndim)))
    return _perm(x, perm)


def _prelu(x, slope):
    x, slope = _t(x), _t(slope)
    if slope.numel() > 1 and slope.ndim < x.ndim:
        # unidirectional broadcast from the channel axis (ONNX PRelu:
        # slope broadcastable to x; exporters emit (C,), (C,1,1), ...)
        want = tuple(slope.shape) + (1,) * (x.ndim - 1 - slope.ndim)
        slope = slope.reshape(want)
    return torch.where(x >= 0, x, slope * x)


def _min_max(xs, kind: str):
    if _is_concrete(*xs):
        fn, xs = getattr(np, kind), list(xs)
    else:
        fn, xs = getattr(torch, kind), [_t(x) for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = fn(out, x)
    return out


def _argminmax(node: OnnxNode, x, kind: str):
    axis = node.attrs.get("axis", 0)
    keep = bool(node.attrs.get("keepdims", 1))
    last = node.attrs.get("select_last_index", 0)
    if _is_concrete(x):
        # argmin/argmax return the FIRST winner; flipping the axis and
        # re-indexing yields the last occurrence instead
        if last:
            out = x.shape[axis] - 1 - getattr(np, kind)(
                np.flip(x, axis), axis=axis)
        else:
            out = getattr(np, kind)(x, axis=axis)
        out = np.asarray(out, np.int64)
        return np.expand_dims(out, axis) if keep else out
    fn = getattr(torch, kind)
    if last:
        out = x.shape[axis] - 1 - fn(torch.flip(x, (axis,)), dim=axis)
    else:
        out = fn(x, dim=axis)
    return torch.unsqueeze(out, axis) if keep else out


def _range(node: OnnxNode, lo, hi, step):
    if not _is_concrete(lo, hi, step):
        raise ValueError(f"Range with traced bounds ({node.name})")
    return np.arange(np.asarray(lo).item(), np.asarray(hi).item(),
                     np.asarray(step).item())


def _tile(node: OnnxNode, x, reps):
    if not _is_concrete(reps):
        raise ValueError(f"Tile with traced reps ({node.name})")
    reps = tuple(int(r) for r in np.asarray(reps).reshape(-1))
    return np.tile(x, reps) if _is_concrete(x) else torch.tile(x, reps)


_OPS: dict[str, Callable] = {
    "Conv": _conv,
    "BatchNormalization": _batch_norm,
    "Relu": _eltwise(lambda x: np.maximum(x, 0), torch.relu),
    "Add": _eltwise(lambda a, b: a + b, torch.add),
    "Sub": _eltwise(lambda a, b: a - b, torch.sub),
    "Mul": _eltwise(lambda a, b: a * b, torch.mul),
    "Div": lambda n, a, b: _div(a, b),
    "Exp": _eltwise(np.exp, torch.exp),
    "Sqrt": _eltwise(np.sqrt, torch.sqrt),
    "Sigmoid": lambda n, x: torch.sigmoid(_t(x)),
    "Identity": lambda n, x: x,
    "Concat": _concat,
    "Transpose": _transpose,
    "Reshape": _reshape,
    "Flatten": lambda n, x: x.reshape(
        int(np.prod(x.shape[:n.attrs.get("axis", 1)]) or 1), -1),
    # opset 15+: optional start/end attrs slice the shape (negatives
    # clamp per spec)
    "Shape": lambda n, x: np.asarray(
        tuple(x.shape)[slice(n.attrs.get("start", 0), n.attrs.get("end"))],
        np.int64),
    "Gather": _gather,
    "Unsqueeze": _unsqueeze,
    "Squeeze": _squeeze,
    "Cast": _cast,
    "Softmax": _softmax,
    "Slice": _slice,
    "MaxPool": _max_pool,
    "MaxUnpool": _max_unpool,
    "AveragePool": lambda n, x: _pool(n, x, "avg"),
    "Clip": _clip,
    "Constant": lambda n: n.attrs["value"],
    "Gemm": _gemm,
    "MatMul": lambda n, a, b: _t(a) @ _t(b),
    "GlobalAveragePool": lambda n, x: _global_pool(n, x, True),
    "GlobalMaxPool": lambda n, x: _global_pool(n, x, False),
    "ConvTranspose": _conv_transpose,
    "Pad": _pad,
    "Resize": _resize,
    "Upsample": _upsample,
    "Split": _split,
    "Dropout": _dropout,
    "LRN": _lrn,
    "DepthToSpace": _depth_to_space,
    "SpaceToDepth": _space_to_depth,
    "ConstantOfShape": _constant_of_shape,
    "Expand": _expand,
    "ReduceMean": lambda n, x, axes=None: _reduce(n, x, axes, kind="mean"),
    "ReduceSum": lambda n, x, axes=None: _reduce(n, x, axes, kind="sum"),
    "ReduceMax": lambda n, x, axes=None: _reduce(n, x, axes, kind="max"),
    "ReduceMin": lambda n, x, axes=None: _reduce(n, x, axes, kind="min"),
    "ReduceProd": lambda n, x, axes=None: _reduce(n, x, axes, kind="prod"),
    "LeakyRelu": lambda n, x: (lambda x: torch.where(
        x >= 0, x, n.attrs.get("alpha", 0.01) * x))(_t(x)),
    "PRelu": lambda n, x, slope: _prelu(x, slope),
    "Elu": lambda n, x: (lambda x: torch.where(
        x >= 0, x, n.attrs.get("alpha", 1.0) * (torch.exp(x) - 1)))(_t(x)),
    "Selu": lambda n, x: (lambda x: n.attrs.get("gamma", 1.0507009873554805)
                          * torch.where(
                              x >= 0, x,
                              n.attrs.get("alpha", 1.6732632423543772)
                              * (torch.exp(x) - 1)))(_t(x)),
    "Tanh": _eltwise(np.tanh, torch.tanh),
    "Erf": lambda n, x: torch.erf(_t(x)),
    "HardSigmoid": lambda n, x: torch.clamp(
        n.attrs.get("alpha", 0.2) * _t(x) + n.attrs.get("beta", 0.5), 0, 1),
    "HardSwish": lambda n, x: (lambda x: x * torch.clamp(
        x / 6.0 + 0.5, 0, 1))(_t(x)),
    "Softplus": lambda n, x: (lambda x: torch.logaddexp(
        x, torch.zeros_like(x)))(_t(x)),
    "Pow": _eltwise(lambda a, b: a ** b, torch.pow),
    "Neg": lambda n, x: -x,
    "Abs": _eltwise(np.abs, torch.abs),
    "Floor": _eltwise(np.floor, torch.floor),
    "Ceil": _eltwise(np.ceil, torch.ceil),
    "Reciprocal": lambda n, x: 1.0 / x,
    "Log": _eltwise(np.log, torch.log),
    "Min": lambda n, *xs: _min_max(xs, "minimum"),
    "Max": lambda n, *xs: _min_max(xs, "maximum"),
    "Where": _eltwise(np.where, torch.where),
    "Equal": _eltwise(lambda a, b: a == b, torch.eq),
    "Greater": _eltwise(lambda a, b: a > b, torch.gt),
    "GreaterOrEqual": _eltwise(lambda a, b: a >= b, torch.ge),
    "Less": _eltwise(lambda a, b: a < b, torch.lt),
    "LessOrEqual": _eltwise(lambda a, b: a <= b, torch.le),
    "Not": lambda n, x: ~x,
    "And": _eltwise(lambda a, b: a & b, torch.bitwise_and),
    "Or": _eltwise(lambda a, b: a | b, torch.bitwise_or),
    "ArgMax": lambda n, x: _argminmax(n, x, "argmax"),
    "ArgMin": lambda n, x: _argminmax(n, x, "argmin"),
    "Range": _range,
    "Tile": _tile,
}

# inputs that must stay concrete (shapes, axes, pads, geometry): never
# turned into tensors, even when another input is one
_CONCRETE_INPUTS: dict[str, frozenset] = {
    op: frozenset(pos) for op, pos in {
        "Shape": (0,), "Reshape": (1,), "Unsqueeze": (1,), "Squeeze": (1,),
        "Slice": (1, 2, 3, 4), "MaxUnpool": (2,), "Clip": (1, 2),
        "Pad": (1, 2, 3), "Resize": (1, 2, 3), "Upsample": (1,),
        "Split": (1,), "Dropout": (1, 2), "ConstantOfShape": (0,),
        "Expand": (1,), "ReduceMean": (1,), "ReduceSum": (1,),
        "ReduceMax": (1,), "ReduceMin": (1,), "ReduceProd": (1,),
        "Range": (0, 1, 2), "Tile": (1,),
    }.items()}

UNPORTED = ("not in the PyTorch port's op set (the JAX executor's other "
            "ops, If, Loop and Scan are ROADMAP A.8b)")


class GraphExecutor(torch.nn.Module):
    """Callable ONNX graph: ``executor(*inputs) -> tuple(outputs)``.

    Build-time validation: every node's op must be in the op set and every
    node input producible, so an unknown topology fails here, as tract's
    load-time check does. The build then evaluates, once, every node whose
    inputs are all constants and whose result is NumPy, and registers the
    graph's constants as buffers (the module docstring). ``nodes_run`` is
    the number of nodes a call executes; ``host_copies`` the NumPy values
    the last call turned into tensors (0 on a graph whose data never meets
    a value computed on the host)."""

    def __init__(self, graph: OnnxGraph):
        super().__init__()
        self.graph = graph
        self.input_names = [i.name for i in graph.inputs]
        self.output_names = [o.name for o in graph.outputs]
        known = set(self.input_names) | set(graph.initializers) | {""}
        self._annotate_opset(graph.nodes, graph.opset)
        self._validate(graph.nodes, known)
        absent = [o for o in self.output_names if o not in known]
        if absent:
            raise ValueError(f"graph outputs never produced: {absent}")
        self._static = self._fold(graph)
        self._nodes = [n for n in graph.nodes
                       if not all(o in self._static for o in n.outputs)]
        self.nodes_run = len(self._nodes)
        self.host_copies = 0
        self._buffer_of: dict[str, str] = {}
        for i, (name, value) in enumerate(self._static.items()):
            if isinstance(value, (np.ndarray, np.generic)) \
                    and value.dtype != object:
                attr = f"const{i}"
                self.register_buffer(attr, _to_tensor(value, "cpu"),
                                     persistent=False)
                self._buffer_of[name] = attr
        # per node: (data input positions, [(position, buffer)] of its
        # constant data inputs)
        self._plans = [self._plan(n) for n in self._nodes]

    def _annotate_opset(self, nodes, opset: int) -> None:
        """Ops whose SEMANTICS changed across opsets need the model's
        opset at run time; record it on the node."""
        for node in nodes:
            if node.op_type in ("Softmax", "Resize"):
                node.attrs.setdefault("_opset", opset)

    def _validate(self, nodes, known: set) -> None:
        for node in nodes:
            if node.op_type not in _OPS:
                raise ValueError(
                    f"unsupported ONNX op {node.op_type!r} "
                    f"(node {node.name!r}): {UNPORTED}")
            missing = [i for i in node.inputs if i not in known]
            if missing:
                raise ValueError(
                    f"node {node.name!r} consumes unknown values "
                    f"{missing} (graph not topologically ordered?)")
            known.update(node.outputs)

    @staticmethod
    def _fold(graph: OnnxGraph) -> dict:
        """The graph's constants: its initializers, and the outputs of
        every node computed from constants alone that yields NumPy."""
        static = dict(graph.initializers)
        saved, _STATE.device = getattr(_STATE, "device", None), None
        for node in graph.nodes:
            if not all(i == "" or i in static for i in node.inputs):
                continue
            args = [static[i] if i else None for i in node.inputs]
            while args and args[-1] is None:
                args.pop()
            try:
                results = _OPS[node.op_type](node, *args)
            except Exception:  # left to the call, which raises the same
                continue
            results = results if len(node.outputs) > 1 else (results,)
            if len(results) == len(node.outputs) and _is_concrete(*results):
                static.update(zip(node.outputs, results))
        _STATE.device = saved
        return static

    def _plan(self, node: OnnxNode):
        keep = _CONCRETE_INPUTS.get(node.op_type, frozenset())
        data = [i for i in range(len(node.inputs)) if i not in keep]
        consts = [(i, self._buffer_of[node.inputs[i]]) for i in data
                  if node.inputs[i] in self._buffer_of]
        return data, consts

    def forward(self, *inputs):
        """Run the graph on ``inputs`` (tensors, or arrays that become
        tensors on the executor's device); returns the graph's outputs as a
        tuple. NumPy values meet tensors on the inputs' device."""
        if len(inputs) != len(self.input_names):
            raise ValueError(
                f"expected {len(self.input_names)} inputs "
                f"({self.input_names}), got {len(inputs)}")
        device = next((x.device for x in inputs
                       if isinstance(x, torch.Tensor)), None)
        if device is None:
            device = next((b.device for b in self.buffers()),
                          torch.device("cpu"))
        saved = getattr(_STATE, "device", None), getattr(_STATE,
                                                         "converted", 0)
        _STATE.device, _STATE.converted = device, 0
        try:
            env: dict[str, object] = dict(self._static)
            env.update(zip(self.input_names,
                           (_to_tensor(x, device)
                            if not isinstance(x, torch.Tensor) else x
                            for x in inputs)))
            self._exec_nodes(env)
            self.host_copies = _STATE.converted
        finally:
            _STATE.device, _STATE.converted = saved
        return tuple(env[name] for name in self.output_names)

    def _exec_nodes(self, env: dict) -> None:
        buffers = self._buffers
        for node, (data, consts) in zip(self._nodes, self._plans):
            # optional inputs are empty-named and may sit in the MIDDLE of
            # the list (torch: Resize(X, "", scales)): keep their position
            # as None, strip the trailing ones
            args = [env[name] if name != "" else None
                    for name in node.inputs]
            if consts and any(isinstance(args[i], torch.Tensor)
                              for i in data):
                for i, attr in consts:
                    args[i] = buffers[attr]
            while args and args[-1] is None:
                args.pop()
            results = _OPS[node.op_type](node, *args)
            if len(node.outputs) == 1:
                env[node.outputs[0]] = results
            else:
                if len(results) != len(node.outputs):
                    raise ValueError(
                        f"node {node.name!r} ({node.op_type}) produced "
                        f"{len(results)} results for "
                        f"{len(node.outputs)} declared outputs")
                for out_name, val in zip(node.outputs, results):
                    env[out_name] = val


class GraphModel(torch.nn.Module):
    """A graph mapping one ``[1, 3, H, W]`` float image to ``(scores [1, K,
    2], boxes [1, K, 4])``, as the port's detect programs call a model:
    ``model(x [B, H, W, 3], priors) -> (scores, boxes)``. The graph runs
    once per image under `torch.func.vmap` (the JAX package vmaps it too):
    exports pin batch 1 in their ``Reshape`` constants, and a graph run on
    the whole batch would merge the images there. ``priors`` is unused:
    the graph decodes its own boxes."""

    def __init__(self, graph: OnnxGraph):
        super().__init__()
        self.executor = GraphExecutor(graph)

    def _one(self, xi: torch.Tensor):
        scores, boxes = self.executor(xi[None])
        return scores[0], boxes[0]

    def forward(self, x: torch.Tensor, priors=None):
        return torch.func.vmap(self._one)(x.permute(0, 3, 1, 2))


class _NotAGraphProgram:
    """A `Detector` program that JAX's ``GraphDetector`` does not have:
    reading it raises AttributeError, so ``hasattr`` is False and the
    serving worker takes the graph's own paths, as the JAX worker does."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        raise AttributeError(
            f"{objtype.__name__} has no program {self.name!r}: a graph "
            "detector runs the JAX GraphDetector's programs only")


class _GraphPrograms:
    """What a graph detector lacks of `Detector`: the splice transcode and
    the programs that decode JPEG bytes themselves."""

    run_device_ycbcr = _NotAGraphProgram()
    run_device_coefficients = _NotAGraphProgram()
    run_device_coefficients_annotated = _NotAGraphProgram()
    run_device_coefficients_annotated_packed = _NotAGraphProgram()

    def to_mesh(self, mesh: list) -> "ShardedGraphDetector":
        """The same graph over the replicas of ``mesh`` (a list of
        devices): a replica copies the graph module, constants included,
        to its card."""
        return ShardedGraphDetector(self, mesh)


class GraphDetector(_GraphPrograms, Detector):
    """A detector whose CNN is the ONNX graph itself (the port of JAX's
    ``GraphDetector``; the reference loads and runs the downloaded graph).

    Any export that consumes ``[1, 3, H, W]`` float and yields
    ``(scores [1, K, 2], boxes [1, K, 4])`` serves: preprocess to the
    graph's input size, the graph per image, then filter + greedy NMS
    (``csrc/nms.cu`` on the card, one launch a call). It has JAX's
    programs: `run_device`, `run_device_ycbcr_packed`,
    `run_device_ycbcr_annotated`, `run_device_annotated`,
    `run_device_coefficients_arrays`, `warmup`, `detect_batch`, `detect`
    and `to_mesh`; no splice transcode and no tiled programs. It computes
    in float32, the graph's own dtype, in IEEE float32 whatever the TF32
    settings (`config.full_float32` around every program)."""

    # pylint: disable=super-init-not-called  (no UltraFace weights to load)
    def __init__(self, path_or_graph, config: DetectorConfig | None = None,
                 *, device: str | torch.device = "cuda"):
        self.config = config or DetectorConfig(compute_dtype="float32")
        self.device = resolve_device(device)
        graph = (path_or_graph if isinstance(path_or_graph, OnnxGraph)
                 else read_onnx_graph(path_or_graph))
        self.graph = graph
        shape = graph.inputs[0].shape
        if len(shape) != 4 or shape[1] != 3:
            raise ValueError(f"expected NCHW image input, got {shape}")
        self.height, self.width = int(shape[2]), int(shape[3])
        self.model = GraphModel(graph).to(self.device)
        self.executor = self.model.executor
        self.priors = torch.zeros((0, 4), device=self.device)
        self.preprocessor = Preprocessor(self.width, self.height,
                                         self.device)


class ShardedGraphDetector(_GraphPrograms, ShardedDetector):
    """`GraphDetector.to_mesh`: the graph's programs with the batch split
    over the replicas of ``mesh`` (`ShardedDetector`)."""

    def __init__(self, detector: GraphDetector, mesh: list):
        super().__init__(detector, mesh)
        self.graph = detector.graph
