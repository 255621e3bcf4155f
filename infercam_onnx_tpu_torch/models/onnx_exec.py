"""Execute an ONNX graph with PyTorch: the port of
``infercam_onnx_tpu/models/onnx_exec.py``.

The reference loads the downloaded ONNX graph and *runs* it (tract). The
JAX package does the same with an interpreter over ``jax.numpy``; this is
its counterpart over torch. `GraphExecutor` walks the graph's nodes in
order and calls one plain function per op; `GraphDetector` runs a graph
that maps ``[1, 3, H, W]`` images to ``(scores, boxes)`` inside the port's
detect programs (preprocess, the graph, filter + greedy NMS through
``csrc/nms.cu``).

The op set is the JAX table's whole: the convolutional ops, the norms,
the RNN family (a plain time loop: ONNX gate orders, ``clip``,
``sequence_lens``), the sequence, gather/scatter, GridSample and RoiAlign
ops, the int8 quantized family (QDQ exports; the integer convolution
and matmul accumulate exactly in float64), and the control flow ops
``If``/``Loop``/``Scan``, whose bodies are child modules with their own
constants. An op outside the table raises when the executor is built,
with the JAX executor's message.

Values are NumPy where they are concrete and tensors where they are data,
as in the JAX interpreter: ``Shape -> Gather -> Unsqueeze -> Concat ->
Reshape`` chains stay NumPy and resolve to static shapes, and a NumPy value
that meets a tensor becomes a tensor on the tensor's device, float64 as
float32 (the JAX package runs without x64). The graph's constants (its
initializers, ``Constant`` nodes and the nodes computed from them alone,
which the build evaluates once: a QDQ export's int8 weights are
dequantized there) are registered buffers of the executor: they reach a
device with ``.to(device)`` or a deep copy, once, and no call copies them
from the host again. A condition or trip count of control flow is read
on the host where it is NumPy or a tensor outside `torch.func.vmap`; a
condition batched under vmap takes both branches and a select (If) or a
loop that runs while any image's condition holds, each image keeping its
values once its own condition fails (Loop), as ``jax.vmap`` of the JAX
executor does.
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
    """``v`` as a tensor: a tensor as it is; a constant of the running
    graph by its buffer; another NumPy value or a Python number copied to
    the executor's device, float64 as float32."""
    if isinstance(v, torch.Tensor):
        return v
    at = (getattr(_STATE, "buffer_of", None) or {}).get(id(v))
    if at is not None:
        return at[0]._buffers[at[1]]
    _STATE.converted = getattr(_STATE, "converted", 0) + 1
    return _to_tensor(v, _device())


def _to_tensor(v, device: torch.device) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype in (np.uint16, np.uint32, np.uint64):
        a = a.astype(np.int64)
    return torch.tensor(np.asarray(a, order="C"), device=device)


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


def _softmax(node: OnnxNode, x, log: bool = False):
    # opset < 13: flattened-2D semantics: softmax over ALL dims from
    # `axis` on (default axis 1), not just one axis. The executor records
    # the model opset on the node at build time (subgraphs inherit it).
    fn = torch.log_softmax if log else torch.softmax
    opset = node.attrs.get("_opset", 13)
    if opset < 13:
        axis = int(node.attrs.get("axis", 1)) % max(x.ndim, 1)
        shape = tuple(x.shape)
        lead = int(np.prod(shape[:axis])) if axis else 1
        return fn(_t(x).reshape(lead, -1), dim=-1).reshape(shape)
    axis = node.attrs.get("axis", -1)
    if _is_concrete(x) and not log:
        e = np.exp(x - x.max(axis=axis, keepdims=True))
        return e / e.sum(axis=axis, keepdims=True)
    return fn(_t(x), dim=axis)


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


def _host(v):
    """A value read on the host: NumPy as it is, a tensor copied back."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


def _batched(v) -> bool:
    """A tensor that carries a `torch.func.vmap` batch: its value differs
    per image, so the host cannot read one value of it."""
    return isinstance(v, torch.Tensor) and \
        torch._C._functorch.is_batchedtensor(v)


def _readable(*vals) -> bool:
    """Values the host can read (NumPy, or tensors outside vmap's batch):
    JAX's concrete values, and the tensors it would read eagerly."""
    return all(_is_concrete(v) or (isinstance(v, torch.Tensor)
                                   and not _batched(v)) for v in vals)


def _any(v) -> bool:
    """Whether ``v`` holds for any image of every enclosing vmap."""
    while _batched(v):
        v = torch._C._functorch.get_unwrapped(v)
    return bool(v.any())


def _topk(node: OnnxNode, x, k=None):
    if k is None:  # opset <= 9: k as attribute
        k = node.attrs["k"]
    elif not _is_concrete(k):
        raise ValueError(f"TopK with traced K ({node.name})")
    k = int(np.asarray(k).reshape(()))
    axis = node.attrs.get("axis", -1)
    largest = bool(node.attrs.get("largest", 1))
    if _is_concrete(x):
        xs = np.asarray(x)
        # negation of unsigned dtypes wraps instead of reversing order
        key = (xs.astype(np.int64)
               if np.issubdtype(xs.dtype, np.unsignedinteger) else xs)
        order = np.argsort(-key if largest else key, axis=axis,
                           kind="stable")
        idx = np.take(order, np.arange(k), axis=axis)
        return (np.take_along_axis(xs, idx, axis=axis),
                idx.astype(np.int64))
    moved = torch.movedim(_t(x), axis, -1)
    key = moved.to(torch.int64) if moved.dtype == torch.uint8 else moved
    # a stable sort keeps the lower index first on ties, as lax.top_k
    idx = torch.sort(key, dim=-1, descending=largest,
                     stable=True).indices[..., :k]
    vals = torch.gather(moved, -1, idx)
    return torch.movedim(vals, -1, axis), torch.movedim(idx, -1, axis)


def _nms_onnx(node: OnnxNode, boxes, scores, max_out=None,
              iou_thresh=None, score_thresh=None):
    """ONNX NonMaxSuppression: dynamic-length selected_indices [S, 3]
    (batch, class, box). The output SHAPE depends on the data, so the op
    runs on the host (NumPy, as the JAX package's) on values it can read:
    under vmap it raises (the fixed-shape NMS of ``ops/postprocess.py``
    is the device path)."""
    if not _readable(boxes, scores):
        raise ValueError(
            f"NonMaxSuppression under vmap is unsupported ({node.name}) "
            "— dynamic output shape; use the fixed-shape NMS "
            "(ops/postprocess.py) for on-device pipelines")
    boxes, scores, max_out, iou_thresh, score_thresh = (
        _host(v) for v in (boxes, scores, max_out, iou_thresh,
                           score_thresh))
    max_out = (0 if max_out is None
               else int(np.asarray(max_out).reshape(())))
    if max_out == 0:
        # spec: max_output_boxes_per_class defaults to 0 = NO output
        return np.zeros((0, 3), np.int64)
    iou_thresh = (0.0 if iou_thresh is None
                  else float(np.asarray(iou_thresh).reshape(())))
    score_thresh = (None if score_thresh is None
                    else float(np.asarray(score_thresh).reshape(())))
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    if node.attrs.get("center_point_box", 0):
        cx, cy, w, h = (boxes[..., i] for i in range(4))
        boxes = np.stack([cy - h / 2, cx - w / 2,
                          cy + h / 2, cx + w / 2], axis=-1)
    else:
        # corners may be flipped per spec; canonicalize
        y1 = np.minimum(boxes[..., 0], boxes[..., 2])
        y2 = np.maximum(boxes[..., 0], boxes[..., 2])
        x1 = np.minimum(boxes[..., 1], boxes[..., 3])
        x2 = np.maximum(boxes[..., 1], boxes[..., 3])
        boxes = np.stack([y1, x1, y2, x2], axis=-1)
    selected = []
    for b in range(scores.shape[0]):
        for c in range(scores.shape[1]):
            s = scores[b, c]
            order = np.argsort(-s, kind="stable")
            if score_thresh is not None:
                order = order[s[order] > score_thresh]
            kept: list[int] = []
            for i in order:
                if len(kept) >= max_out:
                    break
                bi = boxes[b, i]
                ok = True
                for j in kept:
                    bj = boxes[b, j]
                    yy1 = max(bi[0], bj[0])
                    xx1 = max(bi[1], bj[1])
                    yy2 = min(bi[2], bj[2])
                    xx2 = min(bi[3], bj[3])
                    inter = max(0.0, yy2 - yy1) * max(0.0, xx2 - xx1)
                    area_i = (bi[2] - bi[0]) * (bi[3] - bi[1])
                    area_j = (bj[2] - bj[0]) * (bj[3] - bj[1])
                    union = area_i + area_j - inter
                    if union > 0 and inter / union > iou_thresh:
                        ok = False
                        break
                if ok:
                    kept.append(int(i))
            selected.extend([b, c, i] for i in kept)
    return np.asarray(selected, np.int64).reshape(-1, 3)


def _instance_norm(node: OnnxNode, x, scale, bias):
    eps = node.attrs.get("epsilon", 1e-5)
    x, scale, bias = _t(x), _t(scale), _t(bias)
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (scale.reshape(shape) * (x - mean)
            / torch.sqrt(var + eps) + bias.reshape(shape))


def _layer_norm(node: OnnxNode, x, scale, bias=None):
    eps = node.attrs.get("epsilon", 1e-5)
    x = _t(x)
    axes = tuple(range(node.attrs.get("axis", -1) % x.ndim, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, correction=0)
    inv_std = 1.0 / torch.sqrt(var + eps)
    out = (x - mean) * inv_std * _t(scale)
    if bias is not None:
        out = out + _t(bias)
    if len(node.outputs) == 1:
        return out
    # spec: optional Mean and InvStdDev outputs (kept reduced-rank with
    # keepdims, the shape the spec's "reduced" wording implies)
    return (out, mean, inv_std)[:len(node.outputs)]


def _group_norm(node: OnnxNode, x, scale, bias):
    eps = node.attrs.get("epsilon", 1e-5)
    groups = int(node.attrs["num_groups"])
    x, scale, bias = _t(x), _t(scale), _t(bias)
    b, c = x.shape[0], x.shape[1]
    g = x.reshape((b, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, g.ndim))
    mean = g.mean(dim=axes, keepdim=True)
    var = g.var(dim=axes, keepdim=True, correction=0)
    out = ((g - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    # opset 18 passes per-GROUP scale/bias [num_groups]; opset 21 (and
    # torch) per-CHANNEL [C]: broadcast the per-group form up
    if scale.shape[0] == groups and groups != c:
        scale = torch.repeat_interleave(scale, c // groups)
        bias = torch.repeat_interleave(bias, c // groups)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return scale.reshape(shape) * out + bias.reshape(shape)


def _shrink(node: OnnxNode, x):
    lambd = node.attrs.get("lambd", 0.5)
    bias = node.attrs.get("bias", 0.0)
    x = _t(x)
    return torch.where(x > lambd, x - bias,
                       torch.where(x < -lambd, x + bias, 0.0))


def _is_inf(node: OnnxNode, x):
    def fn(xp, x):
        return (xp.isinf(x)
                & ((x > 0) if not node.attrs.get("detect_negative", 1)
                   else (x == x))
                & ((x < 0) if not node.attrs.get("detect_positive", 1)
                   else (x == x)))
    return fn(np, x) if _is_concrete(x) else fn(torch, x)


def _eye_like(node: OnnxNode, x):
    k = node.attrs.get("k", 0)
    n, m = int(x.shape[0]), int(x.shape[1])
    if _is_concrete(x):
        dt = (_ONNX_NP_DTYPES[node.attrs["dtype"]] if "dtype" in node.attrs
              else np.asarray(x).dtype)
        return np.eye(n, m, k=k, dtype=dt)
    dt = (_ONNX_TORCH_DTYPES[node.attrs["dtype"]] if "dtype" in node.attrs
          else x.dtype)
    rows = torch.arange(n, device=x.device)[:, None]
    return (rows + k == torch.arange(m, device=x.device)[None, :]).to(dt)


def _trilu(node: OnnxNode, x, k=None):
    k = int(np.asarray(k).reshape(())) if k is not None else 0
    upper = node.attrs.get("upper", 1)
    if _is_concrete(x):
        return (np.triu if upper else np.tril)(x, k)
    return (torch.triu if upper else torch.tril)(x, k)


def _one_hot(node: OnnxNode, idx, depth, values):
    if not _is_concrete(depth):
        raise ValueError(f"OneHot with traced depth ({node.name})")
    d = int(np.asarray(depth).reshape(()))
    axis = node.attrs.get("axis", -1)
    if _is_concrete(idx, values):
        idx, off_on, hot = np.asarray(idx), np.asarray(values), np.arange(d)
        moveaxis, where = np.moveaxis, np.where
    else:
        idx, off_on = _t(idx), _t(values)
        hot = torch.arange(d, device=idx.device)
        moveaxis, where = torch.movedim, torch.where
    idx = where(idx < 0, idx + d, idx)  # negative indices per spec
    # broadcast compare along a new trailing axis, then move into place
    out = where(idx[..., None] == hot, off_on[1], off_on[0])
    if axis != -1:
        out = moveaxis(out, -1, axis % (idx.ndim + 1))
    return out


def _roi_align(node: OnnxNode, x, rois, batch_idx):
    """RoiAlign (two-stage detector exports): average/max pooling of
    bilinear samples over each ROI bin, with the ONNX reference kernel's
    quirks the JAX package keeps (samples more than 1px outside the image
    count zero, max mode takes the max of the WEIGHTED corners,
    output_half_pixel clamps thin ROIs to 1px). All ROIs at once: [R]
    leading every per-ROI value."""
    mode = node.attrs.get("mode", b"avg")
    oh = int(node.attrs.get("output_height", 1))
    ow = int(node.attrs.get("output_width", 1))
    ratio = int(node.attrs.get("sampling_ratio", 0))
    scale = float(node.attrs.get("spatial_scale", 1.0))
    coord = node.attrs.get("coordinate_transformation_mode",
                           b"half_pixel")
    aligned = coord == b"half_pixel"
    offset = 0.5 if aligned else 0.0
    adaptive = False
    if ratio > 0:
        rh = rw = ratio
    else:
        rhw = node.attrs.get("_ratio_hw")
        if rhw is not None:
            rh, rw = rhw
        elif not _is_concrete(rois, batch_idx):
            # adaptive ratio = ceil(roi_size / output) per axis is per-ROI
            # data: a static upper-bound sample grid sized for an ROI
            # spanning the whole feature map, each ROI's unused sample
            # rows/cols masked out (the JAX package's traced form; an ROI
            # wider than the whole map samples coarser than the reference)
            adaptive = True
            rh = max(-(-int(x.shape[2]) // oh), 1)
            rw = max(-(-int(x.shape[3]) // ow), 1)
        else:
            # concrete ROIs: group them by their resolved (gh, gw) grid,
            # one call per distinct grid
            rois_np = np.asarray(rois, np.float32)
            bi_np = np.asarray(batch_idx)
            n = rois_np.shape[0]
            c = x.shape[1]
            if n == 0:
                if isinstance(x, torch.Tensor):
                    return torch.zeros((0, c, oh, ow), dtype=x.dtype,
                                       device=x.device)
                return np.zeros((0, c, oh, ow), np.asarray(x).dtype)
            sizes = (rois_np[:, 2:4] - rois_np[:, 0:2]) * scale
            gw_all = np.maximum(np.ceil(sizes[:, 0] / ow), 1).astype(int)
            gh_all = np.maximum(np.ceil(sizes[:, 1] / oh), 1).astype(int)
            out = [None] * n
            for key in {(int(gh_all[k]), int(gw_all[k])) for k in range(n)}:
                idx = [k for k in range(n)
                       if (gh_all[k], gw_all[k]) == key]
                sub = OnnxNode(node.op_type, node.name, node.inputs,
                               node.outputs, dict(node.attrs, _ratio_hw=key))
                grp = _roi_align(sub, x, rois_np[idx], bi_np[idx])
                for j, k in enumerate(idx):
                    out[k] = grp[j]
            return torch.stack(out)
    x = _t(x)
    dev = x.device
    h, w = int(x.shape[2]), int(x.shape[3])
    rois = _t(rois).to(torch.float32)
    bidx = _t(batch_idx).to(torch.int64)
    r = rois.shape[0]
    x1, y1, x2, y2 = (rois[:, k] * scale - offset for k in range(4))
    roi_h, roi_w = y2 - y1, x2 - x1
    if not aligned:
        # legacy (output_half_pixel) mode clamps thin ROIs to 1px
        roi_h = torch.clamp(roi_h, min=1.0)
        roi_w = torch.clamp(roi_w, min=1.0)
    bin_h = roi_h / oh
    bin_w = roi_w / ow
    # sample grid: rh x rw points per bin at bin-relative offsets
    # (i + 0.5) / ratio per axis; adaptive mode masks the samples beyond
    # each ROI's own ratio out of the reduction
    sub_y = torch.arange(oh * rh, device=dev) % rh
    sub_x = torch.arange(ow * rw, device=dev) % rw
    if adaptive:
        rh_d = torch.clamp(torch.ceil(roi_h / oh), 1, rh)[:, None]
        rw_d = torch.clamp(torch.ceil(roi_w / ow), 1, rw)[:, None]
    else:
        rh_d, rw_d = float(rh), float(rw)
    bins_y = torch.arange(oh * rh, device=dev) // rh
    bins_x = torch.arange(ow * rw, device=dev) // rw
    iy = y1[:, None] + (bins_y + (sub_y + 0.5) / rh_d) * bin_h[:, None]
    ix = x1[:, None] + (bins_x + (sub_x + 0.5) / rw_d) * bin_w[:, None]
    grid_ok = (sub_y < rh_d)[..., :, None] & (sub_x < rw_d)[..., None, :]
    # samples more than 1px outside the image contribute ZERO (the ONNX
    # reference kernel), inside ones clamp
    ok = (((iy >= -1.0) & (iy <= h))[:, :, None]
          & ((ix >= -1.0) & (ix <= w))[:, None, :])
    gy = torch.clamp(iy, 0.0, h - 1.0)
    gx = torch.clamp(ix, 0.0, w - 1.0)
    y0 = torch.floor(gy).to(torch.int64)
    x0 = torch.floor(gx).to(torch.int64)
    y1i = torch.clamp(y0 + 1, max=h - 1)
    x1i = torch.clamp(x0 + 1, max=w - 1)
    wy = (gy - y0)[:, None, :, None]
    wx = (gx - x0)[:, None, None, :]
    bsel = bidx[:, None, None]

    def at(yy, xx):  # [R, C, Hs, Ws]
        return x[bsel, :, yy[:, :, None], xx[:, None, :]].permute(0, 3, 1, 2)

    v00, v01, v10, v11 = at(y0, x0), at(y0, x1i), at(y1i, x0), at(y1i, x1i)
    w00 = (1 - wy) * (1 - wx)
    w01 = (1 - wy) * wx
    w10 = wy * (1 - wx)
    w11 = wy * wx
    okc = ok[:, None]
    gokc = (grid_ok if grid_ok.ndim == 3 else grid_ok[None])[:, None]
    c = x.shape[1]
    if mode == b"max":
        # the Caffe2-lineage quirk the ONNX reference keeps: per sample,
        # max over the four WEIGHTED corner contributions
        v = torch.maximum(torch.maximum(w00 * v00, w01 * v01),
                          torch.maximum(w10 * v10, w11 * v11))
        v = torch.where(okc, v, 0.0)
        v = torch.where(gokc, v, -float("inf"))  # grid-masked: excluded
        return torch.amax(v.reshape(r, c, oh, rh, ow, rw), dim=(3, 5))
    v = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11
    v = torch.where(okc & gokc, v, 0.0)
    s = v.reshape(r, c, oh, rh, ow, rw).sum(dim=(3, 5))
    if adaptive:
        return s / (rh_d * rw_d).reshape(r, 1, 1, 1)
    return s / (rh_d * rw_d)


def _grid_reflect(coord, size: int, align: bool):
    """Reflect about [0, size-1] (align) or [-0.5, size-0.5]: fold into a
    doubled period, mirror the upper half."""
    if align:
        span = 2.0 * max(size - 1, 1)
        c = torch.remainder(torch.abs(coord), span)
        return torch.where(c > span / 2, span - c, c)
    span = 2.0 * size
    c = torch.remainder(coord + 0.5, span)
    c = torch.where(c > size, span - c, c)
    return torch.clamp(c - 0.5, 0.0, size - 1.0)


def _grid_unnormalize(coord, size: int, align: bool, reflect: bool):
    if align:
        c = (coord + 1) * (size - 1) / 2
    else:
        c = ((coord + 1) * size - 1) / 2
    return _grid_reflect(c, size, align) if reflect else c


def _grid_sample(node: OnnxNode, x, grid):
    """GridSample (opset 16+): bilinear/nearest/bicubic sampling of
    x[B,C,H,W] at grid[B,Ho,Wo,2] locations in [-1,1] xy order, by the
    JAX package's formula (zeros padding SELECTS 0 outside, so an inf at
    the clamped border pixel never leaks in as inf * 0)."""
    mode = node.attrs.get("mode", b"bilinear")
    if mode == b"linear":
        mode = b"bilinear"  # opset-20 rename
    if mode == b"cubic":
        mode = b"bicubic"  # opset-20 rename
    pad = node.attrs.get("padding_mode", b"zeros")
    align = bool(node.attrs.get("align_corners", 0))
    if mode not in (b"bilinear", b"nearest", b"bicubic"):
        raise ValueError(
            f"GridSample mode {mode!r} unsupported ({node.name})")
    if pad not in (b"zeros", b"border", b"reflection"):
        raise ValueError(
            f"GridSample padding_mode {pad!r} unsupported "
            f"({node.name})")
    if len(x.shape) == 5:
        if mode == b"bicubic":
            raise ValueError(
                f"GridSample cubic is 4-D only per spec ({node.name})")
        return _grid_sample_3d(node, x, grid, mode, pad, align)
    if len(x.shape) != 4:
        raise ValueError(
            f"GridSample expects 4-D [B,C,H,W] or 5-D [B,C,D,H,W] "
            f"input, got rank {len(x.shape)} ({node.name})")
    x, grid = _t(x), _t(grid)
    h, w = int(x.shape[2]), int(x.shape[3])
    # bilinear/nearest reflect the CENTER coordinate (torch's
    # compute_source_index); bicubic leaves the center untouched and
    # folds each tap instead (torch's get_value_bounded)
    fold = pad == b"reflection" and mode != b"bicubic"
    gx = _grid_unnormalize(grid[..., 0], w, align, fold)  # [B, Ho, Wo]
    gy = _grid_unnormalize(grid[..., 1], h, align, fold)
    bsel = torch.arange(x.shape[0], device=x.device)[:, None, None]

    def sample(iy, ix):
        """x at integer (iy, ix) with the padding mode; [B,C,Ho,Wo]."""
        inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        v = x[bsel, :, torch.clamp(iy, 0, h - 1),
              torch.clamp(ix, 0, w - 1)].permute(0, 3, 1, 2)
        if pad == b"zeros":
            # select, don't multiply: 0 * inf/nan at a clamped border
            # pixel must still yield exact 0
            v = torch.where(inside[:, None], v, 0.0)
        return v

    if mode == b"nearest":
        return sample(torch.round(gy).to(torch.int64),
                      torch.round(gx).to(torch.int64))
    y0, x0 = torch.floor(gy), torch.floor(gx)
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    if mode == b"bicubic":
        # 4x4 Keys cubic (a = -0.75), padding applied PER TAP: taps reach 2
        # past the floor cell, so border/reflection fold each integer tap
        # coordinate
        a = -0.75

        def cubic_weights(t):
            # tap offsets -1..2 -> distances 1+t, t, 1-t, 2-t
            d0, d1, d2, d3 = 1.0 + t, t, 1.0 - t, 2.0 - t
            return (a * d0 ** 3 - 5 * a * d0 ** 2 + 8 * a * d0 - 4 * a,
                    (a + 2) * d1 ** 3 - (a + 3) * d1 ** 2 + 1,
                    (a + 2) * d2 ** 3 - (a + 3) * d2 ** 2 + 1,
                    a * d3 ** 3 - 5 * a * d3 ** 2 + 8 * a * d3 - 4 * a)

        wys = cubic_weights((gy - y0)[:, None])
        wxs = cubic_weights((gx - x0)[:, None])

        def tap(iy, ix):
            if pad == b"reflection":
                iy = torch.round(_grid_reflect(iy.to(gy.dtype), h, align)
                                 ).to(torch.int64)
                ix = torch.round(_grid_reflect(ix.to(gx.dtype), w, align)
                                 ).to(torch.int64)
            return sample(iy, ix)

        out = 0.0
        for jy in range(4):
            row = 0.0
            for jx in range(4):
                row = row + wxs[jx] * tap(y0i + jy - 1, x0i + jx - 1)
            out = out + wys[jy] * row
        return out
    wy = (gy - y0)[:, None]
    wx = (gx - x0)[:, None]
    return ((1 - wy) * (1 - wx) * sample(y0i, x0i)
            + (1 - wy) * wx * sample(y0i, x0i + 1)
            + wy * (1 - wx) * sample(y0i + 1, x0i)
            + wy * wx * sample(y0i + 1, x0i + 1))


def _grid_sample_3d(node: OnnxNode, x, grid, mode, pad, align):
    """Volumetric GridSample (opset 16+/20): x[B,C,D,H,W] sampled at
    grid[B,Do,Ho,Wo,3] xyz locations, trilinear/nearest with the padding
    semantics of the 4-D path."""
    x, grid = _t(x), _t(grid)
    d, h, w = int(x.shape[2]), int(x.shape[3]), int(x.shape[4])
    fold = pad == b"reflection"
    gx = _grid_unnormalize(grid[..., 0], w, align, fold)  # [B, Do, Ho, Wo]
    gy = _grid_unnormalize(grid[..., 1], h, align, fold)
    gz = _grid_unnormalize(grid[..., 2], d, align, fold)
    bsel = torch.arange(x.shape[0], device=x.device)[:, None, None, None]

    def sample(iz, iy, ix):
        inside = ((iz >= 0) & (iz < d) & (iy >= 0) & (iy < h)
                  & (ix >= 0) & (ix < w))
        v = x[bsel, :, torch.clamp(iz, 0, d - 1), torch.clamp(iy, 0, h - 1),
              torch.clamp(ix, 0, w - 1)].permute(0, 4, 1, 2, 3)
        if pad == b"zeros":
            v = torch.where(inside[:, None], v, 0.0)
        return v

    if mode == b"nearest":
        return sample(*(torch.round(g).to(torch.int64)
                        for g in (gz, gy, gx)))
    z0, y0, x0 = torch.floor(gz), torch.floor(gy), torch.floor(gx)
    wz, wy, wx = ((g - f)[:, None] for g, f in ((gz, z0), (gy, y0),
                                                 (gx, x0)))
    z0i, y0i, x0i = (v.to(torch.int64) for v in (z0, y0, x0))
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                wgt = ((wz if dz else 1 - wz)
                       * (wy if dy else 1 - wy)
                       * (wx if dx else 1 - wx))
                out = out + wgt * sample(z0i + dz, y0i + dy, x0i + dx)
    return out


def _rnn_directions(node: OnnxNode):
    d = node.attrs.get("direction", b"forward")
    if d == b"forward":
        return [False]
    if d == b"reverse":
        return [True]
    if d == b"bidirectional":
        return [False, True]
    raise ValueError(f"direction {d!r} unsupported ({node.name})")


def _rnn_seq_prep(x, seq_lens, reverse: bool):
    """Per-batch variable-length handling for the RNN family: returns
    (xs, mask[S,B], gidx) where ``xs`` is the per-batch-reversed input
    for reverse directions (ONNX reverses only the valid prefix of each
    sequence, not the padded tail), ``mask[t, b]`` = step t is within
    batch b's length (None without lengths: every step is), and
    ``gidx`` scatters reverse outputs back."""
    s = x.shape[0]
    if seq_lens is None:
        return (torch.flip(x, (0,)) if reverse else x), None, None
    lens = _t(seq_lens).to(torch.int64)
    t_idx = torch.arange(s, device=x.device)[:, None]
    mask = t_idx < lens[None, :]
    if not reverse:
        return x, mask, None
    gidx = torch.clamp(lens[None, :] - 1 - t_idx, 0, s - 1)
    return torch.gather(x, 0, gidx[:, :, None].expand(-1, -1, x.shape[2])), \
        mask, gidx


def _rnn_seq_finish(y, reverse: bool, seq_lens, mask, gidx):
    """Undo the per-batch reversal on the stacked outputs."""
    if seq_lens is None:
        return torch.flip(y, (0,)) if reverse else y
    if reverse:
        y = torch.gather(y, 0, gidx[:, :, None].expand(-1, -1, y.shape[2]))
        y = torch.where(mask[:, :, None], y, 0.0)
    return y


def _rnn_step_out(mask, t, new, old):
    """Past a batch row's length the state freezes and Y is 0."""
    if mask is None:
        return new, new
    m = mask[t][:, None]
    return torch.where(m, new, old), torch.where(m, new, 0.0)


def _rnn_common_checks(node: OnnxNode,
                       default_acts: tuple[bytes, ...]):
    acts = node.attrs.get("activations")
    if acts:
        # exporters often spell out the defaults; only NON-default
        # activations are unsupported
        want = list(default_acts) * (len(acts) // len(default_acts) or 1)
        if [a.capitalize() for a in acts] != want:
            raise ValueError(
                f"{node.op_type} custom activations {acts} "
                f"unsupported ({node.name})")
    if node.attrs.get("layout", 0):
        raise ValueError(
            f"{node.op_type} layout=1 unsupported ({node.name})")


def _rnn_outputs(node: OnnxNode, ys, *states):
    outs = (torch.stack(ys, dim=1),) + tuple(torch.stack(s)
                                              for s in states)
    return outs[:len(node.outputs)] if len(node.outputs) > 1 else outs[0]


def _lstm(node: OnnxNode, x, w, r, b=None, seq_lens=None, h0=None,
          c0=None, p=None):
    """ONNX LSTM (gate order iofc), default activations, no peepholes:
    a plain time loop per direction (``clip`` on the gates' input and the
    ``sequence_lens`` freezing are the spec's, not torch.nn.LSTM's)."""
    _rnn_common_checks(node, (b"Sigmoid", b"Tanh", b"Tanh"))
    if p is not None:
        raise ValueError(f"LSTM peepholes unsupported ({node.name})")
    clip = float(node.attrs.get("clip", 0.0))
    if node.attrs.get("input_forget", 0):
        raise ValueError(
            f"LSTM input_forget (CIFG) unsupported ({node.name})")
    hs = int(node.attrs["hidden_size"])
    x, w, r = _t(x), _t(w), _t(r)
    bsz = x.shape[1]
    ys, hs_out, cs_out = [], [], []
    for d, reverse in enumerate(_rnn_directions(node)):
        wd, rd = w[d], r[d]
        bias = (_t(b)[d, :4 * hs] + _t(b)[d, 4 * hs:] if b is not None
                else torch.zeros(4 * hs, dtype=x.dtype, device=x.device))
        h = (_t(h0)[d] if h0 is not None
             else torch.zeros((bsz, hs), dtype=x.dtype, device=x.device))
        c = (_t(c0)[d] if c0 is not None
             else torch.zeros((bsz, hs), dtype=x.dtype, device=x.device))
        xs, mask, gidx = _rnn_seq_prep(x, seq_lens, reverse)
        gx = torch.einsum("sbi,gi->sbg", xs, wd) + bias
        steps = []
        for t in range(gx.shape[0]):
            g = gx[t] + h @ rd.T
            if clip:  # spec: applied to the activations' input
                g = torch.clamp(g, -clip, clip)
            i = torch.sigmoid(g[:, 0 * hs:1 * hs])
            o = torch.sigmoid(g[:, 1 * hs:2 * hs])
            f = torch.sigmoid(g[:, 2 * hs:3 * hs])
            ct = torch.tanh(g[:, 3 * hs:4 * hs])
            cn = f * c + i * ct
            h, y = _rnn_step_out(mask, t, o * torch.tanh(cn), h)
            c, _ = _rnn_step_out(mask, t, cn, c)
            steps.append(y)
        ys.append(_rnn_seq_finish(torch.stack(steps), reverse, seq_lens,
                                  mask, gidx))
        hs_out.append(h)
        cs_out.append(c)
    return _rnn_outputs(node, ys, hs_out, cs_out)


def _rnn(node: OnnxNode, x, w, r, b=None, seq_lens=None, h0=None):
    """ONNX vanilla RNN (tanh recurrence; custom activations raise)."""
    _rnn_common_checks(node, (b"Tanh",))
    clip = float(node.attrs.get("clip", 0.0))
    hs = int(node.attrs["hidden_size"])
    x, w, r = _t(x), _t(w), _t(r)
    bsz = x.shape[1]
    ys, hs_out = [], []
    for d, reverse in enumerate(_rnn_directions(node)):
        wd, rd = w[d], r[d]
        bias = (_t(b)[d, :hs] + _t(b)[d, hs:] if b is not None
                else torch.zeros(hs, dtype=x.dtype, device=x.device))
        h = (_t(h0)[d] if h0 is not None
             else torch.zeros((bsz, hs), dtype=x.dtype, device=x.device))
        xs, mask, gidx = _rnn_seq_prep(x, seq_lens, reverse)
        gx = torch.einsum("sbi,gi->sbg", xs, wd) + bias
        steps = []
        for t in range(gx.shape[0]):
            pre = gx[t] + h @ rd.T
            if clip:
                pre = torch.clamp(pre, -clip, clip)
            h, y = _rnn_step_out(mask, t, torch.tanh(pre), h)
            steps.append(y)
        ys.append(_rnn_seq_finish(torch.stack(steps), reverse, seq_lens,
                                  mask, gidx))
        hs_out.append(h)
    return _rnn_outputs(node, ys, hs_out)


def _gru(node: OnnxNode, x, w, r, b=None, seq_lens=None, h0=None):
    """ONNX GRU (gate order zrh, ``linear_before_reset``), default
    activations."""
    _rnn_common_checks(node, (b"Sigmoid", b"Tanh"))
    clip = float(node.attrs.get("clip", 0.0))
    lbr = int(node.attrs.get("linear_before_reset", 0))
    hs = int(node.attrs["hidden_size"])
    x, w, r = _t(x), _t(w), _t(r)
    bsz = x.shape[1]

    def cl(v):
        return torch.clamp(v, -clip, clip) if clip else v

    ys, hs_out = [], []
    for d, reverse in enumerate(_rnn_directions(node)):
        wd, rd = w[d], r[d]
        zeros = torch.zeros(3 * hs, dtype=x.dtype, device=x.device)
        wb = _t(b)[d, :3 * hs] if b is not None else zeros
        rb = _t(b)[d, 3 * hs:] if b is not None else zeros
        h = (_t(h0)[d] if h0 is not None
             else torch.zeros((bsz, hs), dtype=x.dtype, device=x.device))
        xs, mask, gidx = _rnn_seq_prep(x, seq_lens, reverse)
        gx = torch.einsum("sbi,gi->sbg", xs, wd) + wb
        steps = []
        for t in range(gx.shape[0]):
            g = gx[t]
            gh = h @ rd.T + rb
            z = torch.sigmoid(cl(g[:, :hs] + gh[:, :hs]))
            rt = torch.sigmoid(cl(g[:, hs:2 * hs] + gh[:, hs:2 * hs]))
            if lbr:
                ht = torch.tanh(cl(g[:, 2 * hs:] + rt * gh[:, 2 * hs:]))
            else:
                ht = torch.tanh(cl(g[:, 2 * hs:] + (rt * h) @ rd[2 * hs:].T
                                   + rb[2 * hs:]))
            h, y = _rnn_step_out(mask, t, (1 - z) * ht + z * h, h)
            steps.append(y)
        ys.append(_rnn_seq_finish(torch.stack(steps), reverse, seq_lens,
                                  mask, gidx))
        hs_out.append(h)
    return _rnn_outputs(node, ys, hs_out)


def _seq_pos(node: OnnxNode, pos) -> int:
    if not _is_concrete(pos):
        raise ValueError(
            f"sequence op with traced position ({node.name})")
    return int(np.asarray(pos).reshape(()))


def _seq_insert(node: OnnxNode, seq, x, pos=None):
    out = list(seq)
    if pos is None:
        out.append(x)
    else:
        out.insert(_seq_pos(node, pos), x)
    return out


def _seq_erase(node: OnnxNode, seq, pos=None):
    out = list(seq)
    del out[-1 if pos is None else _seq_pos(node, pos)]
    return out


def _concat_from_sequence(node: OnnxNode, seq):
    axis = node.attrs.get("axis", 0)
    stack = node.attrs.get("new_axis", 0)
    if _is_concrete(*seq):
        return (np.stack if stack else np.concatenate)(seq, axis=axis)
    return (torch.stack if stack else torch.cat)([_t(v) for v in seq],
                                                 dim=axis)


def _norm_indices(idx, x, node: OnnxNode):
    """ONNX allows negative gather/scatter indices; normalize."""
    dim = x.shape[node.attrs.get("axis", 0)]
    if _is_concrete(x, idx):
        idx = np.asarray(idx)
        return np.where(idx < 0, idx + dim, idx)
    idx = _t(idx).to(torch.int64)
    return torch.where(idx < 0, idx + dim, idx)


def _gather_elements(node: OnnxNode, x, idx):
    axis = node.attrs.get("axis", 0)
    idx = _norm_indices(idx, x, node)
    if _is_concrete(x, idx):
        return np.take_along_axis(np.asarray(x), idx, axis=axis)
    return torch.gather(_t(x), axis, idx)


def _gather_nd(node: OnnxNode, x, idx):
    b = int(node.attrs.get("batch_dims", 0))

    def core(xb, ib):
        return xb[tuple(ib[..., k] for k in range(ib.shape[-1]))]

    if b == 0 and _is_concrete(x, idx):
        return core(np.asarray(x), np.asarray(idx))
    fn = core
    for _ in range(b):
        fn = torch.func.vmap(fn)
    return fn(_t(x), _t(idx).to(torch.int64))


# ONNX scatter `reduction` attr -> (np.ufunc for the concrete path, the
# torch scatter_reduce name for the tensor path)
_SCATTER_REDUCTIONS = {
    b"add": (np.add, "sum"),
    b"mul": (np.multiply, "prod"),
    b"min": (np.minimum, "amin"),
    b"max": (np.maximum, "amax"),
}


def _scatter_reduction(node: OnnxNode):
    red = node.attrs.get("reduction", b"none")
    if red == b"none":
        return None
    if red not in _SCATTER_REDUCTIONS:
        raise ValueError(
            f"{node.op_type} reduction {red!r} unsupported "
            f"({node.name})")
    return _SCATTER_REDUCTIONS[red]


def _scatter_elements(node: OnnxNode, x, idx, upd):
    red = _scatter_reduction(node)
    axis = node.attrs.get("axis", 0)
    idx = _norm_indices(idx, x, node)
    if _is_concrete(x, idx, upd):
        out = np.asarray(x).copy()
        if red is None:
            np.put_along_axis(out, np.asarray(idx), np.asarray(upd),
                              axis=axis)
            return out
        # unbuffered accumulate: duplicate indices each apply
        grids = list(np.meshgrid(*(np.arange(s) for s in idx.shape),
                                 indexing="ij"))
        grids[axis] = np.asarray(idx)
        red[0].at(out, tuple(grids), np.asarray(upd))
        return out
    x = _t(x)
    idx, upd = _t(idx), _t(upd).to(x.dtype)
    if red is None:
        return x.scatter(axis, idx, upd)
    return x.scatter_reduce(axis, idx, upd, red[1], include_self=True)


def _scatter_nd(node: OnnxNode, x, idx, upd):
    red = _scatter_reduction(node)
    r = idx.shape[-1]
    if _is_concrete(x, idx, upd):
        out = np.asarray(x).copy()
        parts = tuple(np.asarray(idx)[..., k] for k in range(r))
        if red is None:
            out[parts] = upd
        else:
            red[0].at(out, parts, np.asarray(upd))
        return out
    # one flat row index over the first r axes, then a row scatter
    x = _t(x)
    idx, upd = _t(idx).to(torch.int64), _t(upd).to(x.dtype)
    lead, rest = tuple(x.shape[:r]), tuple(x.shape[r:])
    flat_idx = 0
    for k in range(r):
        ik = idx[..., k]
        flat_idx = flat_idx * lead[k] + torch.where(ik < 0, ik + lead[k], ik)
    rows = x.reshape((-1,) + rest)
    flat_idx = flat_idx.reshape(-1)
    upd = upd.reshape((-1,) + rest)
    if red is None:
        out = rows.index_put((flat_idx,), upd)
    else:
        out = rows.scatter_reduce(
            0, flat_idx.reshape((-1,) + (1,) * len(rest)).expand(upd.shape),
            upd, red[1], include_self=True)
    return out.reshape(x.shape)


def _cumsum(node: OnnxNode, x, axis):
    if not _is_concrete(axis):
        raise ValueError(f"CumSum with traced axis ({node.name})")
    axis = int(np.asarray(axis).reshape(()))
    exclusive = node.attrs.get("exclusive", 0)
    reverse = node.attrs.get("reverse", 0)
    if _is_concrete(x):
        if reverse:
            x = np.flip(x, axis)
        out = np.cumsum(x, axis=axis)
        if exclusive:
            out = np.roll(out, 1, axis)
            sl = [slice(None)] * out.ndim
            sl[axis] = 0
            out[tuple(sl)] = 0
        return np.flip(out, axis) if reverse else out
    x = _t(x)
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if exclusive:
        first = torch.arange(out.shape[axis], device=out.device) == 0
        shape = [1] * out.ndim
        shape[axis] = -1
        out = torch.where(first.reshape(shape), 0,
                          torch.roll(out, 1, axis))
    return torch.flip(out, (axis,)) if reverse else out


def _reduce_l1(node: OnnxNode, x, axes=None):
    return _reduce(node, np.abs(x) if _is_concrete(x) else torch.abs(_t(x)),
                   axes, kind="sum")


def _reduce_l2(node: OnnxNode, x, axes=None):
    x = x if _is_concrete(x) else _t(x)
    s = _reduce(node, x * x, axes, kind="sum")
    return np.sqrt(s) if _is_concrete(s) else torch.sqrt(s)


def _logsumexp(node: OnnxNode, x, axes=None):
    """Max-shifted (overflow-stable) logsumexp: compute in shifted space,
    add the shift back."""
    if axes is None:
        axes_attr = node.attrs.get("axes")
    else:
        axes_attr = np.asarray(axes).reshape(-1).tolist()
    keep = bool(node.attrs.get("keepdims", 1))
    ax = (None if axes_attr in (None, [])
          else tuple(int(a) for a in axes_attr))
    if _is_concrete(x):
        m = np.max(x, axis=ax, keepdims=True)
        m = np.where(np.isfinite(m), m, 0.0)  # all -inf slices stay finite
        out = np.log(np.sum(np.exp(x - m), axis=ax, keepdims=True)) + m
        if not keep:
            out = out.squeeze(ax) if ax is not None else out.reshape(())
        return out
    x = _t(x)
    dims = tuple(range(x.ndim)) if ax is None else ax
    m = torch.amax(x, dim=dims, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    out = torch.log(torch.sum(torch.exp(x - m), dim=dims, keepdim=True)) + m
    return out if keep else out.squeeze(dims)


def _lp_normalization(node: OnnxNode, x):
    axis = node.attrs.get("axis", -1)
    p = node.attrs.get("p", 2)
    if _is_concrete(x):
        norm = (np.sum(np.abs(x), axis=axis, keepdims=True) if p == 1
                else np.sqrt(np.sum(x * x, axis=axis, keepdims=True)))
        return x / norm
    x = _t(x)
    norm = (torch.sum(torch.abs(x), dim=axis, keepdim=True) if p == 1
            else torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True)))
    return x / norm


def _mod(node: OnnxNode, a, b):
    """ONNX Mod: ``fmod=1`` is C's fmod (the sign of the dividend), else
    the floor modulus (the sign of the divisor, torch.remainder's
    semantics), formed from fmod as jnp.mod forms it, so that float
    results are exact."""
    if _is_concrete(a, b):
        return np.fmod(a, b) if node.attrs.get("fmod", 0) else np.mod(a, b)
    a, b = _t(a), _t(b)
    r = torch.fmod(a, b)
    if node.attrs.get("fmod", 0):
        return r
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _celu(node: OnnxNode, x):
    alpha = node.attrs.get("alpha", 1.0)
    x = _t(x)
    return torch.clamp(x, min=0.0) + alpha * torch.expm1(
        torch.clamp(x, max=0.0) / alpha)


# -- quantized op family -------------------------------------------------
# int8/uint8 exports are what real edge detectors ship. Semantics follow
# the ONNX spec as the JAX package's ops do: round half to even everywhere
# (np.round and torch.round both are), saturating casts to the zero
# point's dtype, zero points widened to int32 before they are
# subtracted. The integer convolution and matmul accumulate in float64,
# exact below 2**53 whatever the summation order, so the card equals the
# CPU bit for bit: torch has no integer conv2d, and no integer matmul on
# the card. The JAX package accumulates in int32, which wraps past 2**31
# where float64 does not (ROADMAP C).

_NP_OF_TORCH = {torch.uint8: np.uint8, torch.int8: np.int8,
                torch.int16: np.int16, torch.int32: np.int32,
                torch.int64: np.int64}
_TORCH_OF_NP = {np.dtype(v): k for k, v in _NP_OF_TORCH.items()}


def _q_info(zp, default=np.uint8):
    """(numpy dtype, qmin, qmax) for a zero-point value (or default)."""
    if zp is None:
        dt = np.dtype(default)
    elif isinstance(zp, torch.Tensor):
        dt = np.dtype(_NP_OF_TORCH[zp.dtype])
    else:
        dt = np.asarray(zp).dtype
    info = np.iinfo(dt)
    return dt, info.min, info.max


def _q_per_axis(p, ndim: int, axis: int):
    """Broadcast a quantization parameter: scalars stay scalar, 1-D
    per-axis values reshape to broadcast along `axis`."""
    if not isinstance(p, torch.Tensor):
        p = np.asarray(p)
    size = p.numel() if isinstance(p, torch.Tensor) else p.size
    if p.ndim == 0 or size == 1:
        return p.reshape(())
    shape = [1] * ndim
    shape[axis % ndim] = -1
    return p.reshape(shape)


def _q_no_blocks(node: OnnxNode):
    if node.attrs.get("block_size", 0):
        raise ValueError(
            f"blocked quantization unsupported ({node.name})")


def _q_concrete(*vals) -> bool:
    """Concrete, an omitted (None) zero point included: the result is
    NumPy, so the build folds a constant weight's dequantization once."""
    return _is_concrete(*(v for v in vals if v is not None))


def _quantize_linear(node: OnnxNode, x, scale, zp=None):
    _q_no_blocks(node)
    axis = node.attrs.get("axis", 1)
    dt, lo, hi = _q_info(zp)
    ndim = len(x.shape)
    if _q_concrete(x, scale, zp):
        s = _q_per_axis(scale, ndim, axis)
        z = np.float32(0) if zp is None else np.asarray(
            _q_per_axis(zp, ndim, axis), np.float32)
        # divide by the scale (a reciprocal's product moves the ties)
        y = np.clip(np.round(np.asarray(x, s.dtype) / s) + z, lo, hi)
        return y.astype(dt)
    s = _q_per_axis(_t(scale), ndim, axis)
    y = torch.round(_t(x).to(s.dtype) / s)
    if zp is not None:
        y = y + _q_per_axis(_t(zp), ndim, axis).to(torch.float32)
    return torch.clamp(y, lo, hi).to(_TORCH_OF_NP[dt])


def _dequantize_linear(node: OnnxNode, x, scale, zp=None):
    _q_no_blocks(node)
    axis = node.attrs.get("axis", 1)
    ndim = len(x.shape)
    if _q_concrete(x, scale, zp):
        # widen BEFORE subtracting (int8 - int8 overflows at -255)
        xi = np.asarray(x, np.int32)
        if zp is not None:
            xi = xi - np.asarray(_q_per_axis(zp, ndim, axis), np.int32)
        s = _q_per_axis(scale, ndim, axis)
        return xi.astype(s.dtype) * s
    xi = _t(x).to(torch.int32)
    if zp is not None:
        xi = xi - _q_per_axis(_t(zp), ndim, axis).to(torch.int32)
    s = _q_per_axis(_t(scale), ndim, axis)
    return xi.to(s.dtype) * s


def _q_requant(acc_i32, multiplier, y_zp):
    """int32 accumulator -> quantized output: y = saturate(round(acc * m)
    + y_zp) with banker's rounding, the QLinear* output stage. The
    accumulator is cast to float32 before scaling, as in the JAX package
    (and onnxruntime's reference kernels), so accumulators beyond 2**24
    lose low bits and land at most one output quantum from integer-exact
    requantization (tests/test_onnx_exec_ops.py::
    test_q_requant_large_accumulator_envelope pins the envelope)."""
    dt, lo, hi = _q_info(y_zp)
    if _is_concrete(acc_i32):
        y = np.round(acc_i32.astype(np.float32)
                     * np.asarray(multiplier, np.float32))
        y = y + np.asarray(y_zp, np.float32).reshape(())
        return np.clip(y, lo, hi).astype(dt)
    y = torch.round(acc_i32.to(torch.float32)
                    * _t(multiplier).to(torch.float32))
    y = y + _t(y_zp).to(torch.float32).reshape(())
    return torch.clamp(y, lo, hi).to(_TORCH_OF_NP[dt])


def _int_operand(v, zp, zp_shape: tuple):
    """``v - zp`` as exact float64 integers: NumPy for concrete values,
    else a tensor."""
    if _q_concrete(v, zp):
        vi = np.asarray(v, np.int32)
        if zp is not None:
            z = np.asarray(zp, np.int32)
            vi = vi - (z.reshape(()) if z.size == 1 else z.reshape(zp_shape))
        return vi.astype(np.float64)
    vi = _t(v).to(torch.int32)
    if zp is not None:
        z = _t(zp).to(torch.int32)
        vi = vi - (z.reshape(()) if z.numel() == 1 else z.reshape(zp_shape))
    return vi.to(torch.float64)


def _int_result(acc):
    """A float64 accumulation of integers -> int32 (rounded first: the
    card's conv algorithms need not sum in integer steps)."""
    if isinstance(acc, np.ndarray):
        return np.round(acc).astype(np.int32)
    return torch.round(acc).to(torch.int32)


def _int_conv_core(node: OnnxNode, x, x_zp, w, w_zp):
    """(x - x_zp) conv (w - w_zp), accumulated exactly (float64). w_zp may
    be per-output-channel (1-D of size M): subtracting it from w directly
    is exact because each output channel convolves only its own
    filters. Concrete operands give NumPy."""
    xd = _int_operand(x, x_zp, ())
    wd = _int_operand(w, w_zp, (-1, 1, 1, 1))
    concrete = isinstance(xd, np.ndarray) and isinstance(wd, np.ndarray)
    if concrete:
        xd, wd = torch.from_numpy(xd), torch.from_numpy(wd)
    # the conv attributes (strides, dilations, group, pads) are Conv's
    acc = _int_result(_conv(node, _t(xd), _t(wd)))
    return acc.numpy() if concrete else acc


def _qlinear_conv(node: OnnxNode, x, x_s, x_zp, w, w_s, w_zp,
                  y_s, y_zp, b=None):
    acc = _int_conv_core(node, x, x_zp, w, w_zp)
    concrete = _is_concrete(acc)
    cast = ((lambda v, dt: np.asarray(v, dt)) if concrete
            else (lambda v, dt: _t(v).to(dt)))
    i32, f32 = ((np.int32, np.float32) if concrete
                else (torch.int32, torch.float32))
    if b is not None:  # int32 bias at scale x_s*w_s, zero point 0
        acc = acc + cast(b, i32).reshape(1, -1, 1, 1)
    m = (cast(x_s, f32).reshape(()) * cast(w_s, f32).reshape(-1)
         / cast(y_s, f32).reshape(()))
    size = m.size if concrete else m.numel()
    m = m.reshape(()) if size == 1 else m.reshape(1, -1, 1, 1)
    return _q_requant(acc, m, y_zp)


def _int_matmul_core(a, a_zp, b, b_zp):
    # a per-row a_zp (1-D of size K rows) broadcasts over a's rows; a
    # per-column b_zp over b's columns
    ad = _int_operand(a, a_zp, (-1, 1))
    bd = _int_operand(b, b_zp, (1, -1))
    if isinstance(ad, np.ndarray) and isinstance(bd, np.ndarray):
        return _int_result(ad @ bd)
    return _int_result(_t(ad) @ _t(bd))


def _matmul_integer(node: OnnxNode, a, b, a_zp=None, b_zp=None):
    return _int_matmul_core(a, a_zp, b, b_zp)


def _conv_integer(node: OnnxNode, x, w, x_zp=None, w_zp=None):
    return _int_conv_core(node, x, x_zp, w, w_zp)


def _qlinear_matmul(node: OnnxNode, a, a_s, a_zp, b, b_s, b_zp,
                    y_s, y_zp):
    for s in (a_s, b_s, y_s):
        size = s.numel() if isinstance(s, torch.Tensor) else np.size(s)
        if len(np.shape(s)) and size > 1:
            raise ValueError(
                f"QLinearMatMul per-axis scales unsupported "
                f"({node.name})")
    acc = _int_matmul_core(a, a_zp, b, b_zp)
    if _is_concrete(acc):
        m = (np.asarray(a_s, np.float32).reshape(())
             * np.asarray(b_s, np.float32).reshape(())
             / np.asarray(y_s, np.float32).reshape(()))
    else:
        m = (_t(a_s).reshape(()) * _t(b_s).reshape(())
             / _t(y_s).reshape(()))
    return _q_requant(acc, m, y_zp)


def _dynamic_quantize_linear(node: OnnxNode, x):
    """DynamicQuantizeLinear: uint8 range [0,255], scale from the
    zero-including min/max, zero point saturate(round(-xmin/scale))."""
    if _is_concrete(x):
        f32 = np.float32
        xf = np.asarray(x, f32)
        xmin = np.minimum(np.min(xf), f32(0.0))
        xmax = np.maximum(np.max(xf), f32(0.0))
        scale = ((xmax - xmin) / f32(255.0)).astype(f32)
        # all-zero input: scale 0 would divide by zero; the spec's y is
        # then uniformly the zero point, which any nonzero scale yields
        safe = np.where(scale > 0, scale, f32(1.0))
        zp = np.clip(np.round(-xmin / safe), 0, 255)
        y = np.clip(np.round(xf / safe) + zp, 0, 255)
        return y.astype(np.uint8), scale.reshape(()), \
            zp.astype(np.uint8).reshape(())
    xf = _t(x).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=xf.device)
    xmin = torch.minimum(torch.amin(xf), zero)
    xmax = torch.maximum(torch.amax(xf), zero)
    scale = (xmax - xmin) / 255.0
    safe = torch.where(scale > 0, scale, 1.0)
    zp = torch.clamp(torch.round(-xmin / safe), 0, 255)
    y = torch.clamp(torch.round(xf / safe) + zp, 0, 255)
    return y.to(torch.uint8), scale.reshape(()), \
        zp.to(torch.uint8).reshape(())


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

_OPS.update({
    "TopK": lambda n, x, k=None: _topk(n, x, k),
    "NonMaxSuppression": _nms_onnx,
    "InstanceNormalization": _instance_norm,
    "GroupNormalization": _group_norm,
    "LayerNormalization": _layer_norm,
    "Einsum": lambda n, *xs: torch.einsum(n.attrs["equation"].decode(),
                                          *(_t(x) for x in xs)),
    "Shrink": _shrink,
    "IsNaN": _eltwise(np.isnan, torch.isnan),
    "IsInf": _is_inf,
    "EyeLike": _eye_like,
    "Trilu": _trilu,
    "OneHot": _one_hot,
    "GridSample": _grid_sample,
    "RoiAlign": _roi_align,
    "LSTM": _lstm,
    "GRU": _gru,
    "RNN": _rnn,
    # sequences are plain Python lists in the interpreter's env
    # (torchscript list-append loops export these, typically as
    # Loop-carried values)
    "SequenceEmpty": lambda n: [],
    "SequenceConstruct": lambda n, *xs: list(xs),
    "SequenceInsert": _seq_insert,
    "SequenceErase": _seq_erase,
    "SequenceAt": lambda n, seq, pos: seq[_seq_pos(n, pos)],
    "SequenceLength": lambda n, seq: np.int64(len(seq)),
    "ConcatFromSequence": _concat_from_sequence,
    "GatherElements": _gather_elements,
    "GatherND": _gather_nd,
    "ScatterElements": _scatter_elements,
    "ScatterND": _scatter_nd,
    "LogSoftmax": lambda n, x: _softmax(n, x, log=True),
    "CumSum": _cumsum,
    "ReduceL1": _reduce_l1,
    "ReduceL2": _reduce_l2,
    "ReduceLogSumExp": _logsumexp,
    "LpNormalization": _lp_normalization,
    "Mod": _mod,
    "Sign": _eltwise(np.sign, torch.sign),
    "Round": _eltwise(np.round, torch.round),
    "Softsign": _eltwise(lambda x: x / (1 + np.abs(x)),
                         lambda x: x / (1 + torch.abs(x))),
    "Mish": lambda n, x: (lambda x: x * torch.tanh(torch.logaddexp(
        x, torch.zeros_like(x))))(_t(x)),
    "Gelu": lambda n, x: F.gelu(_t(x), approximate=(
        "tanh" if n.attrs.get("approximate", b"none") == b"tanh"
        else "none")),
    "Celu": _celu,
    "ThresholdedRelu": lambda n, x: (lambda x: torch.where(
        x > n.attrs.get("alpha", 1.0), x, 0.0))(_t(x)),
    "QuantizeLinear": _quantize_linear,
    "DequantizeLinear": _dequantize_linear,
    "QLinearConv": _qlinear_conv,
    "QLinearMatMul": _qlinear_matmul,
    "MatMulInteger": _matmul_integer,
    "ConvInteger": _conv_integer,
    "DynamicQuantizeLinear": _dynamic_quantize_linear,
})

# the control flow ops and their subgraph attributes
_SUBGRAPHS = {"If": ("then_branch", "else_branch"), "Loop": ("body",),
              "Scan": ("body",)}


class _Scope(torch.nn.Module):
    """The nodes of one graph with its constants and subgraphs: the top
    graph (`GraphExecutor`) or the body of an If/Loop/Scan node, built as
    a child module so that ``.to(device)`` and a replica's deep copy carry
    its constants as well. A body sees the names of the graphs around it
    (``outer_static``: their constants, for the fold) except the ones its
    own inputs ``shadow``."""

    def __init__(self, graph: OnnxGraph, outer_static: dict | None = None,
                 shadow: frozenset = frozenset(),
                 unfolded: frozenset = frozenset()):
        super().__init__()
        self.graph = graph
        seed = {k: v for k, v in (outer_static or {}).items()
                if k not in shadow}
        seed.update(graph.initializers)
        # names a call substitutes (`GraphExecutor`'s ``initializers``):
        # nothing is folded from them
        for name in unfolded:
            seed.pop(name, None)
        folded = self._fold(graph.nodes, seed)
        # what a run of this graph adds to its scope: its initializers
        # and the values the build folded
        self._static = {**graph.initializers, **folded}
        self._nodes = [n for n in graph.nodes
                       if not all(o in folded for o in n.outputs)]
        self._buffer_of: dict[str, str] = {}
        for i, (name, value) in enumerate(self._static.items()):
            if isinstance(value, (np.ndarray, np.generic)) \
                    and value.dtype != object:
                attr = f"const{i}"
                self.register_buffer(attr, _to_tensor(value, "cpu"),
                                     persistent=False)
                self._buffer_of[name] = attr
        # the subgraphs, keyed by their node's position and attribute
        self._bodies = torch.nn.ModuleDict()
        visible = {**seed, **folded}
        for i, node in enumerate(self._nodes):
            for key in _SUBGRAPHS.get(node.op_type, ()):
                sub = node.attrs[key]
                self._bodies[f"n{i}_{key}"] = _Scope(
                    sub, visible, frozenset(v.name for v in sub.inputs))

    @staticmethod
    def _fold(nodes, static: dict) -> dict:
        """The outputs of every node computed from ``static`` values alone
        that yields NumPy (control flow runs at call time)."""
        static, folded = dict(static), {}
        saved, _STATE.device = getattr(_STATE, "device", None), None
        for node in nodes:
            if node.op_type in _SUBGRAPHS or not all(
                    i == "" or i in static for i in node.inputs):
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
                folded.update(zip(node.outputs, results))
        _STATE.device = saved
        return folded

    def _exec_nodes(self, env: dict) -> None:
        for i, node in enumerate(self._nodes):
            if node.op_type == "If":
                results = self._run_if(node, f"n{i}_", env)
            elif node.op_type == "Loop":
                results = self._run_loop(node, f"n{i}_", env)
            elif node.op_type == "Scan":
                results = self._run_scan(node, f"n{i}_", env)
            else:
                # optional inputs are empty-named and may sit in the
                # MIDDLE of the list (torch: Resize(X, "", scales)): keep
                # their position as None, strip the trailing ones
                args = [env[name] if name != "" else None
                        for name in node.inputs]
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

    def _run_body(self, key: str, env: dict, bindings: dict) -> list:
        """Run a subgraph: ONNX scoping, the body sees the outer scope and
        its own values do not leak back out."""
        body = self._bodies[key]
        sub_env = dict(env)
        sub_env.update(body._static)
        sub_env.update(bindings)
        body._exec_nodes(sub_env)
        return [sub_env[o.name] for o in body.graph.outputs]

    def _run_if(self, node: OnnxNode, prefix: str, env: dict):
        """If: a condition the host can read (shape math, or a tensor
        outside vmap) runs one branch, with no same-shape-both-branches
        constraint. A condition batched under vmap runs both branches
        and selects per image, as lax.cond does under jax.vmap: their
        outputs must then match in shape and dtype."""
        cond = env[node.inputs[0]]
        if _readable(cond):
            key = "then_branch" if bool(np.asarray(_host(cond)).reshape(())) \
                else "else_branch"
            outs = self._run_body(prefix + key, env, {})
        else:
            pick = cond.reshape(()).to(torch.bool)
            then, other = ([_t(v) for v in self._run_body(prefix + key, env,
                                                          {})]
                           for key in ("then_branch", "else_branch"))
            outs = []
            for a, b in zip(then, other):
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise ValueError(
                        f"If with a data-dependent condition requires both "
                        f"branches to produce matching shapes/dtypes "
                        f"({node.name}): {tuple(a.shape)} {a.dtype} "
                        f"against {tuple(b.shape)} {b.dtype}")
                outs.append(torch.where(pick, a, b))
        return tuple(outs) if len(node.outputs) > 1 else outs[0]

    def _run_loop(self, node: OnnxNode, prefix: str, env: dict):
        """Loop with a trip count and condition the host can read, run
        iteration by iteration (torchscript-scripted modules export
        Python loops this way): carried values thread through, scan
        outputs stack along a new axis 0. A condition batched under vmap
        (at the start, or from the body) goes to `_run_loop_traced`; a
        batched trip count raises."""
        key = prefix + "body"
        body = self._bodies[key]
        args = [env[name] if name != "" else None for name in node.inputs]
        m = args[0] if len(args) > 0 else None
        cond = args[1] if len(args) > 1 else None
        carried = list(args[2:])
        n_carried = len(carried)
        n_scan = len(body.graph.outputs) - 1 - n_carried
        if m is None and cond is None:
            raise ValueError(f"Loop without trip count or condition "
                             f"({node.name})")
        if m is not None and not _readable(m):
            raise ValueError(
                f"Loop with traced (data-dependent) trip count "
                f"({node.name}) is unsupported")
        trip = None if m is None else int(np.asarray(_host(m)).reshape(()))
        if trip is not None and trip >= 2**31 - 1:
            # torchscript exports `while cond:` as trip=INT64_MAX: unbounded
            trip = None
        if cond is not None and not _readable(cond):
            return self._run_loop_traced(node, key, env, trip, cond,
                                         carried, n_scan)
        cond_val = True if cond is None else bool(
            np.asarray(_host(cond)).reshape(()))
        names = [i.name for i in body.graph.inputs]
        scans: list[list] = [[] for _ in range(n_scan)]
        i = 0
        while (trip is None or i < trip) and cond_val:
            if trip is None and i >= 100_000:
                raise ValueError(
                    f"Loop ran 100000 iterations ({node.name})")
            bindings = {names[0]: np.int64(i),
                        names[1]: np.asarray(cond_val)}
            bindings.update(zip(names[2:], carried))
            outs = self._run_body(key, env, bindings)
            if not _readable(outs[0]):
                # the body makes the exit condition batched: restart on
                # the masked loop (the iterations so far changed nothing
                # outside the body)
                return self._run_loop_traced(node, key, env, trip, cond,
                                             list(args[2:]), n_scan)
            cond_val = bool(np.asarray(_host(outs[0])).reshape(()))
            carried = outs[1:1 + n_carried]
            for k in range(n_scan):
                scans[k].append(outs[1 + n_carried + k])
            i += 1
        if n_scan and i == 0:
            raise ValueError(
                f"Loop with zero iterations and scan outputs "
                f"({node.name}): result shape is unknowable")
        results = carried + [np.stack(s) if _is_concrete(*s)
                             else torch.stack([_t(v) for v in s])
                             for s in scans]
        return tuple(results) if len(node.outputs) > 1 else results[0]

    def _run_loop_traced(self, node: OnnxNode, key: str, env: dict, trip,
                         cond, carried: list, n_scan: int):
        """Loop whose exit condition is batched under vmap: jax.vmap's
        while_loop, by hand. It runs while the condition holds for any
        image; an image whose condition failed keeps its carried values
        (a select), so each ends where its own loop would. Carried values
        only (scan outputs would have a data-dependent shape), with
        iteration-invariant shapes and dtypes."""
        if n_scan:
            raise ValueError(
                f"Loop with a data-dependent condition AND scan "
                f"outputs ({node.name}): scan output shape would be "
                f"data-dependent")
        names = [i.name for i in self._bodies[key].graph.inputs]
        carried = [_t(v) for v in carried]
        dev = _device()
        i = torch.zeros((), dtype=torch.int64, device=dev)
        c = (torch.ones((), dtype=torch.bool, device=dev) if cond is None
             else _t(cond).reshape(()).to(torch.bool))
        steps = 0
        while True:
            go = c if trip is None else c & (i < trip)
            if not _any(go):
                break
            if steps >= 100_000:
                raise ValueError(
                    f"Loop ran 100000 iterations ({node.name})")
            bindings = {names[0]: i, names[1]: c}
            bindings.update(zip(names[2:], carried))
            outs = [_t(v) for v in self._run_body(key, env, bindings)]
            for new, old in zip(outs[1:], carried):
                if new.shape != old.shape or new.dtype != old.dtype:
                    raise ValueError(
                        f"Loop with a data-dependent condition requires "
                        f"iteration-invariant carried shapes/dtypes "
                        f"({node.name}): {tuple(old.shape)} {old.dtype} "
                        f"became {tuple(new.shape)} {new.dtype}")
            carried = [torch.where(go, new, old)
                       for new, old in zip(outs[1:], carried)]
            c = torch.where(go, outs[0].reshape(()).to(torch.bool), c)
            i = torch.where(go, i + 1, i)
            steps += 1
        return tuple(carried) if len(node.outputs) > 1 else carried[0]

    def _run_scan(self, node: OnnxNode, prefix: str, env: dict):
        """Scan: the body over slices of the scan inputs (the trip count
        is a SHAPE, so it runs under vmap too). States thread through;
        scan outputs stack along their output axis; concrete inputs give
        NumPy results."""
        key = prefix + "body"
        body = self._bodies[key]
        n_scan_in = int(node.attrs["num_scan_inputs"])
        args = [env[name] for name in node.inputs]
        n_states = len(args) - n_scan_in
        states = list(args[:n_states])
        in_axes = node.attrs.get("scan_input_axes", [0] * n_scan_in)
        in_dirs = node.attrs.get("scan_input_directions", [0] * n_scan_in)
        n_scan_out = len(body.graph.outputs) - n_states
        out_axes = node.attrs.get("scan_output_axes", [0] * n_scan_out)
        out_dirs = node.attrs.get("scan_output_directions",
                                  [0] * n_scan_out)
        xs = []
        for x, a, d in zip(args[n_states:], in_axes, in_dirs):
            if _is_concrete(x):
                x = np.moveaxis(np.asarray(x), int(a), 0)
                xs.append(x[::-1] if d else x)
            else:
                x = torch.movedim(_t(x), int(a), 0)
                xs.append(torch.flip(x, (0,)) if d else x)
        trip = xs[0].shape[0]
        if trip == 0 and n_scan_out:
            raise ValueError(
                f"Scan over a zero-length sequence with scan outputs "
                f"({node.name}): result shape is unknowable")
        names = [i.name for i in body.graph.inputs]
        scans: list[list] = [[] for _ in range(n_scan_out)]
        for t in range(trip):
            bindings = dict(zip(names[:n_states], states))
            bindings.update((nm, x[t]) for nm, x in zip(names[n_states:], xs))
            outs = self._run_body(key, env, bindings)
            states = outs[:n_states]
            for k in range(n_scan_out):
                scans[k].append(outs[n_states + k])
        stacked = []
        for k in range(n_scan_out):
            s = scans[k][::-1] if out_dirs[k] else scans[k]
            if _is_concrete(*s):
                stacked.append(np.moveaxis(np.stack(s, 0), 0,
                                           int(out_axes[k])))
            else:
                stacked.append(torch.movedim(torch.stack(
                    [_t(v) for v in s]), 0, int(out_axes[k])))
        results = tuple(states) + tuple(stacked)
        return results if len(node.outputs) > 1 else results[0]


def _annotate_opset(nodes, opset: int) -> None:
    """Ops whose SEMANTICS changed across opsets need the model's opset at
    run time; record it on the node (subgraphs inherit)."""
    for node in nodes:
        if node.op_type in ("Softmax", "LogSoftmax", "Resize"):
            node.attrs.setdefault("_opset", opset)
        for v in node.attrs.values():
            if isinstance(v, OnnxGraph):
                _annotate_opset(v.nodes, opset)


def _validate(nodes, known: set) -> None:
    """Every op known and every input producible, recursively through
    If/Loop/Scan subgraphs, with the JAX executor's messages."""
    for node in nodes:
        if node.op_type not in _SUBGRAPHS and node.op_type not in _OPS:
            raise ValueError(
                f"unsupported ONNX op {node.op_type!r} "
                f"(node {node.name!r}) — extend models/onnx_exec.py")
        missing = [i for i in node.inputs if i not in known]
        if missing:
            raise ValueError(
                f"node {node.name!r} consumes unknown values "
                f"{missing} (graph not topologically ordered?)")
        if node.op_type == "If":
            for key in ("then_branch", "else_branch"):
                sub = node.attrs.get(key)
                if not isinstance(sub, OnnxGraph):
                    raise ValueError(
                        f"If node {node.name!r} missing {key}")
                # ONNX subgraphs see the outer lexical scope
                sub_known = (set(known) | set(sub.initializers)
                             | {i.name for i in sub.inputs})
                _validate(sub.nodes, sub_known)
                if len(sub.outputs) != len(node.outputs):
                    raise ValueError(
                        f"If node {node.name!r}: {key} yields "
                        f"{len(sub.outputs)} outputs, node declares "
                        f"{len(node.outputs)}")
                absent = [o.name for o in sub.outputs
                          if o.name not in sub_known]
                if absent:
                    raise ValueError(
                        f"If node {node.name!r}: {key} outputs "
                        f"never produced: {absent}")
        if node.op_type == "Scan":
            body = node.attrs.get("body")
            if not isinstance(body, OnnxGraph):
                raise ValueError(
                    f"Scan node {node.name!r} missing body")
            n_scan_in = int(node.attrs.get("num_scan_inputs", 0))
            n_states = len(node.inputs) - n_scan_in
            if n_scan_in < 1 or n_states < 0:
                raise ValueError(
                    f"Scan node {node.name!r}: bad num_scan_inputs")
            if len(body.inputs) != n_states + n_scan_in:
                raise ValueError(
                    f"Scan node {node.name!r}: body declares "
                    f"{len(body.inputs)} inputs, expected "
                    f"{n_states + n_scan_in}")
            n_scan_out = len(body.outputs) - n_states
            if n_scan_out < 0 \
                    or len(node.outputs) != n_states + n_scan_out:
                raise ValueError(
                    f"Scan node {node.name!r}: output arity "
                    f"mismatch")
            body_known = (set(known) | set(body.initializers)
                          | {i.name for i in body.inputs})
            _validate(body.nodes, body_known)
            absent = [o.name for o in body.outputs
                      if o.name not in body_known]
            if absent:
                raise ValueError(
                    f"Scan node {node.name!r}: body outputs "
                    f"never produced: {absent}")
        if node.op_type == "Loop":
            body = node.attrs.get("body")
            if not isinstance(body, OnnxGraph):
                raise ValueError(
                    f"Loop node {node.name!r} missing body")
            n_carried = max(len(node.inputs) - 2, 0)
            if len(body.inputs) != 2 + n_carried:
                raise ValueError(
                    f"Loop node {node.name!r}: body declares "
                    f"{len(body.inputs)} inputs, expected "
                    f"{2 + n_carried}")
            n_scan = len(body.outputs) - 1 - n_carried
            if n_scan < 0 or len(node.outputs) != n_carried + n_scan:
                raise ValueError(
                    f"Loop node {node.name!r}: output arity "
                    f"mismatch (body {len(body.outputs)}, node "
                    f"{len(node.outputs)}, carried {n_carried})")
            body_known = (set(known) | set(body.initializers)
                          | {i.name for i in body.inputs})
            _validate(body.nodes, body_known)
            absent = [o.name for o in body.outputs
                      if o.name not in body_known]
            if absent:
                raise ValueError(
                    f"Loop node {node.name!r}: body outputs "
                    f"never produced: {absent}")
        known.update(node.outputs)


class GraphExecutor(_Scope):
    """Callable ONNX graph: ``executor(*inputs) -> tuple(outputs)``.

    Build-time validation: every node's op must be in the op set and every
    node input producible, through every subgraph, so an unknown topology
    fails here, as tract's load-time check does. The build then evaluates,
    once, every node whose inputs are all constants and whose result is
    NumPy, and registers the graph's constants as buffers (the module
    docstring), each body's in a child module. ``nodes_run`` is the
    number of top-graph nodes a call executes; ``host_copies`` the NumPy
    values the last call turned into tensors (0 on a graph whose data
    never meets a value computed on the host)."""

    def __init__(self, graph: OnnxGraph, *,
                 unfolded: frozenset = frozenset()):
        known = ({i.name for i in graph.inputs} | set(graph.initializers)
                 | {""})
        _annotate_opset(graph.nodes, graph.opset)
        _validate(graph.nodes, known)
        absent = [o.name for o in graph.outputs if o.name not in known]
        if absent:
            raise ValueError(f"graph outputs never produced: {absent}")
        super().__init__(graph, unfolded=unfolded)
        self.input_names = [i.name for i in graph.inputs]
        self.output_names = [o.name for o in graph.outputs]
        self.nodes_run = len(self._nodes)
        self.host_copies = 0
        self._by_id = None
        # (substituted names, device) -> an executor of the same graph
        # that folds nothing from those names
        self._substituting: dict[tuple, GraphExecutor] = {}

    def _constant_buffers(self) -> dict:
        """id of each constant's NumPy value -> (module, buffer name), over
        the graph and its bodies: where such a value meets a tensor, `_t`
        takes its buffer, so a call copies no constant from the host,
        though one that flows out of a body (an If branch's output, a
        value a Loop carries) stays NumPy for shape math. Built at the
        first call of each copy (a deep copy holds other NumPy objects)."""
        if self._by_id is None or self._by_id[0] != id(self._static):
            self._by_id = (id(self._static), {
                id(scope._static[name]): (scope, attr)
                for scope in self.modules() if isinstance(scope, _Scope)
                for name, attr in scope._buffer_of.items()})
        return self._by_id[1]

    def forward(self, *inputs, initializers: dict | None = None):
        """Run the graph on ``inputs`` (tensors, or arrays that become
        tensors on the executor's device); returns the graph's outputs as a
        tuple. NumPy values meet tensors on the inputs' device.

        ``initializers`` (name -> value) substitutes graph initializers for
        the call, as the JAX executor's does. The call then runs on a copy
        of this executor, built once per set of names and device, that
        folds nothing computed from them."""
        if len(inputs) != len(self.input_names):
            raise ValueError(
                f"expected {len(self.input_names)} inputs "
                f"({self.input_names}), got {len(inputs)}")
        device = next((x.device for x in inputs
                       if isinstance(x, torch.Tensor)), None)
        if device is None:
            device = next((b.device for b in self.buffers()),
                          torch.device("cpu"))
        if initializers:
            key = (frozenset(initializers), device)
            runner = self._substituting.get(key)
            if runner is None:
                runner = self._substituting[key] = GraphExecutor(
                    self.graph, unfolded=key[0]).to(device)
            out = runner._run(inputs, device, initializers)
            self.host_copies = runner.host_copies
            return out
        return self._run(inputs, device, {})

    def _run(self, inputs: tuple, device: torch.device,
             initializers: dict) -> tuple:
        saved = (getattr(_STATE, "device", None),
                 getattr(_STATE, "converted", 0),
                 getattr(_STATE, "buffer_of", None))
        _STATE.device, _STATE.converted = device, 0
        _STATE.buffer_of = self._constant_buffers()
        try:
            env: dict[str, object] = dict(self._static)
            env.update(initializers)
            env.update(zip(self.input_names,
                           (_to_tensor(x, device)
                            if not isinstance(x, torch.Tensor) else x
                            for x in inputs)))
            self._exec_nodes(env)
            self.host_copies = _STATE.converted
        finally:
            _STATE.device, _STATE.converted, _STATE.buffer_of = saved
        return tuple(env[name] for name in self.output_names)


def load_graph_executor(path: str) -> GraphExecutor:
    """Parse and validate an ONNX file into an executor (on the CPU; move
    it with ``.to(device)``)."""
    return GraphExecutor(read_onnx_graph(path))


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
