"""The network's weights, made from the run's seed on the device.

One ``torch.randn`` call on a generator seeded with ``--seed`` draws every
conv weight at once (He-normal: each weight's standard deviation
``sqrt(2 / fan_in)``; the first conv over all three colour channels).
Each folded BatchNorm is then set, as training leaves it, from its conv's
output statistics: one float32 forward pass over the cell's own pictures
(the first frame of each camera), each layer normalized in turn to unit
variance and mean ``bn_shift``. The box regressions are scaled to the
spread ``box_regression_std`` of a trained head, and the classification
heads' background logit gets the bias under which the pictures give
``candidates_per_input`` priors above ``min_confidence`` on average (a
quantile of the face-minus-background margins). Without these steps the
number of candidates swung with the seed from 14 to over 2,000 a frame
(random deep nets without normalization), and with it the NMS work and
the payload sizes.

The weights are rounded to bfloat16's grid, the type they are served in,
so the program's bfloat16 copy and the reference's float32 one hold the
same numbers. The program gets them as NumPy arrays (one copy back), the
reference as tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.ultraface import (Network, ieee_float32, leaves,
                                 param_shapes, priors)


class _Calibrating(Network):
    """The reference's forward pass, setting each folded BatchNorm (in
    place, in the caller's pytree too) from its conv's output statistics
    on the batch: unit variance, mean ``bn_shift``."""

    def __init__(self, params: dict, cfg: dict):
        super().__init__(params, cfg)
        self.p = params  # float32 HWIO leaves, written in place

    def _oihw_conv(self, x, w, stride=1, padding=0, dilation=1, groups=1):
        return super()._conv(x, w.permute(3, 2, 0, 1), stride, padding,
                             dilation, groups)

    def cbr(self, p, x, *, stride=1, padding=0, dilation=1, groups=1,
            relu=True):
        x = self._oihw_conv(x, p["w"], stride, padding, dilation, groups)
        var, mean = torch.var_mean(x, dim=(0, 2, 3))
        p["scale"].copy_(torch.rsqrt(var + 1e-5))
        p["bias"].copy_(self.cfg["bn_shift"] - mean * p["scale"])
        x = x * p["scale"][:, None, None] + p["bias"][:, None, None]
        return torch.relu(x) if relu else x

    def biased(self, p, x, *, stride=1, padding=0, groups=1):
        return (self._oihw_conv(x, p["w"], stride, padding, 1, groups)
                + p["b"][:, None, None])


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def make_params(cfg: dict, seed: int, device: torch.device,
                inputs: torch.Tensor) -> dict:
    """The weight pytree (HWIO) as float32 tensors on ``device``,
    calibrated on ``inputs`` ([N, h, w, 3] normalized network inputs on
    ``device``)."""
    shapes = param_shapes(cfg)
    spec = list(leaves(shapes))
    total = sum(int(np.prod(s)) for _, (kind, s, _) in spec if kind == "w")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    draws = torch.randn(total, generator=gen, device=device)
    ncls = cfg["num_classes"]
    tree = shapes
    offset = 0
    for path, (kind, shape, fan_in) in spec:
        if kind == "w":
            n = int(np.prod(shape))
            value = (draws[offset:offset + n].reshape(shape)
                     * float(np.sqrt(2.0 / fan_in)))
            offset += n
        elif kind == "scale":
            value = torch.ones(shape, device=device)
        else:
            value = torch.zeros(shape, device=device)
        _set(tree, path, value)
    pri = torch.from_numpy(priors(cfg)).to(device)
    with torch.no_grad(), ieee_float32():
        net = _Calibrating(tree, cfg)
        net(inputs, pri)
        # the box regressions' spread, as a trained head has it
        for level, loc in enumerate(net.head_outputs(inputs, "reg_heads")):
            head = tree["reg_heads"][level]
            last = head["pw"] if "pw" in head else head
            gain = cfg["box_regression_std"] / loc.std()
            last["w"].mul_(gain)
            last["b"].mul_(gain)
        scores, _ = net(inputs, pri)
        margin = torch.log(scores[..., 1]) - torch.log(scores[..., 0])
        # a prior's confidence is sigmoid(margin - bias): the bias that
        # leaves candidates_per_input priors of an input above the filter
        share = cfg["candidates_per_input"] / margin.shape[1]
        bias = (torch.quantile(margin.flatten().float().cpu(), 1.0 - share)
                - float(np.log(cfg["min_confidence"]
                               / (1.0 - cfg["min_confidence"]))))
    for path, (kind, _, _) in spec:
        leaf = _get(tree, path)
        if kind == "cls_bias":
            leaf[0::ncls] = float(bias)
        _set(tree, path, leaf.to(torch.bfloat16).to(torch.float32))
    return tree


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def as_numpy(tree: dict) -> dict:
    """The same pytree as NumPy arrays, copied back in one transfer."""
    spec = list(leaves(tree))
    flat = torch.cat([t.reshape(-1) for _, t in spec]).cpu().numpy()
    out = _copy_structure(tree)
    offset = 0
    for path, t in spec:
        n = t.numel()
        _set(out, path, flat[offset:offset + n].reshape(tuple(t.shape)).copy())
        offset += n
    return out


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_structure(v) for v in tree]
    return None
