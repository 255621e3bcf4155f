"""The yardstick: the work a frame needs, counted from shapes, and the
card's published peaks (``peaks.json``).

- the resample, in float32: the chroma upsample of the ycbcr decode
  (4:2:0: each chroma plane doubled in height, then in width) and the
  resize to the network (a vertical, then a horizontal pass), each pass
  counted as the filter's taps it needs (2 FLOPs for each nonzero of the
  Triangle matrix, for each sample it applies to), whatever implements
  it: a pass whose size does not change is the identity and needs none,
  and the dense matrix products the program runs count no more; bytes:
  the frame's u8 pixels in, the network input's float32 out;
- the trunk's convolutions, counted by ``FlopCounterMode`` on the
  reference network at one input (they run in bfloat16 on tensor cores);
- NMS: the bytes of the ``top_k`` candidates' boxes and validity read and
  of the keep mask written, per image.

A tiled frame counts each tile's resize and trunk.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from reference.ultraface import Network, priors, tiles, triangle_matrix

PEAKS = json.loads((pathlib.Path(__file__).resolve().parent.parent
                    / "peaks.json").read_text())


def peaks(device_name: str) -> dict:
    for entry in PEAKS:
        if entry["match"] in device_name:
            return entry
    raise KeyError(f"no peaks for {device_name!r} in peaks.json")


def _pass_flops(in_size: int, out_size: int, samples: int) -> int:
    """FLOPs of one Triangle resample pass over ``samples`` lines."""
    if in_size == out_size:
        return 0
    return 2 * int(np.count_nonzero(triangle_matrix(in_size, out_size))) \
        * samples


def resample_flops(cfg: dict, traffic: dict) -> tuple[int, int]:
    """(FLOPs, bytes) one frame's resample needs."""
    s = traffic["decode_scale"]
    width, height = traffic["frame_width"] // s, traffic["frame_height"] // s
    w, h = cfg["input_width"], cfg["input_height"]
    flops = 0
    if traffic["decode_mode"] == "ycbcr":
        ch, cw = (height + 1) // 2, (width + 1) // 2
        flops += 2 * (_pass_flops(ch, 2 * ch, cw)
                      + _pass_flops(cw, 2 * cw, 2 * ch))
    regions = ([(0, 0, width, height)] if not traffic["tile_min_pixels"]
               else tiles(width, height, traffic["tile_grid"],
                          traffic["tile_overlap"]))
    for x0, y0, x1, y1 in regions:
        tw, th = x1 - x0, y1 - y0
        flops += _pass_flops(th, h, tw * 3) + _pass_flops(tw, w, h * 3)
    nbytes = width * height * 3 + len(regions) * h * w * 3 * 4
    return flops, nbytes


def trunk_flops(cfg: dict, traffic: dict, params: dict,
                device: torch.device) -> int:
    """Convolution FLOPs of one frame's network inputs."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.zeros(1, cfg["input_height"], cfg["input_width"], 3,
                    device=device)
    pri = torch.from_numpy(priors(cfg)).to(device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        Network(params, cfg)(x, pri)
    cols, rows = traffic["tile_grid"]
    return counter.get_total_flops() * (cols * rows
                                        if traffic["tile_min_pixels"] else 1)


def nms_bytes(cfg: dict) -> int:
    """Bytes one image's suppression reads and writes: boxes [4, top_k]
    and validity [top_k] in float32, the keep mask [top_k] out."""
    return cfg["top_k"] * (4 * 4 + 4 + 4)
