"""Tiled high-resolution detection with a cross-tile NMS merge, on one
device or over a mesh (the port of ``infercam_onnx_tpu/parallel/tiling.py``).

The model input is 320x240 (RFB-320); a face that is small in a 1080p
frame falls below the detector's prior scales once the whole frame is
squashed to that size. So the frame splits into an overlapping grid of
equal tiles, every tile runs the whole detector as one more batch row,
each tile's boxes are mapped back into frame coordinates, and one
filter + greedy NMS over the merged candidates of all tiles drops the
duplicates that the overlaps produce.

`batched_nms` cuts the T x K merged candidates of an image to ``top_k``
before the suppression, so the NMS kernel (``csrc/nms.cu``) runs once a
call on [B, 4, top_k]. With ``top_k`` above the kernel's limit of 1024 it
raises, as on the untiled path; nothing falls back to the plain version.

On a mesh (a list of devices, `parallel.mesh`) `TiledDetector` runs in one
of two modes, as the JAX class does:

- by default the tiles are cut on the first device and the flattened
  (image x tile) batch is split over the replicas of a `ShardedDetector`
  for the resize and the trunk, so even one frame's tiles spread out; the
  candidates come back to the first device, where they are merged, cut to
  ``top_k`` and suppressed: one NMS launch a call;
- with ``batch_sharded_out`` (what a lockstep member runs) the batch is
  split by image and each replica runs the whole tiled program: one NMS
  launch per replica.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from infercam_onnx_tpu_torch.config import full_float32
from infercam_onnx_tpu_torch.detector import (Detection, Detector,
                                              as_tensor, pack_detections,
                                              unpack_detections)
from infercam_onnx_tpu_torch.ops.jpeg_device import (combine_ycbcr,
                                                     unpack_ycbcr_planes)
from infercam_onnx_tpu_torch.ops.postprocess import batched_nms
from infercam_onnx_tpu_torch.parallel.data_parallel import ShardedDetector
from infercam_onnx_tpu_torch.ops.preprocess import preprocess_images

Tile = tuple[int, int, int, int]


def tile_grid_boxes(width: int, height: int, grid: tuple[int, int],
                    overlap: float = 0.2) -> list[Tile]:
    """Pixel boxes (x0, y0, x1, y1) of an overlapping cols x rows grid.

    Tiles are equally sized (so one pair of resize matrices serves all)
    and overlap adjacent tiles by ``overlap`` of the tile extent, so a face
    on a seam is seen whole by at least one tile."""
    cols, rows = grid
    tile_w = int(np.ceil(width / (cols - (cols - 1) * overlap)))
    tile_h = int(np.ceil(height / (rows - (rows - 1) * overlap)))
    xs = (np.linspace(0, width - tile_w, cols).round().astype(int)
          if cols > 1 else np.array([0]))
    ys = (np.linspace(0, height - tile_h, rows).round().astype(int)
          if rows > 1 else np.array([0]))
    return [(int(x), int(y), int(x) + tile_w, int(y) + tile_h)
            for y in ys for x in xs]


@functools.lru_cache(maxsize=None)
def _tile_mapping(tiles: tuple[Tile, ...], width: int, height: int,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale [4], shift [T, 4]) float32 on ``device``, copied there once:
    a tile's relative box times ``scale`` plus its row of ``shift`` is the
    box relative to the whole frame (the JAX program's constants, built in
    its order)."""
    tw, th = tiles[0][2] - tiles[0][0], tiles[0][3] - tiles[0][1]
    offs_x = torch.tensor([t[0] for t in tiles], dtype=torch.float32)
    offs_y = torch.tensor([t[1] for t in tiles], dtype=torch.float32)
    scale = torch.tensor([tw / width, th / height, tw / width, th / height],
                         dtype=torch.float32)
    shift = torch.stack([offs_x / width, offs_y / height,
                         offs_x / width, offs_y / height], dim=-1)
    return scale.to(device), shift.to(device)


def extract_tiles(images: torch.Tensor,
                  tiles: tuple[Tile, ...]) -> torch.Tensor:
    """[B, H, W, 3] frames -> the tiles as static slices, [B*T, th, tw, 3]
    (image-major)."""
    b = images.shape[0]
    th = tiles[0][3] - tiles[0][1]
    tw = tiles[0][2] - tiles[0][0]
    return torch.stack([images[:, y0:y1, x0:x1, :]
                        for (x0, y0, x1, y1) in tiles],
                       dim=1).reshape(b * len(tiles), th, tw, 3)


@torch.inference_mode()
@full_float32()
def tile_candidates(model, priors: torch.Tensor, flat: torch.Tensor,
                    r_h: torch.Tensor, r_w: torch.Tensor):
    """The resize and the model over a batch of tiles: (scores [N, K, 2],
    boxes [N, K, 4] relative to their tile)."""
    return model(preprocess_images(flat, r_h, r_w), priors)


@torch.inference_mode()
@full_float32()
def merge_tiles(scores: torch.Tensor, boxes: torch.Tensor, *,
                tiles: tuple[Tile, ...], width: int, height: int,
                min_confidence: float, max_iou: float, top_k: int,
                max_detections: int, pack_output: bool = False,
                nms_impl: str = "kernel"):
    """The candidates of B x T tiles (`tile_candidates`, image-major) of
    ``width`` x ``height`` frames -> each tile's boxes mapped into its
    frame and `batched_nms` over the [B, T*K] merged candidates."""
    t = len(tiles)
    b, k = boxes.shape[0] // t, boxes.shape[1]
    scale, shift = _tile_mapping(tiles, width, height, boxes.device)
    boxes = boxes.reshape(b, t, k, 4) * scale + shift[None, :, None, :]
    sel_boxes, sel_conf, count = batched_nms(
        scores[:, :, 1].reshape(b, t * k), boxes.reshape(b, t * k, 4),
        min_confidence=min_confidence, max_iou=max_iou, top_k=top_k,
        max_detections=max_detections, impl=nms_impl)
    if not pack_output:
        return sel_boxes, sel_conf, count
    return pack_detections(sel_boxes, sel_conf, count)


def tiled_detect_program(
    model,
    priors: torch.Tensor,
    images: torch.Tensor,  # [B, H, W, 3] uint8 (or float on the u8 grid)
    r_h: torch.Tensor,  # [model_h, tile_h]
    r_w: torch.Tensor,  # [model_w, tile_w]
    *,
    tiles: tuple[Tile, ...],
    **kw,
):
    """Frames in, padded detections in frame coordinates out, all on
    ``images.device``: `extract_tiles`, `tile_candidates` over all of them
    at once, then `merge_tiles` (``kw``: its thresholds, ``pack_output``
    and ``nms_impl``). Returns what `detector.detect_program` returns."""
    _, height, width, _ = images.shape
    scores, boxes = tile_candidates(model, priors,
                                    extract_tiles(images, tiles), r_h, r_w)
    return merge_tiles(scores, boxes, tiles=tiles, width=width,
                       height=height, **kw)


@torch.inference_mode()
def ycbcr_frames(packed: torch.Tensor, *, width: int, height: int,
                 y_pw: int, y_ph: int, c_pw: int, c_ph: int,
                 sampling: tuple[int, int]) -> torch.Tensor:
    """[B, n] packed planes -> [B, height, width, 3] float RGB on the u8
    grid: the chroma upsample and BT.601 of the untiled ycbcr path."""
    y, cb, cr = unpack_ycbcr_planes(packed, y_pw=y_pw, y_ph=y_ph, c_pw=c_pw,
                                    c_ph=c_ph)
    return combine_ycbcr(y, cb, cr, width=width, height=height,
                         sampling=sampling)


def tiled_detect_from_ycbcr_program(
    model,
    priors: torch.Tensor,
    packed: torch.Tensor,  # [B, n] uint8 packed planes
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
    **kw,
):
    """Packed YCbCr planes in (``decode_ycbcr_batch``'s layout): a 4:2:0
    frame crosses to the device at ~1.5 bytes a pixel instead of 3.
    `ycbcr_frames`, then `tiled_detect_program` (``kw``)."""
    rgb = ycbcr_frames(packed, width=width, height=height, y_pw=y_pw,
                       y_ph=y_ph, c_pw=c_pw, c_ph=c_ph, sampling=sampling)
    return tiled_detect_program(model, priors, rgb, r_h, r_w, **kw)


def tiled_detect_from_ycbcr_rows_program(model, priors: torch.Tensor,
                                         rows, r_h: torch.Tensor,
                                         r_w: torch.Tensor, **kw):
    """The batch as B separate [n] rows, each uploaded by a copy of its
    own, stacked on the device (a device-local copy), then
    `tiled_detect_from_ycbcr_program`."""
    return tiled_detect_from_ycbcr_program(model, priors, torch.stack(rows),
                                           r_h, r_w, **kw)


class TiledDetector:
    """High-resolution detection of ``frame_size`` frames through a tile
    grid, with the wrapped detector's model, priors and thresholds (no
    copy of the weights on its own device).

    ``mesh``: a list of devices (the module docstring's two modes;
    ``axis`` names its one axis). A detector already built over that very
    list (``detector.mesh is mesh``: a `ShardedDetector` or a lockstep
    member) lends its replicas; otherwise a `ShardedDetector` over
    ``mesh`` is built here."""

    def __init__(self, detector: Detector, frame_size: tuple[int, int],
                 grid: tuple[int, int] = (2, 2), overlap: float = 0.2,
                 mesh: list | None = None, axis: str = "data",
                 batch_sharded_out: bool = False):
        self.detector = detector
        self.frame_w, self.frame_h = frame_size  # (width, height)
        self.tiles = tuple(tile_grid_boxes(self.frame_w, self.frame_h,
                                           grid, overlap))
        x0, y0, x1, y1 = self.tiles[0]
        self._tile_wh = (x1 - x0, y1 - y0)
        self._r_h, self._r_w = detector.preprocessor.matrices(*self._tile_wh)
        self._static = dict(tiles=self.tiles, **detector._thresholds())
        self._batch_sharded_out = batch_sharded_out
        # what runs the programs: the detector itself, or replicas
        self._runner = detector
        if mesh is not None and getattr(detector, "mesh", None) is not mesh:
            self._runner = ShardedDetector(detector, mesh, axis=axis)
        # the default mode on a mesh: tiles of one frame split over the
        # replicas
        self._split_tiles = mesh is not None and not batch_sharded_out

    def _geometry(self, geom: dict) -> dict:
        """`ycbcr_frames`' keywords for ``geom``; raises on a frame of
        another size than the tile grid's."""
        if (geom["width"], geom["height"]) != (self.frame_w, self.frame_h):
            raise ValueError(
                f"geometry {geom['width']}x{geom['height']} != tiled "
                f"frame {self.frame_w}x{self.frame_h}")
        keys = ("width", "height", "y_pw", "y_ph", "c_pw", "c_ph")
        return dict({k: geom[k] for k in keys},
                    sampling=tuple(geom["sampling"]))

    def _on_split_tiles(self, frames: torch.Tensor, pack_output: bool):
        """The default mesh mode on ``frames`` (on the first device): the
        tiles split over the replicas, merged and suppressed on the first
        device."""
        runner = self._runner

        def call(r, flat):
            return tile_candidates(r.model, r.priors, flat,
                                   *r.preprocessor.matrices(*self._tile_wh))

        scores, boxes = runner._dispatch([extract_tiles(frames, self.tiles)],
                                         call)
        return merge_tiles(scores, boxes, width=self.frame_w,
                           height=self.frame_h, pack_output=pack_output,
                           **self._static)

    def _first_device(self, a) -> torch.Tensor:
        """``a`` on the first device, copied on the caller's stream."""
        return as_tensor(a).to(self._runner.device, non_blocking=True)

    def run_device(self, images: torch.Tensor | np.ndarray, *,
                   pack_output: bool = False):
        """[B, frame_h, frame_w, 3] uint8 -> (boxes, confs, counts) in
        frame-relative coordinates ([B, D, 6] with ``pack_output``), on the
        (first) device. Returns without waiting for the device."""
        h, w = int(images.shape[1]), int(images.shape[2])
        if (w, h) != (self.frame_w, self.frame_h):
            # the tile boxes are fixed per frame size: another size would
            # cover a corner only, or fail in a slice
            raise ValueError(f"frame {w}x{h} != tiled frame size "
                             f"{self.frame_w}x{self.frame_h}")
        if self._split_tiles:
            return self._on_split_tiles(self._first_device(images),
                                        pack_output)

        def call(r, images):
            return tiled_detect_program(
                r.model, r.priors, images,
                *r.preprocessor.matrices(*self._tile_wh),
                pack_output=pack_output, **self._static)
        return self._runner._dispatch([images], call)

    def run_device_ycbcr_packed(self, packed: torch.Tensor | np.ndarray,
                                geom: dict, *, pack_output: bool = False):
        """[B, n] packed planes of ``geom`` (``decode_ycbcr_batch``'s) ->
        detections as `run_device` gives them, one host->device copy."""
        geo = self._geometry(geom)
        if self._split_tiles:
            return self._on_split_tiles(
                ycbcr_frames(self._first_device(packed), **geo), pack_output)

        def call(r, packed):
            return tiled_detect_from_ycbcr_program(
                r.model, r.priors, packed,
                *r.preprocessor.matrices(*self._tile_wh),
                pack_output=pack_output, **geo, **self._static)
        return self._runner._dispatch([packed], call)

    def run_device_ycbcr_rows(self, rows, geom: dict, *,
                              pack_output: bool = False):
        """``rows``: B per-frame [n] packed-plane rows (device tensors, each
        the product of its own upload, or host arrays) -> detections as
        `run_device_ycbcr_packed` gives them; the batch is stacked on the
        device. A per-row upload is a one-device transfer route: lockstep
        batches (``batch_sharded_out``) take the stacked one."""
        if self._batch_sharded_out:
            raise ValueError("per-row upload is a single-host transfer "
                             "optimization; lockstep batches use the "
                             "stacked path")
        geo = self._geometry(geom)
        if self._split_tiles:
            return self._on_split_tiles(ycbcr_frames(torch.stack(
                [self._first_device(r) for r in rows]), **geo), pack_output)
        det = self.detector
        return tiled_detect_from_ycbcr_rows_program(
            det.model, det.priors, [det._on_device(r) for r in rows],
            self._r_h, self._r_w, pack_output=pack_output, **geo,
            **self._static)

    def detect_batch(self, images) -> list[list[Detection]]:
        """[B, frame_h, frame_w, 3] uint8 -> per-frame detection lists."""
        packed = self.run_device(images, pack_output=True)
        return unpack_detections(packed.cpu().numpy())
