"""The detect path: uint8 frames in, packed detections out, on one device.

The counterpart of ``infercam_onnx_tpu/detector.py``'s
``detect_program_impl``: preprocess (resize + normalize), the UltraFace
forward, and filter + greedy NMS over a whole batch of frames. The raw
uint8 frames are the only host->device copy, and with
``pack_output=True`` one ``[B, D, 6]`` array is the only copy back.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from infercam_onnx_tpu_torch.config import (DetectorConfig, full_float32,
                                            resolve_device)
from infercam_onnx_tpu_torch.models import checkpoint
from infercam_onnx_tpu_torch.models import ultraface as uf
from infercam_onnx_tpu_torch.ops.postprocess import batched_postprocess
from infercam_onnx_tpu_torch.ops.preprocess import Preprocessor, preprocess_images

log = logging.getLogger(__name__)

# A detection: (relative corner bbox [x_tl, y_tl, x_br, y_br], confidence)
Detection = tuple[np.ndarray, float]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@torch.inference_mode()
@full_float32()
def detect_program(
    model: uf.UltraFace,
    priors: torch.Tensor,
    images: torch.Tensor,  # [B, H, W, 3] uint8
    r_h: torch.Tensor,
    r_w: torch.Tensor,
    *,
    min_confidence: float,
    max_iou: float,
    top_k: int,
    max_detections: int,
    pack_output: bool = False,
    nms_impl: str = "kernel",
):
    """uint8 frames in, padded detections out, all on ``images.device``.

    The convs run in the model's parameter dtype, a float32 trunk in IEEE
    float32 whatever the process's TF32 settings. Returns
    ``(boxes [B,D,4], confs [B,D], counts [B])``, or with ``pack_output``
    one [B, D, 6] array of rows (x_tl, y_tl, x_br, y_br, confidence,
    valid). ``nms_impl`` is `batched_nms`'s ``impl``."""
    x = preprocess_images(images, r_h, r_w)
    scores, boxes = model(x, priors)
    sel_boxes, sel_conf, count = batched_postprocess(
        scores, boxes, min_confidence=min_confidence, max_iou=max_iou,
        top_k=top_k, max_detections=max_detections, impl=nms_impl)
    if not pack_output:
        return sel_boxes, sel_conf, count
    return pack_detections(sel_boxes, sel_conf, count)


def pack_detections(sel_boxes, sel_conf, count) -> torch.Tensor:
    """(boxes [B,D,4], confs [B,D], count [B]) -> ONE [B, D, 6] array
    (x0, y0, x1, y1, conf, valid); `unpack_detections` is the host-side
    inverse."""
    d = sel_boxes.shape[1]
    rows = torch.arange(d, device=sel_boxes.device)
    valid = (rows[None, :] < count[:, None]).to(torch.float32)
    return torch.cat([sel_boxes, sel_conf[..., None], valid[..., None]],
                     dim=-1)


def unpack_detections(packed: np.ndarray) -> list[list[Detection]]:
    """Host-side inverse of ``pack_output=True``."""
    out: list[list[Detection]] = []
    for row in np.asarray(packed):
        n = int(row[:, 5].sum())
        out.append([(row[i, :4], float(row[i, 4])) for i in range(n)])
    return out


class Detector:
    """UltraFace detector on one device.

    Weights, in order: ``params`` (a JAX-layout pytree), else the .npz at
    ``weights`` (either layout `models.checkpoint.load_params` reads),
    else deterministic random weights ``init_params(rng,
    background_bias=0.75)``. There is no download path.
    """

    def __init__(self, config: DetectorConfig = DetectorConfig(),
                 params=None, *, weights: str | None = None, rng: int = 0,
                 device: str | torch.device = "cuda"):
        if config.variant not in uf.VARIANTS:
            raise ValueError(f"unknown variant {config.variant!r}; have "
                             f"{list(uf.VARIANTS)}")
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {config.compute_dtype!r}")
        self.config = config
        self.device = resolve_device(device)
        if params is None and weights is not None:
            params = checkpoint.load_params(weights)
        if params is None:
            log.warning("no UltraFace weights given; using deterministic "
                        "random weights (seed %d)", rng)
            params = uf.init_params(rng, background_bias=0.75,
                                    arch=uf.arch_of(config.variant))
        self.width, self.height = uf.VARIANTS[config.variant]
        self.model = uf.UltraFace.from_params(params).to(
            device=self.device, dtype=_DTYPES[config.compute_dtype])
        self.priors = torch.from_numpy(
            uf.generate_priors(self.width, self.height)).to(self.device)
        self.preprocessor = Preprocessor(self.width, self.height,
                                         self.device)

    # -- device program ----------------------------------------------------

    def run_device(self, images: torch.Tensor | np.ndarray, *,
                   pack_output: bool = False):
        """[B, H, W, 3] uint8 -> (boxes [B,D,4], confs [B,D], counts [B])
        as tensors on the device, or with ``pack_output`` one [B, D, 6]
        tensor. Returns without waiting for the device."""
        if isinstance(images, np.ndarray):  # torch wants writable memory
            images = torch.from_numpy(np.require(images, requirements="WC"))
        images = images.to(self.device)
        _, h, w, _ = images.shape
        r_h, r_w = self.preprocessor.matrices(w, h)
        c = self.config
        return detect_program(
            self.model, self.priors, images, r_h, r_w,
            min_confidence=c.min_confidence, max_iou=c.max_iou,
            top_k=c.top_k, max_detections=c.max_detections,
            pack_output=pack_output)

    def warmup(self, batch_size: int, height: int, width: int) -> None:
        """Run one (B, H, W) batch so the kernel build, cuDNN's algorithm
        choice and the resize matrices happen ahead of traffic."""
        dummy = np.zeros((batch_size, height, width, 3), np.uint8)
        self.run_device(dummy, pack_output=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- host API ----------------------------------------------------------

    def detect_batch(self, frames: np.ndarray) -> list[list[Detection]]:
        """[B, H, W, 3] uint8 frames -> per-frame detection lists
        (relative corner bboxes + confidences, descending confidence)."""
        packed = self.run_device(frames, pack_output=True)
        return unpack_detections(packed.cpu().numpy())

    def detect(self, frame: np.ndarray) -> list[Detection]:
        """Single [H, W, 3] uint8 frame -> detections."""
        return self.detect_batch(frame[None])[0]
