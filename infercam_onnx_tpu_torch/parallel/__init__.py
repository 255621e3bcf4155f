"""Scale-out on one device: tiled high-resolution detection."""

from infercam_onnx_tpu_torch.parallel.tiling import (  # noqa: F401
    TiledDetector,
    tile_grid_boxes,
)
