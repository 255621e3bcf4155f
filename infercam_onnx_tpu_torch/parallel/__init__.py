"""Scale-out: data-parallel replicas over a list of devices, tiled
high-resolution detection (on one device or split over replicas), and a
serving cluster of several processes in lockstep (`parallel.lockstep`,
`parallel.multihost`)."""

from infercam_onnx_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from infercam_onnx_tpu_torch.parallel.data_parallel import (  # noqa: F401
    ShardedDetector,
    shard_detect,
)
from infercam_onnx_tpu_torch.parallel.tiling import (  # noqa: F401
    TiledDetector,
    tile_grid_boxes,
)
