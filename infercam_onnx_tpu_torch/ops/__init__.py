"""Device ops of the detect path: preprocess, filter + NMS, and the hand
NMS kernel's wrapper (built at its first launch, never at import)."""

from infercam_onnx_tpu_torch.ops.preprocess import (  # noqa: F401
    Preprocessor,
    preprocess_images,
    triangle_resize_matrix,
)
from infercam_onnx_tpu_torch.ops.postprocess import (  # noqa: F401
    batched_postprocess,
)
