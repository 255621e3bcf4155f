"""UltraFace network, weight conversion and checkpoint reading."""

from infercam_onnx_tpu_torch.models.ultraface import (  # noqa: F401
    VARIANTS,
    UltraFace,
    forward,
    generate_priors,
    init_params,
)
