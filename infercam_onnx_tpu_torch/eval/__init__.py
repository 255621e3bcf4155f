"""Evaluation: detection parity metrics and golden-output fixtures."""

from infercam_onnx_tpu_torch.eval.parity import (  # noqa: F401
    fidelity_gate,
    match_detections,
    parity_report,
)
