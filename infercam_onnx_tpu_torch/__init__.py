"""PyTorch/CUDA port of infercam_onnx_tpu for one NVIDIA H100.

The JAX package ``infercam_onnx_tpu`` stays the reference; this package
does the same work in PyTorch, with every Pallas TPU kernel of the
ported path rewritten by hand for Hopper (``csrc/``). It imports neither
``jax`` nor anything of the JAX package.

Ported so far: the fused detect path (preprocess -> UltraFace -> filter +
greedy NMS -> packed ``[B, D, 6]`` output), its weight loaders, the
``detect`` CLI and the goldens check.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise.
"""

from infercam_onnx_tpu_torch.config import DetectorConfig, resolve_device

__all__ = ["DetectorConfig", "resolve_device"]
