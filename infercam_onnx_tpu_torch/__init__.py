"""PyTorch/CUDA port of infercam_onnx_tpu for one NVIDIA H100.

The JAX package ``infercam_onnx_tpu`` stays the reference; this package
does the same work in PyTorch, with every Pallas TPU kernel of the
ported path rewritten by hand for Hopper (``csrc/``). It imports neither
``jax`` nor anything of the JAX package.

Ported: the model-level API (``UltraFace.create``, ``models.forward``,
``ops.Preprocessor``, ``ops.batched_postprocess``), the fused detect path
(preprocess -> UltraFace -> filter + greedy NMS -> packed ``[B, D, 6]``
output) with its weights chain (an .npz, the
converted cache, the cached or downloaded ONNX file, random weights),
the packed-YCbCr and coefficient inputs and the device annotate tails,
the serving tier (``serve``, every decode and annotate mode), tiling,
data-parallel replicas and lockstep clusters, the ONNX graph runtime
(`models.onnx_exec.GraphExecutor` with the JAX executor's whole op
table, the int8 quantized ops and If/Loop/Scan included, `GraphDetector`,
the structural converter ``models.convert.params_from_onnx``, ``--onnx``
and ``--runtime graph``), the edge sender with the V4L2 camera
(``client``), the goldens ``make``/``check`` CLI with the parity metrics
and the NumPy reference oracle (``eval``, ``ops.reference_impl``), and
the operator tools ``detect``, ``onnx_run``, ``loadgen`` and
``cluster_launch``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise.
"""

from infercam_onnx_tpu_torch.config import DetectorConfig, resolve_device

__all__ = ["DetectorConfig", "resolve_device"]


def __getattr__(name):
    # lazy top-level API: importing the package stays cheap
    if name == "Detector":
        from infercam_onnx_tpu_torch.detector import Detector

        return Detector
    if name == "UltraFace":
        from infercam_onnx_tpu_torch.models.ultraface import UltraFace

        return UltraFace
    if name == "GraphDetector":
        from infercam_onnx_tpu_torch.models.onnx_exec import GraphDetector

        return GraphDetector
    if name == "ShardedDetector":
        from infercam_onnx_tpu_torch.parallel.data_parallel import (
            ShardedDetector)

        return ShardedDetector
    if name in ("EngineConfig", "ServerConfig", "ClientConfig",
                "ParallelConfig"):
        from infercam_onnx_tpu_torch import config

        return getattr(config, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
