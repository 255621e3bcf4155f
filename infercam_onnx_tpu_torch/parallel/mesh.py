"""The device "mesh" of the port: a list of devices.

The JAX package's ``make_mesh`` (``infercam_onnx_tpu/parallel/mesh.py``)
builds a 1-D ``jax.sharding.Mesh`` whose one axis the batch shards over.
Here a mesh is the list of devices that `ShardedDetector` puts one
replica on each of. A list may name a device more than once (two replicas
with streams of their own on one card); that is how a one-card machine,
and the CPU tests, drive several replicas.
"""

from __future__ import annotations

import torch

from infercam_onnx_tpu_torch.config import resolve_device


def make_mesh(n_devices: int | None = None, *,
              device: str | torch.device = "cuda") -> list[torch.device]:
    """The first ``n_devices`` CUDA devices (default: all of them), or on
    ``device="cpu"`` ``n_devices`` (default 1) entries of the CPU. Raises
    when more devices are asked for than there are, as the JAX package
    does."""
    if resolve_device(device).type == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n > have:
        raise ValueError(f"requested {n_devices} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]
