"""A serving cluster of several processes: ``torch.distributed``.

The port of ``infercam_onnx_tpu/parallel/multihost.py``. There,
``jax.distributed`` joins one process per host and ``jax.devices()``
becomes the global device list. Here ``initialize`` joins a
``torch.distributed`` process group, and each process keeps a mesh of its
own cards (`parallel.mesh`); `process_index` and `process_count` are the
rank and the world size. Run one server process per host (or several on
one machine)::

    python -m infercam_onnx_tpu_torch.serve \
        --distributed coordinator_host:1234,num_processes=2,process_id=0 \
        --lockstep-address coordinator_host:1235

The group is a ``gloo`` one. It carries only control data: the rank and
the world size the server reads, the start-up agreement and a dry run's
gather. No tensor crosses it on the hot path, where each process feeds
its own replicas the frames of its own streams, and the processes agree
on what to run over the lockstep socket (`parallel.lockstep`). NCCL would
also refuse two ranks on one card, which is how a one-card machine runs a
two-member cluster.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DistributedSpec:
    coordinator: str
    num_processes: int
    process_id: int


def parse_distributed_spec(spec: str) -> DistributedSpec:
    """Parse ``host:port,num_processes=N,process_id=I``."""
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if not parts:
        raise ValueError("empty --distributed spec")
    coordinator = parts[0]
    if ":" not in coordinator:
        raise ValueError(
            f"coordinator must be host:port, got {coordinator!r}")
    kv = {}
    for p in parts[1:]:
        if "=" not in p:
            raise ValueError(f"expected key=value, got {p!r}")
        k, v = p.split("=", 1)
        kv[k.strip()] = v.strip()
    try:
        return DistributedSpec(
            coordinator=coordinator,
            num_processes=int(kv["num_processes"]),
            process_id=int(kv["process_id"]))
    except KeyError as e:
        raise ValueError(f"missing {e.args[0]} in --distributed spec")


def initialize(spec: str | DistributedSpec) -> None:
    """Join the process group (before the server builds its mesh). Raises
    when the group cannot form."""
    if isinstance(spec, str):
        spec = parse_distributed_spec(spec)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{spec.coordinator}",
        world_size=spec.num_processes, rank=spec.process_id)


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the group; 0 without a group."""
    return dist.get_rank() if _joined() else 0


def process_count() -> int:
    """The group's world size; 1 without a group."""
    return dist.get_world_size() if _joined() else 1
