"""Run any supported ONNX model through the port's graph executor (the
counterpart of ``tools/onnx_run.py``).

The reference's network runtime is a general ONNX executor (tract,
reference infer_server/src/nn.rs:166-174); this runs the port's,
`models.onnx_exec.GraphExecutor` (the JAX executor's op table with
If/Loop/Scan), on any export::

    python -m infercam_onnx_tpu_torch.onnx_run model.onnx      # random inputs
    python -m infercam_onnx_tpu_torch.onnx_run model.onnx --input x.npy y.npy
    python -m infercam_onnx_tpu_torch.onnx_run model.onnx --runs 50  # timing
    python -m infercam_onnx_tpu_torch.onnx_run model.onnx --device cpu \\
        --out outputs.npz

Inputs are made from ``--seed`` by the JAX tool's rules: symbolic dims
become 1, uint8 inputs get 0..255, int32/int64 get 0..3, everything else
a float32 standard normal. Outputs print as shape, dtype and mean;
``--out`` writes them to an .npz (``out0``, ``out1``, ...). ``--runs N``
(N > 1) times N calls after the first: on ``cuda`` with CUDA events and a
synchronize, on the CPU with the host clock. Float32 runs in IEEE float32
(`config.full_float32`). The executor runs eagerly: there is no
counterpart of the JAX tool's ``--no-jit``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _random_input(info, rng) -> np.ndarray:
    """One graph input from ``rng`` (``tools/onnx_run.py``'s rules)."""
    shape = [1 if d is None else int(d) for d in info.shape]
    # TensorProto elem types: 1=float32, 2=uint8, 6=int32, 7=int64
    if info.elem_type == 2:
        return rng.integers(0, 256, size=shape).astype(np.uint8)
    if info.elem_type in (6, 7):
        dt = np.int32 if info.elem_type == 6 else np.int64
        return rng.integers(0, 4, size=shape).astype(dt)
    return rng.normal(size=shape).astype(np.float32)


def _host(value) -> np.ndarray:
    """An output (a tensor, or NumPy where the graph computed it on the
    host) as a NumPy array."""
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Run an ONNX model through the PyTorch port's graph "
                    "executor.")
    ap.add_argument("model", help="ONNX file")
    ap.add_argument("--input", nargs="*", default=None,
                    help=".npy/.npz files, one per graph input "
                         "(default: random tensors from declared "
                         "shapes)")
    ap.add_argument("--runs", type=int, default=1,
                    help="timed runs after the first call (default 1: "
                         "none timed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None,
                    help="write the outputs to this .npz")
    args = ap.parse_args(argv)

    import torch

    from infercam_onnx_tpu_torch.config import full_float32, resolve_device
    from infercam_onnx_tpu_torch.models.onnx_exec import GraphExecutor
    from infercam_onnx_tpu_torch.models.onnx_reader import read_onnx_graph

    device = resolve_device(args.device)
    graph = read_onnx_graph(args.model)
    ex = GraphExecutor(graph).to(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host CPU")
    print(f"{os.path.basename(args.model)}: {len(graph.nodes)} nodes, "
          f"{len(graph.initializers)} initializers; device {device} "
          f"({name})")

    rng = np.random.default_rng(args.seed)
    if args.input:
        inputs = []
        for p in args.input:
            loaded = np.load(p)
            if isinstance(loaded, np.lib.npyio.NpzFile):
                inputs.extend(loaded[k] for k in loaded.files)
            else:
                inputs.append(loaded)
        if len(inputs) != len(graph.inputs):
            ap.error(f"model wants {len(graph.inputs)} inputs "
                     f"({[i.name for i in graph.inputs]}), "
                     f"got {len(inputs)} arrays")
    else:
        inputs = [_random_input(i, rng) for i in graph.inputs]
    for info, arr in zip(graph.inputs, inputs):
        print(f"  in  {info.name}: {arr.shape} {arr.dtype}")
    tensors = [torch.from_numpy(np.array(a)).to(device) for a in inputs]

    def run():
        with torch.inference_mode(), full_float32():
            return ex(*tensors)

    t0 = time.perf_counter()
    outs = [_host(o) for o in run()]
    first_s = time.perf_counter() - t0
    for o, info in zip(outs, graph.outputs):
        flat = o.reshape(-1)
        summary = (f"mean {flat.astype(np.float64).mean():.6g}"
                   if flat.size else "empty")
        print(f"  out {info.name}: {o.shape} {o.dtype} ({summary})")
    print(f"first call: {first_s * 1e3:.1f} ms")
    if args.out:
        np.savez(args.out, **{f"out{i}": o for i, o in enumerate(outs)})

    if args.runs > 1:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.runs):
                run()
            end.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(end) / args.runs
        else:
            t0 = time.perf_counter()
            for _ in range(args.runs):
                run()
            ms = (time.perf_counter() - t0) / args.runs * 1e3
        print(f"{args.runs} runs: {ms:.3f} ms/run")
    return 0


if __name__ == "__main__":
    sys.exit(main())
