"""The user cache directory (the port of ``infercam_onnx_tpu/utils/cache.py``).

The reference caches downloaded model files under the user cache dir
(reference infer_server/src/nn.rs:149-162). Both packages use the same
folder, ``$XDG_CACHE_HOME/infercam_onnx_tpu`` (``~/.cache`` without it),
so a host that holds the JAX server's converted weights gives the port
the same ones.

The JAX module's ``enable_compilation_cache`` is XLA's and has no
counterpart here: nvcc and g++ builds are cached by source hash in
``build/`` (`kernels.build`, `native.jpeg.build`).
"""

from __future__ import annotations

import os


def cache_dir(*parts: str) -> str:
    """``$XDG_CACHE_HOME/infercam_onnx_tpu/<parts>``, created if absent."""
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    d = os.path.join(base, "infercam_onnx_tpu", *parts)
    os.makedirs(d, exist_ok=True)
    return d
