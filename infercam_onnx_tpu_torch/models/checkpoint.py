"""Reading weight files (.npz) into the JAX-layout parameter pytree.

Two layouts are read, told apart by their keys:

- the JAX package's checkpoints (``infercam_onnx_tpu/models/checkpoint.py``
  ``save_params``): pytree paths joined by ``::``, HWIO weights, BatchNorm
  already folded;
- upstream-named state dicts (``base_net.0.0.weight``, ...), such as the
  committed ``resources/weights/ultraface-twin.npz``, converted by
  `convert.params_from_state_dict`.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from infercam_onnx_tpu_torch.models.convert import params_from_state_dict

_SEP = "::"


def _insert(root: dict, path: list[str], value: np.ndarray) -> None:
    """Place ``value`` at ``path``; digit parts index lists."""
    node: Any = root
    for part, nxt in zip(path[:-1], path[1:]):
        node = _child(node, part, [] if nxt.isdigit() else {})
    leaf = path[-1]
    if isinstance(node, list):
        _child(node, leaf, None)
        node[int(leaf)] = value
    else:
        node[leaf] = value


def _child(node: Any, part: str, default: Any) -> Any:
    if isinstance(node, list):
        i = int(part)
        node.extend([None] * (i + 1 - len(node)))
        if node[i] is None:
            node[i] = default
        return node[i]
    return node.setdefault(part, default)


def load_params(path: str) -> Any:
    """Read either layout of .npz into a NumPy parameter pytree."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    if not any(_SEP in k for k in arrays):
        return params_from_state_dict(arrays)
    root: dict = {}
    for key, value in arrays.items():
        _insert(root, key.split(_SEP), value)
    return root
