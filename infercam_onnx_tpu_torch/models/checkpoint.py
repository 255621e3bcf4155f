"""Weight files (.npz) of the JAX-layout parameter pytree.

`save_params` writes the JAX package's checkpoint layout
(``infercam_onnx_tpu/models/checkpoint.py`` ``save_params``), so each
package reads the other's files. Two layouts are read, told apart by
their keys:

- checkpoints (`save_params`, here or in the JAX package): pytree paths
  joined by ``::``, HWIO weights, BatchNorm already folded;
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


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Pytree -> {"a::0::w": leaf}; tensor leaves come to the host."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    else:
        if hasattr(tree, "detach"):  # a torch tensor, wherever it lies
            tree = tree.detach().cpu().numpy()
        out[prefix.rstrip(":")] = np.asarray(tree)
    return out


def save_params(params: Any, path: str) -> None:
    """Write a parameter pytree (NumPy or tensor leaves) as a flat .npz
    keyed by ``::``-joined pytree paths."""
    np.savez_compressed(path, **_flatten(params))


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
