"""Whole-body HTTP download to a file (the port of
``infercam_onnx_tpu/utils/download.py``; reference
infer_server/src/utils.rs:9-21).

Standard-library urllib; offline every call raises, and callers fall back
(`models.convert.load_or_download_params` returns None).
"""

from __future__ import annotations

import os
import urllib.request


def download_file(url: str, path: str, *, timeout: float = 60.0) -> None:
    """GET ``url`` in 1 MiB chunks into ``path.part``, then move it to
    ``path``, so ``path`` never holds a partial file."""
    tmp = path + ".part"
    with urllib.request.urlopen(url, timeout=timeout) as resp:  # noqa: S310
        with open(tmp, "wb") as f:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
    os.replace(tmp, path)
