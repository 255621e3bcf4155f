"""A module-scoped autouse fixture for the port's test files: the weights
chain runs in a cache of its own and offline.

A port ``Detector`` built without weights walks the JAX package's chain:
the converted .npz cache and the ONNX file under ``$XDG_CACHE_HOME``,
then a download, then random weights. Under this fixture the cache is a
temporary directory and the port's downloader (and the JAX package's,
where the test file imported it) raises at once, so such a detector gets
its seeded random weights whatever the host's cache holds, and no test
reaches the network. Import it into a test module to use it::

    from torch_port_offline import offline_weights_chain  # noqa: F401
"""

import sys

import pytest


def _offline(url, path, *, timeout=60.0):
    raise OSError(f"offline: not fetching {url}")


@pytest.fixture(scope="module", autouse=True)
def offline_weights_chain(tmp_path_factory):
    from infercam_onnx_tpu_torch.utils import download

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XDG_CACHE_HOME", str(tmp_path_factory.mktemp("cache")))
        mp.setattr(download, "download_file", _offline)
        if "infercam_onnx_tpu" in sys.modules:
            from infercam_onnx_tpu.utils import download as jdownload

            mp.setattr(jdownload, "download_file", _offline)
        yield
