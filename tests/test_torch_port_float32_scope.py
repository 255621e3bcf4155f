"""Process-wide float32 state: `config.full_float32` across threads, and
the CPU's MKL thread mode under `config.resolve_device`.

The float32 precisions are process-wide settings, so the scope is counted
across threads: while any scope is open both settings read ``"ieee"``;
the last scope to close restores the settings the process had before the
first opened. The JAX package has no such state (its precision is per
op), so there is no JAX counterpart to compare with: these tests hold the
scope's contract. A CPU device turns MKL's dynamic thread choice off, so
float32 matmuls split the same way in every run.
"""

import os
import pathlib
import random
import subprocess
import sys
import threading
import time

import pytest
import torch

from infercam_onnx_tpu_torch.config import full_float32

TIMEOUT_S = 30.0


def _settings() -> tuple[str, str]:
    return (torch.backends.cuda.matmul.fp32_precision,
            torch.backends.cudnn.conv.fp32_precision)


@pytest.fixture
def tf32_on():
    """Both precisions set to "tf32" for the test, the process's own
    restored after."""
    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    saved = _settings()
    matmul.fp32_precision = conv.fp32_precision = "tf32"
    try:
        yield
    finally:
        matmul.fp32_precision, conv.fp32_precision = saved


def test_overlapping_scopes_on_two_threads(tf32_on):
    """A enters, B enters, A leaves: B's scope still reads "ieee", and
    after B leaves the caller's "tf32" is back."""
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen: dict[str, tuple[str, str]] = {}
    errors: list[BaseException] = []

    def thread_a():
        try:
            with full_float32():
                a_in.set()
                assert b_in.wait(TIMEOUT_S)
                seen["a_inside"] = _settings()
            a_out.set()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            a_out.set()

    def thread_b():
        try:
            assert a_in.wait(TIMEOUT_S)
            with full_float32():
                b_in.set()
                assert a_out.wait(TIMEOUT_S)
                seen["b_after_a_left"] = _settings()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            b_in.set()

    threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert seen == {"a_inside": ("ieee", "ieee"),
                    "b_after_a_left": ("ieee", "ieee")}
    assert _settings() == ("tf32", "tf32")


def test_nested_scopes_on_one_thread(tf32_on):
    with full_float32():
        with full_float32():
            assert _settings() == ("ieee", "ieee")
        assert _settings() == ("ieee", "ieee")
    assert _settings() == ("tf32", "tf32")


def test_scope_restores_after_an_exception(tf32_on):
    with pytest.raises(RuntimeError):
        with full_float32():
            raise RuntimeError("boom")
    assert _settings() == ("tf32", "tf32")


def test_decorator_form(tf32_on):
    @full_float32()
    def inside():
        return _settings()

    assert inside() == ("ieee", "ieee")
    assert _settings() == ("tf32", "tf32")


def test_many_threads_stress(tf32_on):
    """More threads than cores enter and leave scopes (some nested) with
    a short switch interval: every read inside a scope is "ieee", and the
    caller's settings come back at the end."""
    n_threads, rounds = 16, 200
    bad: list[tuple[str, str]] = []
    errors: list[BaseException] = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def worker(seed: int):
        rng = random.Random(seed)
        try:
            for _ in range(rounds):
                with full_float32():
                    time.sleep(0)  # let another thread open or close
                    if rng.random() < 0.3:
                        with full_float32():
                            if _settings() != ("ieee", "ieee"):
                                bad.append(_settings())
                    if _settings() != ("ieee", "ieee"):
                        bad.append(_settings())
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and bad == []
    assert _settings() == ("tf32", "tf32")


def test_cpu_device_turns_mkl_dynamic_threads_off():
    """MKL_VERBOSE shows each sgemm's dynamic mode: on for a matmul before
    ``resolve_device("cpu")``, off after it, at the same thread count."""
    if not torch.backends.mkl.is_available():
        pytest.skip("this torch is not built with MKL")
    code = ("import torch\n"
            "from infercam_onnx_tpu_torch.config import resolve_device\n"
            "a = torch.ones(64, 64)\n"
            "a @ a\n"
            "resolve_device('cpu')\n"
            "a @ a\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MKL_", "OMP_"))}
    proc = subprocess.run([sys.executable, "-c", code], env={
        **env, "MKL_VERBOSE": "1"}, capture_output=True, text=True,
        timeout=120, cwd=str(pathlib.Path(__file__).parents[1]))
    assert proc.returncode == 0, proc.stderr
    modes = [ln.split("Dyn:")[1][0] for ln in proc.stdout.splitlines()
             if "GEMM" in ln and "Dyn:" in ln]
    assert modes == ["1", "0"]
