"""The port's UltraFace, priors, init and weight loaders against the JAX
package.

Priors, init and the weight converters are NumPy on both sides and must
be bit-equal. The forward is compared at float32 under the bar of
tests/test_torch_parity.py (rtol 1e-4, atol 2e-5): the two frameworks'
CPU convolutions sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from infercam_onnx_tpu.models import checkpoint as jckpt
from infercam_onnx_tpu.models import convert as jconvert
from infercam_onnx_tpu.models import ultraface as juf
from infercam_onnx_tpu.ops.preprocess import Preprocessor
from infercam_onnx_tpu_torch.models import checkpoint as tckpt
from infercam_onnx_tpu_torch.models import convert as tconvert
from infercam_onnx_tpu_torch.models import ultraface as tuf

from tests.test_goldens_fixtures import SYNTH_PICS, WEIGHTS


def _assert_trees_equal(a, b):
    fa, ta = jax.tree.flatten(a)
    fb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("variant", list(juf.VARIANTS))
def test_priors_bit_equal(variant):
    w, h = juf.VARIANTS[variant]
    assert tuf.VARIANTS[variant] == (w, h)
    np.testing.assert_array_equal(tuf.generate_priors(w, h),
                                  juf.generate_priors(w, h))
    assert tuf.num_priors(w, h) == juf.num_priors(w, h)
    assert tuf.feature_map_sizes(w, h) == juf.feature_map_sizes(w, h)


@pytest.mark.parametrize("arch", ["RFB", "slim"])
@pytest.mark.parametrize("seed,bias", [(0, 0.0), (5, 0.75)])
def test_init_params_bit_equal(arch, seed, bias):
    _assert_trees_equal(
        tuf.init_params(seed, background_bias=bias, arch=arch),
        juf.init_params(seed, background_bias=bias, arch=arch))


def _perturbed_params(seed, arch):
    """init_params with random folded-BN affines and biases, so the affine
    and bias paths are exercised."""
    params = juf.init_params(seed, arch=arch)
    rng = np.random.default_rng(seed + 1)

    def perturb(path, x):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "b"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.mark.parametrize("arch", ["RFB", "slim"])
def test_forward_matches_jax_f32(arch):
    params = _perturbed_params(3, arch)
    priors = juf.generate_priors(320, 240)
    x = np.random.default_rng(4).standard_normal((2, 240, 320, 3),
                                                 dtype=np.float32)
    want_s, want_b = juf.forward(params, jnp.asarray(x), jnp.asarray(priors))
    model = tuf.UltraFace.from_params(params)
    with torch.no_grad():
        got_s, got_b = model(torch.from_numpy(x), torch.from_numpy(priors))
    assert got_s.dtype == got_b.dtype == torch.float32
    assert got_s.shape == (2, 4420, 2) and got_b.shape == (2, 4420, 4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                               rtol=1e-4, atol=2e-5)


def test_forward_bf16_tracks_jax_bf16():
    """bfloat16 convs, float32 softmax/decode, on a real preprocessed
    picture. bf16 keeps 8 significant bits and the frameworks' conv sums
    round at other places, so scores may differ by a few bf16 steps where
    a rounding flips (bound 0.03; 0.013 seen on this input, while either
    side's bf16-vs-f32 gap is ~0.04); most scores stay identical."""
    params = _perturbed_params(3, "RFB")
    priors = juf.generate_priors(320, 240)
    img = np.asarray(Image.open(SYNTH_PICS / "synthetic-0.jpg")
                     .convert("RGB"))[None]
    x = np.asarray(Preprocessor(320, 240)(jnp.asarray(img)))
    want_s, want_b = juf.forward(params, jnp.asarray(x), jnp.asarray(priors),
                                 compute_dtype=jnp.bfloat16)
    model = tuf.UltraFace.from_params(params).to(torch.bfloat16)
    with torch.no_grad():
        got_s, got_b = model(torch.from_numpy(x), torch.from_numpy(priors))
    assert got_s.dtype == got_b.dtype == torch.float32
    diff = np.abs(got_s.numpy() - np.asarray(want_s))[..., 1]
    assert diff.max() < 0.03
    assert np.mean(diff < 1e-6) > 0.9
    assert np.abs(got_b.numpy() - np.asarray(want_b)).max() < 0.03


def test_state_dict_loader_matches_jax_on_frozen_weights():
    sd = dict(np.load(WEIGHTS))
    _assert_trees_equal(tconvert.params_from_state_dict(sd),
                        jconvert.params_from_state_dict(sd))


def test_state_dict_loader_rejects_truncated_and_extra():
    sd = dict(np.load(WEIGHTS))
    truncated = dict(sd)
    truncated.pop("base_net.7.ConvLinear.conv.weight")
    with pytest.raises(KeyError):
        tconvert.params_from_state_dict(truncated)
    with pytest.raises(ValueError, match="unconsumed"):
        tconvert.params_from_state_dict({**sd, "stray.weight": sd[
            "extras.0.0.bias"]})


def test_checkpoint_reader_reads_both_layouts(tmp_path):
    params = juf.init_params(2, arch="slim", background_bias=0.5)
    path = str(tmp_path / "ckpt.npz")
    jckpt.save_params(params, path)
    _assert_trees_equal(tckpt.load_params(path), params)
    _assert_trees_equal(tckpt.load_params(str(WEIGHTS)),
                        jconvert.params_from_state_dict(
                            dict(np.load(WEIGHTS))))


def test_params_from_jax_layout():
    state = tconvert.params_from_jax(juf.init_params(0))
    assert state["base.0.w"].shape == (16, 3, 3, 3)
    assert state["base.1.dw.w"].shape == (16, 1, 3, 3)  # depthwise
    assert state["base.7.branch2.3.w"].shape == (16, 16, 3, 3)
    assert state["cls_heads.3.b"].shape == (6,)
    model = tuf.UltraFace("RFB")
    assert set(state) == set(model.state_dict())


def test_from_params_picks_arch():
    assert isinstance(tuf.UltraFace.from_params(
        juf.init_params(0, arch="slim")).base[7], tuf.ConvDW)
    assert isinstance(tuf.UltraFace.from_params(
        juf.init_params(0)).base[7], tuf.RFB)
