"""Parity of the port's SD autoencoder (`g4splat_torch.priors.vae`) with
`g4splat_tpu.priors.vae` on the CPU.

A small VAE runs in both packages on the same weights (the JAX init carried
across by `convert.flax_state_dict`) to 1e-4 relative; the port loads the
reference fixture `vae_tiny_ref.npz` under diffusers' key names with
`load_state_dict` (5e-4, the JAX package's gate), and builds the full SD
VAE with exactly the keys and shapes of `vae_full_keys.json`.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g4splat_tpu.priors.vae as J
from g4splat_torch.convert import flax_state_dict
from g4splat_torch.priors import vae as T

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def nchw(x):
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


def rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def small():
    kw = dict(base_ch=16, ch_mult=(1, 2, 2), z_ch=4)
    jv = J.AutoencoderKL(**kw)
    params = jv.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))
    tv = T.AutoencoderKL(**kw)
    tv.load_state_dict(flax_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return jv, params, tv.eval()


def test_encode_matches_jax(small):
    jv, params, tv = small
    x = np.random.RandomState(0).uniform(-1, 1, (2, 24, 16, 3)).astype(np.float32)
    ref = np.asarray(jv.apply(params, x, method=jv.encode))
    with torch.no_grad():
        got = nhwc(tv.encode(nchw(x)))
    assert got.shape == ref.shape == (2, 6, 4, 4)
    assert rel(got, ref) <= 1e-4


def test_decode_matches_jax(small):
    jv, params, tv = small
    z = np.random.RandomState(2).randn(2, 4, 6, 4).astype(np.float32) * T.SD_SCALE
    ref = np.asarray(jv.apply(params, z, method=jv.decode))
    with torch.no_grad():
        got = nhwc(tv.decode(nchw(z)))
    assert got.shape == ref.shape == (2, 16, 24, 3)
    assert rel(got, ref) <= 1e-4


def test_fixture_loads_without_converter():
    fx = np.load(os.path.join(FIXTURES, "vae_tiny_ref.npz"))
    tv = T.AutoencoderKL(base_ch=32, ch_mult=(1, 2), z_ch=4)
    tv.load_state_dict({k[3:]: torch.from_numpy(fx[k]) for k in fx.files
                        if k.startswith("sd.")}, strict=True)
    with torch.no_grad():
        mean = tv.encode(torch.from_numpy(fx["in.x"])).numpy() / T.SD_SCALE
        rec = tv.decode(torch.from_numpy(fx["out.mean"]) * T.SD_SCALE).numpy()
    assert rel(mean, fx["out.mean"]) < 5e-4
    assert rel(rec, fx["out.rec"]) < 5e-4


def test_full_config_keys_and_shapes():
    with open(os.path.join(FIXTURES, "vae_full_keys.json")) as f:
        shapes = json.load(f)
    with torch.device("meta"):
        tv = T.AutoencoderKL()
    assert {k: list(v.shape) for k, v in tv.state_dict().items()} == shapes
    assert tv.factor == 8
