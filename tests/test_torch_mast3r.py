"""The port's MASt3R against the reference fixture and the JAX package.

- `mast3r_tiny_ref.npz`: the reference model's state dict (`sd.*`) loads
  into the port's `AsymmetricMASt3R` with `strict=True`, and the forward on
  the recorded pair matches `out1.*` / `out2.*` within 5e-4 of max|ref| (the
  JAX package's own test's tolerance).
- `mast3r_vitl_keys.json`: the full-width model's state-dict keys and shapes
  (built on the meta device) are the reference checkpoint's 1017.
- TINY_CONFIG: a seeded, perturbed port init crosses to the JAX package
  through its own converter (`convert_torch_mast3r`) and back through
  `convert.mast3r_state_dict`, bit for bit; `symmetric_inference_batch`
  agrees within 1e-4 of max|JAX| per map. (The flax init of TINY_CONFIG
  compiles for ~16 s on the CPU; the JAX package's converter builds the
  same param tree without a compile.)
- RoPE against `apply_rope_2d`, `grid_positions`, every LayerNorm's ε
  (1e-6, as flax's default and CroCo's), and `reciprocal_nn_matches` with a
  block smaller than N (indices and mutual mask equal, a tie going to the
  first index) and `extract_correspondences`.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g4splat_torch.convert import mast3r_state_dict
from g4splat_torch.priors import mast3r as TM
from g4splat_torch.priors import vit as TV
from g4splat_tpu.priors import mast3r as JM
from g4splat_tpu.priors import vit as JV

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
REF_TOL = 5e-4
JAX_TOL = 1e-4
TINY_REF_CFG = TM.MASt3RConfig(
    patch_size=16, enc_embed_dim=32, enc_depth=2, enc_num_heads=2, dec_embed_dim=32,
    dec_depth=12, dec_num_heads=2, local_feat_dim=8, dpt_features=16,
    dpt_layer_dims=(8, 16, 24, 32), two_confs=True)
OUT_KEYS = ("pts3d", "conf", "desc", "desc_conf")

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and small tensor ops on eight contended threads each run slower
    than on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def test_reference_fixture_loads_strictly_and_matches():
    f = np.load(os.path.join(FIXTURES, "mast3r_tiny_ref.npz"))
    net = TM.AsymmetricMASt3R(TINY_REF_CFG)
    net.load_state_dict({k[3:]: torch.from_numpy(f[k]) for k in f.files if k.startswith("sd.")},
                        strict=True)
    model = TM.MASt3RModel(TINY_REF_CFG, model=net)
    out1, out2 = model.infer_pair(f["in.img1"].transpose(0, 2, 3, 1),
                                  f["in.img2"].transpose(0, 2, 3, 1))
    for tag, out in (("out1", out1), ("out2", out2)):
        for k in OUT_KEYS:
            ref = f[f"{tag}.{k}"]
            got = out[k].numpy()
            assert got.shape == ref.shape, (tag, k)
            assert np.abs(got - ref).max() / max(1e-3, np.abs(ref).max()) < REF_TOL, (tag, k)


def test_full_width_keys_and_shapes():
    with open(os.path.join(FIXTURES, "mast3r_vitl_keys.json")) as fh:
        want = json.load(fh)
    with torch.device("meta"):
        net = TM.AsymmetricMASt3R(TM.MASt3RConfig())
    got = {k: list(v.shape) for k, v in net.state_dict().items()}
    assert got == want and len(got) == 1017
    norms = [m for m in net.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 2 * 24 + 2 * 12 * 4 + 2 and all(m.eps == 1e-6 for m in norms)


@pytest.fixture(scope="module")
def tiny_pair():
    """The port's TINY_CONFIG model and the JAX one on the same params."""
    torch.manual_seed(0)
    net = TM.AsymmetricMASt3R(TM.TINY_CONFIG)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.02 * torch.randn_like(p))   # LayerNorm scales and biases away from 1 / 0
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    params = JM.convert_torch_mast3r(sd, JM.TINY_CONFIG)
    return TM.MASt3RModel(TM.TINY_CONFIG, model=net), JM.MASt3RModel(JM.TINY_CONFIG,
                                                                       params=params), sd


def test_state_dict_round_trip(tiny_pair):
    _, jm, sd = tiny_pair
    back = mast3r_state_dict(jax.tree.map(np.asarray, jm.params), TM.TINY_CONFIG)
    assert set(back) == set(sd)
    unused = ("mask_token", "refinenet4.resConfUnit1")
    for k, v in sd.items():
        if any(u in k for u in unused):
            assert not back[k].any(), k            # zero-filled: the JAX model has none
        else:
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    net = TM.AsymmetricMASt3R(TM.TINY_CONFIG)
    net.load_state_dict(back, strict=True)


def test_symmetric_inference_batch_matches_jax(tiny_pair):
    tm, jm, _ = tiny_pair
    rng = np.random.default_rng(1)
    # test_torch_pipeline_run.py's shapes: the JAX compile is shared through
    # the persistent compilation cache.
    imgs = rng.uniform(size=(3, 32, 32, 3)).astype(np.float32)
    pairs = [(0, 1), (0, 2), (1, 2)]
    i1, i2 = imgs[[i for i, _ in pairs]], imgs[[j for _, j in pairs]]
    j_out = jm.symmetric_inference_batch(jnp.asarray(i1), jnp.asarray(i2))
    t_out = tm.symmetric_inference_batch(torch.from_numpy(i1), torch.from_numpy(i2), max_batch=4)
    assert len(t_out) == len(pairs)
    for jo, to in zip(j_out, t_out):
        for a, b in zip(jo, to):                     # X11, X21, X22, X12
            for k in OUT_KEYS:
                ref = np.asarray(a[k])
                assert b[k].shape == ref.shape
                assert np.abs(b[k].numpy() - ref).max() <= JAX_TOL * np.abs(ref).max(), k
    # The batch is the pair calls stacked, in (X11, X21, X22, X12) order.
    one = tm.symmetric_inference(i1[1:2], i2[1:2])
    for a, b in zip(one, t_out[1]):
        np.testing.assert_allclose(a["pts3d"].numpy(), b["pts3d"].numpy(), atol=1e-5)
    enc = tm.encode_image(imgs[:1])
    assert enc.shape == (1, 2 * 2, TM.TINY_CONFIG.enc_embed_dim)


def test_rope_and_positions():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 12, 16)).astype(np.float32)
    pos = np.asarray(JV.grid_positions(2, 3, 4))
    np.testing.assert_array_equal(TV.grid_positions(2, 3, 4).numpy(), pos)
    want = np.asarray(JV.apply_rope_2d(jnp.asarray(x), jnp.asarray(pos)))
    got = TV.apply_rope_2d(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(TV.make_2d_rope_freqs(16).numpy(),
                               np.asarray(JV.make_2d_rope_freqs(16)), rtol=1e-7)


def unit(rng, shape):
    d = rng.normal(size=shape).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_reciprocal_nn_matches_blocked_with_a_tie():
    rng = np.random.default_rng(3)
    d1, d2 = unit(rng, (6, 10, 8)), unit(rng, (6, 10, 8))
    d1[2, 3] = d1[0, 0]                # a mutual pair made, then its target duplicated:
    d2[4, 5] = d1[0, 0]                # pixels 0 and 23 tie as 45's nearest, and in
    d2[5, 9] = d1[0, 0]                # image 2, 54 and 59 tie as 0's: the first wins
    jn, jm = JM.reciprocal_nn_matches(jnp.asarray(d1), jnp.asarray(d2), block=16)
    tn, tmut = TM.reciprocal_nn_matches(torch.from_numpy(d1), torch.from_numpy(d2), block=16)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tmut.numpy(), np.asarray(jm))
    assert tn[0] == 45 and tn[23] == 45 and bool(tmut[0]) and not bool(tmut[23])
    # The blocked result equals the unblocked one.
    tn1, _ = TM.reciprocal_nn_matches(torch.from_numpy(d1), torch.from_numpy(d2), block=1 << 20)
    np.testing.assert_array_equal(tn1.numpy(), tn.numpy())


def test_extract_correspondences_matches_jax():
    rng = np.random.default_rng(4)
    d1 = unit(rng, (16, 24, 8))
    d2 = np.roll(d1, 2, axis=1) + 0.01 * rng.normal(size=d1.shape).astype(np.float32)
    c1, c2 = rng.uniform(1, 3, (16, 24)).astype(np.float32), rng.uniform(1, 3, (16, 24)).astype(
        np.float32)
    j = JM.extract_correspondences(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(c1),
                                   jnp.asarray(c2), subsample=4)
    t = TM.extract_correspondences(*(torch.from_numpy(a) for a in (d1, d2, c1, c2)), subsample=4)
    assert len(t[0]) > 10
    for a, b in zip(j, t):
        np.testing.assert_allclose(b, a, rtol=1e-6)
