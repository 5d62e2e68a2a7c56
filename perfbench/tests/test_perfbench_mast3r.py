"""The MASt3R pair cell on the CPU at the program's TINY_CONFIG widths: the
plain reference against the program through one state dict under the
checkpoint's key names, the matching reference against the program's
dense matching, the work count by hand, the tiny cell end to end with
`correct` true, and `correct` false for the control and for each fault
planted in the timed path underneath."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import harness
from perfbench.counts import mast3r as counts
from perfbench.drivers import mast3r_pairs as driver
from perfbench.reference import mast3r as ref
from perfbench.reference.precision import Ops, round_tf32
from perfbench.tests import tiny, tiny_cells

CPU = torch.device("cpu")
SEED = 2 ** 31 + 91
CFG = tiny_cells.MAST3R_MODEL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_cells.layout(tmp_path_factory.mktemp("layout"))


def run(root, cell="mast3r_tiny", trace=False):
    return harness.run_cell(harness.load_cell(root, cell), SEED, 0.5, trace, CPU,
                            time.perf_counter(), log=lambda s: None)


def images(n, seed=0, h=64, w=96):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, h, w, 3), generator=g), torch.rand((n, h, w, 3), generator=g)


def test_parameter_names_are_the_checkpoints_at_full_width():
    """The reference's leaves and aliases are the official checkpoint's key
    set with its shapes (the program loads the same set strictly)."""
    cfg = tiny.config("mast3r_vitl_base_512")
    keys = json.loads((tiny.REPO / "tests" / "fixtures" / "mast3r_vitl_keys.json").read_text())
    leaves = ref.shapes(cfg["model"])
    full = dict(leaves, **{a: leaves[k] for a, k in ref.aliases(cfg["model"]).items()})
    assert set(full) == set(keys)
    assert all(tuple(keys[k]) == tuple(v) for k, v in full.items())
    assert sum(int(np.prod(s)) for s in leaves.values()) == cfg["parameters"]


def test_pairs_are_run_sfms():
    from g4splat_torch.pipeline.sfm import build_pairs_exhaustive

    assert driver.exhaustive_pairs(10) == build_pairs_exhaustive(10)


def test_reference_matches_the_program():
    w = driver.make_weights(ref.shapes(CFG), 5, CPU, 1.0)
    model = driver.program_model(CFG, w)
    a, b = images(3)
    got = model.infer_pair(a, b)
    with torch.no_grad():
        want = ref.forward(w, a, b, CFG, Ops())
    for k, (d, m) in driver.head_gaps(got, want).items():
        assert m > 0 and d / m < 2e-5, k


def test_matching_reference_matches_the_program():
    from g4splat_torch.priors.mast3r import reciprocal_nn_matches

    g = torch.Generator().manual_seed(3)
    d1 = torch.nn.functional.normalize(torch.randn((40, 48, 24), generator=g), dim=-1)
    d2 = torch.nn.functional.normalize(torch.randn((40, 48, 24), generator=g), dim=-1)
    nn12, mutual = reciprocal_nn_matches(d1, d2, block=256)
    q, t, mu = ref.grid_matches(d1, d2, 8, Ops())
    assert torch.equal(nn12[q], t) and torch.equal(mutual[q], mu)
    assert 0 < int(mu.sum()) < q.numel()


def test_work_counts_by_hand():
    """The formulas against a count written out for one tiny shape, and
    against `FlopCounterMode` over the reference's products."""
    c = dict(CFG, enc_depth=1, dec_depth=1)
    N = 4 * 6
    enc = 2 * N * 64 * 3 * 256 + (2 * N * 64 * 192 + 2 * N * 64 * 64 + 2 * 2 * N * 64 * 256
                                  + 2 * 2 * N * N * 64)
    assert counts.encoder_flops(c, 64, 96) == enc
    dec_view = 2 * N * 64 * 48 + (2 * N * 48 * 144 + 2 * N * 48 * 48 + 4 * 2 * N * 48 * 48
                                  + 2 * 2 * N * 48 * 192 + 4 * 2 * N * N * 48)
    assert counts.decoder_flops(c, 64, 96) == 2 * dec_view
    assert counts.matching_flops(c, 64, 96, 8) == 2 * 2 * (8 * 12) * 64 * 96 * 8
    w = {k: torch.zeros(s) for k, s in ref.shapes(CFG).items()}
    a, b = images(1)
    with FlopCounterMode(display=False) as fc:
        ref.forward(w, a, b, CFG, Ops())
    whole = (2 * counts.encoder_flops(CFG, 64, 96) + counts.decoder_flops(CFG, 64, 96)
             + 2 * counts.head_flops(CFG, 64, 96))
    assert fc.get_total_flops() == whole
    d = torch.nn.functional.normalize(torch.randn((64, 96, 8)), dim=-1)
    with FlopCounterMode(display=False) as fc:
        ref.grid_matches(d, d, 8, Ops())
    assert fc.get_total_flops() == counts.matching_flops(CFG, 64, 96, 8)
    s = counts.set_flops(CFG, 4, 64, 96, 8)
    assert s["total"] == (4 * counts.encoder_flops(CFG, 64, 96)
                          + 12 * (counts.decoder_flops(CFG, 64, 96)
                                  + 2 * counts.head_flops(CFG, 64, 96))
                          + 6 * counts.matching_flops(CFG, 64, 96, 8))


@pytest.mark.parametrize("trace", [False, True])
def test_the_tiny_cell_runs_correct(root, trace):
    out = run(root, trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 6 and out["failed"] == 0
    if trace:
        assert set(out["metrics"]) == {"encoder_ms.mast3r", "decoder_ms.mast3r",
                                       "heads_ms.mast3r", "matching_ms.mast3r",
                                       "mfu_pct.mast3r"}
        assert all(v["value"] > 0 for v in out["metrics"].values())
    else:
        assert set(out["metrics"]) == {"prior_items_per_s", "setup_s"}


def test_the_control_fails_the_check(root):
    cell = harness.load_cell(root, "mast3r_tiny")
    nums = cell.driver().control(cell.config, cell.traffic, SEED, CPU, "tf32")
    limits = cell.traffic["limits"]
    assert any(v > limits[n] for n, v in nums), nums


def _rope_base(monkeypatch):
    from g4splat_torch.priors import vit

    orig = vit.apply_rope_2d
    monkeypatch.setattr(vit, "apply_rope_2d",
                        lambda x, pos, base=100.0: orig(x, pos, 10.0 * base))


def _no_norm_y(monkeypatch):
    from g4splat_torch.priors import vit

    def forward(self, x, context, positions=None, context_positions=None):
        x = x + self.attn(self.norm1(x), positions)
        x = x + self.cross_attn(self.norm2(x), context, positions, context_positions)
        return x + self.mlp(self.norm3(x))

    monkeypatch.setattr(vit.DecoderBlock, "forward", forward)


def _taps_off_by_one(monkeypatch):
    """Each DPT tap reads the decoder's next tap."""
    from g4splat_torch.priors import mast3r

    orig = mast3r.CatMLPDPTHead.forward
    monkeypatch.setattr(mast3r.CatMLPDPTHead, "forward",
                        lambda self, enc, taps, grid: orig(self, enc, list(taps[1:]) + [taps[-1]],
                                                           grid))


def _tf32(monkeypatch):
    """The program's linear layers rounding both operands to TF32."""
    monkeypatch.setattr(torch.nn.Linear, "forward",
                        lambda self, x: torch.nn.functional.linear(
                            round_tf32(x), round_tf32(self.weight), self.bias))


def _half_batch(monkeypatch):
    """Each chunk computed on its first half, the rest repeated."""
    from g4splat_torch.priors import mast3r

    orig = mast3r.MASt3RModel.infer_pair

    def infer_pair(self, a, b, model=None):
        n = max(1, a.shape[0] // 2)
        o1, o2 = orig(self, a[:n], b[:n], model)
        idx = torch.arange(a.shape[0]) % n
        return {k: v[idx] for k, v in o1.items()}, {k: v[idx] for k, v in o2.items()}

    monkeypatch.setattr(mast3r.MASt3RModel, "infer_pair", infer_pair)


def _altered_match(monkeypatch):
    """Every pair's first correspondence moved by a pixel."""
    from g4splat_torch.priors import mast3r

    orig = mast3r.extract_correspondences

    def extract(*a, **kw):
        xy1, xy2, conf = orig(*a, **kw)
        xy2 = xy2.copy()
        if len(xy2):
            xy2[0, 0] = (xy2[0, 0] + 1) % a[1].shape[1]
        return xy1, xy2, conf

    monkeypatch.setattr(mast3r, "extract_correspondences", extract)


@pytest.mark.parametrize("fault", [_rope_base, _no_norm_y, _taps_off_by_one, _tf32, _half_batch,
                                   _altered_match])
def test_a_fault_fails_the_check(root, monkeypatch, fault):
    fault(monkeypatch)
    out = run(root)
    assert not out["correct"], out["checks"]
