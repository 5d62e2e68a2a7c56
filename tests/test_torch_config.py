"""The port's YAML reader and `apply_overrides` against PyYAML and the JAX
package: every file under configs/ (the port reads each group) parses equal
to `yaml.safe_load`, and the overlay onto the stage dataclasses (SfMConfig,
ChartAlignConfig) gives the JAX package's fields, unknown keys ignored
unless `strict`."""

import dataclasses
import glob
import os

import pytest
import yaml

import g4splat_torch.pipeline.chart_alignment as TC
import g4splat_torch.pipeline.sfm as TS
import g4splat_tpu.pipeline.chart_alignment as JC
import g4splat_tpu.pipeline.sfm as JS
from g4splat_torch.utils import config as TU
from g4splat_tpu.utils import config as JU

FILES = sorted(glob.glob(os.path.join(TU.CONFIG_ROOT, "*", "*.yaml")))


def test_every_group_is_present():
    groups = {os.path.basename(os.path.dirname(p)) for p in FILES}
    assert groups == {"adaptive_tetrahedralization", "charts_alignment",
                      "free_gaussians_refinement", "mast3r", "multiresolution_tsdf"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, TU.CONFIG_ROOT))
def test_load_config_equals_safe_load(path):
    group, name = os.path.basename(os.path.dirname(path)), os.path.basename(path)[:-5]
    want = yaml.safe_load(open(path)) or {}
    got = TU.load_config(group, name)
    assert got == want
    assert got == JU.load_config(group, name)
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


@pytest.mark.parametrize("text, want", [
    ("a: [2, 8, 16]", {"a": [2, 8, 16]}),
    ("a: [1000]  # comment", {"a": [1000]}),
    ("a: []", {"a": []}),
    ("a: [0.5, true, null, x]", {"a": [0.5, True, None, "x"]}),
])
def test_flow_lists(text, want):
    assert TU.parse_flat_yaml(text) == want == yaml.safe_load(text)


@pytest.mark.parametrize("group, name, jcls, tcls", [
    ("mast3r", "posed", JS.SfMConfig, TS.SfMConfig),
    ("mast3r", "unposed", JS.SfMConfig, TS.SfMConfig),
    ("mast3r", "budget", JS.SfMConfig, TS.SfMConfig),
    ("charts_alignment", "default", JC.ChartAlignConfig, TC.ChartAlignConfig),
    ("charts_alignment", "strong", JC.ChartAlignConfig, TC.ChartAlignConfig),
    ("charts_alignment", "fast", JC.ChartAlignConfig, TC.ChartAlignConfig),
])
def test_apply_overrides_matches_jax(group, name, jcls, tcls):
    j = dataclasses.asdict(JU.apply_overrides(jcls(), JU.load_config(group, name)))
    t = dataclasses.asdict(TU.apply_overrides(tcls(), TU.load_config(group, name)))
    # The JAX package's charts also take `scan_chunk`, the number of steps it
    # fuses into one device dispatch; the port runs one step per iteration.
    assert set(j) - set(t) == ({"scan_chunk"} if group == "charts_alignment" else set())
    assert t == {k: j[k] for k in t}


def test_apply_overrides_unknown_keys():
    over = {"niter1": 7, "not_a_field": 1}
    assert TU.apply_overrides(TS.SfMConfig(), over).niter1 == 7
    with pytest.raises(KeyError):
        TU.apply_overrides(TS.SfMConfig(), over, strict=True)
    with pytest.raises(KeyError):
        JU.apply_overrides(JS.SfMConfig(), over, strict=True)
