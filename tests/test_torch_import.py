"""The port stands alone: importing g4splat_torch (every submodule) or
chip_smoke.py pulls in no JAX (nor flax, optax or PyYAML, which the card's
machine lacks) and nothing of g4splat_tpu, and no source file
of the port, nor the timing scripts (scripts/time_*.py), imports
either. chip_smoke.py refuses to run without a card."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "yaml", "g4splat_tpu")

PROBE = """
import importlib, importlib.util, pkgutil, sys
import g4splat_torch
for m in pkgutil.walk_packages(g4splat_torch.__path__, "g4splat_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print("LOADED", len([m for m in sys.modules if m.startswith("g4splat_torch")]))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_import_pulls_in_no_jax():
    r = subprocess.run([sys.executable, "-c", PROBE.format(forbidden=set(FORBIDDEN))],
                       cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BAD []" in r.stdout
    assert int(r.stdout.split("LOADED ")[1].split()[0]) >= 15


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "g4splat_torch").rglob("*.py"),
                                       REPO / "chip_smoke.py",
                                       *(REPO / "scripts").glob("time_*.py")]))
def test_source_imports_no_jax(path):
    pat = re.compile(r"^\s*(?:import|from)\s+(%s)\b" % "|".join(FORBIDDEN), re.M)
    assert not pat.search((REPO / path).read_text()), path


def test_chip_smoke_refuses_without_card(tmp_path):
    """Here (no card) and alone in a directory it exits non-zero with no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal path is not reachable")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
