"""The build cache of the port's CUDA sources (`g4splat_torch.ops.cuda_build`):
a library's file name carries a hash of everything nvcc reads for it (the
source, the headers beside it, the flags and the headers of every include
directory the flags name), so an edit to any of them is never served a stale
build. Needs no nvcc."""

import pytest

from g4splat_torch.ops import cuda_build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, inc = tmp_path / "csrc", tmp_path / "include"
    csrc.mkdir()
    inc.mkdir()
    (csrc / "x.cu").write_text('#include "x.cuh"\n#include "lib.h"\n')
    (csrc / "x.cuh").write_text("// v1\n")
    (inc / "lib.h").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + (f"-I{inc}",))
    return csrc, inc


def test_target_is_stable(tree):
    assert cuda_build._target("x") == cuda_build._target("x")
    assert cuda_build._target("x").name.startswith("libx-")


@pytest.mark.parametrize("edit", ["header", "new header", "source", "include dir"])
def test_target_follows_every_input(tree, edit):
    csrc, inc = tree
    before = cuda_build._target("x")
    path = {"header": csrc / "x.cuh", "new header": csrc / "y.cuh", "source": csrc / "x.cu",
            "include dir": inc / "lib.h"}[edit]
    path.write_text(path.read_text() + "// edited\n" if path.exists() else "// new\n")
    assert cuda_build._target("x") != before
