"""Where the port's CUDA kernels are built, and what makes them rebuild.

``_build.library_path`` names each library by a hash of its source, of
every shared header ``csrc/*.cuh`` and of the compiler flags, so an edit
to a header that a kernel includes gives a new library path and never
loads a stale build. No ``nvcc`` is needed: nothing is compiled here.
"""

import os
import shutil

import pytest

from dtf_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of ``ops/csrc`` that ``_build`` reads instead of the real one."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", str(copy))
    return copy


def test_every_kernel_source_and_the_shared_header_are_in_csrc():
    names = set(os.listdir(_build.CSRC_DIR))
    assert {f"{n}.cu" for n in _build.KERNELS} <= names
    assert "hopper.cuh" in names


@pytest.mark.parametrize("name", _build.KERNELS)
def test_library_path_follows_the_header(csrc_copy, name):
    before = _build.library_path(name)
    assert os.path.dirname(before) == _build.BUILD_DIR
    assert os.path.basename(before).startswith(f"{name}-")
    with open(csrc_copy / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = _build.library_path(name)
    assert after != before
    # a new header counts as well, and the path is stable between calls
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path(name) not in (before, after)
    assert _build.library_path(name) == _build.library_path(name)


def test_library_path_ignores_other_kernels_and_non_headers(csrc_copy):
    before = _build.library_path("flash_fwd")
    with open(csrc_copy / "flash_bwd.cu", "a") as f:
        f.write("\n// edited\n")
    (csrc_copy / "notes.txt").write_text("not compiled\n")
    assert _build.library_path("flash_fwd") == before
    with open(csrc_copy / "flash_fwd.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path("flash_fwd") != before
