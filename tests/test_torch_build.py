"""The port's CUDA build cache: the library a source maps to changes with
the source, with every ``*.cuh`` header beside it and with nothing else,
and nvcc is given the source's directory as an include path. Runs on the
CPU (no nvcc is started)."""
import shutil
from pathlib import Path

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels._build import CudaLibrary

FLASH_DIR = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
             "kernels" / "flash_attention")


@pytest.fixture
def lib(tmp_path):
    """A library over copies of the backward source and the shared
    header in ``tmp_path``."""
    shutil.copy(FLASH_DIR / "flash_attention_bwd.cu", tmp_path)
    shutil.copy(FLASH_DIR / "hopper.cuh", tmp_path)
    return CudaLibrary("flash_bwd", tmp_path / "flash_attention_bwd.cu", {})


def test_path_is_stable(lib):
    assert lib.path() == lib.path()
    assert lib.path().parent == _build.BUILD_DIR
    assert lib.path().name.startswith("flash_bwd_")


@pytest.mark.parametrize("edit", ["append", "change_byte"])
def test_header_edit_changes_path(lib, edit):
    header = lib.source.with_name("hopper.cuh")
    before = lib.path()
    text = header.read_text()
    if edit == "append":
        header.write_text(text + "\n// one more line\n")
    else:
        header.write_text(text.replace("kNoEncodeFn = 100000",
                                       "kNoEncodeFn = 100002", 1))
        assert header.read_text() != text
    assert lib.path() != before
    header.write_text(text)
    assert lib.path() == before


def test_source_edit_changes_path(lib):
    before = lib.path()
    lib.source.write_text(lib.source.read_text() + "\n")
    assert lib.path() != before


def test_new_header_changes_path(lib):
    before = lib.path()
    lib.source.with_name("extra.cuh").write_text("#pragma once\n")
    assert lib.path() != before


def test_other_files_do_not_change_path(lib, tmp_path):
    before = lib.path()
    (tmp_path / "notes.txt").write_text("not a header")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "deeper.cuh").write_text("#pragma once\n")
    assert lib.path() == before


def test_nvcc_gets_the_source_directory(lib, tmp_path, monkeypatch):
    seen = {}

    class FakePopen:
        def __init__(self, cmd, **kwargs):
            seen["cmd"] = cmd

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakePopen)
    started = lib._start()
    assert started is not None
    cmd = seen["cmd"]
    at = cmd.index("-I")
    assert cmd[at + 1] == str(tmp_path)
    assert cmd[-1] == str(lib.source)


def test_shared_header_is_included_and_hashed(lib, tmp_path, monkeypatch):
    """``kernels/head_dims.cuh`` is on every source's include path and in
    its hash, and the wrappers' ``HEAD_DIMS`` is its list."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    assert lib._include_dirs() == [tmp_path, _build.KERNELS_DIR]
    assert _build.HEAD_DIMS == tuple(range(16, 193, 16))
    assert flash_attention.HEAD_DIMS == paged_attention.HEAD_DIMS \
        == _build.HEAD_DIMS
    shared = tmp_path / "kernels"
    shared.mkdir()
    (shared / "head_dims.cuh").write_text(
        (_build.KERNELS_DIR / "head_dims.cuh").read_text())
    monkeypatch.setattr(_build, "KERNELS_DIR", shared)
    before = lib.path()
    (shared / "head_dims.cuh").write_text("#pragma once\n")
    assert lib.path() != before
