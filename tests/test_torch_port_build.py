"""PyTorch port: the nvcc build helper (no compiler is needed here)."""

import os

import pytest
import torch

from multimodalreactiongeneration_tpu_torch import _build

torch.set_num_threads(1)


def test_find_nvcc_uses_cuda_home_or_raises(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.find_nvcc() == str(fake)

    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "missing"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        assert _build.find_nvcc() == "/usr/local/cuda/bin/nvcc"
    else:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()


def test_library_name_follows_sources_and_headers(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._lib_path("k")
    assert first == _build._lib_path("k")
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build._lib_path("k")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert len({first, second, _build._lib_path("k")}) == 3
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"


def test_shipped_kernel_sources_exist():
    for name in ("mixer_stack", "decode_rollout"):
        assert (_build.CSRC / f"{name}.cu").is_file()


def test_a_variant_build_gets_a_library_and_a_compile_line_of_its_own(
        monkeypatch, tmp_path):
    """A measuring tool's -D build (K2's stamps) never replaces the
    library the wrappers load, and its compile line carries the define."""
    (tmp_path / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    plain, stamped = _build._lib_path("k"), _build._lib_path("k", ("S",))
    assert plain != stamped
    assert stamped == _build._lib_path("k", ("S",))
    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        open(out, "w").close()
        return type("P", (), {"returncode": 0, "stdout": "", "stderr": ""})

    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    assert _build.build("k", ("S",)) == stamped and stamped.is_file()
    assert "-DS" in calls[0] and not plain.exists()
    assert (tmp_path / "_build" / "k-S.log").is_file()
