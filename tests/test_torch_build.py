"""The port's kernel build cache, on the CPU (no nvcc needed): a library's
path is a hash of its source, the headers beside it and the flags, so an
edit to any of them builds a new library and nothing stale is loaded."""

import pytest

from open_gpu_kernel_modules_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_text('#include "core.cuh"\nint k() { return f(); }\n')
    (tmp_path / "core.cuh").write_text("inline int f() { return 1; }\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edited", ["kern.cu", "core.cuh"])
def test_library_path_follows_source_and_headers(csrc, edited):
    before = _build.library_path("kern")
    assert _build.library_path("kern") == before       # stable when unchanged
    (csrc / edited).write_text((csrc / edited).read_text() + "// edit\n")
    after = _build.library_path("kern")
    assert after != before
    assert after.parent == _build.BUILD_DIR and after.name.startswith("kern-")


def test_library_path_follows_a_new_header(csrc):
    before = _build.library_path("kern")
    (csrc / "other.cuh").write_text("inline int g() { return 2; }\n")
    assert _build.library_path("kern") != before
