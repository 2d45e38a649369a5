"""The kernels' build directory (radialog_tpu_torch/ops/_build.py), on the
CPU: no nvcc runs and nothing is built. The directory defaults to
build/kernels/ at the repository root, ``set_build_dir`` moves where the
libraries are built and loaded, and once a library is loaded (faked here)
another directory is refused: ctypes cannot unload a library."""
from pathlib import Path

import pytest

from radialog_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def restore():
    yield
    _build._loaded.clear()
    _build.set_build_dir(_build.DEFAULT_BUILD_DIR)


def test_default_is_build_kernels_at_the_repo_root():
    assert _build.DEFAULT_BUILD_DIR == REPO / "build" / "kernels"
    assert _build.library_path("q8_matmul").parent == REPO / "build" / "kernels"


@pytest.mark.parametrize("name", _build.KERNELS)
def test_library_path_lands_under_the_set_directory(tmp_path, restore, name):
    default = _build.library_path(name)
    _build.set_build_dir(tmp_path / "cold")
    got = _build.library_path(name)
    assert got.parent == (tmp_path / "cold").resolve()
    assert got.name == default.name and got.name.startswith(f"lib{name}-")
    assert not (tmp_path / "cold").exists()       # nothing is made before a build


def test_a_new_directory_after_a_load_raises(tmp_path, restore):
    _build.set_build_dir(tmp_path)
    _build._loaded["q8_matmul"] = object()        # as load() leaves it
    _build.set_build_dir(str(tmp_path))           # the same directory: allowed
    with pytest.raises(RuntimeError, match="already loaded"):
        _build.set_build_dir(tmp_path / "other")
    with pytest.raises(RuntimeError, match="already loaded"):
        _build.set_build_dir(_build.DEFAULT_BUILD_DIR)
    assert _build.library_path("q8_matmul").parent == tmp_path.resolve()
