"""The port's kernel build names each library by a hash of what goes into
it: the kernel's source, every shared header of csrc (csrc/*.cuh) and the
nvcc flags.  An edited header must give a new library path, or a build
would load a stale library compiled from the old header.  CPU only: no
nvcc is run."""
import shutil

import pytest

from repro_torch.kernels import build

HEADER = "mma_bf16.cuh"


@pytest.fixture
def csrc(tmp_path):
    """A temporary copy of the kernel sources."""
    return shutil.copytree(build.CSRC, tmp_path / "csrc")


def test_every_kernel_source_and_the_shared_header_exist():
    for name in build.SIGNATURES:
        assert (build.CSRC / f"{name}.cu").is_file(), name
    assert (build.CSRC / HEADER).is_file()


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_a_copy_of_the_sources_gives_the_same_path(csrc, name):
    assert build.library_path(name, csrc) == build.library_path(name)


@pytest.mark.parametrize("name", ["flash_attention", "flash_backward",
                                  "paged_decode"])
def test_editing_a_header_changes_the_path(csrc, name):
    before = build.library_path(name, csrc)
    header = csrc / HEADER
    header.write_text(header.read_text() + "\n// edited\n")
    after = build.library_path(name, csrc)
    assert after != before
    assert after.parent == before.parent == build.BUILD_DIR
    assert after.name.startswith(f"lib{name}-")


def test_a_new_header_changes_the_path(csrc):
    before = build.library_path("flash_backward", csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("flash_backward", csrc) != before


def test_editing_a_source_changes_only_its_own_path(csrc):
    fa, fb = (build.library_path(n, csrc)
              for n in ("flash_attention", "flash_backward"))
    src = csrc / "flash_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path("flash_attention", csrc) != fa
    assert build.library_path("flash_backward", csrc) == fb
