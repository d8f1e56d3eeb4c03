"""The port's kernel build (``torchft_tpu_torch/ops/cuda_build.py``) keys
each shared library on everything that goes into it: the ``.cu`` source, the
shared ``csrc/*.cuh`` headers and the nvcc flags.  ``_artifact`` only hashes
files, so these tests need no ``nvcc`` and no card."""

from pathlib import Path

import pytest

from torchft_tpu_torch.ops import cuda_build


def _tree(root: Path, cu: str, headers: dict) -> Path:
    csrc = root / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "kern.cu").write_text(cu)
    for name, text in headers.items():
        (csrc / name).write_text(text)
    return csrc


def _artifact_name(monkeypatch, csrc: Path) -> str:
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    return cuda_build._artifact("kern").name


@pytest.mark.parametrize(
    "a,b,same",
    [
        # a header edit alone must not reuse a stale library
        (('#include "h.cuh"', {"h.cuh": "int x = 1;"}),
         ('#include "h.cuh"', {"h.cuh": "int x = 2;"}), False),
        # a header added beside the source changes the key too
        (("k", {}), ("k", {"h.cuh": ""}), False),
        # the same header text under another name is another input
        (("k", {"a.cuh": "t"}), ("k", {"b.cuh": "t"}), False),
        (("k", {"a.cuh": "1"}), ("j", {"a.cuh": "1"}), False),
        # equal trees give one name, whatever directory they sit in
        (("k", {"a.cuh": "1", "b.cuh": "2"}), ("k", {"b.cuh": "2", "a.cuh": "1"}), True),
    ],
    ids=["header-edit", "header-added", "header-renamed", "source-edit", "equal-trees"],
)
def test_artifact_is_keyed_on_source_and_headers(tmp_path, monkeypatch, a, b, same) -> None:
    name_a = _artifact_name(monkeypatch, _tree(tmp_path / "a", *a))
    name_b = _artifact_name(monkeypatch, _tree(tmp_path / "b", *b))
    assert name_a.startswith("kern-") and name_a.endswith(".so")
    assert (name_a == name_b) is same, (name_a, name_b)


def test_artifact_is_keyed_on_the_flags(tmp_path, monkeypatch) -> None:
    csrc = _tree(tmp_path, "k", {"h.cuh": "1"})
    before = _artifact_name(monkeypatch, csrc)
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build._artifact("kern").name != before


def test_every_repo_source_builds_under_its_own_key() -> None:
    """The port's sources hash to distinct names in the build directory."""
    names = sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    assert set(names) == {"flash_fwd_sm90", "flash_dkv_sm90", "flash_dq_sm90", "quant",
                          "quant_reduce_sm90"}
    artifacts = {cuda_build._artifact(n) for n in names}
    assert len(artifacts) == len(names)
    assert all(a.parent == cuda_build.BUILD_DIR for a in artifacts)
