"""``chip_smoke.py``'s kernel list names real files: every kernel's CUDA
source exists in the repository, and every ``replaces`` entry (file:line)
points at the ``def`` of a Pallas TPU kernel of the JAX package, a function
that one of that file's ``pl.pallas_call`` launchers hands to the call.

The files are read as text and parsed, never imported."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _kernels() -> dict:
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "KERNELS" for t in node.targets
        ):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no KERNELS table")


def _pallas_kernel_names(tree: ast.Module) -> set:
    """Names used inside each function that calls ``pallas_call``: the
    kernel body it launches, bound directly or through functools.partial."""
    names = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        calls = [
            n for n in ast.walk(fn)
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "pallas_call"
        ]
        if calls:
            names |= {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
    return names


KERNELS = _kernels()


def test_the_table_covers_every_source_and_all_six_kernels() -> None:
    assert sorted(KERNELS) == sorted([
        "flash_fwd", "flash_dq", "flash_dkv", "quant_quantize", "quant_reduce",
        "quant_dequantize",
    ])
    sources = {source for source, _ in KERNELS.values()}
    on_disk = {str(p.relative_to(REPO)) for p in (REPO / "torchft_tpu_torch" / "csrc").glob("*.cu")}
    assert sources == on_disk
    # every flash kernel runs on its own Hopper source; the wmma one is gone
    assert KERNELS["flash_dkv"][0] == "torchft_tpu_torch/csrc/flash_dkv_sm90.cu"
    assert KERNELS["flash_dq"][0] == "torchft_tpu_torch/csrc/flash_dq_sm90.cu"
    assert "torchft_tpu_torch/csrc/flash_attention.cu" not in sources


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_source_exists_and_replaces_points_at_a_pallas_kernel_def(name) -> None:
    source, replaces = KERNELS[name]
    assert (REPO / source).is_file(), source
    path, line = replaces.rsplit(":", 1)
    assert path.startswith("torchft_tpu/"), replaces
    tree = ast.parse((REPO / path).read_text())
    defs = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.lineno == int(line)]
    assert defs, f"{replaces} is not the line of a def"
    kernel = defs[0].name
    assert kernel in _pallas_kernel_names(tree), f"{kernel} is not handed to a pallas_call"
    # the port's name and the TPU kernel's name agree: fwd -> _fwd_kernel
    assert kernel.removeprefix("_").removesuffix("_kernel") in name.replace("quantize", "quant")
