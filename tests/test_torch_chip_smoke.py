"""``chip_smoke.py``'s kernel list names real files: every kernel's CUDA
source exists in the repository, and every ``replaces`` entry (file:line)
points at the ``def`` of a Pallas TPU kernel of the JAX package, a function
that one of that file's ``pl.pallas_call`` launchers hands to the call.
Its quant cases cover the main path's shapes and the wide window, and the
reduce's cold-L2 timing rotates over more bytes than the card's L2.

The kernel table and the JAX files are read as text and parsed; the cases
and the rotation come from importing ``chip_smoke.py``, which needs only
torch (no card) to import."""

import ast
import sys
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
    # the reduce runs on its own bulk-copy source, quantize and dequantize stay
    assert KERNELS["quant_reduce"][0] == "torchft_tpu_torch/csrc/quant_reduce_sm90.cu"
    assert KERNELS["quant_quantize"][0] == KERNELS["quant_dequantize"][0] == (
        "torchft_tpu_torch/csrc/quant.cu")


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def test_quant_cases_hold_the_main_path_and_the_wide_window(chip_smoke) -> None:
    cases = {c["name"]: c for c in chip_smoke.QUANT_CASES}
    assert set(cases) == {"main", "ragged", "w3", "nan_inf_zero", "wide"}
    assert (cases["main"]["w"], cases["main"]["rows"]) == (2, 2048)
    assert (cases["ragged"]["w"], cases["ragged"]["rows"]) == (2, 1040)
    # one window at TORCHFT_QUANT_WINDOW_MB=64 split over 2 ranks
    assert (cases["wide"]["w"], cases["wide"]["rows"]) == (2, 64 * 2**20 // 1024 // 2)
    bound_ms, bound_by = chip_smoke._quant_bound("reduce", cases["wide"])
    assert bound_by == "bytes" and bound_ms == pytest.approx(3 * 32768 * 1028 / 3.35e12 * 1e3)


@pytest.mark.parametrize("name", ["main", "ragged", "w3", "nan_inf_zero", "wide"])
def test_reduce_timing_rotates_past_the_l2(chip_smoke, name) -> None:
    case = next(c for c in chip_smoke.QUANT_CASES if c["name"] == name)
    sets, launches, nbytes = chip_smoke._rotation(case["w"], case["rows"])
    assert nbytes > chip_smoke.L2_BYTES == 50e6
    assert sets >= 2 and launches % sets == 0 and launches >= sets
    # every input set and every output is another buffer: one set is
    # inputs and an output of one launch
    assert nbytes == sets * (case["w"] + 1) * case["rows"] * 1028
    if name == "main":
        assert sets >= 9


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
