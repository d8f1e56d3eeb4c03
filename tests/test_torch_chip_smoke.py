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


def test_four_train_phases_name_their_tier(chip_smoke) -> None:
    """Float and quantized, each on the C++ tier and on the Python tier;
    every phase names its tier (never ``auto``, which falls back quietly)."""
    phases = [(q, t) for _, q, t in chip_smoke.TRAIN_PHASES]
    assert sorted(phases) == [(False, "cpp"), (False, "python"), (True, "cpp"), (True, "python")]
    assert len({key for key, _, _ in chip_smoke.TRAIN_PHASES}) == 4
    assert chip_smoke.PLANES["cpp"] == dict(
        lighthouse="CppLighthouseServer", manager_server="CppManagerServer",
        communicator="CppCommunicator")
    assert chip_smoke.PLANES["python"] == dict(
        lighthouse="LighthouseServer", manager_server="ManagerServer",
        communicator="TCPCommunicator")
    source = (REPO / "chip_smoke.py").read_text()
    assert "tier=tier" in source and '"auto"' not in source


@pytest.mark.parametrize("name", [
    "manager::quorum_rpc", "comm::op", "manager::fence", "manager::should_commit"])
def test_split_reads_spans_that_the_port_records(chip_smoke, name) -> None:
    """Each span of the ``commit`` split is one the port records (and the
    JAX package too: the split adds no span of its own)."""
    assert name in chip_smoke.SPLIT_SPANS
    needle = f'obs_span("{name}"'
    assert needle in "".join(
        p.read_text() for p in (REPO / "torchft_tpu_torch").rglob("*.py"))
    assert needle in "".join(p.read_text() for p in (REPO / "torchft_tpu").rglob("*.py"))


def test_commit_split_sums_each_window_per_replica(chip_smoke) -> None:
    spans = [
        {"name": "comm::op", "t": 1.0, "dur": 0.4},
        {"name": "comm::op", "t": 1.5, "dur": 0.2},
        {"name": "manager::fence", "t": 1.9, "dur": 1.0},
        {"name": "manager::should_commit", "t": 2.5, "dur": 0.1},
        {"name": "comm::rendezvous", "t": 1.1, "dur": 5.0},  # not in the split
    ]
    rows = chip_smoke.commit_split(spans, [(1.0, 2.0), (2.0, 3.0)], replicas=2)
    assert rows[0] == pytest.approx({"manager::quorum_rpc": 0.0, "comm::op": 0.3,
                                     "manager::fence": 0.5, "manager::should_commit": 0.0})
    assert rows[1] == pytest.approx({"manager::quorum_rpc": 0.0, "comm::op": 0.0,
                                     "manager::fence": 0.0, "manager::should_commit": 0.05})


def test_cross_tier_hash_check(chip_smoke) -> None:
    results = {key: {"params_sha256": ("q" if quantized else "f")}
               for key, quantized, _ in chip_smoke.TRAIN_PHASES}
    assert chip_smoke.check_cross_tier(results) == {
        "float": {"cpp": "f", "python": "f"}, "quantized": {"cpp": "q", "python": "q"}}
    results["train_quantized_python"] = {"params_sha256": "other"}
    with pytest.raises(AssertionError, match="quantized sync"):
        chip_smoke.check_cross_tier(results)


def test_diloco_phases_are_bench_phase_d_and_its_twins(chip_smoke) -> None:
    """The three DiLoCo / LocalSGD phases: bench.py's phase D schedule
    (sync_every 8, 2 fragments, delay 2) with a kill, float and int8, and
    LocalSGD; every keyword is one ``run_diloco_fleet`` takes, and the tier
    is named by the phase runner, never resolved."""
    import inspect

    from torchft_tpu_torch import train_diloco

    params = inspect.signature(train_diloco.run_diloco_fleet).parameters
    phases = dict(chip_smoke.DILOCO_PHASES)
    assert list(phases) == ["diloco_cpp", "diloco_quantized_cpp", "localsgd_cpp"]
    for fleet in phases.values():
        assert set(fleet) <= set(params) and "tier" not in fleet
    for key in ("diloco_cpp", "diloco_quantized_cpp"):
        fleet = phases[key]
        assert (fleet["sync_every"], fleet["num_fragments"], fleet["fragment_sync_delay"],
                fleet["outer_steps"], fleet["kill_at"]) == (8, 2, 2, 4, (1, 5))
        assert fleet["should_quantize"] == (key == "diloco_quantized_cpp")
    assert phases["localsgd_cpp"]["algo"] == "localsgd" and "kill_at" not in phases["localsgd_cpp"]
    assert 'tier="cpp", **fleet' in (REPO / "chip_smoke.py").read_text()


def test_host_rss_sampler_reads_this_process(chip_smoke) -> None:
    import time

    import numpy as np

    with chip_smoke.HostRss() as rss:
        block = np.ones(64 << 20, dtype=np.uint8)  # 64 MiB, touched
        time.sleep(0.5)
    assert rss.peak_bytes >= rss.start_bytes + block.nbytes // 2 and rss.start_bytes > 0
