"""``chip_smoke.py``'s kernel list names real files: every kernel's CUDA
source exists in the repository, and every ``replaces`` entry (file:line)
points at the ``def`` of a Pallas TPU kernel of the JAX package, a function
that one of that file's ``pl.pallas_call`` launchers hands to the call.
Its quant cases cover the main path's shapes and the wide window, and the
reduce's cold-L2 timing rotates over more bytes than the card's L2.  The
ring phase's launch arithmetic and checks run on the CPU at a small S (the
plain versions), and each train phase names its heal transport.

The kernel table and the JAX files are read as text and parsed; the cases
and the rotation come from importing ``chip_smoke.py``, which needs only
torch (no card) to import."""

import ast
import math
import os
import sys
import time
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


def _port_kernels() -> dict:
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "PORT_KERNELS" for t in node.targets
        ):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no PORT_KERNELS table")


def test_the_table_covers_every_source_and_all_six_kernels() -> None:
    """The six TPU kernels, and beside them the port's own kernel (the AVG
    divide on the card, which replaces host code): together every CUDA
    source on disk."""
    assert sorted(KERNELS) == sorted([
        "flash_fwd", "flash_dq", "flash_dkv", "quant_quantize", "quant_reduce",
        "quant_dequantize",
    ])
    sources = {source for source, _ in KERNELS.values()}
    port_sources = {source for source, _ in _port_kernels().values()}
    on_disk = {str(p.relative_to(REPO)) for p in (REPO / "torchft_tpu_torch" / "csrc").glob("*.cu")}
    assert sources | port_sources == on_disk and not sources & port_sources
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
    """Float and quantized, each on the C++ tier and on the Python tier
    (``train_quantized_python`` runs again); every phase names its tier
    (never ``auto``, which falls back quietly)."""
    phases = [(q, t) for _, q, t in chip_smoke.TRAIN_PHASES]
    assert sorted(phases) == [(False, "cpp"), (False, "python"), (True, "cpp"), (True, "python")]
    assert len({key for key, _, _ in chip_smoke.TRAIN_PHASES}) == 4
    assert ("train_quantized_python", True, "python") in chip_smoke.TRAIN_PHASES
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


@pytest.mark.parametrize("name", [
    "ddp::quorum_wait", "ddp::stage", "ddp::submit", "quant::pipeline", "quant::dequantize",
    "manager::avg", "ddp::gather", "ddp::copy_back"])
def test_host_tail_spans_are_recorded_by_the_port(chip_smoke, name) -> None:
    """Each span of the host tail's split is one the port records, and the
    train phases print it per phase beside :data:`SPLIT_SPANS`."""
    assert name in chip_smoke.HOST_SPANS
    assert f'obs_span("{name}"' in "".join(
        p.read_text() for p in (REPO / "torchft_tpu_torch").rglob("*.py"))
    source = (REPO / "chip_smoke.py").read_text()
    assert "SPLIT_SPANS + HOST_SPANS" in source
    assert "host_split_ms_median_last3" in source and "unspanned_ms_median_last3" in source


@pytest.mark.parametrize("name", [
    "diloco::host_copy", "diloco::reshard", "diloco::pseudograd", "diloco::apply",
    "diloco::write", "outer_shard::pipeline"])
def test_diloco_split_spans_are_recorded_by_the_port(chip_smoke, name) -> None:
    """The DiLoCo outer sync's split reads spans the port records; the
    DiLoCo phases print it per committed sync."""
    assert name in chip_smoke.DILOCO_SPANS
    assert f'obs_span("{name}"' in "".join(
        p.read_text() for p in (REPO / "torchft_tpu_torch").rglob("*.py"))
    assert "spans=spans" in (REPO / "chip_smoke.py").read_text()


@pytest.mark.parametrize("quantized", [False, True])
def test_unspanned_time_is_what_no_span_covers(chip_smoke, quantized) -> None:
    """Outside compute, an iteration's seconds less the train thread's
    spans, plus the part of the fence its pipeline's spans leave bare;
    a pipeline longer than the fence (spans on threads that overlap) adds
    nothing."""
    row = dict.fromkeys(chip_smoke.SPLIT_SPANS + chip_smoke.HOST_SPANS, 0.0)
    row.update({"ddp::stage": 1.0, "ddp::submit": 0.25, "manager::fence": 4.0,
                "manager::should_commit": 0.25, "manager::avg": 1.0, "ddp::copy_back": 0.5})
    row["quant::pipeline" if quantized else "comm::op"] = 2.0
    phase = {"compute": 0.3, "allreduce": 1.5, "commit": 4.5}
    # 6.0 outside compute - 5.5 on the train thread + 0.5 of the fence bare
    assert chip_smoke.unspanned_s(phase, row, quantized) == pytest.approx(1.0)
    row["manager::avg"] = 3.0
    assert chip_smoke.unspanned_s(phase, row, quantized) == pytest.approx(0.5)


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
    """Each sync's pair is held across the tiers: float and quantized."""
    results = {key: {"params_sha256": ("q" if quantized else "f")}
               for key, quantized, _ in chip_smoke.TRAIN_PHASES}
    assert chip_smoke.check_cross_tier(results) == {
        "float": {"cpp": "f", "python": "f"}, "quantized": {"cpp": "q", "python": "q"}}
    results["train_python"] = {"params_sha256": "other"}
    with pytest.raises(AssertionError, match="float sync"):
        chip_smoke.check_cross_tier(results)
    results["train_python"] = {"params_sha256": "f"}
    results["train_quantized_python"] = {"params_sha256": "other"}
    with pytest.raises(AssertionError, match="quantized sync"):
        chip_smoke.check_cross_tier(results)


def test_diloco_phases_are_bench_phase_d_and_its_twins(chip_smoke) -> None:
    """The DiLoCo / LocalSGD phases: bench.py's phase D schedule (sync_every
    8, 2 fragments, delay 2) with a kill, the same streamed with its kill
    between a submit and its barrier, the same over the int8 wire (its 3
    outer steps, its kill and its heal over HTTP driven again), and
    LocalSGD; every keyword is one
    ``run_diloco_fleet`` takes, and the tier is named by the phase runner,
    never resolved."""
    import inspect

    from torchft_tpu_torch import train_diloco

    params = inspect.signature(train_diloco.run_diloco_fleet).parameters
    phases = dict(chip_smoke.DILOCO_PHASES)
    assert list(phases) == ["diloco_cpp", "diloco_stream_cpp", "diloco_quantized_cpp",
                            "localsgd_cpp"]
    for fleet in phases.values():
        assert set(fleet) <= set(params) and "tier" not in fleet
    for key in ("diloco_cpp", "diloco_stream_cpp"):
        fleet = phases[key]
        assert (fleet["sync_every"], fleet["num_fragments"], fleet["fragment_sync_delay"],
                fleet["outer_steps"], fleet["should_quantize"]) == (8, 2, 2, 3, False)
    assert phases["diloco_cpp"]["kill_at"] == (1, 5)
    assert phases["diloco_stream_cpp"]["kill_at"] == chip_smoke.STREAM_KILL_AT
    quantized = phases["diloco_quantized_cpp"]
    assert (quantized["sync_every"], quantized["num_fragments"], quantized["fragment_sync_delay"],
            quantized["outer_steps"], quantized["kill_at"], quantized["should_quantize"]) == (
                8, 2, 2, 3, (1, 5), True)
    assert quantized == dict(phases["diloco_cpp"], should_quantize=True)
    assert chip_smoke.DILOCO_ENV == {"diloco_stream_cpp": {"TORCHFT_STREAM_SYNC": "1"}}
    assert phases["localsgd_cpp"]["algo"] == "localsgd" and "kill_at" not in phases["localsgd_cpp"]
    assert 'tier="cpp", **fleet' in (REPO / "chip_smoke.py").read_text()


def test_post_heal_sync_check_needs_every_fragment(chip_smoke) -> None:
    """The restarted replica's commits after its heal must cover every
    fragment: at 3 outer steps it syncs fragments 1 and 0, at 2 only 1; a
    decision that did not commit synced nothing."""
    from types import SimpleNamespace

    healed = SimpleNamespace(sync_decisions=[(1, True), (2, True)])
    assert chip_smoke.check_post_heal_syncs(healed, 2) == [1, 0]
    with pytest.raises(AssertionError, match=r"synced fragments \[1\], not all 2"):
        chip_smoke.check_post_heal_syncs(SimpleNamespace(sync_decisions=[(1, True)]), 2)
    with pytest.raises(AssertionError, match=r"synced fragments \[1\], not all 2"):
        chip_smoke.check_post_heal_syncs(
            SimpleNamespace(sync_decisions=[(1, True), (2, False)]), 2)


@pytest.mark.parametrize("killed, restarts, heal, fragment_heals, match", [
    (True, [0, 1], 11_519_880_848, [1, 1], None),
    (False, [0, 0], None, [0, 0], None),
    (True, [0, 0], 11_519_880_848, [1, 1], "expected \\[0, 1\\]"),
    (True, [0, 1], None, [0, 0], "no fragment state"),
    (True, [0, 1], 11_519_880_848, [1, 0], "no fragment state"),
    (False, [0, 1], None, [0, 0], "expected \\[0, 0\\]"),
    (False, [0, 0], 4096, [1, 0], "without a kill"),
])
def test_restart_check_with_and_without_a_kill(chip_smoke, killed, restarts, heal,
                                               fragment_heals, match) -> None:
    """A DiLoCo fleet with a kill restarts replica 1 once and heals its
    fragments; ``diloco_quantized_cpp``, without one, restarts and heals
    nothing."""
    from types import SimpleNamespace

    healed = None if heal is None else SimpleNamespace(bytes_total=heal)
    results = [SimpleNamespace(restarts=restarts[0], heal=None, fragment_heals=[0, 0]),
               SimpleNamespace(restarts=restarts[1], heal=healed, fragment_heals=fragment_heals)]
    if match is None:
        assert chip_smoke.check_restarts(results, killed) is healed
    else:
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_restarts(results, killed)


@pytest.mark.parametrize("decisions, shas, match", [
    ([(0, True), (1, True)], [("s0", "s1"), ("s0", "s1")], None),
    ([(0, True)], [("s0", "i1"), ("s0", "i1")], None),
    ([(0, True), (1, False)], [("s0", "i1"), ("s0", "i1")], None),
    ([(0, True)], [("s0", "i1"), ("s0", "x1")], "backups differ"),
    ([(0, True), (1, True)], [("s0", "i1"), ("s0", "i1")], "still the initial"),
    ([(0, True)], [("s0", "s1"), ("s0", "s1")], "never synced"),
])
def test_backup_check_follows_the_synced_fragments(chip_smoke, decisions, shas, match) -> None:
    """A fragment whose sync committed moved from the initial weights; one
    never synced (``diloco_quantized_cpp`` ends after fragment 0's sync)
    still holds them; backups are equal across replicas."""
    from types import SimpleNamespace

    results = [SimpleNamespace(sync_decisions=decisions, fragment_sha256=list(sha),
                               initial_fragment_sha256=["i0", "i1"]) for sha in shas]
    if match is None:
        chip_smoke.check_backups(results, 2)
    else:
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_backups(results, 2)


@pytest.mark.parametrize("tier", ["cpp", "python"])
def test_quantized_diloco_fleet_passes_its_checks_on_the_cpu(chip_smoke, tier) -> None:
    """``diloco_quantized_cpp``'s fleet at ``llama_debug`` size: 3
    committed int8 outer steps with replica 1 killed and healed over HTTP
    pass the card phase's checks (one restart, a heal carrying fragment
    state, every fragment synced after it; backups moved and equal; the
    fragment synced last equal live).  The C++ tier skips only where the
    native library does not build."""
    import torch

    from torchft_tpu_torch import native, train_ddp, train_diloco

    if tier == "cpp" and not native.available():
        pytest.skip(f"the port's native library does not build: {native._lib_error}")
    fleet = dict(chip_smoke.DILOCO_PHASES)["diloco_quantized_cpp"]
    results = train_diloco.run_diloco_fleet(
        train_ddp.model_config("llama_debug"), torch.device("cpu"), replicas=2, batch=2,
        seq=128, lr=1e-3, timeout=30.0, tier=tier, **fleet)
    assert [r.final_step for r in results] == [3, 3]
    assert chip_smoke.check_restarts(results, killed=True) is results[1].heal
    assert chip_smoke.check_post_heal_syncs(results[1], fleet["num_fragments"]) == [1, 0]
    chip_smoke.check_backups(results, fleet["num_fragments"])
    last = (results[0].final_step - 1) % fleet["num_fragments"]
    assert results[0].fragment_live_sha256[last] == results[1].fragment_live_sha256[last]


def test_host_rss_sampler_reads_this_process(chip_smoke) -> None:
    import time

    import numpy as np

    with chip_smoke.HostRss() as rss:
        block = np.ones(64 << 20, dtype=np.uint8)  # 64 MiB, touched
        time.sleep(0.5)
    assert rss.peak_bytes >= rss.start_bytes + block.nbytes // 2 and rss.start_bytes > 0


def test_cnn_and_hsdp_phases_take_their_entry_points_keywords(chip_smoke) -> None:
    """``cnn_cpp`` is ``train_ddp --model cnn`` at the example's defaults,
    ``hsdp_cpp`` is ``train_hsdp`` at 2 groups of one rank (fsdp = tp = 1),
    3 steps (4 before the fleet phases joined), group 1 killed before step
    2; both on the named C++ tier."""
    import inspect

    from torchft_tpu_torch import train_ddp, train_hsdp

    assert set(chip_smoke.CNN_PHASE) <= set(inspect.signature(train_ddp.run_fleet).parameters)
    assert set(chip_smoke.HSDP_PHASE) <= set(
        inspect.signature(train_hsdp.run_hsdp_fleet).parameters)
    assert chip_smoke.CNN_PHASE == dict(replicas=2, steps=20, batch=32, lr=1e-3, kill_at=(1, 5))
    assert chip_smoke.HSDP_PHASE == dict(groups=2, fsdp=1, tp=1, steps=3, batch=1, seq=2048,
                                         lr=1e-4, kill_at=(1, 2))
    source = (REPO / "chip_smoke.py").read_text()
    for key in ("cnn_cpp", "hsdp_cpp"):
        assert f'results["{key}"] = t = ' in source
    assert 'train_ddp.CNNConfig(), torch.device("cuda"), tier="cpp"' in source
    assert 'torch.device("cuda"), tier="cpp", timeout=' in source


def _cnn_results(change=None):
    from types import SimpleNamespace

    from torchft_tpu_torch.observability import HealMetrics

    def one(restarts, heal):
        return SimpleNamespace(losses=[5.0, 4.0, 3.0, 2.5, 2.4, 2.3], final_step=6,
                               restarts=restarts, heal=heal, params_sha256="h")

    results = [one(0, None), one(1, HealMetrics(bytes_total=100))]
    for (i, name), value in (change or {}).items():
        setattr(results[i], name, value)
    return results


@pytest.mark.parametrize("change, match", [
    ({(0, "losses"): [5.0, float("nan"), 3.0, 2.0, 2.0, 2.0]}, "non-finite"),
    ({(1, "final_step"): 5}, "ended at step"),
    ({(0, "losses"): [2.0, 2.0, 2.0, 2.5, 2.5, 2.5]}, "did not fall"),
    ({(1, "restarts"): 0}, "restarts"),
    ({(1, "heal"): None}, "no heal"),
    ({(1, "params_sha256"): "other"}, "diverged"),
])
def test_cnn_checks_raise_on_failure(chip_smoke, change, match) -> None:
    chip_smoke.check_cnn(_cnn_results(), 6)
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_cnn(_cnn_results(change), 6)


def _hsdp_fleet():
    def rank(group, incarnation, heal):
        return dict(group=group, rank=0, incarnation=incarnation, losses=[12.2, 12.1],
                    final_step=4, grad_is_dtensor=True, params_sha256="h", heal=heal,
                    launches=dict(fwd=8, dq=8, dkv=8))

    return [[rank(0, 0, None)], [rank(1, 1, dict(bytes=10, seconds=1.0))]]


@pytest.mark.parametrize("group, key, value, match", [
    (0, "losses", [float("inf")], "non-finite"),
    (1, "final_step", 3, "ended at step"),
    (0, "grad_is_dtensor", False, "not a DTensor"),
    (1, "launches", dict(fwd=3, dq=0, dkv=3), "kernel dq never launched"),
    (1, "incarnation", 0, "restarts"),
    (1, "heal", None, "no heal"),
    (1, "params_sha256", "other", "diverged"),
])
def test_hsdp_checks_raise_on_failure(chip_smoke, group, key, value, match) -> None:
    chip_smoke.check_hsdp(_hsdp_fleet(), 4)
    fleet = _hsdp_fleet()
    fleet[group][0][key] = value
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_hsdp(fleet, 4)


def test_kernels_line_lists_six_and_the_last_line_is_the_contract() -> None:
    """The kernels line still carries every kernel of the table, and the
    last line printed is ``{"ok": true, "device": {platform, kind, count}}``
    after the card's own nvidia-smi line."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    prints = [n for n in ast.walk(main) if isinstance(n, ast.Call)
              and getattr(n.func, "id", "") == "print"]
    prints.sort(key=lambda n: n.lineno)
    last, before = ast.unparse(prints[-1]), ast.unparse(prints[-2])
    assert last == "print(json.dumps({'ok': True, 'device': device}), flush=True)"
    assert before.startswith("print(card")
    assert ast.unparse(prints[-3]) == "print(json.dumps(line), flush=True)"
    source = ast.unparse(main)
    assert "'platform': 'gpu', 'kind': torch.cuda.get_device_name(0)" in source
    assert "'count': torch.cuda.device_count()" in source
    for names in ("('fwd', 'dq', 'dkv')", "('quantize', 'reduce', 'dequantize')"):
        assert names in source


def test_ring_launch_arithmetic(chip_smoke) -> None:
    """sp = 4: each rank attends its diagonal block causally and every
    earlier block fully, 4 causal and 6 full forwards, and each block's
    backward launches dq and dkv once."""
    want = {"causal": 4, "full": 6}
    assert chip_smoke.ring_launches_expected(4) == {"fwd": want, "dq": want, "dkv": want}
    assert chip_smoke.ring_launches_expected(2) == {
        name: {"causal": 2, "full": 1} for name in ("fwd", "dq", "dkv")}
    total = dict(fwd=10, dq=10, dkv=10)
    assert chip_smoke.check_ring_launches(total, dict(fwd=4, dq=4, dkv=4), 4)["dq"] == want
    with pytest.raises(AssertionError, match="ring launches"):
        chip_smoke.check_ring_launches(total, dict(fwd=4, dq=4, dkv=3), 4)
    with pytest.raises(AssertionError, match="ring launches"):
        chip_smoke.check_ring_launches(dict(total, fwd=16), dict(fwd=4, dq=4, dkv=4), 4)
    assert chip_smoke.RING_CASE == dict(B=1, S=8192, H=32, KV=8, D=128, sp=4)


RING_SMALL = dict(B=1, S=512, H=4, KV=2, D=64, sp=4)


def test_ring_check_on_the_plain_versions(chip_smoke) -> None:
    """``ring_phase``'s checks on the CPU at a small S (the wrappers take
    the plain versions for CPU tensors, so nothing launches): the ring
    equals the plain ring and lies within the ring tolerance of
    whole-sequence flash."""
    import torch

    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel import ring_attention as ring

    out = chip_smoke.ring_check(fa, ring, RING_SMALL, torch.device("cpu"))
    assert out["launches"] == {"fwd": 0, "dq": 0, "dkv": 0} and out["peak_device_gb"] is None
    assert out["max_abs_err"] == 0.0
    assert all(e["ok"] and e["norm_rel"] < 1e-2 for e in out["vs_whole"].values())


def test_ragged_ring_case_and_its_plain_ring(chip_smoke, monkeypatch) -> None:
    """The ragged ring case's blocks, and the card gate check's lengths,
    are lengths the CPU's flash gate refuses even when forced (640 tokens
    is not a multiple of 512), and the plain ring that
    holds the card's ring there tiles such blocks: at 160-token blocks it
    equals the online-softmax ring within 1e-5 (f32, the CPU)."""
    import torch

    from torchft_tpu_torch.models.llama import use_flash
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel import ring_attention as ring

    case = chip_smoke.RING_RAGGED_CASE
    blk = case["S"] // case["sp"]
    assert blk == 640 and {k: case[k] for k in ("H", "KV", "D")} == dict(H=32, KV=8, D=128)
    monkeypatch.setenv("TORCHFT_FLASH", "1")
    for seq in (blk, *chip_smoke.GATE_SEQS):
        assert not use_flash(seq, torch.device("cpu")) and use_flash(seq, torch.device("cuda"))
    gen = torch.Generator().manual_seed(0)
    sp, S = 4, 640
    q, do = (torch.randn(1, S, 4, 64, generator=gen) for _ in range(2))
    k, v = (torch.randn(1, S, 2, 64, generator=gen) for _ in range(2))
    got = chip_smoke._ring_run(ring, q, k, v, do, sp, chip_smoke.plain_attend(fa))
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    qs, ks, vs = (t.chunk(sp, dim=1) for t in (qa, ka, va))
    o = torch.cat([ring.ring_local(qs[r], lambda t, r=r: (ks[(r - t) % sp], vs[(r - t) % sp]), r, sp)
                   for r in range(sp)], dim=1)
    want = (o.detach(), *torch.autograd.grad(o, (qa, ka, va), do))
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)


def test_ring_check_fails_a_ring_that_drops_the_earlier_blocks(chip_smoke, monkeypatch) -> None:
    import torch

    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel import ring_attention as ring

    monkeypatch.setattr(ring, "block_kind", lambda my, src: "causal" if my == src else "skip")
    with pytest.raises(AssertionError, match="disagree with whole-sequence flash"):
        chip_smoke.ring_check(fa, ring, RING_SMALL, torch.device("cpu"))


def test_heal_transport_of_each_phase(chip_smoke) -> None:
    """The float DDP phases and hsdp_cpp heal over the communicator, the
    quantized phase over HTTP (one run holds both on the same state); the
    entry points take the keyword."""
    import inspect

    from torchft_tpu_torch import train_ddp, train_hsdp

    assert set(chip_smoke.TRAIN_HEAL_TRANSPORT) == {key for key, _, _ in chip_smoke.TRAIN_PHASES}
    for key, quantized, _tier in chip_smoke.TRAIN_PHASES:
        assert chip_smoke.TRAIN_HEAL_TRANSPORT[key] == ("http" if quantized else "comm")
    assert chip_smoke.HSDP_HEAL_TRANSPORT == "comm"
    assert "heal_transport" in inspect.signature(train_ddp.run_fleet).parameters
    assert "heal_transport" in inspect.signature(train_hsdp.run_hsdp_fleet).parameters
    source = (REPO / "chip_smoke.py").read_text()
    assert "TRAIN_HEAL_TRANSPORT[key])" in source and "heal_transport=HSDP_HEAL_TRANSPORT" in source


@pytest.mark.parametrize("transport, nbytes, match", [
    ("comm", 99, "over comm"),
    ("comm", 101, "over comm"),
    ("http", 100, "over HTTP"),
    ("comm", 0, "no heal"),
    ("http", None, "no heal"),
])
def test_heal_check_needs_the_whole_state(chip_smoke, transport, nbytes, match) -> None:
    chip_smoke.check_heal(100, 100, "comm", "r")
    chip_smoke.check_heal(130, 100, "http", "r")
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_heal(nbytes, 100, transport, "r")


def test_int8_phases_train_three_groups_and_heal_striped_on_the_python_tier(chip_smoke) -> None:
    """The int8 phases train three groups, so the Python tier's kill heals
    from the two others; the C++ sidecar advertises one source; the float
    phases keep two groups and one source; the main loop passes both."""
    keys = {key for key, _, _ in chip_smoke.TRAIN_PHASES}
    assert set(chip_smoke.TRAIN_REPLICAS) == set(chip_smoke.TRAIN_HEAL_SOURCES) == keys
    for key, quantized, _tier in chip_smoke.TRAIN_PHASES:
        assert chip_smoke.TRAIN_REPLICAS[key] == (3 if quantized else 2)
    assert chip_smoke.TRAIN_HEAL_SOURCES == {"train_cpp": 1, "train_python": 1,
                                             "train_quantized_cpp": 1,
                                             "train_quantized_python": 2}
    source = (REPO / "chip_smoke.py").read_text()
    assert "replicas=TRAIN_REPLICAS[key]" in source and "sources=TRAIN_HEAL_SOURCES[key]" in source
    assert "check_heal_sources(heal, sources" in source


def _heal(**change):
    from torchft_tpu_torch.observability import HealMetrics

    return HealMetrics(**{**dict(num_sources=2, bytes_total=100,
                                 per_source_bytes={"a": 60, "b": 40}), **change})


@pytest.mark.parametrize("change, sources, match", [
    ({}, 1, "from 2 sources"),
    (dict(num_sources=1, per_source_bytes={"a": 100}), 2, "from 1 sources"),
    (dict(per_source_bytes={"a": 100}), 2, "from 2 sources"),
    (dict(per_source_bytes={"a": 100, "b": 0}), 2, "served no bytes"),
    (dict(per_source_bytes={"a": 60, "b": 39}), 2, "the sources served 99 bytes"),
    (dict(failed_sources=["b"]), 2, "failed"),
    (dict(stolen_chunks=1), 2, "1 chunks stolen"),
], ids=["too_many", "too_few", "one_served", "zero_bytes", "short_sum", "failed", "stolen"])
def test_heal_source_check_raises_on_failure(chip_smoke, change, sources, match) -> None:
    chip_smoke.check_heal_sources(_heal(), 2, "r")
    chip_smoke.check_heal_sources(_heal(num_sources=1, per_source_bytes={"a": 100}), 1, "r")
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_heal_sources(_heal(**change), sources, "r")
    with pytest.raises(AssertionError, match="recorded no heal"):
        chip_smoke.check_heal_sources(None, sources, "r")


@pytest.mark.parametrize("key", ["train_quantized_cpp", "train_quantized_python"])
def test_int8_phase_heal_checks_pass_on_a_cpu_fleet(chip_smoke, monkeypatch, key) -> None:
    """The int8 phases' fleet on the CPU at ``llama_debug`` size, each with
    its tier, group count and HTTP heal: replica 1's heal passes the
    phase's checks (the whole state, from the phase's sources)."""
    import torch

    from torchft_tpu_torch import train_ddp

    monkeypatch.setenv("TORCHFT_HEAL_CHUNK_MB", "0.0625")  # many chunks of a small state
    tier = dict((k, t) for k, _, t in chip_smoke.TRAIN_PHASES)[key]
    results = train_ddp.run_fleet(
        train_ddp.model_config("llama_debug"), torch.device("cpu"),
        replicas=chip_smoke.TRAIN_REPLICAS[key], steps=chip_smoke.STEPS, seq=64, batch=2,
        lr=1e-3, kill_at=(1, 2), timeout=60.0, should_quantize=True, tier=tier,
        heal_transport=chip_smoke.TRAIN_HEAL_TRANSPORT[key])
    heal = results[1].heal
    chip_smoke.check_heal(heal.bytes_total, results[1].state_bytes, "http", "replica 1")
    chip_smoke.check_heal_sources(heal, chip_smoke.TRAIN_HEAL_SOURCES[key], "replica 1")
    assert len({r.params_sha256 for r in results}) == 1


def test_expected_hashes_are_held(chip_smoke) -> None:
    """The card's hashes at 3 steps (c894c076, fd116fce, 8dcd35ec at 4; the
    int8 sync at two groups 54b70f3a, at three 73db8d6f)."""
    expected = chip_smoke.EXPECTED_SHA256
    assert expected["float"].startswith("963bb689") and expected["quantized"].startswith("73db8d6f")
    assert expected["hsdp"].startswith("c93b8cb0") and all(len(h) == 64 for h in expected.values())
    chip_smoke.check_expected_hashes(dict(expected))
    with pytest.raises(AssertionError, match="float: final parameter sha256"):
        chip_smoke.check_expected_hashes({"float": expected["quantized"]})


def test_spare_phases_take_their_entry_points_keywords(chip_smoke) -> None:
    """``spare_python`` is DILOCO's schedule to 2 committed outer steps
    (3 before the fleet phases joined) with one spare on the Python tier;
    the delta fleet of ``spare_drills`` is a Llama at head dim 64, bf16,
    killed after a committed sync; both run ``run_diloco_fleet``."""
    import inspect

    import torch

    from torchft_tpu_torch import train_diloco
    from torchft_tpu_torch.models.llama import LlamaConfig

    params = set(inspect.signature(train_diloco.run_diloco_fleet).parameters)
    assert chip_smoke.SPARE_PHASE == dict(chip_smoke.DILOCO, should_quantize=False, spares=1,
                                          outer_steps=2)
    assert chip_smoke.SPARE_PHASE["kill_at"] == (1, 5)
    assert set(chip_smoke.SPARE_PHASE) <= params and set(chip_smoke.SPARE_DELTA_FLEET) <= params
    cfg = LlamaConfig(**chip_smoke.SPARE_DELTA_CFG)
    assert cfg.head_dim == 64 and cfg.dtype == torch.bfloat16
    source = (REPO / "chip_smoke.py").read_text()
    for key in ("spare_python", "spare_drills"):
        assert f'results["{key}"] = t = ' in source
    assert 'seq=2048, tier="python", **fleet)' in source


def _spare_results(change=None):
    """A passing fleet with one spare at ``SPARE_PHASE``'s 2 outer steps:
    replica 0, replica 1 (killed), the promoted spare."""
    from types import SimpleNamespace

    def one(**kw):
        base = dict(restarts=0, killed=False, spare=None, heal=None, quorum_ids=[1, 2, 2],
                    fragment_sha256=["b0", "b1"], initial_fragment_sha256=["i0", "i1"],
                    fragment_live_sha256=["l0", "l1"], final_step=2, losses=[12.0, 11.0])
        base.update(kw)
        return SimpleNamespace(**base)

    spare = dict(promoted=True, promotions_total=1, promote_warm_lag_steps=0.0,
                 warm_fresh_fraction_max=1.0, warm_deltas_applied=0.0,
                 launches_at_promotion=dict(fwd=10, dq=10, dkv=10))
    results = [one(), one(killed=True, quorum_ids=[1], final_step=1), one(spare=spare,
                                                                          quorum_ids=[2, 2])]
    for (i, name), value in (change or {}).items():
        if i == "spare":
            results[2].spare = dict(spare, **{name: value})
        else:
            setattr(results[i], name, value)
    return results


LAUNCHES = dict(fwd=20, dq=20, dkv=20)


@pytest.mark.parametrize("change, launches, match", [
    # a cold heal of a restarted replica in place of the promotion
    ({(1, "restarts"): 1, (1, "killed"): False}, LAUNCHES, "cold heal"),
    ({(1, "killed"): False}, LAUNCHES, "must die"),
    ({(2, "heal"): object()}, LAUNCHES, "not warm"),
    ({("spare", "promote_warm_lag_steps"): 1.0}, LAUNCHES, "not warm"),
    ({("spare", "promoted"): False}, LAUNCHES, "not promoted exactly once"),
    ({("spare", "promotions_total"): 2}, LAUNCHES, "not promoted exactly once"),
    # two membership edits
    ({(0, "quorum_ids"): [1, 2, 3]}, LAUNCHES, "2 membership edits"),
    ({("spare", "warm_fresh_fraction_max"): 0.75}, LAUNCHES, "fresh fraction of 1.0"),
    ({(2, "fragment_sha256"): ["b0", "other"]}, LAUNCHES, "fragment 1: backups differ"),
    ({(0, "fragment_sha256"): ["i0", "b1"], (2, "fragment_sha256"): ["i0", "b1"]}, LAUNCHES,
     "initial weights"),
    # fragment 1 is the one synced last at 2 outer steps
    ({(2, "fragment_live_sha256"): ["l0", "other"]}, LAUNCHES, "live parameters differ"),
    ({(2, "final_step"): 3}, LAUNCHES, "ended at step"),
    ({(2, "losses"): [float("nan")]}, LAUNCHES, "non-finite"),
    # no kernel launches after the promotion
    ({}, dict(fwd=10, dq=11, dkv=11), "after the promotion"),
])
def test_spare_checks_raise_on_failure(chip_smoke, change, launches, match) -> None:
    fleet = chip_smoke.SPARE_PHASE
    assert chip_smoke.check_spare(_spare_results(), fleet, LAUNCHES) == dict(fwd=10, dq=10, dkv=10)
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_spare(_spare_results(change), fleet, launches)


def test_spare_check_counts_committed_deltas(chip_smoke) -> None:
    fleet = chip_smoke.SPARE_DELTA_FLEET  # 4 outer steps
    at_4 = {(0, "final_step"): 4, (2, "final_step"): 4}
    with pytest.raises(AssertionError, match="fewer than 1"):
        chip_smoke.check_spare(_spare_results(at_4), fleet, LAUNCHES, min_deltas=1)
    chip_smoke.check_spare(_spare_results({**at_4, ("spare", "warm_deltas_applied"): 1.0}), fleet,
                           LAUNCHES, min_deltas=1)


@pytest.mark.parametrize("promote, kill, match", [
    (dict(promotions_total=0, quorum_reconfigs=1, promotion_latency_s=0.5), None, "spare_promote"),
    (dict(promotions_total=1, quorum_reconfigs=2, promotion_latency_s=0.5), None, "spare_promote"),
    (None, dict(quorum_reconfigs=1, promotions_total=0), "kill_spare"),
    (None, dict(quorum_reconfigs=0, promotions_total=1), "kill_spare"),
])
def test_spare_drill_checks_raise_on_failure(chip_smoke, promote, kill, match) -> None:
    good_promote = dict(promotions_total=1, quorum_reconfigs=1, promotion_latency_s=0.5)
    good_kill = dict(quorum_reconfigs=0, promotions_total=0)
    chip_smoke.check_spare_drills(good_promote, good_kill)
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_spare_drills(promote or good_promote, kill or good_kill)


def test_kernels_line_carries_the_spare_paths_launches() -> None:
    source = (REPO / "chip_smoke.py").read_text()
    assert 'row["spare_launches"] = results["spare_python"]["launches"]' in source


def test_diloco_depth_cut_spares_diloco_cpp(chip_smoke) -> None:
    """The DiLoCo phases and ``spare_python`` run 1 layer deep to keep the
    command inside its 1200 s limit; ``diloco_cpp`` and ``spare_python`` share a depth,
    so the cold heal printed beside the promotion moves the state of the
    depth the spare phase promotes at.  The DDP and HSDP phases keep
    LAYERS, so their fixed hashes stand."""
    phases = dict(chip_smoke.DILOCO_PHASES)
    assert set(chip_smoke.DILOCO_LAYERS) == set(phases) | {"spare_python"}
    assert all(1 <= n < chip_smoke.LAYERS for n in chip_smoke.DILOCO_LAYERS.values())
    assert chip_smoke.DILOCO_LAYERS["diloco_cpp"] == chip_smoke.DILOCO_LAYERS["spare_python"]
    source = (REPO / "chip_smoke.py").read_text()
    assert "DILOCO_LAYERS.get(key, LAYERS)" in source
    assert 'DILOCO_LAYERS.get("spare_python", LAYERS)' in source


def test_pipeline_launch_arithmetic(chip_smoke, monkeypatch) -> None:
    """Live ticks only: each layer attends each microbatch once forward
    and once backward, and a recomputed attention half ("layer", "attn")
    attends again in the backward.  On the CPU the in-process pipeline's
    attention calls, recomputes included, are counted at a small width."""
    import dataclasses

    import torch

    from torchft_tpu_torch.models import llama
    from torchft_tpu_torch.parallel.pipeline import PipelinedLlama

    assert chip_smoke.pipeline_launches_expected(2, 4, "layer") == dict(fwd=16, dq=8, dkv=8)
    assert chip_smoke.pipeline_launches_expected(2, 4, "ffn") == dict(fwd=8, dq=8, dkv=8)
    case = chip_smoke.PIPELINE_CASE
    assert case == dict(layers=2, pp=2, batch=4, seq=2048, microbatches=4, remat_mode="layer")
    calls = []
    plain = llama.naive_attention
    monkeypatch.setattr(llama, "naive_attention", lambda *a, **k: calls.append(1) or plain(*a, **k))
    for mode in ("layer", "attn", "ffn", "none"):
        calls.clear()
        cfg = dataclasses.replace(llama.llama_debug(), remat_mode=mode)
        model = PipelinedLlama(cfg, device="cpu", pp=case["pp"], num_microbatches=case["microbatches"])
        tokens = torch.randint(0, cfg.vocab_size, (case["batch"], 16))
        model.loss(tokens, tokens.roll(-1, 1)).backward()
        want = chip_smoke.pipeline_launches_expected(cfg.n_layers, case["microbatches"], mode)
        assert len(calls) == want["fwd"], mode


def _pipeline_args(**change):
    args = dict(loss=10.0, plain_loss=10.05, rel_errs={"embed": 0.01, "lm_head.weight": 0.001},
                launches=dict(fwd=16, dq=8, dkv=8), expected=dict(fwd=16, dq=8, dkv=8))
    args.update(change)
    return args


@pytest.mark.parametrize("change, match", [
    (dict(loss=float("nan")), "non-finite"),
    (dict(loss=10.2), "loss"),
    (dict(rel_errs={"embed": 0.03}), "gradients off"),
    (dict(rel_errs={"embed": float("nan")}), "gradients off"),
    (dict(launches=dict(fwd=8, dq=8, dkv=8)), "flash launches"),
])
def test_pipeline_checks_raise_on_failure(chip_smoke, change, match) -> None:
    chip_smoke.check_pipeline(**_pipeline_args())
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_pipeline(**_pipeline_args(**change))


def _moe_fleet():
    fleet = _hsdp_fleet()
    for group in fleet:
        for r in group:
            r.update(final_step=3, incarnation=0, heal=None, moe_params=3,
                     missing_moe_grads=[0, 0, 0], moe_dropped=[10, 12, 11])
    return fleet


@pytest.mark.parametrize("group, key, value, match", [
    (1, "missing_moe_grads", [0, 1, 0], "without a gradient"),
    (0, "missing_moe_grads", [], "without a gradient"),
    (0, "moe_params", 0, "MoE parameters"),
    (1, "launches", dict(fwd=3, dq=3, dkv=0), "kernel dkv never launched"),
    (1, "incarnation", 1, "restarts"),
    (1, "params_sha256", "other", "diverged"),
])
def test_moe_checks_raise_on_failure(chip_smoke, group, key, value, match) -> None:
    chip_smoke.check_moe_hsdp(_moe_fleet(), 3, 1)
    fleet = _moe_fleet()
    fleet[group][0][key] = value
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_moe_hsdp(fleet, 3, 1)


def test_new_phases_take_their_entry_points_keywords(chip_smoke) -> None:
    """``moe_hsdp_cpp`` is ``train_hsdp`` over ``llama3_8b_moe`` at 2 groups
    of one rank, 3 steps, no kill; the rehearsal
    phase expects each kernel launched once per case of
    ``quant_kernel_reports`` (3 flash configs, 2 wire kinds)."""
    import inspect

    from torchft_tpu_torch import train_hsdp
    from torchft_tpu_torch.parallel import rehearsal

    assert set(chip_smoke.MOE_PHASE) <= set(inspect.signature(train_hsdp.run_hsdp_fleet).parameters)
    assert chip_smoke.MOE_PHASE == dict(groups=2, fsdp=1, tp=1, ep=1, steps=3, batch=1, seq=2048,
                                        lr=1e-4)
    cfg = train_hsdp.model_config("llama3_8b_moe", chip_smoke.MOE_LAYERS)
    assert (cfg.num_experts, cfg.capacity_factor, cfg.dim, cfg.n_layers) == (8, 1.5, 4096, 1)
    n_flash = len(rehearsal._flash_cases())
    assert chip_smoke.REHEARSAL_LAUNCHES == dict(fwd=n_flash, dq=n_flash, dkv=n_flash,
                                                 quantize=2, reduce=2, dequantize=2)
    source = (REPO / "chip_smoke.py").read_text()
    for key in ("pipeline", "moe_hsdp_cpp", "rehearsal"):
        assert f'results["{key}"] = t = ' in source
    for key in ("pipeline_launches", "moe_hsdp_launches", "rehearsal_launches"):
        assert f'row["{key}"] = ' in source


def test_release_host_memory_runs_on_the_cpu(chip_smoke) -> None:
    chip_smoke.release_host_memory()
    assert chip_smoke.HostRss.now() > 0


# -- the fleet phases: supervised_cpp and baby_cpp ---------------------------

_L = '{"fwd":2,"dq":2,"dkv":2}'


def _fleet_logs(change=None) -> dict:
    """A passing supervised_cpp: group 0, group 1's killed active, its
    promoted standby and the fresh standby parked behind it (pids past the
    kernel's ``pid_max``, so none is alive); ``change`` rewrites a group's
    log text."""
    logs = {
        0: f"FIRST_COMMIT pid=4194410 step=1 t=100.0 launches={_L}\n"
           f"FINAL step=3 params_sha=abc first_commit_t=100.0 state_bytes=50 launches={_L} "
           f"peak_device_gb=14.9 pid=4194410\n",
        1: f"STANDBY pid=4194412 t=90.0 launches={_L} peak_device_gb=7.2\n"
           f"FIRST_COMMIT pid=4194411 step=1 t=100.1 launches={_L}\n"
           "2026-10-17 12:00:00 train_ddp: step 1 loss 12.25 committed=True participants=2\n"
           f"STANDBY pid=4194413 t=140.0 launches={_L} peak_device_gb=7.1\n"
           f"FIRST_COMMIT pid=4194412 step=2 t=130.0 launches={_L}\n"
           f"FINAL step=3 params_sha=abc standby_park_s=20.0 promoted_t=110.0 "
           f"first_commit_t=130.0 heal_s=8.0 heal_bytes=50 state_bytes=50 launches={_L} "
           f"peak_device_gb=14.9 pid=4194412\n",
    }
    for g, (old, new) in (change or {}).items():
        assert old in logs[g]
        logs[g] = logs[g].replace(old, new)
    return logs


_EVENTS = ["launching replica group 0", "launching replica group 1",
           "replica group 1 exited rc=-9; promoted warm standby (1)", "replica group 1 finished"]


def test_parse_fleet_log_reads_the_workers_lines(chip_smoke) -> None:
    recs = chip_smoke.parse_fleet_log(_fleet_logs()[1])
    assert [r["kind"] for r in recs] == ["STANDBY", "FIRST_COMMIT", "STANDBY", "FIRST_COMMIT",
                                        "FINAL"]
    assert recs[-1]["launches"] == {"fwd": 2, "dq": 2, "dkv": 2}
    assert recs[-1]["heal_bytes"] == "50" and recs[-1]["standby_park_s"] == "20.0"


def test_supervised_checks_pass_on_a_good_fleet(chip_smoke) -> None:
    logs = {g: chip_smoke.parse_fleet_log(t) for g, t in _fleet_logs().items()}
    facts = chip_smoke.check_supervised(logs, _EVENTS, {10**7}, 3)
    assert facts["killed_pid"] == 4194411 and facts["promoted"]["pid"] == "4194412"
    assert facts["processes"] == [4194410, 4194411, 4194412, 4194413]


@pytest.mark.parametrize("change, events, match", [
    ({1: ("params_sha=abc standby", "params_sha=abd standby")}, _EVENTS, "diverged"),
    ({0: ("FINAL step=3", "FINAL step=2")}, _EVENTS, "ended at step"),
    # the killed active restarted cold instead of the standby's promotion
    ({}, _EVENTS[:2] + ["replica group 1 exited rc=-9; restarting (1)"], "one promotion"),
    ({}, _EVENTS + ["replica group 1 exited rc=-9; promoted warm standby (2)"], "one promotion"),
    # group 1 finished in a process that never parked
    ({1: ("standby_park_s=20.0 promoted_t=110.0 ", "")}, _EVENTS, "never a parked standby"),
    ({1: ("STANDBY pid=4194412", "STANDBY pid=4194414")}, _EVENTS, "did not park once"),
    ({1: ("heal_bytes=50 state", "heal_bytes=49 state")}, _EVENTS, "not its state"),
    ({1: ("heal_s=8.0 heal_bytes=50 ", "")}, _EVENTS, "recorded no heal"),
    ({1: ('FIRST_COMMIT pid=4194411 step=1 t=100.1 launches={"fwd":2,"dq":2,"dkv":2}',
          'FIRST_COMMIT pid=4194411 step=1 t=100.1 launches={"fwd":2,"dq":0,"dkv":2}')}, _EVENTS,
     "kernel dq never launched"),
    ({1: ("FIRST_COMMIT pid=4194411", "FIRST_COMMIT pid=4194412")}, _EVENTS, "one killed active"),
])
def test_supervised_checks_raise_on_failure(chip_smoke, change, events, match) -> None:
    logs = {g: chip_smoke.parse_fleet_log(t) for g, t in _fleet_logs(change).items()}
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_supervised(logs, events, set(), 3)


def test_supervised_check_fails_while_a_fleet_process_lives(chip_smoke) -> None:
    import os

    logs = {g: chip_smoke.parse_fleet_log(t) for g, t in _fleet_logs().items()}
    with pytest.raises(AssertionError, match="left alive"):
        chip_smoke.check_supervised(logs, _EVENTS, {os.getpid()}, 3)


def test_child_pids_and_pid_alive_read_proc(chip_smoke) -> None:
    import subprocess
    import sys

    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)  # fleet_marker"])
    try:
        assert proc.pid in chip_smoke.child_pids("fleet_marker")
        assert chip_smoke.pid_alive(proc.pid)
    finally:
        proc.kill()
        proc.wait()
    assert not chip_smoke.pid_alive(proc.pid)
    assert proc.pid not in chip_smoke.child_pids("fleet_marker")


def test_supervised_phase_runs_the_port_worker_under_the_ports_supervisor(chip_smoke) -> None:
    """The workers are ``python -m torchft_tpu_torch.train_ddp`` at the main
    path's width and depth, 3 steps, healing over comm, holding commits for
    both groups; the lighthouse takes bench.py's fleet settings."""
    import argparse

    cmd = chip_smoke.SUPERVISED_CMD
    assert cmd[:2] == ("-m", "torchft_tpu_torch.train_ddp")
    parser = argparse.ArgumentParser()
    for flag in ("--model", "--layers", "--steps", "--heal-transport", "--min-replicas"):
        parser.add_argument(flag)
    args = parser.parse_args(cmd[2:])
    assert (args.model, int(args.layers), int(args.steps), args.heal_transport,
            int(args.min_replicas)) == ("llama3_8b", chip_smoke.LAYERS, 3, "comm", 2)
    assert chip_smoke.SUPERVISED_LIGHTHOUSE == dict(min_replicas=1, join_timeout_ms=1000,
                                                     quorum_tick_ms=50)
    source = (REPO / "chip_smoke.py").read_text()
    assert 'chaos.ProcessReplica("supervised_group1", sup, 1).inject(chaos.Failure.KILL)' in source
    assert "launcher.ReplicaSupervisor(specs" in source


def _baby_stats(change=None) -> list:
    # pids past the kernel's pid_max: none is alive
    base = [dict(shm_ops=40, child_pids=[1 << 23, (1 << 23) + 1], live_pid=None),
            dict(shm_ops=44, child_pids=[(1 << 23) + 2], live_pid=None),
            dict(shm_ops=30, child_pids=[(1 << 23) + 3], live_pid=None)]
    for (i, key), value in (change or {}).items():
        base[i][key] = value
    return base


def test_baby_checks(chip_smoke) -> None:
    import os

    good = dict(dead_babies=1, alive_old_children=[])
    chip_smoke.check_baby(_baby_stats(), 1, good)
    for stats, restart, match in (
        (_baby_stats({(0, "child_pids"): [1, 102]}), good, "its own process"),
        (_baby_stats({(2, "child_pids"): [(1 << 23) + 2]}), good, "its own process"),
        (_baby_stats(), dict(good, dead_babies=0), "not shut down"),
        (_baby_stats(), dict(good, alive_old_children=[1 << 23]), "live on"),
        (_baby_stats({(0, "shm_ops"): 0, (1, "shm_ops"): 0, (2, "shm_ops"): 0}), good,
         "shared memory"),
        (_baby_stats({(2, "live_pid"): (1 << 23) + 3}), good, "left alive"),
        (_baby_stats({(2, "child_pids"): [os.getpid()]}), good, "left alive"),
    ):
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_baby(stats, 1, restart)


def test_kernels_line_carries_the_fleet_phases_launches() -> None:
    source = (REPO / "chip_smoke.py").read_text()
    assert 'row["baby_launches"] = results["baby_cpp"]["launches"][name]' in source
    assert 'results["supervised_cpp"]["launches"].values()' in source
    assert 'results["baby_cpp"] = t = baby_phase(' in source
    assert 'results["supervised_cpp"] = t = supervised_phase(card)' in source
    assert "check_expected_hashes({\"float\": t[\"params_sha256\"]})" in source


def test_every_path_reports_its_own_launches_or_null() -> None:
    """The train_ddp and train_hsdp workers report the launches of every
    kernel of the table, the avg kernel's included (their gradients go
    through it), and the kernels line prints a path's count of a kernel
    only where that path counted it: null, never a made-up 0."""
    from torchft_tpu_torch import train_ddp

    assert set(train_ddp._launches()) == {"fwd", "dq", "dkv", "quantize", "reduce",
                                          "dequantize", "avg"}
    hsdp = (REPO / "torchft_tpu_torch" / "train_hsdp.py").read_text()
    assert "launches={**fa.launches, **qk.launches, **avg_ops.launches}" in hsdp
    source = (REPO / "chip_smoke.py").read_text()
    line = source[source.index("line = {\"kernels\": ["):source.index("print(json.dumps(line)")]
    assert ".get(name, 0)" not in line and ".get(name)" in line
    for phase in ("def diloco_phase(", "def spare_phase("):
        body = source[source.index(phase):]
        body = body[:body.index("\ndef ")]
        assert "avg.reset_launches()" in body and "**avg.launches}" in body


def _job_loss(change=None):
    """A passing job loss: the first fleet saved step 1 from replica 0; the
    restored fleet loaded it on both replicas and saved step 2."""
    saved = dict(step=1, digest="d1", bytes=100)
    first = dict(final_step=1, saves=[[saved], []], restored=[None, None], healed=[False, False])
    restored = dict(
        final_step=2, saves=[[dict(step=2, digest="d2", bytes=100)], []], healed=[False, False],
        restored=[dict(step=1, manager_step=1, digest="d1", read_s=1.0, apply_s=1.0)
                  for _ in range(2)])
    if change:
        change(first, restored)
    return first, restored


def _set(which, key, value, replica=None, field=None):
    def change(first, restored):
        target = first if which == "first" else restored
        if replica is None:
            target[key] = value
        else:
            target[key][replica][field] = value
    return change


@pytest.mark.parametrize("change, steps, match", [
    (None, [1, 2], None),
    (_set("first", "saves", [[dict(step=1, digest="d1")], [dict(step=1, digest="d1")]]), [1, 2],
     "saved"),
    (_set("first", "saves", [[], []]), [1, 2], "saved"),
    (_set("first", "restored", [dict(step=0), None]), [1, 2], "empty dir"),
    (_set("restored", "restored", "d0", 1, "digest"), [1, 2], "digest at restore"),
    (_set("restored", "restored", 0, 0, "step"), [1, 2], "restored"),
    (_set("restored", "restored", 0, 1, "manager_step"), [1, 2], "restored"),
    (_set("restored", "restored", [None, None]), [1, 2], "restored None"),
    (_set("restored", "healed", [False, True]), [1, 2], "healed"),
    (_set("restored", "saves", [[], []]), [1, 2], "restored fleet saved"),
    (None, [2], "holds steps"),
    (None, [1, 2, 3], "holds steps"),
])
def test_job_loss_checks_raise_on_failure(chip_smoke, change, steps, match) -> None:
    first, restored = _job_loss(change)
    if match is None:
        assert chip_smoke.check_job_loss(first, restored, steps)["digest"] == "d1"
        return
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_job_loss(first, restored, steps)


def test_localsgd_cpp_is_the_job_loss(chip_smoke) -> None:
    """localsgd_cpp runs through ``jobloss_phase``: its fleet to 1 committed
    sync, then the restored fleet to 2; a checkpoint is 6 bytes a
    parameter; the kernels line carries the restored fleet's launches."""
    fleet = dict(chip_smoke.DILOCO_PHASES)["localsgd_cpp"]
    assert fleet["outer_steps"] == 1 and fleet["sync_every"] == 4
    assert chip_smoke.DILOCO_LAYERS["localsgd_cpp"] == 1
    assert chip_smoke.JOBLOSS_BYTES_PER_PARAM == 6
    source = (REPO / "chip_smoke.py").read_text()
    assert 'if key == "localsgd_cpp":' in source and "jobloss_phase(" in source
    assert 'row["jobloss_launches"]' in source


def test_a_failed_probe_stops_the_run_by_name(chip_smoke, monkeypatch, capsys) -> None:
    """With a card reported but not executing, ``main`` raises
    ``CardProbeError`` before it builds anything, and prints no ok line."""
    import torch

    from torchft_tpu_torch.ops import cuda_build
    from torchft_tpu_torch.utils import probe

    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(probe, "backend_executes_with_retries", lambda *a, **k: False)
    monkeypatch.setattr(cuda_build, "build", lambda names: built.append(names))
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    with pytest.raises(chip_smoke.CardProbeError, match="did not execute"):
        chip_smoke.main()
    assert built == []
    assert '"ok": true' not in capsys.readouterr().out


def test_a_short_checkpoint_filesystem_stops_the_phase_by_name(chip_smoke, monkeypatch,
                                                               tmp_path) -> None:
    """``jobloss_phase`` checks the free space for two checkpoints before
    its first fleet, fails with ``InsufficientSpaceError`` and removes its
    directory."""
    from collections import namedtuple

    from torchft_tpu_torch import train_ddp
    from torchft_tpu_torch.utils.checkpoint import InsufficientSpaceError

    usage = namedtuple("usage", "total used free")
    monkeypatch.setattr(chip_smoke.shutil, "disk_usage", lambda _p: usage(1 << 40, 0, 1 << 30))
    ran = []
    monkeypatch.setattr(chip_smoke, "diloco_phase", lambda *a, **k: ran.append(a))
    build = REPO / "build"
    before = set(build.glob("jobloss_ckpt_*")) if build.exists() else set()
    fleet = dict(chip_smoke.DILOCO_PHASES)["localsgd_cpp"]
    with pytest.raises(InsufficientSpaceError, match="two checkpoints"):
        chip_smoke.jobloss_phase(None, train_ddp, None, None, "card", fleet, 1)
    assert ran == [] and set(build.glob("jobloss_ckpt_*")) == before


def test_job_loss_phase_reports_the_check_apart(chip_smoke, monkeypatch) -> None:
    """``jobloss_phase`` over two stand-in fleets: the restore digest's
    seconds stand apart, kill to first commit is given with and without
    them, and ``jobloss_line`` prints both; the directory is removed."""
    from torchft_tpu_torch import train_ddp

    timed = dict(save_s=3.0, host_copy_s=1.0, write_s=1.5, fsync_s=1.25, bytes=600)
    calls = []

    def fleet_run(*args):
        ckpt_dir, step = args[-1], len(calls) + 1
        os.makedirs(os.path.join(ckpt_dir, f"step_{step}"))
        open(os.path.join(ckpt_dir, f"step_{step}", "state.tftc"), "wb").close()
        calls.append(ckpt_dir)
        now = time.monotonic()
        restored = ([None, None] if step == 1 else
                    [dict(step=1, manager_step=1, digest="d1", read_s=1.0, apply_s=0.5,
                          digest_s=s) for s in (2.0, 3.0)])
        return dict(final_step=step, saves=[[dict(timed, step=step, digest=f"d{step}")], []],
                    restored=restored, healed=[False, False],
                    first_commit_ts=[now + 10.0, now + 11.0], max_memory_allocated_gb=1.0,
                    peak_host_rss_gb=2.0, launches={"flash_fwd": 8}, wall_s=5.0)

    monkeypatch.setattr(chip_smoke, "diloco_phase", fleet_run)
    fleet = dict(chip_smoke.DILOCO_PHASES)["localsgd_cpp"]
    t = chip_smoke.jobloss_phase(None, train_ddp, None, None, "card", fleet, 1)
    assert len(calls) == 2 and not os.path.exists(calls[0])
    assert t["ckpt_steps"] == [1, 2] and t["restore_digest_s"] == [2.0, 3.0]
    assert 10.0 <= t["kill_to_first_commit_s"] < 12.0
    assert t["kill_to_first_commit_less_check_s"] == pytest.approx(
        t["kill_to_first_commit_s"] - 3.0)
    line = chip_smoke.jobloss_line("localsgd_cpp", t)
    assert "hashed for the check in [2.0, 3.0] s" in line
    assert "less the check's restore digest" in line


def test_stream_kill_lands_between_a_submit_and_its_barrier(chip_smoke, monkeypatch) -> None:
    """``diloco_stream_cpp``'s schedule: at a per-fragment cadence of 4 with
    delay 2, ``TORCHFT_STREAM_SYNC=1`` stalls 1 inner step, so a fragment's
    sync is submitted after inner steps 2, 6, 10 and resolved at its barrier
    after inner steps 5, 9, 13; the kill before inner step 6 (6 steps done)
    falls after fragment 1's submit and before its barrier."""
    from torchft_tpu_torch.local_sgd import stream_stall_for

    fleet = dict(chip_smoke.DILOCO_PHASES)["diloco_stream_cpp"]
    per_frag = fleet["sync_every"] // fleet["num_fragments"]
    for key, value in chip_smoke.STREAM_ENV.items():
        monkeypatch.setenv(key, value)
    stall = stream_stall_for(per_frag, fleet["fragment_sync_delay"])
    assert stall == 1
    submits = [k for k in range(1, 14) if k % per_frag == per_frag - fleet["fragment_sync_delay"]]
    barriers = [k for k in range(1, 14) if k > per_frag and k % per_frag == stall]
    assert submits == [2, 6, 10] and barriers == [5, 9, 13]
    done = fleet["kill_at"][1]  # inner steps finished when the kill lands
    submitted = max(k for k in submits if k <= done)
    assert submitted == done and min(b for b in barriers if b > submitted) > done
    # fragment 1 goes second: the kill is after the first committed sync
    assert submitted // per_frag % fleet["num_fragments"] == 1


def _stream_results(change=None):
    """A passing diloco_stream_cpp fleet: replica 0 committed steps 1-3 and
    voted down the sync in flight at the kill (step 1); replica 1, killed
    with fragment 1's sync in flight at step 1, healed to step 1 and
    committed steps 2 and 3."""
    from types import SimpleNamespace

    results = [
        SimpleNamespace(streaming=[True], stream_barriers=[2, 2], kills=[], final_step=3,
                        sync_decisions=[(0, True), (1, False), (1, True), (2, True)]),
        SimpleNamespace(streaming=[True, True], stream_barriers=[1, 1], final_step=3,
                        kills=[dict(inner_step=6, step=1, in_flight=[1])],
                        sync_decisions=[(1, True), (2, True)]),
    ]
    for (i, name), value in (change or {}).items():
        setattr(results[i], name, value)
    return results


@pytest.mark.parametrize("change, match", [
    ({(1, "streaming"): [False, True]}, "not on every incarnation"),
    ({(0, "streaming"): []}, "not on every incarnation"),
    # a decision that did not come at a stream barrier (the blocking path)
    ({(0, "stream_barriers"): [2, 1]}, "stream barriers"),
    ({(1, "sync_decisions"): []}, "stream barriers"),
    # committed decisions that do not account for the final step
    ({(0, "final_step"): 4}, "do not account"),
    ({(0, "kills"): [dict(inner_step=6, step=1, in_flight=[1])]}, "was killed"),
    ({(1, "kills"): []}, "was killed"),
    # the kill landed outside a submit and its barrier
    ({(1, "kills"): [dict(inner_step=5, step=1, in_flight=[])]}, "in flight"),
    # the survivor committed the sync in flight at the kill
    ({(0, "sync_decisions"): [(0, True), (1, True), (2, True)],
      (0, "stream_barriers"): [2, 1]}, "committed"),
])
def test_stream_checks_raise_on_failure(chip_smoke, change, match) -> None:
    fleet = dict(chip_smoke.DILOCO_PHASES)["diloco_stream_cpp"]
    got = chip_smoke.check_stream(_stream_results(), fleet)
    assert got["kill"] == dict(inner_step=6, step=1, in_flight=[1])
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_stream(_stream_results(change), fleet)


def test_chaos_deadlock_phase_takes_run_drills_keywords(chip_smoke, monkeypatch) -> None:
    """``chaos_deadlock`` runs the drill's CLI with flags it parses into
    CHAOS_DEADLOCK's ``run_drill`` arguments, on ``cnn_cpp``'s model on the
    card; at its pace a lone survivor still trains past the rest of the
    freeze and a restart of the victim of 70 s (30-41 s on H100 hosts), and
    the drill's timing is the JAX example's.  It runs beside ``hsdp_cpp``
    and ``pipeline_phase``."""
    from torchft_tpu_torch import chaos_drill

    seen = []
    monkeypatch.setattr(chaos_drill, "run_drill", lambda *a: seen.append(a) or {
        "params_sha": "0" * 16, "events": []})
    cmd = chip_smoke.chaos_deadlock_cmd()
    assert cmd[1:3] == ["-m", "torchft_tpu_torch.chaos_drill"]
    assert chaos_drill.main(cmd[3:]) == 0
    (replicas, failure, victim, steps, freeze, pace, work, worker), = seen
    d = chip_smoke.CHAOS_DEADLOCK
    assert (replicas, failure, victim, steps, pace, work) == (
        d["replicas"], d["failure"], d["victim"], d["steps"], d["step_time"], d["step_work"])
    assert worker[worker.index("--model") + 1] == "cnn"
    assert worker[worker.index("--device") + 1] == "cuda"
    assert worker[worker.index("--layers") + 1] == "0"  # the CNN keeps its preset
    planned = chaos_drill.drill_timing(pace + work, steps, pace, freeze_s=freeze)
    assert work == chaos_drill.STEP_DEFAULTS["cpu"][1]
    assert (planned.comm_timeout_s, planned.freeze_s) == (5.0, 12.0)
    remaining = steps - chaos_drill.WARMUP_STEPS - 1
    assert planned.survivors_outlast_freeze(remaining)
    # the freeze's last 7 s past the eviction, and 70 s for a restart
    assert remaining * pace >= planned.freeze_s - chaos_drill.HEARTBEAT_S + 70.0
    source = (REPO / "chip_smoke.py").read_text()
    assert 'results["chaos_deadlock"] = c = chaos_deadlock_phase(chaos, card)' in source
    hsdp = source.index('results["hsdp_cpp"] = t = hsdp_phase(')
    pipeline = source.index('results["pipeline"] = t = pipeline_phase(')
    assert (source.index("chaos = start_chaos_deadlock()  # beside hsdp_cpp") < hsdp
            < pipeline < source.index("chaos_deadlock_phase(chaos, card)"))
    assert 'row["stream_launches"] = results["diloco_stream_cpp"]["launches"]' in source
    assert 'for n in results["chaos_deadlock"]["launches"]]' in source


def test_drill_output_is_read_back_with_int_groups(chip_smoke) -> None:
    """The CLI's ``drill numbers`` line, as ``check_chaos_deadlock`` reads
    it; a drill that did not pass raises."""
    import json

    numbers = {"params_sha": "ab", "events": [["deadlock", "rg1"]], "logs": {"1": "x"},
               "finals": {"0": {"step": "9"}, "1": {"step": "9"}}, "timing": {}}
    text = f"DRILL PASSED: ...\ndrill numbers: {json.dumps(numbers)}\n"
    got = chip_smoke._drill_result(text)
    assert got["events"] == [("deadlock", "rg1")] and set(got["finals"]) == {0, 1}
    assert got["logs"] == {1: "x"}
    with pytest.raises(AssertionError, match="did not pass: .*replicas diverged"):
        chip_smoke._drill_result("injected deadlock into rg1\nreplicas diverged: {}\n")


def test_drill_heal_steps_read_every_heal_of_a_log(chip_smoke) -> None:
    """The steps a drill worker healed at, in its log's order: the report's
    ``heal_step`` (the last) and the survivor's steps left then."""
    log = ("healing required, fetching checkpoint metadata from http://h:1 max_step=0\n"
           "step 3 loss 2.1 committed=True\n"
           "healing required, fetching checkpoint metadata from http://h:1 max_step=118\n")
    assert chip_smoke.drill_heal_steps(log) == [0, 118]
    assert chip_smoke.drill_heal_steps("step 3 loss 2.1 committed=True\n") == []


def test_stop_chaos_deadlock_takes_the_workers_down_too(chip_smoke) -> None:
    """The drill runs in a session of its own; stopping it signals its
    process group, so a worker it started goes with it."""
    import subprocess
    import sys
    import time

    script = ("import subprocess, sys, time; "
              "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)']); "
              "print(p.pid, flush=True); time.sleep(60)")
    proc = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE, text=True,
                            start_new_session=True)
    worker = int(proc.stdout.readline())
    chip_smoke.stop_chaos_deadlock({"proc": proc})
    assert proc.poll() is not None
    deadline = time.monotonic() + 10
    while chip_smoke.pid_alive(worker) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not chip_smoke.pid_alive(worker)
    chip_smoke.stop_chaos_deadlock({"proc": proc})  # a no-op once it has ended


def _drill_result(tmp_path, heal_line="max_step=9", **change):
    log = tmp_path / "rg1.log"
    log.write_text("healing required, fetching checkpoint metadata from h:1 max_step=0\n"
                   f"healing required, fetching checkpoint metadata from h:1 {heal_line}\n")
    final = dict(step="80", params_sha="ab" * 8, heal_s="0.01", heal_bytes="6543186",
                 launches='{"fwd":0,"dq":0,"dkv":0}', pid="999999999")
    result = dict(events=[("deadlock", "rg1")], timing=dict(freeze_s=12.0),
                  inject_to_commit_s=14.5, logs={0: str(tmp_path / "rg0.log"), 1: str(log)},
                  finals={0: dict(final), 1: dict(final)})
    for key, value in change.items():
        if key in ("final0", "final1"):
            result["finals"][int(key[-1])].update(value)
        else:
            result[key] = value
    return result


@pytest.mark.parametrize("heal_line, change, match", [
    ("max_step=9", dict(events=[("kill", "rg1")]), "not one deadlock"),
    ("max_step=9", dict(events=[]), "not one deadlock"),
    ("max_step=9", dict(inject_to_commit_s=11.0), "inside its"),
    ("max_step=9", dict(final1=dict(step="79")), "not all at step 80"),
    # a group that never printed its FINAL line (final_fields: an empty dict)
    ("max_step=9", dict(final1={"step": None}), "not all at step 80"),
    # only the step-0 sync's heal: the thawed member rejoined without one
    ("max_step=0", {}, "without a heal"),
    ("max_step=9", dict(final1=dict(heal_bytes="0")), "without a heal"),
])
def test_chaos_deadlock_checks_raise_on_failure(chip_smoke, tmp_path, heal_line, change,
                                                match) -> None:
    import os

    chip_smoke.check_chaos_deadlock(_drill_result(tmp_path), 80, 1)
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_chaos_deadlock(_drill_result(tmp_path, heal_line, **change), 80, 1)
    alive = _drill_result(tmp_path, final0=dict(pid=str(os.getpid())))
    with pytest.raises(AssertionError, match="outlived the drill"):
        chip_smoke.check_chaos_deadlock(alive, 80, 1)


def test_the_avg_kernel_is_held_in_place(chip_smoke) -> None:
    """``avg_phase`` also divides in place, as the main path divides each
    leaf: bf16 and f32, at a leaf's 16-byte-aligned length and at a ragged
    one with the special values."""
    cases = chip_smoke.AVG_IN_PLACE_CASES
    assert {(c["src"], c["dst"]) for c in cases} == {
        (chip_smoke.torch.bfloat16,) * 2, (chip_smoke.torch.float32,) * 2}
    sizes = {c["src"]: c["src"].itemsize for c in cases}
    for c in cases:
        aligned = c["n"] * sizes[c["src"]] % 16 == 0
        assert aligned != c["name"].startswith("special")
    source = (REPO / "chip_smoke.py").read_text()
    assert 'avg.average_into(src, case["divisor"], src)' in source


def test_the_avg_kernel_is_held_and_listed(chip_smoke) -> None:
    """The port's AVG kernel replaces the JAX package's host divide
    (``manager._div``), is timed at the float and int8 paths' whole
    gradient and held on NaN payloads, and rides the kernels line with its
    launches from the float phase."""
    source, replaces = _port_kernels()["ddp_avg"]
    assert (REPO / source).is_file()
    path, line = replaces.rsplit(":", 1)
    tree = ast.parse((REPO / path).read_text())
    defs = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.lineno == int(line)]
    assert [d.name for d in defs] == ["_div"]
    cases = {c["name"]: c for c in chip_smoke.AVG_CASES}
    assert cases["main"]["n"] == cases["int8"]["n"] == chip_smoke.MAIN_QUANT["n"]
    assert {c["divisor"] for c in chip_smoke.AVG_CASES} == {2, 3}
    text = (REPO / "chip_smoke.py").read_text()
    assert 'name="ddp_avg"' in text and 'launches=float_t["launches"]["avg"]' in text
    assert '("fwd", "dq", "dkv", "avg")' in text
    assert '("quantize", "reduce", "dequantize") if should_quantize' in text


def test_the_outer_kernel_is_held_and_listed(chip_smoke) -> None:
    """DiLoCo's outer kernel replaces the JAX package's host outer update
    (its sharded owner's update callback), is held at one owner's shard of
    the 1-layer fragment and timed at that shard's first chunk, rides the
    kernels line with diloco_cpp's launches, and every DiLoCo fleet must
    launch it."""
    source, replaces = _port_kernels()["diloco_outer"]
    assert (REPO / source).is_file()
    path, line = replaces.rsplit(":", 1)
    tree = ast.parse((REPO / path).read_text())
    defs = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.lineno == int(line)]
    assert [d.name for d in defs] == ["_cb"]
    assert {c["n"] for c in chip_smoke.OUTER_CASES} >= {"shard", "chunk"}
    assert all(c["lr"] == 0.7 for c in chip_smoke.OUTER_CASES)
    text = (REPO / "chip_smoke.py").read_text()
    assert 'name="diloco_outer"' in text
    assert 'launches=results["diloco_cpp"]["launches"]["outer"]' in text
    assert '(("outer",) if diloco else ())' in text
    assert 'if launches["outer"] <= 0:' in text  # the spare's fleet


def test_outer_phase_runs_at_the_fragments_shapes(chip_smoke) -> None:
    """The 1-layer Llama-3-8B-width DiLoCo fleet's fragment 0, one owner's
    shard of it at 2 owners, and that shard's first pipeline chunk, from a
    model on the meta device."""
    import torch

    from torchft_tpu_torch import train_ddp

    fragments = chip_smoke.diloco_fragments(train_ddp, chip_smoke.DILOCO_LAYERS["diloco_cpp"])
    assert len(fragments) == chip_smoke.DILOCO["num_fragments"]
    assert fragments[0][0] == ("embed", (128256, 4096), torch.bfloat16)
    shapes = chip_smoke.outer_shapes(fragments[0])
    assert shapes == {"fragment": 684_732_416, "shard": 342_366_208, "chunk": 5_349_472}
    assert sum(chip_smoke.outer_shapes(f)["fragment"] for f in fragments) == 1_268_789_248


def test_outer_numpy_checks_read_this_hosts_numpy(chip_smoke) -> None:
    """numpy's sum over axis 0 starts from +0 (a sum of -0s is +0), and the
    int8 chunk sum's einsum rounds its products and sums apart, as the
    outer kernel does."""
    got = chip_smoke.outer_numpy_checks()
    assert got["sum_of_negative_zeros_negative"] is False
    assert got["einsum_differs_from_mul_then_add"] == 0
    assert got["einsum_differs_from_fused_second_term"] > 0


@pytest.mark.parametrize("name", [
    "outer_shard::scatter_wait", "outer_shard::to_card", "outer_shard::chunk_update",
    "outer_shard::to_wire", "outer_shard::gather_wait", "outer_shard::from_wire",
    "outer_shard::contribution", "outer_shard::sum"])
def test_outer_pipeline_spans_are_recorded_by_the_port(chip_smoke, name) -> None:
    """The outer pipeline's chunk spans are ones the port records, and the
    DiLoCo phases print them per committed sync."""
    assert name in chip_smoke.DILOCO_SPANS
    assert f'obs_span("{name}"' in "".join(
        p.read_text() for p in (REPO / "torchft_tpu_torch").rglob("*.py"))


@pytest.mark.parametrize("name", [
    "manager::heal_send", "manager::heal_recv", "diloco::save_state", "diloco::load_state",
    "outer_shard::export", "outer_shard::exchange", "outer_shard::rebuild",
    "heal::send_copy", "heal::send_write", "heal::recv_land", "heal::recv_read",
    "manager::heal_apply"])
def test_heal_spans_are_recorded_by_the_port(chip_smoke, name) -> None:
    """The heal's split (the send and, inside it, the sender's copies from
    the card and its writes; the receive and, inside it, the landing
    buffers and the reads; the apply at should_commit; the fragments' state
    across card and host, the reshard's export, exchange and rebuild) reads
    spans the port records, every phase that heals prints it, and the
    worker processes report the heal's spans (``obs.spans.HEAL_PREFIXES``)."""
    from torchft_tpu_torch.obs import spans

    assert name in chip_smoke.HEAL_SPANS
    assert f'obs_span("{name}"' in "".join(
        p.read_text() for p in (REPO / "torchft_tpu_torch").rglob("*.py"))
    text = (REPO / "chip_smoke.py").read_text()
    assert text.count("heal_split_s") >= 8
    if name.startswith(("heal::", "manager::heal_")):
        assert name.startswith(spans.HEAL_PREFIXES)


def test_heal_spans_split_a_heal_recorded_on_the_cpu(chip_smoke) -> None:
    """A heal over each transport on the CPU records its send, copy, write,
    receive, landing and read spans, which ``heal_split`` sums and
    ``obs.spans.totals`` reports for a worker process."""
    import io

    import torch

    from torchft_tpu_torch.checkpointing.serialization import load_pytree, plan_pytree
    from torchft_tpu_torch.obs import spans

    spans.configure(True)
    try:
        spans.clear()
        state = {"w": torch.arange(4096, dtype=torch.float32), "b": torch.ones(3, dtype=torch.bool)}
        plan = plan_pytree(state, snapshot=True)
        buf = io.BytesIO()
        plan.write_range(0, plan.total_len, buf)
        buf.seek(0)
        load_pytree(buf)
        split = chip_smoke.heal_split(spans.snapshot(), 1)
        totals = spans.totals(spans.HEAL_PREFIXES)
    finally:
        spans.configure(None)
        spans.clear()
    for name in ("heal::send_write", "heal::recv_land", "heal::recv_read"):
        # snapshot() rounds each span to the microsecond
        assert split[name] > 0 and totals[name] == pytest.approx(split[name], abs=1e-5)
    assert set(split) == set(chip_smoke.HEAL_SPANS)
    assert chip_smoke.heal_split_of([totals, {}])["heal::recv_read"] == totals["heal::recv_read"] / 2


def test_outer_sync_check_steps_a_committed_trace(chip_smoke) -> None:
    """The whole on-card sync check runs at least two syncs, so the second
    steps the trace the first staged and committed on the card, over
    fragment 0 of the 1-layer DiLoCo phases less its embedding (its other
    159,395,840 elements at their 8B-width shapes and dtypes), in at least
    two pipeline chunks a sync at one owner."""
    import torch

    from torchft_tpu_torch import train_ddp
    from torchft_tpu_torch.collectives import _outer_chunk_ranges, outer_shard_layout

    assert chip_smoke.OUTER_SYNC_STEPS >= 2
    fragment = chip_smoke.outer_sync_fragment(train_ddp)
    full = chip_smoke.diloco_fragments(train_ddp, chip_smoke.DILOCO_LAYERS["diloco_cpp"])[0]
    assert [leaf for leaf in full if leaf not in fragment] == [
        ("embed", (128256, 4096), torch.bfloat16)]
    elements = sum(math.prod(shape) for _name, shape, _dtype in fragment)
    assert elements == 159_395_840
    assert chip_smoke.OUTER_SYNC_MIN_CHUNKS >= 2
    _padded, per, unit = outer_shard_layout(elements, 1, False)
    assert len(_outer_chunk_ranges(per, unit, 1)) >= chip_smoke.OUTER_SYNC_MIN_CHUNKS
