"""ftlint of the port (``python -m torchft_tpu_torch.analysis``) against the
JAX package's (``torchft_tpu/analysis``).

- On the tree as it stands, with the empty baseline, the port's ftlint
  exits 0, and every one of its nine checkers reads the port's files.
- Each checker flags a drift seeded into a copy of the port's files (a new
  module with the bug class it exists for, a changed constant of the C++
  tier, an undeclared knob or metric), and the unseeded copy stays clean.
- The synthetic-source cases of ``tests/test_analysis.py`` run again, as
  they are, against the port's checkers (``TestPorted*``): the JAX test
  module's source with its package name rewritten, less the three cases of
  the ``kMaxIovSegs`` mirror the port does not keep (ROADMAP §C).
"""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

from torchft_tpu_torch.analysis import CHECKERS, core
from torchft_tpu_torch.analysis import __main__ as cli

REPO = Path(__file__).resolve().parents[1]
JAX_TESTS = REPO / "tests" / "test_analysis.py"
# cases of the JAX tests that pin the kMaxIovSegs / _MAX_IOV_SEGS mirror,
# which the port's native-mirror does not check (the batching is C's alone)
NOT_PORTED = {
    "TestNativeMirror": ("test_drifted_iovec_cap_flagged", "test_missing_iovec_cap_flagged",
                         "test_binding_missing_iov_constant_flagged"),
}


def _ported_cases() -> dict:
    """The JAX test module's classes, compiled from its source with every
    ``torchft_tpu`` name rewritten to ``torchft_tpu_torch``."""
    source = re.sub(r"\btorchft_tpu\b", "torchft_tpu_torch", JAX_TESTS.read_text())
    module = types.ModuleType("ported_test_analysis")
    module.__file__ = str(JAX_TESTS)
    exec(compile(source, f"{JAX_TESTS} (ported)", "exec"), module.__dict__)
    out = {}
    for name, obj in vars(module).items():
        if isinstance(obj, type) and name.startswith("Test"):
            for case in NOT_PORTED.get(name, ()):
                delattr(obj, case)
            ported = f"TestPorted{name.removeprefix('Test')}"
            obj.__name__ = obj.__qualname__ = ported
            obj.__module__ = __name__
            out[ported] = obj
    return out


globals().update(_ported_cases())


def test_the_not_ported_cases_exist_in_the_jax_tests() -> None:
    text = JAX_TESTS.read_text()
    for cases in NOT_PORTED.values():
        for case in cases:
            assert f"def {case}(" in text


def test_cli_exits_zero_on_the_tree_with_an_empty_baseline() -> None:
    baseline = REPO / "torchft_tpu_torch" / "analysis" / "baseline.json"
    assert json.loads(baseline.read_text())["suppressions"] == []
    proc = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.analysis", "--format", "json"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    run = json.loads(proc.stdout)
    assert run["counts"]["new"] == 0 and run["counts"]["baselined"] == 0
    assert run["stale_baseline"] == []
    # the suppressions are the port's own pragmas, in the port's files
    assert {f["file"].split("/")[0] for f in run["findings"]} == {"torchft_tpu_torch"}


def test_the_checkers_are_the_jax_packages_nine() -> None:
    from torchft_tpu.analysis import CHECKERS as JAX_CHECKERS

    assert CHECKERS == JAX_CHECKERS and len(CHECKERS) == 9


def test_paths_point_at_the_port() -> None:
    from torchft_tpu_torch.analysis import knobcheck, metricscheck, nativelocks, nativemirror

    assert core.default_baseline_path(str(REPO)) == str(
        REPO / "torchft_tpu_torch" / "analysis" / "baseline.json")
    assert knobcheck._SCAN_ROOTS == metricscheck._SCAN_ROOTS == ("torchft_tpu_torch",
                                                                 "chip_smoke.py")
    assert knobcheck._DOC_REL == metricscheck._DOC_REL == os.path.join("docs",
                                                                      "torch_operations.md")
    native = os.path.join("torchft_tpu_torch", "csrc", "native")
    assert nativelocks._NATIVE_DIR == native
    assert nativemirror._COMM_H == os.path.join(native, "comm.h")
    assert nativemirror._BINDING == os.path.join("torchft_tpu_torch", "native.py")


def test_registries_tables_are_the_ports_doc() -> None:
    """``docs/torch_operations.md`` carries the tables the two registries
    generate."""
    from torchft_tpu_torch import knobs
    from torchft_tpu_torch.obs import metrics

    doc = (REPO / "docs" / "torch_operations.md").read_text()
    assert knobs.operations_md_table() in doc
    assert metrics.operations_md_table() in doc


@pytest.fixture(scope="module")
def clean_copy(tmp_path_factory) -> Path:
    """The files the port's checkers read, copied."""
    root = tmp_path_factory.mktemp("port_tree")
    shutil.copytree(REPO / "torchft_tpu_torch", root / "torchft_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.cu", "*.cuh"))
    (root / "docs").mkdir()
    for rel in ("chip_smoke.py", "pyproject.toml", "docs/torch_operations.md"):
        shutil.copy(REPO / rel, root / rel)
    return root


def _seed_module(source: str):
    def seed(root: Path) -> None:
        (root / "torchft_tpu_torch" / "seeded.py").write_text(textwrap.dedent(source))

    return seed


def _edit(rel: str, old: str, new: str):
    def seed(root: Path) -> None:
        path = root / rel
        text = path.read_text()
        assert old in text, (rel, old)
        path.write_text(text.replace(old, new, 1))

    return seed


SEEDS = {
    "thread-safety": (_seed_module("""
        import threading

        class Server:
            def __init__(self):
                self._inflight_ops = 0
                self._lock = threading.Lock()

            def start(self):
                threading.Thread(target=self._loop, daemon=True).start()

            def _loop(self):
                self._inflight_ops += 1

            def submit_op(self):
                self._inflight_ops += 1
        """), "_inflight_ops"),
    "lock-order": (_seed_module("""
        class S:
            def a_then_b(self):
                with self._a_lock:
                    with self._b_lock:
                        self._x = 1

            def b_then_a(self):
                with self._b_lock:
                    with self._a_lock:
                        self._x = 2
        """), "_a_lock"),
    "blocking-under-lock": (_seed_module("""
        import time

        class S:
            def poll(self):
                with self._lock:
                    time.sleep(0.5)
        """), "S.poll"),
    "executor-starvation": (_seed_module("""
        import concurrent.futures

        class S:
            def __init__(self):
                self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)

            def kick(self):
                self._executor.submit(self._task)

            def _task(self):
                self._executor.submit(self._cleanup).result()

            def _cleanup(self):
                pass
        """), "S._task._executor"),
    "wire-protocol": (_seed_module("""
        def f(comm, x):
            comm.allgather(x, tag=666)
        """), "666"),
    "knob-registry": (_seed_module("""
        import os

        LANES = os.environ.get("TORCHFT_SEEDED_UNDECLARED_KNOB", "1")
        """), "TORCHFT_SEEDED_UNDECLARED_KNOB"),
    "metrics-registry": (_seed_module("""
        from torchft_tpu_torch.obs.metrics import metric_sample

        def sample():
            return metric_sample("torchft_mgr_seeded_undeclared_total", 1)
        """), "torchft_mgr_seeded_undeclared_total"),
    "native-mirror": (_edit("torchft_tpu_torch/csrc/native/wire.h", "kMaxFrameBytes =",
                            "kMaxFrameBytes = 2 * "), "kMaxFrameBytes"),
    "native-locks": (_edit("torchft_tpu_torch/csrc/native/comm.h", "class ",
                           "class SeededDeadMutex {\n  std::mutex dead_mu_;\n};\n\nclass "),
                     "mutex.dead_mu_"),
}


def test_every_checker_has_a_seed() -> None:
    assert set(SEEDS) == set(CHECKERS)


@pytest.mark.parametrize("checker", CHECKERS)
def test_each_checker_flags_a_drift_seeded_into_the_ports_files(checker, clean_copy,
                                                                tmp_path) -> None:
    clean = core.run_checkers(root=str(clean_copy), checkers=[checker])
    assert clean.new == [], "\n".join(f.render() for f in clean.new)
    root = tmp_path / "seeded"
    shutil.copytree(clean_copy, root)
    seed, symbol = SEEDS[checker]
    seed(root)
    found = core.run_checkers(root=str(root), checkers=[checker]).new
    assert found and all(f.checker == checker for f in found)
    assert any(symbol in f.symbol or symbol in f.message for f in found), \
        "\n".join(f.render() for f in found)
    # the same drift in the CLI's exit status
    assert cli.main(["--root", str(root), "--checker", checker, "-q"]) == 1
