"""The port's chaos drill (``python -m torchft_tpu_torch.chaos_drill``), the
twin of ``examples/chaos_drill.py``: it supervises ``python -m
torchft_tpu_torch.train_ddp`` processes, injects a failure, awaits the heal
and checks that every replica ends with the same parameters.

- Its progress reader applies the JAX example's two patterns, and they
  match the lines the port's ``train_ddp`` logs.
- ``kill`` and ``deadlock`` (SIGSTOP past the peers' 5 s op timeout) on
  ``llama_debug`` on the CPU, end to end, each in under a minute here.
"""

import ast
import logging
import re
from pathlib import Path

import pytest
import torch

from torchft_tpu_torch import chaos_drill, train_ddp

REPO = Path(__file__).resolve().parents[1]
WORKER = ["--device", "cpu", "--model", "llama_debug", "--seq-len", "64", "--batch-size", "2"]


def _example_patterns() -> list:
    """The regex literals of ``re.findall`` calls in the JAX example."""
    tree = ast.parse((REPO / "examples" / "chaos_drill.py").read_text())
    return [
        node.args[0].value
        for node in ast.walk(tree)
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "findall"
        and isinstance(node.args[0], ast.Constant)
    ]


def test_progress_patterns_are_the_examples() -> None:
    patterns = _example_patterns()
    assert r"step (\d+) loss \S+ committed=True" in patterns
    assert r"FINAL step=(\d+)" in patterns
    assert r"FINAL step=(\d+) params_sha=(\w+)" in patterns
    source = Path(chaos_drill.__file__).read_text()
    for pattern in patterns:
        assert repr(pattern) in source or f'r"{pattern}"' in source, pattern


def test_progress_reads_the_ports_train_loop_lines(caplog) -> None:
    """Drive ``train_ddp.train_loop`` for two committed steps and read its
    log with the drill's reader: the lines the port writes are the ones
    the example's patterns take."""

    class _Mgr:
        step = 0

        def current_step(self):
            return self.step

        def num_participants(self):
            return 1

    mgr = _Mgr()

    class _Opt:
        def zero_grad(self):
            pass

        def step(self):
            mgr.step += 1
            return True

    class _Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(2))

        def loss(self, x, y):
            return (self.w * x).sum()

    caplog.set_level(logging.INFO, logger="train_ddp")
    original = train_ddp.allreduce_gradients
    train_ddp.allreduce_gradients = lambda *a, **k: None
    try:
        train_ddp.train_loop(mgr, _Model(), _Opt(), [(torch.ones(2), None)], 2)
    finally:
        train_ddp.allreduce_gradients = original
    text = caplog.text + "\nFINAL step=2 params_sha=0123abcd pid=1\n"
    assert chaos_drill.committed_progress(text) == 2
    assert re.findall(r"step (\d+) loss \S+ committed=True", caplog.text) == ["0", "1"]
    assert chaos_drill.committed_progress("step 7 loss 1.0 committed=False") == 0


def test_final_hashes_take_each_logs_last_line(tmp_path) -> None:
    a, b = tmp_path / "a.log", tmp_path / "b.log"
    a.write_text("FINAL step=3 params_sha=aaaa\nFINAL step=9 params_sha=bbbb pid=1\n")
    b.write_text("step 1 loss 2.0 committed=True\n")
    assert chaos_drill.final_hashes({0: a, 1: b}) == {0: "bbbb", 1: None}


@pytest.mark.parametrize("argv", [["--replicas", "1"], ["--victim", "2"]])
def test_cli_refuses_a_drill_without_a_peer(argv) -> None:
    with pytest.raises(SystemExit):
        chaos_drill.main(argv)


@pytest.mark.parametrize("failure, steps, freeze", [("kill", 20, 12.0), ("deadlock", 30, 6.0)])
def test_drill_heals_and_the_replicas_agree(failure, steps, freeze, tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("TORCHFT_TIER", "python")  # no native build in each worker
    result = chaos_drill.run_drill(replicas=2, failure=failure, victim=1, steps=steps,
                                   freeze_secs=freeze, step_time=0.15, worker_args=WORKER,
                                   logdir=str(tmp_path))
    assert result["events"] == [(failure, "rg1")]
    assert re.fullmatch(r"[0-9a-f]{16}", result["params_sha"])
    finals = re.findall(r"FINAL step=(\d+) .*", Path(result["logs"][1]).read_text())
    assert finals == [str(steps)]  # one process of the victim's group finished
    if failure == "kill":
        # the restarted incarnation healed its state from the peer
        final = re.search(r"FINAL step=\d+ .*", Path(result["logs"][1]).read_text()).group(0)
        assert int(re.search(r"heal_bytes=(\d+)", final).group(1)) > 0


def test_step_time_paces_train_ddp(monkeypatch) -> None:
    """``--step-time`` is parsed and sleeps before each step (the JAX
    example's pacing)."""
    import time

    naps: list = []
    monkeypatch.setattr(time, "sleep", naps.append)
    captured = {}

    def fake_loop(manager, model, opt, batches, steps, on_step=None, **kw):
        on_step(0)
        on_step(1)
        captured["steps"] = steps
        return []

    monkeypatch.setenv("TORCHFT_TIER", "python")  # no native build
    monkeypatch.setattr(train_ddp, "train_loop", fake_loop)
    monkeypatch.setattr(train_ddp, "Manager", lambda **kw: _StubManager())
    monkeypatch.setattr(train_ddp, "OptimizerWrapper", lambda m, o: None)
    train_ddp.main(WORKER + ["--steps", "2", "--step-time", "0.25"])
    assert naps == [0.25, 0.25] and captured["steps"] == 2


class _StubManager:
    _checkpoint_transport = None

    def current_step(self):
        return 0

    def shutdown(self):
        pass


@pytest.mark.parametrize("argv, layers", [([], "1"), (["--layers", "0"], "0")])
def test_cli_cuts_the_workers_to_one_layer_by_default(argv, layers, monkeypatch) -> None:
    """Two full-depth 8B workers do not fit one card: the CLI passes
    ``--layers 1`` unless told otherwise (0 keeps the preset's depth)."""
    seen = []
    monkeypatch.setattr(chaos_drill, "run_drill", lambda *a: seen.append(a[-1]) or {
        "params_sha": "0" * 16, "events": []})
    assert chaos_drill.main(argv) == 0
    args = seen[0]
    assert args[args.index("--layers") + 1] == layers
    assert args[args.index("--device") + 1] == "cuda"
