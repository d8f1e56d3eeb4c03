"""The port's chaos drill (``python -m torchft_tpu_torch.chaos_drill``), the
twin of ``examples/chaos_drill.py``: it supervises ``python -m
torchft_tpu_torch.train_ddp`` processes, injects a failure, awaits the heal
and checks that every replica ends with the same parameters.

- Its progress reader applies the JAX example's two patterns, and they
  match the lines the port's ``train_ddp`` logs.
- ``kill`` and ``deadlock`` (SIGSTOP past the peers' 5 s op timeout) on
  ``llama_debug`` on the CPU, end to end, each in under a minute here.
- The drill's timing follows the workers' planned step: at the JAX
  example's CPU step it is the example's constants; a slower step
  lengthens the per-op timeout, the freeze (which outlasts the timeout and
  the heartbeat) and the deadlines; a deadlock on workers paced to a 1.5 s
  step runs with the timeout and freeze that step gives.  The CLI's
  workers stay on the card at ``llama3_8b`` width cut to 1 layer, and its
  pace and work default by device to the card's step or the example's.
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


def test_timing_is_the_examples_at_its_cpu_step() -> None:
    """At the JAX example's pace (0.15 s) and its 0.4 s allowance, the
    drill's timing is the example's: a 5 s per-op timeout, a 12 s freeze,
    a finish deadline of 60 + steps * 0.55 s."""
    example = (REPO / "examples" / "chaos_drill.py").read_text()
    assert '"--comm-timeout", "5"' in example
    assert '"--freeze-secs", type=float, default=12.0' in example
    assert "60.0 + args.steps * (args.step_time + 0.4)" in example
    assert chaos_drill.STEP_DEFAULTS["cpu"] == (0.15, 0.4)
    t = chaos_drill.drill_timing(0.15 + 0.4, 120, pace_s=0.15)
    assert t.comm_timeout_s == 5.0 and t.freeze_s == 12.0
    assert t.finish_timeout_s == pytest.approx(60.0 + 120 * 0.55)
    assert t.warmup_timeout_s >= 180.0 and t.heal_timeout_s >= 300.0


@pytest.mark.parametrize("step_s", [0.55, 2.4, 12.0, 20.15])
def test_timing_follows_a_slow_step(step_s) -> None:
    """A slower step lengthens every timeout: the per-op timeout holds
    three times a step's work past the pace, the freeze outlasts it and the
    heartbeat, and the heal and finish deadlines cover the freeze and the
    steps."""
    t = chaos_drill.drill_timing(step_s, 12, pace_s=0.15)
    faster = chaos_drill.drill_timing(step_s / 2, 12, pace_s=0.15)
    assert t.comm_timeout_s >= max(5.0, 3 * (step_s - 0.15))
    assert t.freeze_s > t.comm_timeout_s + chaos_drill.HEARTBEAT_S
    assert t.heal_timeout_s > t.freeze_s + t.comm_timeout_s + step_s
    assert t.finish_timeout_s >= 12 * step_s and t.warmup_timeout_s >= 5 * step_s
    for key in ("comm_timeout_s", "freeze_s", "warmup_timeout_s", "heal_timeout_s",
                "finish_timeout_s"):
        assert getattr(t, key) >= getattr(faster, key), key
    # what the caller pins is kept
    pinned = chaos_drill.drill_timing(step_s, 12, comm_timeout_s=7.0, freeze_s=9.0)
    # the pace is no work: a slower pace alone keeps the timeout
    assert chaos_drill.drill_timing(step_s + 1.0, 12, pace_s=1.15).comm_timeout_s == (
        t.comm_timeout_s)
    assert (pinned.comm_timeout_s, pinned.freeze_s) == (7.0, 9.0)


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:0"])
def test_cli_pace_and_work_default_by_device(device, monkeypatch) -> None:
    """Without ``--step-time`` and ``--step-work`` the CLI plans for its
    device's step (``STEP_DEFAULTS``), whatever the model; either flag
    overrides its half alone."""
    seen = []
    monkeypatch.setattr(chaos_drill, "run_drill", lambda *a: seen.append(a) or {
        "params_sha": "0" * 16, "events": [], "inject_to_commit_s": 0.0, "wall_s": 0.0,
        "finals": {}})
    pace, work = chaos_drill.STEP_DEFAULTS[device.split(":")[0]]
    assert chaos_drill.main(["--device", device, "--model", "cnn"]) == 0
    assert seen[-1][5:7] == (pace, work)
    assert chaos_drill.main(["--device", device, "--step-time", "0.5"]) == 0
    assert seen[-1][5:7] == (0.5, work)
    assert chaos_drill.main(["--device", device, "--step-work", "2.5"]) == 0
    assert seen[-1][5:7] == (pace, 2.5)


def test_cli_workers_stay_on_the_card_at_llama3_8b_width(monkeypatch) -> None:
    """The CLI's default workers: ``--device cuda --model llama3_8b
    --layers 1``, and it plans for the card's step at that width (a pace as
    long as a step's work), so the per-op timeout holds a healthy step
    there."""
    seen = []
    monkeypatch.setattr(chaos_drill, "run_drill", lambda *a: seen.append(a) or {
        "params_sha": "0" * 16, "events": [], "inject_to_commit_s": 0.0, "wall_s": 0.0,
        "finals": {}})
    assert chaos_drill.main([]) == 0
    (replicas, failure, victim, steps, freeze, step_time, step_work, worker), = seen
    assert worker[worker.index("--device") + 1] == "cuda"
    assert worker[worker.index("--model") + 1] == "llama3_8b"
    assert worker[worker.index("--layers") + 1] == "1"
    assert (step_time, step_work, freeze) == (10.0, 10.0, None)
    t = chaos_drill.drill_timing(step_time + step_work, steps, pace_s=step_time)
    assert (t.comm_timeout_s, t.freeze_s) == (30.0, 37.0)


def test_a_freeze_inside_the_timeout_is_refused() -> None:
    """A deadlock that thaws before the per-op timeout is never evicted."""
    with pytest.raises(ValueError, match="does not outlast"):
        chaos_drill.run_drill(failure="deadlock", freeze_secs=5.0)


def test_a_deadlock_the_survivors_would_outrun_is_refused() -> None:
    """Survivors that finish their steps before the frozen member thaws
    leave it to train on alone, and the replicas diverge.  Alone, a
    survivor steps at its pace: 12 steps paced 1.5 s leave 6 after the
    injection, 9 s, against a 12 s freeze less the 5 s heartbeat and four
    1.9 s steps to rejoin."""
    t = chaos_drill.drill_timing(1.9, 12, pace_s=1.5)
    assert not t.survivors_outlast_freeze(12 - chaos_drill.WARMUP_STEPS - 1)
    assert t.survivors_outlast_freeze(24 - chaos_drill.WARMUP_STEPS - 1)
    with pytest.raises(ValueError, match="pass more --steps"):
        chaos_drill.run_drill(failure="deadlock", steps=12, step_time=1.5)


def test_deadlock_timing_follows_a_paced_step(tmp_path, monkeypatch) -> None:
    """Workers paced to 1.5 s a step, planned at 3.5 s a step (2 s of work
    past the pace): they run a 6 s per-op timeout, the freeze lasts 13 s and
    the finish deadline covers 24 planned steps; the frozen member is
    evicted, thaws, heals from its peer, and the replicas agree."""
    monkeypatch.setenv("TORCHFT_TIER", "python")  # no native build in each worker
    result = chaos_drill.run_drill(replicas=2, failure="deadlock", victim=1, steps=24,
                                   step_time=1.5, step_work=2.0, worker_args=WORKER,
                                   logdir=str(tmp_path))
    timing = result["timing"]
    assert (timing["pace_s"], timing["comm_timeout_s"]) == (1.5, pytest.approx(6.0))
    assert timing["freeze_s"] == pytest.approx(6.0 + chaos_drill.HEARTBEAT_S + 2.0)
    assert timing["step_s"] == 3.5
    assert timing["finish_timeout_s"] == pytest.approx(60.0 + 24 * 3.5)
    assert result["events"] == [("deadlock", "rg1")]
    assert result["inject_to_commit_s"] > timing["freeze_s"]
    assert {f["step"] for f in result["finals"].values()} == {"24"}
    # the frozen member rejoined behind the survivor and healed from it
    heals = re.findall(r"healing required, fetching checkpoint metadata from \S+ max_step=(\d+)",
                       Path(result["logs"][1]).read_text())
    assert max(map(int, heals)) > 0
