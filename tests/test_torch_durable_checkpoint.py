"""Durable job checkpoints of the port (``torchft_tpu_torch/utils/checkpoint.py``)
against the JAX package's (``torchft_tpu/utils/checkpoint.py``), and the
job-loss path built on them (``train_diloco --algo localsgd --ckpt-dir``).

- The three cases of ``tests/test_durable_checkpoint.py`` run on the same
  numpy inputs through both packages; the port's bf16 leaves come back bit
  for bit, equal to the JAX package's bf16 bits.
- ``load_latest`` falls back past a torn step dir in both packages; in the
  port a step dir the JAX package wrote raises ``ForeignSnapshotError``
  instead of being skipped (ROADMAP §C22), and a filesystem short of space
  raises ``InsufficientSpaceError`` before anything is written.
- A corrupt newest step dir falls back to the step before it in both
  packages (ROADMAP §C25): byte 28 of ``step_2/state.tftc``, the first
  character of a module name in the pickled skeleton, set to 0; and each
  byte of each package's own step-2 file set to 0 in turn, where
  ``load_latest`` never raises and returns step 1 or step 2.
- ``train_diloco.main(--algo localsgd --ckpt-dir ...)`` run twice: the
  second run resumes at the saved step; ``--algo diloco`` refuses the flag.
- Two ``run_diloco_fleet`` calls with one ``ckpt_dir`` are a job loss: the
  model and optimizer state hashed at the save equals the state hashed on
  both replicas just after the restore, with no heal.
"""

import hashlib
import logging
import os
import shutil
import tempfile
from collections import namedtuple

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torchft_tpu.utils import checkpoint as jax_ckpt
from torchft_tpu_torch import train_ddp, train_diloco
from torchft_tpu_torch.checkpointing.serialization import ForeignSnapshotError
from torchft_tpu_torch.lighthouse import LighthouseServer
from torchft_tpu_torch.utils import checkpoint as ckpt

RNG_SEED = 0


def _inputs():
    rng = np.random.default_rng(RNG_SEED)
    return {
        "w": rng.normal(size=(6, 5)).astype(np.float32),
        "b16": rng.normal(size=(7, 3)).astype(ml_dtypes.bfloat16),
        "i": rng.integers(0, 100, size=(4,)).astype(np.int64),
    }


def _port_state(x) -> dict:
    return {
        "model": {
            "w": torch.from_numpy(x["w"].copy()),
            "b16": torch.from_numpy(x["b16"].view(np.int16).copy()).view(torch.bfloat16),
        },
        "optim": {"i": torch.from_numpy(x["i"].copy())},
        "torchft": {"step": 5, "batches_committed": 10},
    }


def _jax_state(x) -> dict:
    return {
        "model": {"w": jnp.asarray(x["w"]), "b16": jnp.asarray(x["b16"])},
        "optim": {"i": np.asarray(x["i"])},
        "torchft": {"step": 5, "batches_committed": 10},
    }


def test_roundtrip_and_latest(tmp_path) -> None:
    x = _inputs()
    base, jbase = str(tmp_path / "port"), str(tmp_path / "jax")
    assert ckpt.latest_step(base) is None and jax_ckpt.latest_step(jbase) is None
    ckpt.save_checkpoint(base, 5, _port_state(x))
    jax_ckpt.save_checkpoint(jbase, 5, _jax_state(x))
    assert ckpt.latest_step(base) == jax_ckpt.latest_step(jbase) == 5
    got, want = ckpt.load_checkpoint(base, 5), jax_ckpt.load_checkpoint(jbase, 5)
    assert got["torchft"] == want["torchft"] == {"step": 5, "batches_committed": 10}
    for leaf in ("w",):
        assert got["model"][leaf].dtype == torch.float32
        np.testing.assert_array_equal(got["model"][leaf].numpy(), np.asarray(want["model"][leaf]))
    b16 = got["model"]["b16"]
    assert b16.dtype == torch.bfloat16 and b16.device.type == "cpu"
    np.testing.assert_array_equal(  # bit for bit, against the JAX package's bits
        b16.view(torch.int16).numpy(), np.asarray(want["model"]["b16"]).view(np.int16))
    np.testing.assert_array_equal(got["optim"]["i"].numpy(), np.asarray(want["optim"]["i"]))


def test_prunes_old_steps(tmp_path) -> None:
    for name, mod in (("port", ckpt), ("jax", jax_ckpt)):
        base = str(tmp_path / name)
        for step in range(6):
            mod.save_checkpoint(base, step, {"s": step}, keep=3)
        assert mod.latest_step(base) == 5
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(base) if d.startswith("step_"))
        assert steps == [3, 4, 5], name


def test_overwrite_same_step(tmp_path) -> None:
    for name, mod in (("port", ckpt), ("jax", jax_ckpt)):
        base = str(tmp_path / name)
        mod.save_checkpoint(base, 1, {"v": 1})
        mod.save_checkpoint(base, 1, {"v": 2})
        assert mod.load_checkpoint(base, 1) == {"v": 2}, name


def test_load_latest_falls_back_past_a_torn_step_dir(tmp_path) -> None:
    x = _inputs()
    for name, mod, state in (("port", ckpt, _port_state(x)), ("jax", jax_ckpt, _jax_state(x))):
        base = str(tmp_path / name)
        mod.save_checkpoint(base, 3, state)
        mod.save_checkpoint(base, 4, state)
        torn = os.path.join(base, "step_4", "state.tftc")
        with open(torn, "r+b") as f:
            f.truncate(os.path.getsize(torn) // 2)
        step, loaded = mod.load_latest(base)
        assert step == 3 and loaded["torchft"]["step"] == 5, name
        shutil.rmtree(os.path.join(base, "step_3"))
        assert mod.load_latest(base) is None, name


def test_load_latest_refuses_a_jax_written_step_dir(tmp_path) -> None:
    """ROADMAP §C22: the JAX package's ``load_latest`` skips any step dir
    that fails to load; the port's lets the refusal of a JAX-written one
    through, rather than rewind the job to the older port-written step."""
    x = _inputs()
    base = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(base, 3, _port_state(x))
    jax_ckpt.save_checkpoint(base, 4, _jax_state(x))
    assert jax_ckpt.load_latest(base)[0] == 4
    with pytest.raises(ForeignSnapshotError, match="written by the JAX package"):
        ckpt.load_latest(base)
    with pytest.raises(ForeignSnapshotError):
        ckpt.load_checkpoint(base, 4)
    assert ckpt.load_checkpoint(base, 3)["torchft"]["step"] == 5


def _step_file(mod, state) -> bytes:
    """The bytes of ``step_2/state.tftc`` that ``mod`` writes for ``state``."""
    with tempfile.TemporaryDirectory() as base:
        mod.save_checkpoint(base, 2, state)
        with open(os.path.join(base, "step_2", "state.tftc"), "rb") as f:
            return f.read()


# ROADMAP §C25's state: {"w": ones(2)} in each package, saved at steps 1 and 2
C25_STATE = {"port": (ckpt, lambda: {"w": torch.ones(2)}),
             "jax": (jax_ckpt, lambda: {"w": np.ones(2, np.float32)})}
C25_FILES = {name: _step_file(mod, make()) for name, (mod, make) in C25_STATE.items()}


def _damaged_ckpt_dir(tmp_path, name: str, offset: int) -> str:
    """Steps 1 and 2 of §C25's state, byte ``offset`` of step 2's file set
    to 0; returns the checkpoint dir."""
    mod, make = C25_STATE[name]
    base = str(tmp_path / name)
    mod.save_checkpoint(base, 1, make())
    mod.save_checkpoint(base, 2, make())
    data = bytearray(C25_FILES[name])
    data[offset] = 0
    with open(os.path.join(base, "step_2", "state.tftc"), "wb") as f:
        f.write(data)
    return base


def _ones(w) -> bool:
    return np.array_equal(np.asarray(w), np.ones(2, np.float32))


@pytest.mark.parametrize("name", sorted(C25_STATE))
def test_load_latest_falls_back_past_a_corrupt_skeleton_c25(tmp_path, name) -> None:
    """ROADMAP §C25: byte 28 of step 2's file is the first character of a
    module name in the pickled skeleton; set to 0, the port's loader raised
    ``ModuleNotFoundError`` out of ``load_latest`` instead of restoring
    step 1, as the JAX package does."""
    mod, _ = C25_STATE[name]
    base = _damaged_ckpt_dir(tmp_path, name, 28)
    with pytest.raises(Exception):
        mod.load_checkpoint(base, 2)
    step, state = mod.load_latest(base)
    assert step == 1 and _ones(state["w"])


@pytest.mark.parametrize("name, offset", [
    (name, offset) for name in sorted(C25_FILES) for offset in range(len(C25_FILES[name]))])
def test_load_latest_never_raises_on_a_zeroed_byte_c25(tmp_path, name, offset) -> None:
    """Every byte of each package's own step-2 file, set to 0 in turn:
    ``load_latest`` restores step 1 of the same state, or step 2 where the
    change left it loadable (a zero byte changed to 0, or a payload byte,
    which no format check covers)."""
    mod, _ = C25_STATE[name]
    step, state = mod.load_latest(_damaged_ckpt_dir(tmp_path, name, offset))
    assert step in (1, 2)
    if step == 1:
        assert _ones(state["w"])


def test_short_filesystem_raises_before_writing(tmp_path, monkeypatch) -> None:
    base = str(tmp_path / "ckpt")
    usage = namedtuple("usage", "total used free")
    monkeypatch.setattr(ckpt.shutil, "disk_usage", lambda _p: usage(100, 90, 10))
    with pytest.raises(ckpt.InsufficientSpaceError, match="needs"):
        ckpt.save_checkpoint(base, 1, _port_state(_inputs()))
    assert os.listdir(base) == []


def test_save_digest_and_timings_match_the_state_hash(tmp_path, monkeypatch) -> None:
    """The digest a save takes of what it writes is ``state_digest`` of the
    state, and of the loaded state: what the job-loss check compares.  It
    is the sha256 of the sha256 of each leaf's chunks, in order."""
    monkeypatch.setattr(ckpt, "CHUNK_BYTES", 8)  # many chunks a leaf
    state = _port_state(_inputs())
    timings = {}
    with ckpt.ChunkDigest(workers=3) as digest:
        ckpt.save_checkpoint(str(tmp_path), 2, state, timings=timings, digest=digest)
        saved = digest.hexdigest()
    assert saved == ckpt.state_digest(state)
    assert ckpt.state_digest(ckpt.load_checkpoint(str(tmp_path), 2)) == saved
    leaves = [state["model"]["w"], state["model"]["b16"], state["optim"]["i"]]
    chunks = []
    for t in leaves:
        raw = t.contiguous().view(torch.uint8).numpy().tobytes()
        chunks += [raw[i:i + 8] for i in range(0, len(raw), 8)]
    want = hashlib.sha256(b"".join(hashlib.sha256(c).digest() for c in chunks))
    assert saved == want.hexdigest()
    assert saved != ckpt.state_digest({"w": leaves[0]})
    assert timings["bytes"] == os.path.getsize(tmp_path / "step_2" / "state.tftc")
    assert {"host_copy_s", "write_s", "fsync_s"} <= set(timings)
    # the file is what the port's serializer writes for the same state
    from torchft_tpu_torch.checkpointing.serialization import dumps_pytree

    assert (tmp_path / "step_2" / "state.tftc").read_bytes() == dumps_pytree(state)


@pytest.mark.parametrize("workers", [1, 4])
def test_chunk_digest_is_the_sha256_of_chunk_sha256s(workers, monkeypatch) -> None:
    monkeypatch.setattr(ckpt, "CHUNK_BYTES", 5)
    data = [bytes(range(13)), b"", bytes(range(100, 105))]
    with ckpt.ChunkDigest(workers=workers) as digest:
        for d in data:
            digest.submit(d)
        got = digest.hexdigest()
    chunks = [bytes(range(0, 5)), bytes(range(5, 10)), bytes(range(10, 13)),
              bytes(range(100, 105))]
    want = hashlib.sha256(b"".join(hashlib.sha256(c).digest() for c in chunks))
    assert got == want.hexdigest()


@pytest.fixture
def lighthouse(monkeypatch):
    server = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100,
                              quorum_tick_ms=20)
    monkeypatch.setenv("TORCHFT_LIGHTHOUSE", server.local_address())
    monkeypatch.setenv("TORCHFT_TIER", "python")
    yield server
    server.shutdown()


CLI = ["--algo", "localsgd", "--device", "cpu", "--model", "llama_debug", "--seq-len", "64",
       "--batch-size", "2", "--sync-every", "2", "--min-replicas", "1", "--comm-timeout", "30"]


def test_cli_resumes_at_the_saved_step(tmp_path, lighthouse, capsys, caplog) -> None:
    base = str(tmp_path / "ckpt")
    caplog.set_level(logging.INFO, logger="train_diloco")
    train_diloco.main(CLI + ["--total-syncs", "1", "--ckpt-dir", base])
    assert "FINAL step=1 " in capsys.readouterr().out
    assert ckpt.latest_step(base) == 1
    saved = ckpt.load_checkpoint(base, 1)
    # the Manager's state in the JAX package's form, beside the model and AdamW
    assert saved["torchft"] == {"step": 1, "batches_committed": 1}
    assert set(saved) == {"model", "optim", "torchft"}
    caplog.clear()
    train_diloco.main(CLI + ["--total-syncs", "2", "--ckpt-dir", base])
    assert "FINAL step=2 " in capsys.readouterr().out
    text = caplog.text
    assert "restored durable checkpoint at step 1" in text
    assert "2 inner steps in" in text  # one sync of 2 inner steps, not two
    assert sorted(ckpt._all_steps(base)) == [1, 2]


def test_durable_checkpoints_refuse_diloco(tmp_path) -> None:
    with pytest.raises(train_diloco.DurableCheckpointError, match="localsgd"):
        train_diloco.main(["--algo", "diloco", "--device", "cpu", "--model", "llama_debug",
                           "--ckpt-dir", str(tmp_path)])
    with pytest.raises(train_diloco.DurableCheckpointError):
        train_diloco.run_diloco_fleet(train_ddp.model_config("llama_debug", None),
                                      torch.device("cpu"), algo="diloco", ckpt_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_fleet_job_loss_restores_the_saved_state_bit_for_bit(tmp_path) -> None:
    cfg = train_ddp.model_config("llama_debug", None)
    base = str(tmp_path / "ckpt")
    kw = dict(algo="localsgd", sync_every=2, num_fragments=1, fragment_sync_delay=0, batch=2,
              seq=64, tier="python", timeout=60.0, ckpt_dir=base)
    first = train_diloco.run_diloco_fleet(cfg, torch.device("cpu"), outer_steps=1, **kw)
    saves = [sv for r in first for sv in r.saves]
    assert [r.restored for r in first] == [None, None]
    assert [sv["step"] for sv in saves] == [1]  # one writer: the participating rank 0
    restored = train_diloco.run_diloco_fleet(cfg, torch.device("cpu"), outer_steps=2, **kw)
    for r in restored:
        assert r.restored["step"] == r.restored["manager_step"] == 1
        assert r.restored["digest"] == saves[0]["digest"]
        assert r.heal is None and r.final_step == 2 and r.restarts == 0
        assert all(np.isfinite(r.losses))
    assert len({r.params_sha256 for r in restored}) == 1
    assert [sv["step"] for r in restored for sv in r.saves] == [2]
    assert sorted(ckpt._all_steps(base)) == [1, 2]
