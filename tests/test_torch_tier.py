"""Tier dispatch of the port (``torchft_tpu_torch/tier.py``) held against the
JAX package's ``tier.py``: the same ``TORCHFT_TIER`` / ``TORCHFT_HIERARCHICAL``
settings resolve to the same tier in both, ``Manager(comm=None)`` takes the
C++ communicator under ``auto`` and the Python one under ``python``, and an
explicit C++ tier whose library does not load raises instead of falling
back."""

import shutil

import pytest

import torchft_tpu.native as jnative
from torchft_tpu import tier as jtier
from torchft_tpu_torch import native, tier
from torchft_tpu_torch.manager import Manager

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    monkeypatch.delenv("TORCHFT_TIER", raising=False)
    monkeypatch.delenv("TORCHFT_HIERARCHICAL", raising=False)
    assert native.available(), native._lib_error


@pytest.mark.parametrize(
    "env, hier, want",
    [
        (None, None, "cpp"),
        ("auto", None, "cpp"),
        ("python", None, "python"),
        ("cpp", None, "cpp"),
        (None, "1", "python"),  # auto downgrades under forced hierarchy
        ("cpp", "1", "cpp"),  # an explicit cpp wins, with a warning
        ("python", "1", "python"),
        ("bogus", None, "cpp"),  # unknown values read as auto
    ],
)
def test_data_plane_tier_resolves_as_in_the_jax_package(monkeypatch, env, hier, want) -> None:
    if env is not None:
        monkeypatch.setenv("TORCHFT_TIER", env)
    if hier is not None:
        monkeypatch.setenv("TORCHFT_HIERARCHICAL", hier)
    assert tier.data_plane_tier() == want
    if jnative.available():
        assert jtier.data_plane_tier() == want


def test_forced_hierarchical_downgrades_loudly(monkeypatch, caplog) -> None:
    monkeypatch.setenv("TORCHFT_HIERARCHICAL", "1")
    with caplog.at_level("WARNING", logger="torchft_tpu_torch.tier"):
        assert tier.data_plane_tier() == "python"
    assert any("downgraded" in r.message for r in caplog.records)
    comm = tier.make_communicator(timeout_s=5.0)
    assert type(comm).__name__ == "TCPCommunicator"
    comm.shutdown()


@pytest.mark.parametrize("name", ["cpp", "python"])
def test_factories_build_the_named_tier(name) -> None:
    comm = tier.make_communicator(timeout_s=5.0, tier=name)
    lighthouse = tier.make_lighthouse(bind="127.0.0.1:0", tier=name)
    try:
        prefix = "Cpp" if name == "cpp" else ""
        assert type(comm).__name__ == ("CppCommunicator" if name == "cpp" else "TCPCommunicator")
        assert type(lighthouse).__name__ == f"{prefix}LighthouseServer"
        assert tier.manager_server_cls(name).__name__ == f"{prefix}ManagerServer"
        # the port's own classes, never the JAX package's
        for obj in (comm, lighthouse, tier.manager_server_cls(name)):
            module = obj.__module__ if isinstance(obj, type) else type(obj).__module__
            assert module.startswith("torchft_tpu_torch.")
    finally:
        comm.shutdown()
        lighthouse.shutdown()


@pytest.mark.parametrize("env, want", [(None, "CppCommunicator"), ("python", "TCPCommunicator")])
def test_manager_defaults_to_the_tier_factory(monkeypatch, env, want) -> None:
    """A Manager built without a comm rides the tier factory: the C++ mesh
    under auto, the Python ring under ``TORCHFT_TIER=python``."""
    if env is not None:
        monkeypatch.setenv("TORCHFT_TIER", env)
    lh = tier.make_lighthouse(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=50,
                              quorum_tick_ms=20)
    manager = None
    try:
        manager = Manager(
            min_replica_size=1, replica_id="tier_default_0",
            lighthouse_addr=lh.local_address(), timeout=10.0, quorum_timeout=10.0,
            use_async_quorum=False, server_cls=tier.manager_server_cls(),
        )
        assert type(manager._comm).__name__ == want
        assert type(manager._manager_server).__name__ == (
            "CppManagerServer" if env is None else "ManagerServer")
    finally:
        if manager is not None:
            manager.shutdown()
        lh.shutdown()


def test_a_failed_build_falls_back_under_auto_and_raises_when_named(monkeypatch) -> None:
    """``auto`` falls back to the Python tier when the library does not
    load (the reference's documented behaviour); a named ``cpp`` raises with
    the build error instead of falling back."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_error", "g++ failed: injected")
    assert tier.default_tier() == "python"
    assert tier.data_plane_tier() == "python"
    fallback = tier.make_communicator(timeout_s=5.0)
    assert type(fallback).__name__ == "TCPCommunicator"
    fallback.shutdown()
    with pytest.raises(RuntimeError, match="injected"):
        tier.make_communicator(timeout_s=5.0, tier="cpp")
    with pytest.raises(RuntimeError, match="injected"):
        tier.make_lighthouse(bind="127.0.0.1:0", tier="cpp")
