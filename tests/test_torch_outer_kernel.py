"""The port's outer-update kernel (``ops/outer.py``, ``csrc/outer.cu``) and
the sharded outer sync's card path, held against the host arithmetic.

- ``outer_update_plain`` bit for bit against the host pipeline's chunk sum
  and scale (``np.sum(np.stack(g), axis=0)``, ``acc *= 1/P``) followed by the
  port's numpy ``OuterSGD.update``, and against the JAX package's
  ``optax.sgd`` step, for w in {1, 2, 3}, Nesterov, plain momentum and none,
  on seeded inputs with -0.0, ±inf, NaN payloads (quiet and signaling) and
  subnormals.  Where two NaNs with different payloads meet in one operation
  the result's payload is numpy's own choice, which moves with the array's
  length (its vector loop may take either operand first): there the test
  holds that the result is NaN, not which NaN.
- The sharded sync's card path run on the CPU (``outer_sharded_sync(...,
  device=cpu)``: the wrappers take their plain versions there) against the
  host numpy path, bit for bit, at world sizes 1, 2 and 3 and on a
  hierarchical topology (the host leaders on the card path), float and
  int8; and whole DiLoCo runs through the card path (``local_sgd._sync_device``
  sending the CPU there) against the host path, bit for bit.
- ``_OuterShard`` with its state on a device exports f32 numpy in its
  reshard blob and ``save_state``, and loads rebuilt state back onto it.
- Card-only cases (marked ``cuda``; they skip here): the kernel against its
  plain version bit for bit, in place and out of place, at a ragged length;
  its launches counted; wrong dtypes and devices refused; two syncs on the
  card with the caller's stream held back before each staged copy of the
  trace, against the host path bit for bit (the sync's own stream must
  wait for that copy).  The module
  imports JAX only inside the optax test, so on the machine with the card::

      python -m pytest --noconftest -m cuda tests/test_torch_outer_kernel.py
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu_torch import collectives as tcoll
from torchft_tpu_torch import local_sgd as tlocal
from torchft_tpu_torch.communicator import TCPCommunicator
from torchft_tpu_torch.local_sgd import DiLoCo, _OuterShard
from torchft_tpu_torch.ops import outer as touter
from torchft_tpu_torch.optim import OuterSGD
from torchft_tpu_torch.store import StoreServer

LR, MOMENTUM = 0.7, 0.9
# (momentum, nesterov) of each update rule the kernel has
RULES = {"nesterov": (MOMENTUM, True), "momentum": (MOMENTUM, False), "sgd": (0.0, False)}
N = 4099  # ragged: no multiple of the kernel's or numpy's vector widths


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _f32(*bits: int) -> np.ndarray:
    return np.array(bits, dtype=np.uint32).view(np.float32)


def _inputs(w: int, seed: int = 0):
    """w contributions and a trace of N elements: normal values over many
    decades, then at fixed places -0.0, ±inf, NaN payloads and subnormals,
    placed so that at most one NaN payload reaches each element."""
    rng = np.random.default_rng(seed)
    c = (rng.standard_normal((w, N)) * 10.0 ** rng.integers(-30, 30, (w, N))).astype(np.float32)
    t = (rng.standard_normal(N) * 10.0 ** rng.integers(-30, 30, N)).astype(np.float32)
    c[:, 0], t[0] = -0.0, -0.0  # every operand -0
    c[:, 1], t[1] = -0.0, 0.0
    c[0, 2] = np.inf  # inf through every step
    c[0, 3] = -np.inf
    if w > 1:
        c[0, 4], c[1, 4] = np.inf, -np.inf  # inf - inf: the default NaN
    c[w - 1, 5] = _f32(0x7FC00123)[0]  # a quiet NaN's payload
    c[w - 1, 6] = _f32(0xFF800042)[0]  # a signaling NaN, made quiet
    t[7] = _f32(0x7FA00007)[0]  # a NaN in the trace only
    t[8] = np.inf  # inf in the trace: m·t' = inf, g + m·t' finite + inf
    c[:, 9], t[9] = -np.inf, np.inf  # -inf + m·inf: the default NaN
    c[:, 10:20] = _f32(0x00000001, 0x80000003, 0x007FFFFF, 0x00400000, 0x00000010,
                       0x80000100, 0x00012345, 0x807FFFFF, 0x00000002, 0x00000007)
    t[10:20] = _f32(0x00000005, 0x007FFFFE, 0x80000001, 0x00200000, 0x00000000,
                    0x80000000, 0x00100000, 0x00000001, 0x807FFFF0, 0x00001000)
    c[0, 20:24] = 1e-38  # normal, scaled into the subnormals by 1/P
    return c, t


def _host(c: np.ndarray, t: np.ndarray, participants: int, rule: str):
    """The host pipeline's arithmetic: np.sum over the stacked chunk (a
    single contribution is the chunk itself, as at world size 1), then
    ``acc *= 1/P`` and ``OuterSGD.update``."""
    momentum, nesterov = RULES[rule]
    acc = np.sum(np.stack(list(c)), axis=0) if len(c) > 1 else np.array(c[0])
    with np.errstate(invalid="ignore", over="ignore"):
        acc *= 1.0 / participants
        delta, state = OuterSGD(LR, momentum, nesterov).update(acc, [t] if momentum else [])
    return acc, delta, (state[0] if momentum else None)


def _plain(c: np.ndarray, t: np.ndarray, participants: int, rule: str, in_place: bool = False):
    momentum, nesterov = RULES[rule]
    delta = torch.empty(N)
    trace = torch.from_numpy(t.copy())
    new_trace = trace if in_place else torch.empty(N)
    touter.outer_update(torch.from_numpy(c), 1.0 / participants, delta, LR, momentum, nesterov,
                        trace if momentum else None, new_trace if momentum else None)
    return delta.numpy(), (new_trace.numpy() if momentum else None)


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("w,participants", [(1, 1), (2, 2), (3, 3), (2, 3)])
@pytest.mark.parametrize("in_place", [False, True], ids=["out", "in_place"])
def test_plain_is_the_host_pipeline_bit_for_bit(w, participants, rule, in_place) -> None:
    c, t = _inputs(w, seed=w)
    _acc, want_delta, want_trace = _host(c, t, participants, rule)
    delta, trace = _plain(c, t, participants, rule, in_place)
    np.testing.assert_array_equal(_bits(delta), _bits(want_delta))
    if want_trace is not None:
        np.testing.assert_array_equal(_bits(trace), _bits(want_trace))
    # the special values did reach the outputs
    assert np.isnan(delta[5]) and np.isnan(delta[6]) and np.isinf(delta[2]) and delta[0] == 0.0


def test_scale_is_f32_of_one_over_p() -> None:
    """``acc *= 1/P`` multiplies by f32(1/P) in f32 (numpy's weak Python
    scalar), the kernel's scale: at P = 3, not by the double 1/3."""
    x = np.random.default_rng(1).standard_normal(1 << 16).astype(np.float32)
    acc = x.copy()
    acc *= 1.0 / 3
    np.testing.assert_array_equal(_bits(acc), _bits(x * np.float32(1.0 / 3)))
    delta = torch.empty(x.size)
    touter.outer_update(torch.from_numpy(x)[None], 1.0 / 3, delta, -1.0)
    np.testing.assert_array_equal(_bits(delta), _bits(acc))


def test_nans_that_meet_stay_nan() -> None:
    """Two different NaN payloads meeting in one add: numpy's result is a
    NaN whose payload depends on the array's length; the plain version's is
    a NaN too."""
    c = np.zeros((2, N), dtype=np.float32)
    c[0, :8] = _f32(0x7FC00001)[0]
    c[1, :8] = _f32(0x7FC00002)[0]
    t = np.zeros(N, dtype=np.float32)
    t[8:16] = _f32(0x7FC00003)[0]
    c[0, 8:16] = _f32(0x7FC00004)[0]
    delta, trace = _plain(c, t, 2, "nesterov")
    _acc, want_delta, want_trace = _host(c, t, 2, "nesterov")
    for got, want in ((delta, want_delta), (trace, want_trace)):
        assert np.isnan(got[:16]).all() and np.isnan(want[:16]).all()
        np.testing.assert_array_equal(_bits(got[16:]), _bits(want[16:]))


@pytest.mark.parametrize("w", [1, 2, 3])
def test_plain_is_the_jax_packages_optax_step(w) -> None:
    """The JAX package sums a chunk in numpy (the tests above) and steps it
    with ``optax.sgd(0.7, 0.9, nesterov=True).update`` on the averaged chunk
    and a slice of the trace (``torchft_tpu/local_sgd.py`` ``_cb``),
    eagerly, as the sharded sync's tests run it.  XLA's CPU code flushes
    subnormal inputs and results to zero, so the plain version's update of
    the same average (one contribution, scale 1) is held against it with
    torch's flush-denormal mode on: bit for bit, -0, ±inf and NaN included.
    With subnormals kept (the port's numpy, the card) the two differ only
    where a subnormal is read or made."""
    import jax
    import jax.numpy as jnp
    import optax

    c, t = _inputs(w, seed=10 + w)
    acc, _delta, _trace = _host(c, t, w, "nesterov")
    tx = optax.sgd(LR, momentum=MOMENTUM, nesterov=True)
    state = tx.init(jnp.zeros(N, jnp.float32))
    state = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(state), [jnp.asarray(t)])
    updates, new_state = tx.update(jnp.asarray(acc), state)
    assert torch.set_flush_denormal(True)
    try:
        delta, trace = torch.empty(N), torch.empty(N)
        touter.outer_update(torch.from_numpy(acc.copy())[None], 1.0, delta, LR, MOMENTUM, True,
                            torch.from_numpy(t.copy()), trace)
    finally:
        torch.set_flush_denormal(False)
    np.testing.assert_array_equal(_bits(delta), _bits(np.asarray(updates)))
    np.testing.assert_array_equal(_bits(trace),
                                  _bits(np.asarray(jax.tree_util.tree_leaves(new_state)[0])))
    assert (np.asarray(updates)[10:20] != _delta[10:20]).any()  # the flush shows


def test_wrapper_checks_its_arguments() -> None:
    c = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="nesterov needs a momentum"):
        touter.outer_update(c, 0.5, torch.empty(8), LR, 0.0, True)
    with pytest.raises(ValueError, match="trace and new_trace"):
        touter.outer_update(c, 0.5, torch.empty(8), LR, MOMENTUM)
    with pytest.raises(ValueError, match="delta has 7"):
        touter.outer_update(c, 0.5, torch.empty(7), LR)
    with pytest.raises(ValueError, match=r"\[w >= 1, n\]"):
        touter.outer_update(torch.zeros(8), 0.5, torch.empty(8), LR)


# ---------------------------------------------------------------------------
# the sharded sync's card path, run on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture()
def store():
    server = StoreServer("127.0.0.1:0")
    yield server
    server.shutdown()


def _shard_update(n: int, gsize: int, gidx: int, quant: bool, device) -> _OuterShard:
    """An owner's shard with a nonzero trace, held on ``device`` (None: the
    host's numpy)."""
    shard = _OuterShard(OuterSGD(LR, MOMENTUM, nesterov=True), n, quant, device)
    _padded, per, _unit = tcoll.outer_shard_layout(n, gsize, quant)
    trace = np.random.default_rng(7 + gidx).standard_normal(per).astype(np.float32)
    meta = {"q": 1, "gsize": gsize, "gidx": gidx, "per": per, "n": n, "owns": True}
    shard._rebuild([(dict(meta), [trace])], meta)
    return shard


def _psg(rank: int, n: int) -> np.ndarray:
    return np.random.default_rng(100 + rank).normal(size=n).astype(np.float32)


def _sync_ranks(store, world: int, n: int, quant: bool, device, prefix: str, hosts=None):
    """One sharded sync on ``world`` threads as replicas (on ``hosts``, a
    hierarchical topology: the host leaders own the shards)."""
    def one(rank: int):
        kwargs = {} if hosts is None else {"host_id": hosts[rank], "hierarchical": "1"}
        comm = TCPCommunicator(timeout_s=30.0, **kwargs)
        comm.configure(f"127.0.0.1:{store.port}/{prefix}", replica_id=f"rep_{rank}", rank=rank,
                       world_size=world)
        try:
            topo = tcoll._hier_topology(comm)
            gsize, gidx, owns = world, rank, True
            assert (topo is None) == (hosts is None)
            if topo is not None:
                gsize, owns = len(topo["leader_ring"]), bool(topo["is_leader"])
                gidx = comm.leader_comm().rank() if owns else -1
            shard = _shard_update(n, gsize, gidx, quant, device) if owns else None
            seen = []
            delta = tcoll.outer_sharded_sync(
                comm, _psg(rank, n), shard.make_update_cb() if owns else tlocal._no_shard_cb,
                world, should_quantize=quant, tap=seen.append, device=device)
            staged = [np.zeros(0, np.float32)]
            if owns:
                shard.commit_stage()
                staged = [np.asarray(l) for l in tlocal._host_leaves(shard._state_leaves)]
            return np.asarray(delta), staged, seen
        finally:
            comm.shutdown()

    with ThreadPoolExecutor(max_workers=world) as pool:
        return list(pool.map(one, range(world)))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("world", [2, 3])
def test_card_path_is_the_host_path_bit_for_bit(store, world, quant, monkeypatch) -> None:
    """The card path's chunk arithmetic (gathered contributions to the
    device, the outer kernel, the delta back for the allgather, the
    allgathered deltas written into a device delta; on int8 the quantize and
    dequantize kernels) on the CPU, against the host numpy path: the same
    delta, the same staged trace and the same tapped bytes on every rank."""
    monkeypatch.setenv("TORCHFT_OUTER_CHUNK_MB", "0.05")  # many chunks
    monkeypatch.setenv(tcoll.DEVICE_REDUCE_ENV, "0")  # the host wire's numpy
    n = 70_000 + 13
    host = _sync_ranks(store, world, n, quant, None, f"h{world}{quant}")
    card = _sync_ranks(store, world, n, quant, torch.device("cpu"), f"c{world}{quant}")
    for (hd, hs, htap), (cd, cs, ctap) in zip(host, card):
        assert isinstance(cd, np.ndarray) and cd.shape == (n,)
        np.testing.assert_array_equal(_bits(cd), _bits(hd))
        np.testing.assert_array_equal(_bits(cs[0]), _bits(hs[0]))
        np.testing.assert_array_equal(_bits(ctap[0]), _bits(htap[0]))
    for d, _s, _t in card[1:]:
        np.testing.assert_array_equal(_bits(d), _bits(card[0][0]))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_card_path_on_hierarchical_leaders_is_the_host_path(store, quant, monkeypatch) -> None:
    """Three replicas on two hosts: the host leaders run the card path's
    chunk arithmetic and broadcast the delta over the host as one host
    array.  The same delta, staged trace and tapped bytes as the host path
    on every rank."""
    monkeypatch.setenv("TORCHFT_OUTER_CHUNK_MB", "0.05")
    monkeypatch.setenv(tcoll.DEVICE_REDUCE_ENV, "0")
    n, hosts = 70_000 + 13, ["h0", "h0", "h1"]
    host = _sync_ranks(store, 3, n, quant, None, f"hh{quant}", hosts)
    card = _sync_ranks(store, 3, n, quant, torch.device("cpu"), f"hc{quant}", hosts)
    for (hd, hs, htap), (cd, cs, ctap) in zip(host, card):
        assert isinstance(cd, np.ndarray) and cd.shape == (n,)
        np.testing.assert_array_equal(_bits(cd), _bits(hd))
        np.testing.assert_array_equal(_bits(cs[0]), _bits(hs[0]))
        np.testing.assert_array_equal(_bits(ctap[0]), _bits(htap[0]))
    for d, _s, _t in card[1:]:
        np.testing.assert_array_equal(_bits(d), _bits(card[0][0]))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_card_path_at_world_one(quant, monkeypatch) -> None:
    from torchft_tpu_torch.communicator import DummyCommunicator

    monkeypatch.setenv("TORCHFT_OUTER_CHUNK_MB", "0.05")
    monkeypatch.setenv(tcoll.DEVICE_REDUCE_ENV, "0")
    n = 50_000 + 5
    out = []
    for device in (None, torch.device("cpu")):
        shard = _shard_update(n, 1, 0, quant, device)
        delta = tcoll.outer_sharded_sync(DummyCommunicator(), _psg(0, n), shard.make_update_cb(),
                                         1, should_quantize=quant, device=device)
        shard.commit_stage()
        out.append((np.asarray(delta), tlocal._host_leaves(shard._state_leaves)[0]))
    np.testing.assert_array_equal(_bits(out[1][0]), _bits(out[0][0]))
    np.testing.assert_array_equal(_bits(out[1][1]), _bits(out[0][1]))


def _diloco_run(monkeypatch, on_card: bool, dtype: str, quant: bool, alpha: float):
    """Three fragment syncs of a two-fragment DiLoCo on a one-replica quorum,
    through the card path (on the CPU) or the host path."""
    import ml_dtypes

    from tests.test_torch_local_sgd import Params, solo_manager

    monkeypatch.setattr(tlocal, "_sync_device", (lambda d: d) if on_card else (lambda d: None))
    np_dtype = np.float32 if dtype == "f32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(5)
    arrays = {k: rng.standard_normal(s).astype(np_dtype)
              for k, s in {"a": (40, 30), "b": (3000,), "c": (2, 3, 7)}.items()}
    model = Params(arrays)
    diloco = DiLoCo(solo_manager(8), model, OuterSGD(LR, MOMENTUM, nesterov=True), sync_every=4,
                    num_fragments=2, should_quantize=quant, fragment_sync_delay=1,
                    fragment_update_alpha=alpha)
    for step in range(8):
        with torch.no_grad():
            for p in model.parameters():
                p.sub_(0.02 * (step + 1) * torch.ones_like(p))
        diloco.step()
    frags = diloco.fragments
    return ([p.detach().clone() for p in model.parameters()],
            [b.clone() for f in frags for b in f.backup],
            [tlocal._host_leaves(f._shard._state_leaves)[0] for f in frags])


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("alpha", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_diloco_through_the_card_path_is_the_host_paths(dtype, alpha, quant, monkeypatch) -> None:
    """The pseudo-gradient, the owner's shard on the device, the card
    pipeline and the apply (``global_from_delta``) against the host path:
    the live parameters, the backups and the outer traces bit for bit."""
    monkeypatch.setenv(tcoll.DEVICE_REDUCE_ENV, "0")
    host = _diloco_run(monkeypatch, False, dtype, quant, alpha)
    card = _diloco_run(monkeypatch, True, dtype, quant, alpha)
    for got_list, want_list in zip(card, host):
        for got, want in zip(got_list, want_list):
            got = torch.as_tensor(got)
            want = torch.as_tensor(want)
            assert got.dtype == want.dtype
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_device_shard_exports_numpy_and_loads_back() -> None:
    """With its state on a device, the reshard blob and ``save_state``
    carry f32 numpy leaves (a JAX rank's format); a rebuilt shard lands
    back on the device."""
    _device_shard_round_trip(torch.device("cpu"))


def _device_shard_round_trip(device: torch.device) -> None:
    shard = _shard_update(256, 2, 1, False, device)
    assert torch.is_tensor(shard._state_leaves[0])
    assert shard._state_leaves[0].device.type == device.type
    want = shard._state_leaves[0].cpu().numpy().copy()
    saved = shard.save_state()
    (meta, leaves), = shard._export_contribs()
    for got in (saved["leaves"][0], leaves[0]):
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    other = _OuterShard(OuterSGD(LR, MOMENTUM, nesterov=True), 256, False, device)
    other.load_state(saved)
    other._rebuild(other._export_contribs(), dict(meta))
    assert other._state_leaves[0].device.type == device.type
    np.testing.assert_array_equal(other._state_leaves[0].cpu().numpy(), want)


_NANS = [0x7FC00000, 0xFFC00000, 0x7FC00123, 0xFF800042, 0x7F800001]


def _nan_input(device) -> torch.Tensor:
    x = torch.tensor(np.array(_NANS + [0x3F800000, 0x80000000], dtype=np.uint32).view(np.int32))
    return x.view(torch.float32).to(device)


def _u16(t: torch.Tensor) -> list:
    return [v & 0xFFFF for v in t.view(torch.int16).tolist()]


def test_apply_rounds_nans_as_the_cpu_cast_does() -> None:
    """The host apply rounds backup + delta to bf16 with torch's CPU cast,
    which writes every NaN, whatever its sign and payload, as one bit
    pattern (its vectorized x86 path: 0xffff; not ml_dtypes' signed quiet
    NaN); ``_round_to`` reads that pattern from the cast and keeps the
    cast's bits on the CPU."""
    x = _nan_input("cpu")
    cast = _u16(x.to(torch.bfloat16))
    assert set(cast[:len(_NANS)]) == {tlocal._host_bf16_nan() & 0xFFFF}
    assert cast[len(_NANS):] == [0x3F80, 0x8000]
    assert _u16(tlocal._round_to(x, torch.bfloat16)) == cast


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_apply_rounds_nans_on_the_card_as_on_the_host(cuda_device) -> None:
    """CUDA's cast writes its canonical 0x7fff for a NaN; ``_round_to``
    rewrites it to the host cast's pattern, and keeps every other value's
    rounding."""
    x = _nan_input(cuda_device)
    assert set(_u16(x.to(torch.bfloat16))[:len(_NANS)]) == {0x7FFF}
    host = _nan_input("cpu").to(torch.bfloat16).view(torch.int16)
    assert torch.equal(tlocal._round_to(x, torch.bfloat16).view(torch.int16).cpu(), host)
    y = torch.randn(1 << 16, device=cuda_device) * 1e3
    assert torch.equal(tlocal._round_to(y, torch.bfloat16).view(torch.int16).cpu(),
                       y.cpu().to(torch.bfloat16).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("w,participants", [(1, 1), (2, 2), (3, 3)])
@pytest.mark.parametrize("in_place", [False, True], ids=["out", "in_place"])
def test_kernel_matches_plain_bit_for_bit(cuda_device, w, participants, rule, in_place) -> None:
    momentum, nesterov = RULES[rule]
    c, t = _inputs(w, seed=w)
    contribs = torch.from_numpy(c).to(cuda_device)
    trace = torch.from_numpy(t).to(cuda_device)
    outs = {}
    for name, fn in (("kernel", touter.outer_update), ("plain", touter.outer_update_plain)):
        delta = torch.empty(N, device=cuda_device)
        tr = trace.clone()
        new_trace = tr if in_place else torch.empty(N, device=cuda_device)
        fn(contribs, 1.0 / participants, delta, LR, momentum, nesterov,
           tr if momentum else None, new_trace if momentum else None)
        outs[name] = (delta, new_trace)
    torch.cuda.synchronize()
    (kd, kt), (pd, pt) = outs["kernel"], outs["plain"]
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))
    if momentum:
        assert torch.equal(kt.view(torch.int32), pt.view(torch.int32))
    # on finite, infinite, signed-zero and subnormal values the host's bits
    _acc, want_delta, _want_trace = _host(c, t, participants, rule)
    got = kd.cpu().numpy()
    keep = ~np.isnan(want_delta)
    np.testing.assert_array_equal(_bits(got[keep]), _bits(want_delta[keep]))
    assert np.isnan(got[~keep]).all()


@pytest.mark.cuda
def test_kernel_counts_its_launches(cuda_device) -> None:
    touter.reset_launches()
    c = torch.zeros(2, 1024, device=cuda_device)
    for _ in range(3):
        touter.outer_update(c, 0.5, torch.empty(1024, device=cuda_device), LR)
    touter.outer_update_plain(c, 0.5, torch.empty(1024, device=cuda_device), LR)
    assert touter.launches["outer"] == 3


@pytest.mark.cuda
def test_kernel_refuses_wrong_dtypes_and_devices(cuda_device) -> None:
    c = torch.zeros(2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous f32"):
        touter.outer_update(c.double(), 0.5, torch.empty(64, device=cuda_device), LR)
    with pytest.raises(ValueError, match="contiguous f32"):
        touter.outer_update(c, 0.5, torch.empty(64), LR)  # delta on the host
    with pytest.raises(ValueError, match="contiguous f32"):
        touter.outer_update(c, 0.5, torch.empty(64, device=cuda_device, dtype=torch.bfloat16), LR)
    with pytest.raises(ValueError, match="contiguous f32"):
        touter.outer_update(torch.zeros(64, 2, device=cuda_device).t(), 0.5,
                            torch.empty(64, device=cuda_device), LR)


@pytest.mark.cuda
def test_device_shard_round_trip_on_the_card(cuda_device) -> None:
    _device_shard_round_trip(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_card_sync_waits_for_the_staged_copy(cuda_device, quant, monkeypatch) -> None:
    """The staged copy of the owner's trace is queued on the caller's
    stream, held back here by a sleep on it; the sync's own stream must
    wait for it before the kernel writes the new trace there.  Two syncs,
    the second stepping the committed trace, against the host path bit for
    bit."""
    from torchft_tpu_torch.communicator import DummyCommunicator

    monkeypatch.setenv("TORCHFT_OUTER_CHUNK_MB", "0.05")
    monkeypatch.setenv(tcoll.DEVICE_REDUCE_ENV, "0")
    n = 50_000 + 5
    out = []
    for device in (None, cuda_device):
        shard = _shard_update(n, 1, 0, quant, device)
        deltas = []
        for k in range(2):
            if device is not None:
                torch.cuda._sleep(200_000_000)  # ~0.1 s of the caller's stream
            cb = shard.make_update_cb()
            delta = tcoll.outer_sharded_sync(DummyCommunicator(), _psg(k, n), cb, 1,
                                             should_quantize=quant, device=device)
            deltas.append(np.asarray(delta.cpu() if torch.is_tensor(delta) else delta))
            shard.commit_stage()
        out.append((deltas, tlocal._host_leaves(shard._state_leaves)[0]))
    (host_deltas, host_trace), (card_deltas, card_trace) = out
    for got, want in zip(card_deltas, host_deltas):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(card_trace), _bits(host_trace))
