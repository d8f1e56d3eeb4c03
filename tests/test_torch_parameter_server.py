"""The port's parameter server (``torchft_tpu_torch/parameter_server.py``)
against the JAX package's (``torchft_tpu/parameter_server.py``).

- The fetch and push case of ``tests/test_aux.py``'s ``TestParameterServer``
  on torch tensors; ``get_params`` returns each tensor on its template's
  device, ``push_grads`` takes tensors or arrays.
- Concurrent sessions: every push lands once in the server's f32 copy.
- The frames are the JAX package's: a JAX client against a port server and
  a port client against a JAX server move the same f32 bits both ways.
"""

import threading
import time

import numpy as np
import pytest
import torch

from torchft_tpu import parameter_server as jax_ps
from torchft_tpu_torch import parameter_server as ps

TIMEOUT = 15.0


def _wait_for(pred, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "the server never applied the push"
        time.sleep(0.02)


def test_fetch_and_push() -> None:
    server = ps.ParameterServer({"w": torch.arange(4, dtype=torch.float32)})
    try:
        client = ps.ParameterServerClient(server.address(), timeout_s=TIMEOUT)
        params = client.get_params({"w": torch.zeros(4, dtype=torch.bfloat16)})
        assert params["w"].dtype == torch.float32 and params["w"].device.type == "cpu"
        torch.testing.assert_close(params["w"], torch.arange(4, dtype=torch.float32))
        client.push_grads({"w": torch.full((4,), 2.0)})
        client.close()
        _wait_for(lambda: torch.equal(server.params()["w"], torch.arange(4.0) + 2.0))
        # the twin of tests/test_aux.py's case, in the JAX package
        jserver = jax_ps.ParameterServer({"w": np.arange(4, dtype=np.float32)})
        try:
            jclient = jax_ps.ParameterServerClient(jserver.address(), timeout_s=TIMEOUT)
            np.testing.assert_array_equal(jclient.get_params({"w": np.zeros(4)})["w"],
                                          params["w"].numpy())
            jclient.push_grads({"w": np.full(4, 2.0, dtype=np.float32)})
            jclient.close()
            _wait_for(lambda: np.array_equal(jserver.params()["w"],
                                             server.params()["w"].numpy()))
        finally:
            jserver.shutdown()
    finally:
        server.shutdown()


def test_concurrent_sessions_each_push_lands_once() -> None:
    init = {"a": torch.zeros(8), "b": torch.ones(3, 2)}
    server = ps.ParameterServer(init)
    sessions = 6
    errors: list = []

    def session(i: int) -> None:
        try:
            client = ps.ParameterServerClient(server.address(), timeout_s=TIMEOUT)
            got = client.get_params({k: torch.zeros_like(v) for k, v in init.items()})
            assert set(got) == {"a", "b"} and got["b"].shape == (3, 2)
            client.push_grads({"a": torch.full((8,), float(i + 1)),
                               "b": np.full((3, 2), 2.0 ** -i, dtype=np.float32)})
            client.close()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=session, args=(i,)) for i in range(sessions)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        want_a = torch.full((8,), float(sum(range(1, sessions + 1))))
        want_b = torch.ones(3, 2) + sum(2.0 ** -i for i in range(sessions))
        _wait_for(lambda: torch.equal(server.params()["a"], want_a)
                  and torch.equal(server.params()["b"], want_b))
    finally:
        server.shutdown()


def _bits(n: int, seed: int) -> np.ndarray:
    """f32 values with every exponent range, including subnormals and -0."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * np.logspace(-40, 30, n)).astype(np.float32)
    x[:3] = [np.float32(-0.0), np.float32(1e-45), np.float32(3.4e38)]
    return x


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_packages_interoperate_bit_for_bit(server_pkg) -> None:
    """A JAX client against a port server, and a port client against a JAX
    server: the fetched parameters and the pushed gradients cross with
    their f32 bits intact."""
    w, g = _bits(257, 1), _bits(257, 2)
    if server_pkg == "port":
        server = ps.ParameterServer({"w": torch.from_numpy(w.copy())})
    else:
        server = jax_ps.ParameterServer({"w": w.copy()})
    try:
        if server_pkg == "port":
            client = jax_ps.ParameterServerClient(server.address(), timeout_s=TIMEOUT)
            got = np.asarray(client.get_params({"w": np.zeros(257, np.float32)})["w"])
            client.push_grads({"w": g})
        else:
            client = ps.ParameterServerClient(server.address(), timeout_s=TIMEOUT)
            got = client.get_params({"w": torch.zeros(257)})["w"].numpy()
            client.push_grads({"w": torch.from_numpy(g.copy())})
        client.close()
        assert got.view(np.uint32).tolist() == w.view(np.uint32).tolist()
        # the server sums the push into a zero buffer, then into its copy
        # (so a pushed -0.0 arrives as +0.0 in both packages)
        with np.errstate(over="ignore"):
            want = (w + (np.zeros_like(g) + g)).view(np.uint32)

        def applied() -> bool:
            now = server.params()["w"]
            now = now.numpy() if isinstance(now, torch.Tensor) else np.asarray(now)
            return np.array_equal(now.view(np.uint32), want)

        _wait_for(applied)
    finally:
        server.shutdown()
