"""Parameter server prototype: reconfigurable communicators without a
lighthouse.

Twin of the reference prototype (``torchft/parameter_server.py:30-194``): it
demonstrates that the data-plane building blocks compose outside the
Manager/quorum protocol.  A server hands out sessions over HTTP
(``/new_session`` → ``{session_id, store_addr}``); for each session it
configures a fresh world-size-2 communicator (server rank 0, client rank 1)
under a per-session store namespace, then serves parameter fetches /
gradient pushes over plain collectives.

The server keeps its parameters as f32 CPU tensors.  The frames on the
wire are the JAX package's (f32 buffers over the same communicator
protocol), so a client of either package talks to a server of either.

Usage::

    ps = ParameterServer(params={"w": torch.zeros(10)})
    # client side
    client = ParameterServerClient(ps.address())
    params = client.get_params({"w": torch.zeros(10, device="cuda")})  # on cuda
    client.push_grads({"w": grads})  # any device; summed into the server copy
"""

from __future__ import annotations

import json
import logging
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.request import urlopen

import numpy as np
import torch

from torchft_tpu_torch.communicator import Communicator, ReduceOp, TCPCommunicator
from torchft_tpu_torch.store import StoreServer

logger = logging.getLogger(__name__)


def _host_f32(value) -> np.ndarray:
    """A contiguous f32 numpy copy of a tensor (any device) or array."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).contiguous().numpy()
    return np.ascontiguousarray(value, dtype=np.float32)


class ParameterServer:
    """Serves f32 parameters to one-session clients: each session fetches
    them with a broadcast from rank 0 and pushes gradients that are summed
    into the server's copy."""

    def __init__(
        self,
        params: Dict[str, object],
        bind: str = "0.0.0.0:0",
        timeout_s: float = 60.0,
        comm_factory=TCPCommunicator,
    ) -> None:
        self._params = {
            k: torch.from_numpy(_host_f32(v).copy()) for k, v in params.items()
        }
        self._timeout_s = timeout_s
        self._comm_factory = comm_factory
        self._store = StoreServer("0.0.0.0:0")
        self._lock = threading.Lock()

        ps = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt: str, *args: object) -> None:
                logger.debug("parameter_server: " + fmt, *args)

            def do_GET(self) -> None:
                if self.path != "/new_session":
                    self.send_error(404)
                    return
                session_id = str(uuid.uuid4())
                store_addr = f"127.0.0.1:{ps._store.port}/ps/{session_id}"
                body = json.dumps(
                    {"session_id": session_id, "store_addr": store_addr}
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                # serve the session on its own thread (server is rank 0)
                threading.Thread(
                    target=ps._serve_session,
                    args=(store_addr,),
                    daemon=True,
                ).start()

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        host, port = bind.rsplit(":", 1)
        self._http = _Server((host, int(port)), _Handler)
        self._port: int = self._http.server_address[1]
        threading.Thread(
            target=self._http.serve_forever, name="tpuft_ps_http", daemon=True
        ).start()

    @property
    def port(self) -> int:
        return self._port

    def address(self) -> str:
        return f"http://127.0.0.1:{self._port}"

    def params(self) -> Dict[str, torch.Tensor]:
        """A copy of the parameters (f32 CPU tensors)."""
        with self._lock:
            return {k: v.clone() for k, v in self._params.items()}

    def _serve_session(self, store_addr: str) -> None:
        comm: Optional[Communicator] = None
        try:
            comm = self._comm_factory(timeout_s=self._timeout_s)
            comm.configure(
                store_addr, replica_id="ps_server", rank=0, world_size=2
            )
            # one fetch + one push per session (the prototype protocol);
            # copies — concurrent sessions mutate the originals in place
            with self._lock:
                snapshot = [self._params[k].numpy().copy() for k in sorted(self._params)]
            comm.broadcast(snapshot, root=0).wait(timeout=self._timeout_s)
            summed = comm.allreduce(
                [np.zeros_like(a) for a in snapshot], ReduceOp.SUM
            ).wait(timeout=self._timeout_s)
            with self._lock:
                for key, grad in zip(sorted(self._params), summed):
                    self._params[key] += torch.from_numpy(np.asarray(grad))
        except Exception as e:  # noqa: BLE001
            logger.warning("parameter server session failed: %s", e)
        finally:
            if comm is not None:
                comm.shutdown()

    def shutdown(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        self._store.shutdown()


class ParameterServerClient:
    """One-session client: fetch params, push gradients."""

    def __init__(self, address: str, timeout_s: float = 60.0, comm_factory=TCPCommunicator) -> None:
        with urlopen(f"{address}/new_session", timeout=timeout_s) as resp:
            session = json.loads(resp.read())
        self._comm = comm_factory(timeout_s=timeout_s)
        self._comm.configure(
            session["store_addr"], replica_id="ps_client", rank=1, world_size=2
        )
        self._timeout_s = timeout_s
        self._param_keys: Optional[list] = None

    def get_params(self, template: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The server's parameters, as f32 tensors on the device of each
        ``template`` tensor (its shape; a numpy template gives CPU)."""
        self._param_keys = sorted(template)
        bufs = [np.zeros(tuple(template[k].shape), np.float32) for k in self._param_keys]
        received = self._comm.broadcast(bufs, root=0).wait(timeout=self._timeout_s)
        out = {}
        for key, arr in zip(self._param_keys, received):
            like = template[key]
            device = like.device if isinstance(like, torch.Tensor) else "cpu"
            out[key] = torch.from_numpy(np.asarray(arr)).to(device)
        return out

    def push_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sum ``grads`` (tensors on any device, or arrays) into the
        server's parameters."""
        assert self._param_keys is not None, "call get_params first"
        bufs = [_host_f32(grads[k]) for k in self._param_keys]
        self._comm.allreduce(bufs, ReduceOp.SUM).wait(timeout=self._timeout_s)

    def close(self) -> None:
        self._comm.shutdown()
