"""A tiny TCP key-value store for bootstrap and communicator rendezvous.

The reference leans on torch's ``TCPStore`` for (a) publishing the manager
address / replica id to all local ranks (``torchft/manager.py:333-334``) and
(b) rendezvous of freshly configured process groups under a per-quorum prefix
(``torchft/process_group.py:109-128``).  torchft_tpu ships its own store with
the same semantics — ``set``, blocking ``get`` (wait-for-key), ``add`` — so
the framework has no torch dependency and the store can later be served by
the C++ runtime (``native/``) over the identical wire protocol.

One ``StoreServer`` runs per replica group (wherever the group's rank-0
process lives); its address rides in ``QuorumMember.store_address`` exactly
like the reference's ``store_addr`` field so that peers joining a new quorum
can rendezvous on the *primary* replica's store
(``src/manager.rs:530-533``).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, Optional

from torchft_tpu_torch.wire import (
    ErrCode,
    create_listener,
    MsgType,
    Reader,
    RpcClient,
    Writer,
    WireError,
    configure_server_socket,
    raise_if_error,
    recv_frame,
    send_error,
    send_frame,
)


class StoreServer:
    """Threaded TCP KV server with wait-for-key gets.

    Semantics match torch's TCPStore as used by the reference: keys are set
    once (last-write-wins), ``get`` blocks until the key exists or the
    client's deadline passes, ``add`` atomically increments an integer key.
    """

    def __init__(self, bind: str = "0.0.0.0:0") -> None:
        self._sock = create_listener(bind, backlog=512)
        self._port: int = self._sock.getsockname()[1]
        self._data: Dict[str, bytes] = {}
        self._cond = threading.Condition()
        self._shutdown = False
        self._thread = threading.Thread(
            target=self._serve, name="tpuft_store_accept", daemon=True
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._port

    def address(self) -> str:
        return f"{socket.gethostname()}:{self._port}"

    def local_address(self) -> str:
        return f"127.0.0.1:{self._port}"

    def _serve(self) -> None:
        while not self._shutdown:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            configure_server_socket(conn)
            threading.Thread(
                target=self._handle, args=(conn,), name="tpuft_store_conn", daemon=True
            ).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            while True:
                msg_type, r = recv_frame(conn)
                if msg_type == MsgType.STORE_SET:
                    key, value = r.string(), r.blob()
                    with self._cond:
                        self._data[key] = value
                        self._cond.notify_all()
                    send_frame(conn, MsgType.STORE_OK)
                elif msg_type == MsgType.STORE_GET:
                    key, timeout_ms = r.string(), r.u64()
                    value = self._wait_get(key, timeout_ms / 1000.0)
                    if value is None:
                        send_error(
                            conn, ErrCode.TIMEOUT, f"store get timed out for {key!r}"
                        )
                    else:
                        send_frame(conn, MsgType.STORE_OK, Writer().blob(value).payload())
                elif msg_type == MsgType.STORE_ADD:
                    key, delta = r.string(), r.i64()
                    with self._cond:
                        try:
                            cur = int(self._data.get(key, b"0"))
                        except ValueError:
                            cur = None
                        else:
                            cur += delta
                            self._data[key] = str(cur).encode()
                            self._cond.notify_all()
                    if cur is None:
                        send_error(
                            conn, ErrCode.INVALID, f"add on non-integer key {key!r}"
                        )
                    else:
                        send_frame(conn, MsgType.STORE_OK, Writer().i64(cur).payload())
                elif msg_type == MsgType.STORE_EXISTS:
                    key = r.string()
                    with self._cond:
                        present = key in self._data
                    send_frame(
                        conn, MsgType.STORE_OK, Writer().boolean(present).payload()
                    )
                elif msg_type == MsgType.STORE_DELETE:
                    prefix = r.string()
                    with self._cond:
                        doomed = [k for k in self._data if k.startswith(prefix)]
                        for k in doomed:
                            del self._data[k]
                    send_frame(
                        conn, MsgType.STORE_OK, Writer().i64(len(doomed)).payload()
                    )
                else:
                    send_error(conn, ErrCode.INVALID, f"bad store op {msg_type}")
        except (ConnectionError, OSError, WireError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _wait_get(self, key: str, timeout_s: float) -> Optional[bytes]:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while key not in self._data:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
            return self._data[key]

    def shutdown(self) -> None:
        self._shutdown = True
        try:
            self._sock.close()
        except OSError:
            pass


class StoreClient(RpcClient):
    """Client for :class:`StoreServer`.

    ``timeout`` bounds every operation including wait-for-key gets, matching
    the reference's store client construction with an explicit connect/op
    timeout (``torchft/process_group.py:109-128``).
    """

    def __init__(self, addr: str, timeout: float = 60.0) -> None:
        super().__init__(addr, connect_timeout=timeout)
        self._timeout = timeout

    def _call(
        self,
        msg_type: MsgType,
        payload: bytes,
        timeout: Optional[float] = None,
        idempotent: bool = False,
    ) -> Reader:
        budget = self._timeout if timeout is None else timeout
        resp_type, r = self.call(msg_type, payload, budget, idempotent=idempotent)
        raise_if_error(resp_type, r)
        return r

    def set(self, key: str, value: bytes) -> None:
        self._call(MsgType.STORE_SET, Writer().string(key).blob(value).payload())

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        budget = self._timeout if timeout is None else timeout
        # reads are idempotent: one reconnect-retry rides out a store blip
        r = self._call(
            MsgType.STORE_GET,
            Writer().string(key).u64(int(budget * 1000)).payload(),
            timeout=budget,
            idempotent=True,
        )
        return r.blob()

    def add(self, key: str, delta: int) -> int:
        r = self._call(MsgType.STORE_ADD, Writer().string(key).i64(delta).payload())
        return r.i64()

    def exists(self, key: str) -> bool:
        r = self._call(
            MsgType.STORE_EXISTS,
            Writer().string(key).payload(),
            idempotent=True,
        )
        return r.boolean()

    def delete_prefix(self, prefix: str) -> int:
        r = self._call(MsgType.STORE_DELETE, Writer().string(prefix).payload())
        return r.i64()


class PrefixStore:
    """Namespaced view of a store.

    The reference namespaces every quorum's rendezvous under
    ``{store}/torchft/{quorum_id}/{group_rank}`` via c10d's PrefixStore
    (``torchft/manager.py:703-705``, ``torchft/process_group.py:121-127``);
    this is the same composition for our store client.
    """

    def __init__(self, store: "StoreClient | PrefixStore", prefix: str) -> None:
        self._store = store
        self._prefix = prefix

    def _key(self, key: str) -> str:
        return f"{self._prefix}/{key}"

    def set(self, key: str, value: bytes) -> None:
        self._store.set(self._key(key), value)

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        return self._store.get(self._key(key), timeout=timeout)

    def add(self, key: str, delta: int) -> int:
        return self._store.add(self._key(key), delta)

    def exists(self, key: str) -> bool:
        return self._store.exists(self._key(key))


def create_store_client(store_prefixed_addr: str, timeout: float = 60.0) -> PrefixStore:
    """Build a store client from an ``addr:port/prefix/...`` string.

    Mirrors ``create_store_client`` (``torchft/process_group.py:109-128``):
    the address part dials the store, the path part becomes the namespace.
    """
    if "/" in store_prefixed_addr:
        addr, prefix = store_prefixed_addr.split("/", 1)
    else:
        addr, prefix = store_prefixed_addr, ""
    client = StoreClient(addr, timeout=timeout)
    return PrefixStore(client, prefix) if prefix else PrefixStore(client, "root")
