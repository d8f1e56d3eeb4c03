"""The port stands alone: ``torchft_tpu_torch`` imports torch, numpy and the
standard library, never ``jax``, ``ml_dtypes``, ``optax`` or anything of
the JAX package ``torchft_tpu`` — the machine with the card has none of
the first three.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "torchft_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "optax", "torchft_tpu")


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_forbidden_import_in_the_source(path) -> None:
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", "")) == "import_module"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and _forbidden(str(node.args[0].value))
        ):
            bad.append(node.args[0].value)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_every_module_imports_and_bf16_paths_run_with_jax_blocked() -> None:
    """In a fresh interpreter where ``jax``, ``ml_dtypes``, ``optax`` and
    ``torchft_tpu`` cannot be imported: import every module of the port,
    round-trip bf16 tensors through the checkpoint serializer, and average
    bf16 gradients over two thread replicas."""
    script = textwrap.dedent(
        f"""
        import importlib, sys
        for name in {list(FORBIDDEN)!r}:
            sys.modules[name] = None  # any import of it now raises
        sys.path.insert(0, {str(REPO)!r})
        for mod in {_modules()!r}:
            importlib.import_module(mod)

        import threading
        import torch
        from torchft_tpu_torch.checkpointing.serialization import dumps_pytree, loads_pytree
        from torchft_tpu_torch.communicator import TCPCommunicator
        from torchft_tpu_torch.ddp import allreduce_gradients
        from torchft_tpu_torch.lighthouse import LighthouseServer
        from torchft_tpu_torch.manager import Manager

        w = torch.randn(5, 3).to(torch.bfloat16)
        back = loads_pytree(dumps_pytree({{"w": w}}))["w"]
        assert back.dtype == torch.bfloat16 and torch.equal(back, w)

        lighthouse = LighthouseServer(bind="127.0.0.1:0", min_replicas=2)
        grads = [torch.full((64,), float(i + 1), dtype=torch.bfloat16) for i in range(2)]
        out = [None, None]

        def replica(i):
            manager = Manager(
                comm=TCPCommunicator(timeout_s=20.0), load_state_dict=lambda s: None,
                state_dict=lambda: {{}}, min_replica_size=2, replica_id=f"r{{i}}",
                lighthouse_addr=lighthouse.local_address(), timeout=20.0,
                quorum_timeout=20.0, connect_timeout=20.0, init_sync=False,
            )
            p = torch.nn.Parameter(torch.zeros(64, dtype=torch.bfloat16))
            p.grad = grads[i].clone()
            manager.start_quorum()
            allreduce_gradients(manager, [p]).wait()
            assert manager.should_commit()
            out[i] = p.grad
            manager.shutdown()

        threads = [threading.Thread(target=replica, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        lighthouse.shutdown()
        assert all(o is not None and o.dtype == torch.bfloat16 for o in out), out
        assert all(torch.equal(o, torch.full((64,), 1.5, dtype=torch.bfloat16)) for o in out)
        print("ISOLATED_OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env,
        cwd=str(REPO),
    )
    assert proc.returncode == 0 and "ISOLATED_OK" in proc.stdout, proc.stdout + proc.stderr


def test_train_ddp_refuses_to_run_without_cuda_unless_asked() -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    from torchft_tpu_torch import train_ddp

    with pytest.raises(RuntimeError, match="--device cpu"):
        train_ddp.main(["--model", "llama_debug", "--steps", "1"])
