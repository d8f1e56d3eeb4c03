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
    round-trip bf16 tensors through the checkpoint serializer, run the fp8
    host wire against the golden fixture, and average bf16 gradients over
    two thread replicas, then average them again through the fp8 quantized
    sync."""
    script = textwrap.dedent(
        f"""
        import importlib, os, sys
        for name in {list(FORBIDDEN)!r}:
            sys.modules[name] = None  # any import of it now raises
        sys.path.insert(0, {str(REPO)!r})
        for mod in {_modules()!r}:
            importlib.import_module(mod)

        import json
        import numpy as np
        from torchft_tpu_torch.quantization import (
            dequantize_rowwise, quantize_rowwise, reduce_quantized,
        )

        with open({str(REPO / "tests" / "fixtures" / "quant_wire_golden.json")!r}) as f:
            golden = json.load(f)["fp8"]
        rng = np.random.default_rng(42)
        flat = (rng.normal(size=512) * np.logspace(-2, 2, 512)).astype(np.float32)
        q, s = quantize_rowwise(flat, row_size=128, kind="fp8")
        assert q.dtype == np.uint8 and q.reshape(-1).tolist() == golden["payload"]
        assert s.astype(float).tolist() == golden["scales"]
        q2, s2 = reduce_quantized(np.stack([q, q]), np.stack([s, s]), kind="fp8")
        twice = dequantize_rowwise(q2, s2, 512, np.float32)
        assert np.abs(twice - 2 * flat).max() <= 2 * np.abs(flat).max() / 8
        os.environ["TORCHFT_QUANT_KIND"] = "fp8"

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
            out[i] = p.grad.clone()
            manager.start_quorum()
            allreduce_gradients(manager, [p], should_quantize=True).wait()
            assert manager.should_commit()
            assert torch.equal(p.grad, out[i])  # 1.5 travels exactly in fp8
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


def test_cpp_tier_loads_the_ports_own_library_even_with_the_jax_knob_set() -> None:
    """After a C++-tier allreduce in a fresh interpreter that cannot import
    the JAX package, with ``TORCHFT_NATIVE_DIR`` pointing at the JAX
    package's ``native/``: the one native library mapped into the process is
    the port's, under ``build/torchft_tpu_torch/``, built from
    ``torchft_tpu_torch/csrc/native/``, and ``torchft_tpu`` is absent from
    ``sys.modules``."""
    script = textwrap.dedent(
        f"""
        import sys
        for name in {list(FORBIDDEN)!r}:
            sys.modules[name] = None  # any import of it now raises
        sys.path.insert(0, {str(REPO)!r})
        from concurrent.futures import ThreadPoolExecutor
        import numpy as np
        from torchft_tpu_torch import native

        store = native.CppStoreServer("127.0.0.1:0")

        def rank(r):
            comm = native.CppCommunicator(timeout_s=20.0)
            comm.configure(f"127.0.0.1:{{store.port}}/iso", replica_id=f"r{{r}}", rank=r,
                           world_size=2)
            try:
                return comm.allreduce(np.full(8, r + 1.0, np.float32)).wait(timeout=20.0)
            finally:
                comm.shutdown()

        with ThreadPoolExecutor(2) as pool:
            outs = list(pool.map(rank, range(2)))
        store.shutdown()
        assert all(o.tolist() == [3.0] * 8 for o in outs), outs
        with open("/proc/self/maps") as f:
            libs = {{line.split()[-1] for line in f if "libtpuft" in line}}
        print("LIBS", sorted(libs))
        print("SOURCE", native.SOURCE_DIR)
        print("ARTIFACT", native._artifact())
        print("JAX_LOADED", sorted(m for m in sys.modules
                                   if m.split(".")[0] == "torchft_tpu"
                                   and sys.modules[m] is not None))
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TORCHFT_NATIVE_DIR"] = str(REPO / "native")
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=300, env=env,
        cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines() if " " in line)
    libs = ast.literal_eval(lines["LIBS"])
    artifact = Path(lines["ARTIFACT"])
    assert libs == [str(artifact)], libs
    assert artifact.parent == REPO / "build" / "torchft_tpu_torch"
    assert artifact.name.startswith("libtpuft_torch-")
    assert Path(lines["SOURCE"]) == PKG / "csrc" / "native"
    assert ast.literal_eval(lines["JAX_LOADED"]) == []


def test_hsdp_cnn_and_sampler_run_with_jax_blocked() -> None:
    """In a fresh interpreter that cannot import the JAX package: the
    sampler shards a dataset, the CNN takes a step, and a one-rank gloo
    group shards Llama with FSDP2, takes an HSDP grad step and round-trips
    its sharded state through the checkpoint serializer."""
    script = textwrap.dedent(
        f"""
        import sys
        for name in {list(FORBIDDEN)!r}:
            sys.modules[name] = None  # any import of it now raises
        sys.path.insert(0, {str(REPO)!r})
        import torch
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor
        from torchft_tpu_torch.checkpointing.serialization import (
            ShardedHostArray, dumps_pytree, loads_pytree)
        from torchft_tpu_torch.data import DistributedSampler, batch_indices
        from torchft_tpu_torch.ddp import restore_tree_like
        from torchft_tpu_torch.models.cnn import SimpleCNN
        from torchft_tpu_torch.models.llama import Llama, llama_debug
        from torchft_tpu_torch.parallel.hsdp import make_grad_step, shard_model
        from torchft_tpu_torch.parallel.mesh import make_mesh
        from torchft_tpu_torch.train_ddp import synthetic_cifar
        from torchft_tpu_torch.train_hsdp import _free_port

        x, y = synthetic_cifar(64)
        sampler = DistributedSampler(len(x), replica_rank=1, num_replica_groups=2)
        idx = next(batch_indices(sampler, 8))
        cnn = SimpleCNN()
        cnn.loss(torch.from_numpy(x[idx]).permute(0, 3, 1, 2),
                 torch.from_numpy(y[idx]).long()).backward()
        assert all(p.grad is not None for p in cnn.parameters())

        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{_free_port()}}",
                                rank=0, world_size=1)
        mesh = make_mesh(fsdp=1)
        model = shard_model(Llama(llama_debug(), device="cpu"), mesh)
        params = dict(model.named_parameters())
        tokens = torch.randint(0, 512, (2, 128))
        loss = make_grad_step(model, mesh)(tokens, torch.roll(tokens, -1, 1))
        assert torch.isfinite(loss)
        assert isinstance(params["embed"].grad, DTensor)
        back = loads_pytree(dumps_pytree({{n: p.detach() for n, p in params.items()}}))
        assert isinstance(back["embed"], ShardedHostArray)
        restore_tree_like(back, params)
        dist.destroy_process_group()
        print("ISOLATED_OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env,
        cwd=str(REPO),
    )
    assert proc.returncode == 0 and "ISOLATED_OK" in proc.stdout, proc.stdout + proc.stderr


def test_kill_spare_drill_runs_with_jax_blocked() -> None:
    """In a fresh interpreter that cannot import the JAX package: the port's
    ``kill_spare`` drill (2 actives, a warming spare killed mid-warm) runs
    on the CPU and holds its contract, and ``chaos`` and ``spare`` import
    nothing of the JAX package on the way."""
    script = textwrap.dedent(
        f"""
        import sys
        for name in {list(FORBIDDEN)!r}:
            sys.modules[name] = None  # any import of it now raises
        sys.path.insert(0, {str(REPO)!r})
        from torchft_tpu_torch.drill import gray_failure_drill
        report = gray_failure_drill(mode="kill_spare", num_replicas=2, steps=8, device="cpu")
        assert report["quorum_reconfigs"] == 0 and report["promotions_total"] == 0, report
        assert "torchft_tpu_torch.spare" in sys.modules and "torchft_tpu_torch.chaos" in sys.modules
        print("ISOLATED_OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env,
        cwd=str(REPO),
    )
    assert proc.returncode == 0 and "ISOLATED_OK" in proc.stdout, proc.stdout + proc.stderr


def test_pipeline_moe_and_rehearsal_run_with_jax_blocked() -> None:
    """In a fresh interpreter that cannot import the JAX package: a
    ``PipelinedLlama`` with every stage in the process and a ``LlamaMoE``
    take a step on the CPU, ``rehearse`` and ``plan_surviving(model=...)``
    give their arithmetic verdicts, and their constructors refuse the
    missing card unless asked for the CPU."""
    script = textwrap.dedent(
        f"""
        import sys
        for name in {list(FORBIDDEN)!r}:
            sys.modules[name] = None  # any import of it now raises
        sys.path.insert(0, {str(REPO)!r})
        import torch
        from torchft_tpu_torch.models.llama import Llama, llama3_8b, llama_debug
        from torchft_tpu_torch.models.llama_moe import LlamaMoE, llama_moe_debug
        from torchft_tpu_torch.parallel.degraded import plan_surviving
        from torchft_tpu_torch.parallel.pipeline import PipelinedLlama
        from torchft_tpu_torch.parallel.rehearsal import rehearse

        tokens = torch.randint(0, 512, (4, 64))
        for model in (PipelinedLlama(llama_debug(), "cpu", pp=2, remat=True, num_microbatches=2),
                      LlamaMoE(llama_moe_debug(), "cpu")):
            model.loss(tokens, torch.roll(tokens, -1, 1)).backward()
            assert all(p.grad is not None for p in model.parameters())
        report = rehearse(Llama(llama3_8b(), "meta"), None, {{"fsdp": 8}}, batch=8, seq=8192,
                          lower=False)
        assert report.hbm_frac > 0 and not report.divisibility_errors
        plan = plan_surviving(3, 4, model=Llama(llama_debug(), "meta"), batch=4, seq=32,
                              axes=("fsdp", "tp"))
        assert plan.mesh_axes == {{"fsdp": 2, "tp": 1}}
        if not torch.cuda.is_available():
            for build in (lambda: PipelinedLlama(llama_debug(), pp=2),
                          lambda: LlamaMoE(llama_moe_debug())):
                try:
                    build()
                    raise AssertionError("built on a missing card")
                except RuntimeError as e:
                    assert "CUDA" in str(e)
        print("ISOLATED_OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env,
        cwd=str(REPO),
    )
    assert proc.returncode == 0 and "ISOLATED_OK" in proc.stdout, proc.stdout + proc.stderr


@pytest.mark.parametrize("argv", [
    ["train_ddp", "--model", "cnn", "--steps", "1"],
    ["train_hsdp", "--model", "llama_debug", "--steps", "1", "--groups", "1"],
    ["train_hsdp", "--model", "llama_moe_debug", "--ep", "2", "--steps", "1", "--groups", "1"],
])
def test_cnn_and_hsdp_entry_points_refuse_to_run_without_cuda_unless_asked(argv) -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    import importlib

    module = importlib.import_module(f"torchft_tpu_torch.{argv[0]}")
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main(argv[1:])


def _child_code_refs(tree: ast.AST):
    """What a module hands a child interpreter: each string constant that
    parses as Python with an import in it (a ``-c`` script), as its
    imported module names, and each module after a ``-m`` in a list or
    tuple literal (a command line) or inside a string (a shell command)."""
    import re

    for node in ast.walk(tree):
        if isinstance(node, (ast.List, ast.Tuple)):
            elts = node.elts
            for a, b in zip(elts, elts[1:]):
                if (isinstance(a, ast.Constant) and a.value == "-m"
                        and isinstance(b, ast.Constant) and isinstance(b.value, str)):
                    yield "-m", b.value
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
            continue
        for name in re.findall(r"-m\s+([A-Za-z_][\w.]*)", node.value):
            yield "-m", name
        if "import " not in node.value:
            continue
        try:
            code = ast.parse(node.value)
        except SyntaxError:
            continue
        for sub in ast.walk(code):
            if isinstance(sub, ast.Import):
                yield from (("-c", a.name) for a in sub.names)
            elif isinstance(sub, ast.ImportFrom) and sub.level == 0 and sub.module:
                yield "-c", sub.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_forbidden_module_in_what_a_child_interpreter_runs(path) -> None:
    """The ``-c`` scripts and ``-m`` modules the port hands a child
    interpreter (the scale harness's subprocess lighthouse, the launcher's
    and scheduler's command lines, the rank processes) name no module of
    the JAX package: an import hidden in a string escapes the AST scan
    above."""
    refs = list(_child_code_refs(ast.parse(path.read_text(), filename=str(path))))
    bad = [ref for ref in refs if _forbidden(ref[1])]
    assert not bad, f"{path.relative_to(REPO)} hands a child {bad}"


def test_the_child_code_scan_sees_the_strings_it_guards() -> None:
    """The scan finds the scale harness's lighthouse script and the rank
    command of ``train_hsdp``, and flags a JAX import hidden in a script
    or a ``-m`` name."""
    scale = ast.parse((PKG / "coord" / "scale.py").read_text())
    assert ("-c", "torchft_tpu_torch.lighthouse") in set(_child_code_refs(scale))
    hsdp = ast.parse((PKG / "train_hsdp.py").read_text())
    assert ("-m", "torchft_tpu_torch.train_hsdp") in set(_child_code_refs(hsdp))
    planted = ast.parse(
        'S = """import sys\\nfrom torchft_tpu.lighthouse import LighthouseServer\\n"""\n'
        'CMD = [sys.executable, "-m", "torchft_tpu.launcher"]\n'
        'SH = "python -m torchft_tpu.scheduler slurm"\n')
    assert sorted(r for r in _child_code_refs(planted) if _forbidden(r[1])) == [
        ("-c", "torchft_tpu.lighthouse"), ("-m", "torchft_tpu.launcher"),
        ("-m", "torchft_tpu.scheduler")]


def test_fleet_layer_runs_with_jax_blocked_in_every_child(tmp_path) -> None:
    """In a fresh interpreter, and in every child it starts (a
    ``sitecustomize`` on ``PYTHONPATH`` blocks the JAX package there too):
    the scale harness's subprocess lighthouse answers, the launcher's CLI
    runs a port module in a supervised child, a ``BabyCommunicator`` child
    on each backend reduces a shared-memory payload, and the scheduler
    renders the port's train module with the GPU resources."""
    blocker = tmp_path / "sitecustomize.py"
    blocker.write_text(f"import sys\nfor name in {list(FORBIDDEN)!r}:\n    sys.modules[name] = None\n")
    script = textwrap.dedent(
        f"""
        import subprocess, sys, threading
        import numpy as np
        sys.path.insert(0, {str(REPO)!r})
        assert sys.modules.get("torchft_tpu", 0) is None, "the blocker did not load"
        from torchft_tpu_torch.baby import BabyCommunicator
        from torchft_tpu_torch.coord.scale import _Lighthouse
        from torchft_tpu_torch.lighthouse import LighthouseClient
        from torchft_tpu_torch.scheduler import JobSpec, render_gke, render_sbatch
        from torchft_tpu_torch.store import StoreServer

        def main():
            lh = _Lighthouse(1, 100, 50, 5000, subprocess_mode=True)
            try:
                assert "quorum_id" in LighthouseClient(lh.addr, connect_timeout=10.0).status()
            finally:
                lh.shutdown()
            rc = subprocess.run(
                [sys.executable, "-m", "torchft_tpu_torch.launcher", "--replicas", "1", "--",
                 sys.executable, "-m", "torchft_tpu_torch.punisher", "--help"],
                capture_output=True, timeout=120).returncode
            assert rc == 0, rc
            store = StoreServer("127.0.0.1:0")
            for backend in ("tcp", "cpp"):
                comms = [BabyCommunicator(timeout_s=30.0, backend=backend) for _ in range(2)]
                ts = [threading.Thread(target=c.configure,
                                       args=(f"127.0.0.1:{{store.port}}/{{backend}}", f"r{{i}}", i, 2))
                      for i, c in enumerate(comms)]
                [t.start() for t in ts]
                [t.join() for t in ts]
                works = [c.allreduce(np.ones(1 << 18, np.float32)) for c in comms]
                assert all(float(w.wait(timeout=30.0)[0]) == 2.0 for w in works)
                assert all(c.stats()["shm_ops"] == 1 for c in comms)
                for c in comms:
                    c.shutdown()
            store.shutdown()
            spec = JobSpec(replicas=1, cmd=["python", "-m", "torchft_tpu_torch.train_ddp"],
                           lighthouse="lh:1")
            (_, sbatch), = render_sbatch(spec)
            (_, gke), = render_gke(spec)
            assert "-m torchft_tpu_torch.train_ddp" in sbatch and "--gpus-per-node=1" in sbatch
            assert "nvidia.com/gpu: 1" in gke and "gke-accelerator: nvidia-h100-80gb" in gke
            print("ISOLATED_OK")

        if __name__ == "__main__":
            main()
        """
    )
    main = tmp_path / "fleet_isolated.py"
    main.write_text(script)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, str(main)], capture_output=True, text=True, timeout=240, env=env,
        cwd=str(REPO),
    )
    assert proc.returncode == 0 and "ISOLATED_OK" in proc.stdout, proc.stdout + proc.stderr
