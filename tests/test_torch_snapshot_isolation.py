"""A snapshot written by the JAX package is refused by the port by name.

The two packages share the checkpoint format, but each skeleton pickles its
own package's ``_ArrayPlaceholder``.  Unpickling a JAX-written skeleton in
the port would import ``torchft_tpu`` into the port's process and then fail
on the missing placeholders; the port's loader instead refuses any class of
the JAX package (or of jax, jaxlib, ml_dtypes) before importing it.  The
first test writes and loads in two subprocesses, so it sees exactly what a
port replica's process imports.
"""

import json
import os
import struct
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from torchft_tpu_torch.checkpointing.serialization import MAGIC, loads_pytree

REPO = Path(__file__).resolve().parents[1]


def _python(code: str) -> str:
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_port_refuses_a_jax_snapshot_by_name_without_importing_it(tmp_path) -> None:
    path = tmp_path / "jax_snapshot.tftc"
    _python(f"""
        import numpy as np
        from torchft_tpu.checkpointing.serialization import save_pytree
        with open({str(path)!r}, "wb") as f:
            save_pytree({{"w": np.arange(4, dtype=np.float32)}}, f)
    """)
    result = json.loads(_python(f"""
        import json, sys
        from torchft_tpu_torch.checkpointing.serialization import load_pytree
        try:
            with open({str(path)!r}, "rb") as f:
                load_pytree(f)
            error = None
        except ValueError as e:
            error = str(e)
        print(json.dumps({{"error": error, "imported": "torchft_tpu" in sys.modules}}))
    """))
    assert result["error"] is not None, "the JAX snapshot was loaded"
    assert "written by the JAX package" in result["error"]
    assert "heal across packages is not supported" in result["error"]
    assert "torchft_tpu.checkpointing.serialization._ArrayPlaceholder" in result["error"]
    assert result["imported"] is False


def _skeleton_naming(module: str) -> bytes:
    """A checkpoint stream whose skeleton is one pickled global,
    ``module.Placeholder``, and which holds no array."""
    skeleton = b"c" + module.encode() + b"\nPlaceholder\n."  # GLOBAL, STOP
    return MAGIC + struct.pack("<I", len(skeleton)) + skeleton + struct.pack("<I", 0)


@pytest.mark.parametrize("root", ["torchft_tpu", "jax", "jaxlib", "ml_dtypes"])
def test_skeleton_classes_of_the_jax_side_are_refused_before_any_import(root) -> None:
    """A module that does not exist raises ValueError, not
    ModuleNotFoundError: the refusal comes before the import."""
    with pytest.raises(ValueError, match="heal across packages is not supported"):
        loads_pytree(_skeleton_naming(f"{root}.no_such_module"))


def test_skeleton_classes_of_the_port_are_still_admitted() -> None:
    """``torchft_tpu_torch`` shares the JAX package's prefix but is the
    port's own: its names are imported as before."""
    with pytest.raises(ModuleNotFoundError):
        loads_pytree(_skeleton_naming("torchft_tpu_torch.no_such_module"))
