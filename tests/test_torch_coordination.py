"""The port's coordination surface (``torchft_tpu_torch/coordination.py``)
against the JAX package's (``torchft_tpu/coordination.py``): the same
``__all__``, every export the port's own class or function and documented
(as ``tests/test_api_docs.py`` requires of the JAX package), and the
``Cpp*`` servers resolved lazily from the port's ``native``."""

import inspect

import pytest

from torchft_tpu import coordination as jax_coordination
from torchft_tpu_torch import coordination, native

CPP = ("CppLighthouseServer", "CppManagerServer", "CppStoreServer")


def test_all_equals_the_jax_modules() -> None:
    assert coordination.__all__ == jax_coordination.__all__


@pytest.mark.parametrize("name", jax_coordination.__all__)
def test_each_export_is_the_ports_and_documented(name) -> None:
    obj = getattr(coordination, name)
    twin = getattr(jax_coordination, name)
    assert obj.__name__ == twin.__name__
    assert obj.__module__.split(".")[0] == "torchft_tpu_torch"
    assert inspect.isclass(obj) == inspect.isclass(twin)
    assert (obj.__doc__ or "").strip(), f"{name} undocumented"


@pytest.mark.parametrize("name", CPP)
def test_cpp_servers_resolve_to_the_ports_native(name) -> None:
    obj = getattr(coordination, name)
    assert obj is getattr(native, name)
    assert obj.__module__ == "torchft_tpu_torch.native"
    assert (obj.__doc__ or "").strip()
    assert getattr(jax_coordination, name).__module__ == "torchft_tpu.native"


def test_unknown_name_raises_attribute_error() -> None:
    with pytest.raises(AttributeError, match="no attribute 'NoSuchServer'"):
        coordination.NoSuchServer  # noqa: B018
