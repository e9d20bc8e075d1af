"""The port's own backend registry, and the device → backend resolver.

Devices resolve in `repro_torch.device` (``None`` is the card); a resolved
device maps to its backend here (`backend_for`).
"""
from __future__ import annotations

import threading
from typing import Callable

import torch

from repro_torch.device import NoCudaDeviceError, resolve_device  # noqa: F401
from repro_torch.runtime.backends import CudaBackend, TorchRefBackend
from repro_torch.runtime.base import EvalBackend


class UnknownBackendError(KeyError):
    """Backend name not present in the registry (lists what is)."""


_lock = threading.Lock()
_factories: dict[str, Callable[[], EvalBackend]] = {}
_instances: dict[str, EvalBackend] = {}


def register_backend(name: str, factory: Callable[[], EvalBackend]) -> None:
    """Register an execution backend under ``name`` (instantiated once, on
    first `get_backend(name)`)."""
    with _lock:
        if name in _factories:
            raise ValueError(f"backend {name!r} already registered")
        _factories[name] = factory


def available_backends() -> tuple[str, ...]:
    """Registered backend names (registration order)."""
    with _lock:
        return tuple(_factories)


def get_backend(name: str) -> EvalBackend:
    """Resolve a backend name to its cached instance."""
    with _lock:
        if name in _instances:
            return _instances[name]
        try:
            factory = _factories[name]
        except KeyError:
            raise UnknownBackendError(
                f"unknown execution backend {name!r}; "
                f"registered: {list(_factories)}"
            ) from None
    inst = factory()
    with _lock:
        return _instances.setdefault(name, inst)


def backend_for(device: torch.device) -> EvalBackend:
    """The backend that serves a resolved device: the kernels on ``cuda``,
    the plain versions on ``cpu``."""
    return get_backend("cuda" if device.type == "cuda" else "torch-ref")


def resolve_backend(
    backend: "str | EvalBackend | None" = None,
) -> EvalBackend:
    """str | EvalBackend → EvalBackend; ``None`` → the default device's
    backend (the kernels, or an exception when there is no card)."""
    if backend is None:
        return backend_for(resolve_device(None))
    if isinstance(backend, EvalBackend):
        return backend
    if isinstance(backend, str):
        return get_backend(backend)
    raise TypeError(
        f"backend must be a registered name or an EvalBackend instance, "
        f"got {type(backend).__name__}"
    )


# -- built-ins --------------------------------------------------------------
register_backend("torch-ref", TorchRefBackend)
register_backend("cuda", CudaBackend)
