"""Execution backends of the port.

  * ``"torch-ref"`` — the plain PyTorch versions (`kernels/ref.py`);
  * ``"cuda"``      — the hand-written Hopper kernels (`kernels/circuit_eval.py`).

Entry points resolve ``device=None`` to the card (`resolve_device`, from
`repro_torch.device`) and the device to its backend (`backend_for`).  The
port keeps its own registry.
"""
from repro_torch.runtime.backends import CudaBackend, TorchRefBackend  # noqa: F401
from repro_torch.runtime.base import (  # noqa: F401
    BackendCapabilities,
    BackendCapabilityError,
    EvalBackend,
)
from repro_torch.runtime.registry import (  # noqa: F401
    NoCudaDeviceError,
    UnknownBackendError,
    available_backends,
    backend_for,
    get_backend,
    register_backend,
    resolve_backend,
    resolve_device,
)

__all__ = [
    "BackendCapabilities",
    "BackendCapabilityError",
    "CudaBackend",
    "EvalBackend",
    "NoCudaDeviceError",
    "TorchRefBackend",
    "UnknownBackendError",
    "available_backends",
    "backend_for",
    "get_backend",
    "register_backend",
    "resolve_backend",
    "resolve_device",
]
