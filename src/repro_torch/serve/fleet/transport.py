"""Transport seam between the `FleetRouter` and its `ServingHost`s.

The router never touches a host object directly — every interaction is
``transport.call(method, payload)`` against an abstract `Transport`.
Two implementations share one wire-codec:

  * `InProcTransport` — direct dispatch into a `ServingHost` living in
    the same process.  Payloads still round-trip through the codec, so
    the in-process path exercises the exact bytes the socket path ships
    — CI's deterministic fleet tests are honest about serialization.
  * `SocketTransport` — length-prefixed frames over TCP to a
    `serve_socket` loop (threaded in tests, a subprocess via
    `spawn_host_process` in real runs).

Wire format: 4-byte big-endian length + JSON.  Binary leaves (numpy
arrays, bundle bytes) ride as tagged base64 — ``{"__nd__": ...}`` wraps
`np.save` bytes so dtype/shape survive exactly (float32 request rows
and int32 predictions come back bitwise-identical, which the fleet
parity criterion depends on); ``{"__b__": ...}`` wraps raw bytes
(persistence bundles in flight during migration).  Remote exceptions
come back as an error envelope and are re-raised router-side as the
matching local type, so callers handle `KeyError`/`AdmissionError`
identically whichever transport served them.

The port's own copy of the reference's codec: frames for the same payload
are the reference's, byte for byte.  Its subprocess host imports
`repro_torch`, takes ``device`` where the reference takes ``backend``
(``None``: the card), and is started with a fresh interpreter whose
``PYTHONPATH`` names this checkout's ``src``.
"""
from __future__ import annotations

import base64
import io
import json
import os
import select
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.serve.async_frontend.queue import (
    AdmissionError,
    DeadlineExceededError,
)
from repro_torch.serve.circuits.server import StalePlanError

_HDR = struct.Struct(">I")
MAX_FRAME = 256 * 1024 * 1024  # corrupt-length guard, not a quota

# remote error envelope type → local exception class; anything else
# re-raises as TransportError carrying the remote type name
_ERROR_TYPES = {
    "KeyError": KeyError,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
    "AdmissionError": AdmissionError,
    "DeadlineExceededError": DeadlineExceededError,
    "StalePlanError": StalePlanError,
}


class TransportError(RuntimeError):
    """Transport-level failure, or a remote error with no local type."""


# -- codec -------------------------------------------------------------

def _enc(obj):
    if isinstance(obj, np.ndarray):
        buf = io.BytesIO()
        np.save(buf, obj, allow_pickle=False)
        return {"__nd__": base64.b64encode(buf.getvalue()).decode("ascii")}
    if isinstance(obj, (bytes, bytearray)):
        return {"__b__": base64.b64encode(bytes(obj)).decode("ascii")}
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    if isinstance(obj, dict):
        return {str(k): _enc(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_enc(v) for v in obj]
    return obj


def _dec(obj):
    if isinstance(obj, dict):
        if set(obj) == {"__nd__"}:
            raw = base64.b64decode(obj["__nd__"])
            return np.load(io.BytesIO(raw), allow_pickle=False)
        if set(obj) == {"__b__"}:
            return base64.b64decode(obj["__b__"])
        return {k: _dec(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dec(v) for v in obj]
    return obj


def encode_frame(obj) -> bytes:
    """Length-prefixed JSON frame with numpy/bytes leaves tagged."""
    body = json.dumps(_enc(obj)).encode()
    if len(body) > MAX_FRAME:
        raise TransportError(f"frame of {len(body)} bytes exceeds MAX_FRAME")
    return _HDR.pack(len(body)) + body


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise TransportError("connection closed mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket):
    (length,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if length > MAX_FRAME:
        raise TransportError(f"incoming frame claims {length} bytes")
    return _dec(json.loads(_recv_exact(sock, length).decode()))


def _raise_remote(envelope: dict):
    etype = envelope.get("error", "TransportError")
    msg = envelope.get("message", "")
    exc_cls = _ERROR_TYPES.get(etype)
    if exc_cls is None:
        raise TransportError(f"remote {etype}: {msg}")
    raise exc_cls(msg)


# -- transports --------------------------------------------------------

class Transport:
    """One host endpoint: ``call(method, payload) → decoded result``."""

    def call(self, method: str, payload: "dict | None" = None):
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - default no-op
        pass


class InProcTransport(Transport):
    """Dispatch into a same-process `ServingHost`, through the codec.

    The encode→decode round-trip is deliberate: requests and results
    cross the same serialization boundary the socket path uses, so a
    codec bug fails the deterministic CI tests, not just real runs."""

    def __init__(self, host):
        self.host = host

    def call(self, method: str, payload: "dict | None" = None):
        request = _dec(json.loads(json.dumps(_enc(payload or {}))))
        result = self.host.handle(method, request)
        envelope = _dec(json.loads(json.dumps(_enc(result))))
        if isinstance(envelope, dict) and "error" in envelope:
            _raise_remote(envelope)
        return envelope


class SocketTransport(Transport):
    """Framed JSON-RPC over TCP; one connection, serial calls.

    The router serializes calls per host (one in-flight RPC per
    transport) so a single connection suffices; `FleetRouter` holds one
    transport per host and fans out across hosts with threads."""

    def __init__(self, address: "tuple[str, int]",
                 *, connect_timeout_s: float = 10.0):
        self.address = tuple(address)
        self._lock = threading.Lock()
        self._sock = socket.create_connection(
            self.address, timeout=connect_timeout_s
        )
        self._sock.settimeout(None)

    def call(self, method: str, payload: "dict | None" = None):
        with self._lock:
            self._sock.sendall(encode_frame(
                {"method": method, "payload": payload or {}}
            ))
            envelope = recv_frame(self._sock)
        if isinstance(envelope, dict) and "error" in envelope:
            _raise_remote(envelope)
        return envelope

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# -- host-side loop ----------------------------------------------------

def serve_socket(
    host,
    *,
    address: "tuple[str, int]" = ("127.0.0.1", 0),
    ready: "threading.Event | None" = None,
) -> "tuple[str, int]":
    """Serve ``host.handle`` over TCP until a ``shutdown`` RPC arrives.

    Binds, publishes the bound address via the return value (and sets
    ``ready`` if given, for thread-hosted servers), then accepts
    connections serially — the router keeps one connection per host, so
    a serial accept loop is the honest concurrency model.  Exceptions
    from handlers become error envelopes; the loop itself only exits on
    ``shutdown``."""
    lsock = socket.create_server(address)
    bound = lsock.getsockname()
    if ready is not None:
        ready.addr = bound  # type: ignore[attr-defined] — test hook
        ready.set()
    stop = False
    while not stop:
        conn, _ = lsock.accept()
        with conn:
            while True:
                try:
                    request = recv_frame(conn)
                except TransportError:
                    break  # client went away; await the next connection
                method = request.get("method", "")
                try:
                    result = host.handle(method, request.get("payload", {}))
                except Exception as err:  # noqa: BLE001 — envelope it
                    result = {"error": type(err).__name__,
                              "message": str(err)}
                conn.sendall(encode_frame(result))
                if method == "shutdown" and "error" not in result:
                    stop = True
                    break
    lsock.close()
    return bound


_HOST_MAIN = """\
import json, sys
from repro_torch.serve.circuits.registry import CircuitRegistry
from repro_torch.serve.fleet.host import ServingHost
from repro_torch.serve.fleet.transport import serve_socket

cfg = json.loads(sys.argv[1])
device = cfg.get("device")
host = ServingHost(cfg["host_id"], CircuitRegistry(), device=device)
host.start()
class _Ready:
    def set(self):
        print(json.dumps({"addr": list(self.addr)}), flush=True)
serve_socket(host, address=("127.0.0.1", int(cfg.get("port", 0))),
             ready=_Ready())
host.stop()
"""

# the directory holding the ``repro_torch`` package
_SRC_DIR = Path(__file__).resolve().parents[3]


def spawn_host_process(
    host_id: str,
    *,
    device: "str | None" = None,
    port: int = 0,
    timeout_s: float = 120.0,
) -> "tuple[subprocess.Popen, tuple[str, int]]":
    """Launch an empty `ServingHost` in a subprocess and connect to it.

    The child prints its bound address as one JSON line; tenants arrive
    afterwards over the transport (``add_tenant`` bundles), exactly as
    in a migration — a process host is just a host whose every tenant
    migrated in.  ``device=None`` serves on the card: the kernel library
    is built here first, so the child only loads it.  ``timeout_s``
    bounds the child's boot, which is mostly ``import torch`` and the
    CUDA context: seconds on a card's host (PERF.md has the measured
    boot), so the bound leaves room for a loaded machine.  Returns
    (process, address)."""
    if device is None or torch.device(device).type == "cuda":
        from repro_torch.kernels import circuit_eval

        circuit_eval.build_library()
    cfg = json.dumps({"host_id": host_id, "device": device, "port": port})
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_SRC_DIR)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", _HOST_MAIN, cfg],
        stdout=subprocess.PIPE, stderr=err, stdin=subprocess.DEVNULL,
        text=True, env=env,
    )
    deadline = time.monotonic() + timeout_s
    line = ""
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 0.2)
        if ready:
            line = proc.stdout.readline()
            if line.strip():
                break
        if proc.poll() is not None:
            err.seek(0)
            raise TransportError(
                f"host process {host_id!r} exited with "
                f"{proc.returncode}: {err.read()[-2000:]}"
            )
    if not line.strip():
        proc.kill()
        proc.wait()
        err.close()
        raise TransportError(f"host process {host_id!r} never announced")
    err.close()
    addr = tuple(json.loads(line)["addr"])
    return proc, (str(addr[0]), int(addr[1]))
