"""The refit search's own process: the child interpreter `RefitWorker` runs.

A refit's 1+λ search is a Python loop of torch calls.  Run on a second
thread of the serving process it shares one interpreter lock with the
serving loop, and each starves the other.  So `RefitWorker` (non-
synchronous) hands every job to one persistent child interpreter, which
runs this module's `main` with the pipes' descriptors and the device
(``"none"``: the card)::

    python -c "import sys; from repro_torch.serve.evolution.refit_process \
        import main; sys.exit(main(sys.argv[1:]))" READ_FD WRITE_FD DEVICE

The child imports the port, resolves the device, and on the card creates
its CUDA context and loads the kernel library the parent has already built
(it refuses to build one: two processes never both run ``nvcc``).  Then
it reports ready and serves jobs until its input pipe closes.  Each job
runs the unchanged `refit_circuit` on the job's inputs and answers with
the `RefitResult` and the kernel launches the search made there (launch
counts are per process).

Messages are pickled dicts in length-prefixed frames
(`multiprocessing.connection.Connection` over two anonymous pipes; the
parent's blocking read releases its interpreter lock).  Circuits cross as
plain pickles of `ServableCircuit` with host-resident genomes and no
compiled programs, so ``lineage`` and ``ref_stats`` come back exactly.

The child is started with a fresh interpreter (`subprocess.Popen`, never a
fork after CUDA is initialised), with ``PYTHONPATH`` set to this checkout's
``src`` so it imports the same code as its parent.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time
import traceback
from multiprocessing.connection import Connection
from pathlib import Path

# the directory holding the ``repro_torch`` package
SRC_DIR = Path(__file__).resolve().parents[3]
_CHILD_MAIN = (
    "import sys; from repro_torch.serve.evolution.refit_process import main; "
    "sys.exit(main(sys.argv[1:]))"
)


class RefitProcessError(RuntimeError):
    """The refit child failed to start, died, or could not run a job."""


def child_argv(read_fd: int, write_fd: int, device: str) -> list[str]:
    """The child's command line: a fresh interpreter running `main`."""
    return [sys.executable, "-c", _CHILD_MAIN, str(read_fd), str(write_fd), device]


def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC_DIR)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    return env


def portable(circuit):
    """``circuit`` with its genome on the host and no compiled programs: the
    form that pickles without touching a card."""
    from repro_torch.core.genome import Genome

    return dataclasses.replace(
        circuit, genome=Genome(*(a.cpu() for a in circuit.genome))
    )


def _device_arg(device) -> str:
    return "none" if device is None else str(device)


class RefitProcess:
    """The parent's handle on one refit child (see module docstring)."""

    def __init__(self, device, *, timeout_s: float = 180.0):
        """Start the child and wait until it reports ready; raises
        `RefitProcessError` when it exits or stays silent for
        ``timeout_s``."""
        if _device_arg(device) != "cpu":
            # the child loads this library and never builds it
            from repro_torch.kernels import circuit_eval

            circuit_eval.build_library()
        to_child_r, to_child_w = os.pipe()
        from_child_r, from_child_w = os.pipe()
        try:
            self.proc = subprocess.Popen(
                child_argv(to_child_r, from_child_w, _device_arg(device)),
                pass_fds=(to_child_r, from_child_w), env=child_env(),
                stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            )
        except OSError as err:
            for fd in (to_child_r, to_child_w, from_child_r, from_child_w):
                os.close(fd)
            raise RefitProcessError(f"cannot start the refit process: {err}") from err
        os.close(to_child_r)
        os.close(from_child_w)
        self._send = Connection(to_child_w, readable=False)
        self._recv = Connection(from_child_r, writable=False)
        deadline = time.monotonic() + timeout_s
        while not self._recv.poll(0.2):
            if self.proc.poll() is not None or time.monotonic() > deadline:
                code = self.proc.poll()
                self.close(timeout=1.0)
                raise RefitProcessError(
                    f"the refit process exited with code {code} before it was ready"
                    if code is not None else
                    f"the refit process was not ready within {timeout_s} s"
                )
        try:
            hello = pickle.loads(self._recv.recv_bytes())
        except (EOFError, OSError) as err:
            self.close(timeout=1.0)
            raise RefitProcessError(
                f"the refit process closed its pipe before it was ready "
                f"(exit code {self.proc.poll()})") from err
        if "error" in hello:
            self.close(timeout=5.0)
            raise RefitProcessError(f"the refit process failed to start:\n{hello['error']}")
        self.pid = hello["pid"]

    def alive(self) -> bool:
        return self.proc.poll() is None

    def refit(self, tenant, live, x, y, cfg, refit_index: int):
        """Run `refit_circuit` in the child; returns ``(RefitResult,
        launches by kernel)``.  Raises `RefitProcessError` when the child
        dies, and re-raises the search's own failure as one."""
        job = {"tenant": tenant, "live": portable(live), "x": x, "y": y,
               "cfg": cfg, "refit_index": int(refit_index)}
        try:
            self._send.send_bytes(pickle.dumps(job, protocol=pickle.HIGHEST_PROTOCOL))
            reply = pickle.loads(self._recv.recv_bytes())
        except (EOFError, OSError) as err:
            try:
                code = self.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                code = None
            raise RefitProcessError(
                f"the refit process died during the job (exit code {code})") from err
        if "error" in reply:
            raise RefitProcessError(f"the refit search failed in its process:\n"
                                    f"{reply['error']}")
        return reply["result"], reply["launches"]

    def close(self, timeout: float = 30.0) -> "int | None":
        """Close the pipes (the child exits at end of input) and wait for
        it, killing it after ``timeout``.  Returns its exit code."""
        for conn in (getattr(self, "_send", None), getattr(self, "_recv", None)):
            if conn is not None:
                conn.close()
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait(timeout=10.0)


# -- the child ---------------------------------------------------------------
def _boot(device_arg: str):
    """Import the port, resolve the device and make it ready to search."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels import circuit_eval

    device = resolve_device(None if device_arg == "none" else device_arg)
    if device.type == "cuda":
        torch.zeros(1, device=device)           # the CUDA context, now
        if not circuit_eval.library_path().exists():
            raise RefitProcessError(
                f"the kernel library {circuit_eval.library_path()} is not built; "
                "the refit process loads the one its parent built")
        circuit_eval.load_library()
    return circuit_eval


def main(argv: "list[str]") -> int:
    """The child: ``argv`` is (read fd, write fd, device)."""
    recv = Connection(int(argv[0]), writable=False)
    send = Connection(int(argv[1]), readable=False)
    try:
        circuit_eval = _boot(argv[2])
        from repro_torch.serve.evolution.refit import refit_circuit
    except BaseException:  # noqa: BLE001 — report, then exit non-zero
        send.send_bytes(pickle.dumps({"error": traceback.format_exc()}))
        return 1
    send.send_bytes(pickle.dumps({"ready": True, "pid": os.getpid()}))
    while True:
        try:
            job = pickle.loads(recv.recv_bytes())
        except EOFError:
            return 0
        before = {k.name: k.launches for k in circuit_eval.KERNELS}
        try:
            result = refit_circuit(job["tenant"], job["live"], job["x"], job["y"],
                                   job["cfg"], refit_index=job["refit_index"])
            reply = {"result": result._replace(candidate=portable(result.candidate)),
                     "launches": {k.name: k.launches - before[k.name]
                                  for k in circuit_eval.KERNELS}}
        except Exception:  # noqa: BLE001 — the parent warns with it
            reply = {"error": traceback.format_exc()}
        send.send_bytes(pickle.dumps(reply, protocol=pickle.HIGHEST_PROTOCOL))

