"""The port's execution backends: the plain PyTorch versions and the
hand-written CUDA kernels."""
from __future__ import annotations

from repro_torch.kernels import circuit_eval, ref
from repro_torch.runtime import aot
from repro_torch.runtime.base import BackendCapabilities, EvalBackend


class TorchRefBackend(EvalBackend):
    """Plain PyTorch versions of the program entry points (`kernels/ref.py`
    ``eval_program*``): the oracle the kernels are held to, and the
    backend of every entry point called with ``device="cpu"``.  It makes
    no span-launch units (``supports_aot=False``), as the reference's
    ``"ref"`` makes no executables."""

    name = "torch-ref"

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(
            name=self.name,
            device_kinds=("cpu", "cuda"),
            supports_spans=True,
            word_alignment=1,
            span_offset_contract="none",
        )

    def eval_program(self, program, x_words):
        return ref.eval_program(program, x_words)

    def eval_program_spans(self, program, x_words, slots, word_off, in_width,
                           live, *, span_words: int):
        return ref.eval_program_spans(
            program, x_words, slots, word_off, in_width, live,
            span_words=span_words,
        )


class CudaBackend(EvalBackend):
    """The hand-written Hopper kernels (`kernels/circuit_eval.py`).  CUDA
    tensors only: a CPU tensor, a failed build or a refused launch raises.
    Any word offset is evaluated as the plain version evaluates it, so
    spans need no alignment.  Its span-launch units (`runtime/aot.py`)
    store as `aot.AOT_FORMAT`."""

    name = "cuda"

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(
            name=self.name,
            device_kinds=("cuda",),
            supports_spans=True,
            word_alignment=1,
            span_offset_contract="none",
            supports_aot=True,
            aot_format=aot.AOT_FORMAT,
            aot_format_version=aot.AOT_FORMAT_VERSION,
        )

    def eval_program(self, program, x_words):
        return circuit_eval.eval_program(program, x_words)

    def eval_program_spans(self, program, x_words, slots, word_off, in_width,
                           live, *, span_words: int):
        return circuit_eval.eval_program_spans(
            program, x_words, slots, word_off, in_width, live,
            span_words=span_words,
        )
