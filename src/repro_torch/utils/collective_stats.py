"""Collective traffic of a step as the reference's dry run records it
(PyTorch port of the reference's ``utils/hlo.py``).

The reference parses the compiled HLO text for its collectives, since
XLA inserts them.  The port has no HLO: its collectives are explicit
calls (`sharding.collectives`), so this module reads a list of the calls
a step issued instead (`Call`, recorded by ``STATS.recording()`` or by a
wrapper of ``torch.distributed``), hence the other name.  The record is
the reference's, with its keys and weights:

    {"all-gather" | "reduce-scatter" | "all-reduce" | "all-to-all"
     | "collective-permute": {"count", "bytes"}, "weighted_bytes"}

where an op's bytes are its *result*, as the reference's regex reads the
result shape of each op: an all-gather's gathered buffer, an
all-reduce's tensor, a reduce-scatter's scattered block (its input over
the group size), a permute's received buffer.  ``weighted_bytes`` weighs
all-reduce 2 and the others 1 (ring algorithms: an all-reduce is a
reduce-scatter and an all-gather).  An all-reduce of the max counts as an
all-reduce, as XLA spells both so.

`count_op` counts an op among the aten ops a dry-run trace dispatched, the
counterpart of the reference's count of an HLO opcode.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Iterable, Mapping, NamedTuple

import torch

# the port's collective kinds (`sharding.collectives.STATS` and the island
# program's ``torch.distributed`` calls) → the reference's HLO op names
HLO_KIND = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
            "all_reduce": "all-reduce", "all_reduce_max": "all-reduce",
            "all_to_all": "all-to-all", "permute": "collective-permute"}

WEIGHT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0, "all-to-all": 1.0,
          "collective-permute": 1.0}


class Call(NamedTuple):
    """One issued collective: its kind (a key of `HLO_KIND`), dtype, the
    shape of its result on this rank and the size of its group."""
    kind: str
    dtype: torch.dtype
    shape: tuple
    group_size: int

    @property
    def result_bytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


def collective_stats(calls: Iterable[Call]) -> dict:
    """→ {op: {"count", "bytes"}, "weighted_bytes": float} (module doc)."""
    per_op: dict = defaultdict(lambda: {"count": 0, "bytes": 0})
    for c in calls:
        op = HLO_KIND[c.kind]
        per_op[op]["count"] += 1
        per_op[op]["bytes"] += c.result_bytes
    out = {op: dict(st) for op, st in per_op.items()}
    out["weighted_bytes"] = float(sum(WEIGHT[op] * st["bytes"] for op, st in per_op.items()))
    return out


def count_op(ops: "Iterable[str] | Mapping[str, int]", opcode: str) -> int:
    """How many of the dispatched aten ops ``ops`` (names such as
    ``"aten.mm.default"``, or a record's ``ops``: name → count) are
    ``opcode`` (``"mm"``: any overload of ``aten.mm``;
    ``"aten.mm.default"``: that overload)."""
    counts = ops if isinstance(ops, Mapping) else Counter(ops)
    n = 0
    for name, k in counts.items():
        parts = name.split(".")
        if name == opcode or (len(parts) >= 2 and parts[1] == opcode):
            n += k
    return n
