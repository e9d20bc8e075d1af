"""Top-k routed mixture-of-experts with sort-based capacity dispatch
(PyTorch port of the reference's ``moe_ffn``).

Covers both MoE archs:
  * granite-moe-1b-a400m — 32 experts, top-8
  * arctic-480b          — 128 experts, top-2 **+ dense residual FFN**
                           (the dense branch lives in `blocks.ffn_sublayer`)

`route` is the router and the dispatch plan: a float32 softmax over the
experts, the top k of each token (ties to the lower expert id, as
``jax.lax.top_k`` breaks them: a stable descending sort), the gates
renormalised over those k, then the (token, k) pairs sorted stably by
expert and ranked within it.  A pair whose rank reaches the capacity
``C = max(int(ceil(T·k / E) · capacity_factor), 1)`` is dropped, so among
the pairs of one expert the ones with the lowest (token, k) index are
kept.  `dispatch` writes the kept pairs' token rows into an (E, C, D)
buffer; the experts are three grouped products over it (`torch.bmm`, the
reference's einsums).  The combine gathers each pair's expert output,
weights it by its gate and sums the k pairs of a token over a (T, k, D)
view: one reduction, the same on every run (an ``index_add_`` would add
them by atomics on the card, in an order that changes from run to run).
The reference adds them one by one into the output (``.at[].add``); the
two orders agree within the tests' tolerance.

The Switch aux loss ``E · Σ_e f_e · p̄_e`` is returned beside the output.
The reference's ``moe_ffn_sharded`` (experts over a mesh axis) waits for
the training slice, with `sharding/`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import MoEConfig


class Dispatch(NamedTuple):
    probs: torch.Tensor   # (T, E) float32 router probabilities
    gates: torch.Tensor   # (T, k) float32, renormalised over the k
    flat_e: torch.Tensor  # (T·k,) expert of each (token, k) pair, token-major
    rank: torch.Tensor    # (T·k,) slot of each pair within its expert
    cap: int              # slots per expert: a pair with rank >= cap is dropped

    @property
    def kept(self) -> torch.Tensor:
        return self.rank < self.cap


def capacity(t: int, cfg: MoEConfig) -> int:
    """Slots per expert for ``t`` tokens (the reference's arithmetic)."""
    return max(int(-(-t * cfg.top_k // cfg.n_experts) * cfg.capacity_factor), 1)


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig) -> Dispatch:
    """Router and dispatch plan for the tokens ``x`` (T, D)."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    # float32 whatever the activation dtype: in bfloat16 the probabilities
    # of near experts round to ties, and the top k would change
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)   # (T, E)
    gate_vals, topk_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, topk_idx = gate_vals[:, :k], topk_idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    flat_e = topk_idx.reshape(-1)                              # (T·k,)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=x.device), right=False)
    rank_sorted = torch.arange(t * k, device=x.device) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[sort_idx] = rank_sorted
    return Dispatch(probs, gate_vals, flat_e, rank, capacity(t, cfg))


def dispatch(x: torch.Tensor, plan: Dispatch) -> torch.Tensor:
    """The (E, C, D) expert buffer: each kept pair's token row at its
    (expert, rank) slot, zeros elsewhere.  Dropped pairs are written to a
    spare slot C that is cut off, so nothing waits on the host for the
    count of kept pairs."""
    e = plan.probs.shape[1]
    k = plan.gates.shape[1]
    buf = torch.zeros((e, plan.cap + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    flat_t = torch.arange(x.shape[0], device=x.device).repeat_interleave(k)
    buf[plan.flat_e, torch.clamp(plan.rank, max=plan.cap)] = x[flat_t]
    return buf[:, :plan.cap]


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, e_wg: torch.Tensor,
            e_wu: torch.Tensor, e_wd: torch.Tensor,
            cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Tokens ``x`` (T, D) → (output (T, D), aux loss ()) (module doc)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    plan = route(x, router_w, cfg)
    buf = dispatch(x, plan)                                    # (E, C, D)

    h_g = torch.bmm(buf, e_wg.to(x.dtype))
    h_u = torch.bmm(buf, e_wu.to(x.dtype))
    y_e = torch.bmm(F.silu(h_g) * h_u, e_wd.to(x.dtype))       # (E, C, D)

    gathered = y_e[plan.flat_e, torch.clamp(plan.rank, max=plan.cap - 1)]
    gathered = torch.where(plan.kept[:, None], gathered, 0)
    w = plan.gates.reshape(-1).to(x.dtype)
    out = (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)

    # integer counts: exact in float32 whatever order the adds land in
    ones = torch.ones(t * k, dtype=torch.float32, device=x.device)
    f_e = torch.zeros(e, dtype=torch.float32, device=x.device).scatter_add_(
        0, plan.flat_e, ones) / (t * k)
    aux = e * torch.sum(f_e * plan.probs.mean(dim=0))
    return out, aux
