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

On a mesh (`sharding/`), `moe_ffn_sharded` is the reference's
``shard_map`` MoE: tokens split over fsdp, experts over tp; rank (d, m)
dispatches its data shard's tokens to its own experts only, and the
combine is one all-reduce over tp.  Capacity drops are per (expert × data
shard): ``C = max(int(ceil(T_loc·k / E) · cf), 1)`` from the shard's
T_loc tokens, and the aux loss is the mean over data shards of each
shard's aux (``pmean``), not the global aux.  `moe_ffn_sharded_plain` runs
the same per-shard semantics in one process over the unsharded tensors:
what the distributed version is held to.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import MoEConfig
from repro_torch.sharding import collectives as C


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
    count of kept pairs, and their gradient is zero, as the reference's
    ``mode="drop"`` write gives."""
    e = plan.probs.shape[1]
    k = plan.gates.shape[1]
    t, d = x.shape
    buf = torch.zeros((e, plan.cap + 1, d), dtype=x.dtype, device=x.device)
    # each token's row once per pair, token-major: its backward sums the k
    # pairs of a token over a view, in one order on every run
    rows = x[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf[plan.flat_e, torch.clamp(plan.rank, max=plan.cap)] = rows
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


# ---------------------------------------------------------------------------
# Explicit-SPMD MoE on a mesh
# ---------------------------------------------------------------------------

def _local_dispatch_compute(x_loc: torch.Tensor, router_w: torch.Tensor, e_wg: torch.Tensor,
                            e_wu: torch.Tensor, e_wd: torch.Tensor, cfg: MoEConfig, m_idx: int,
                            e_loc: int):
    """One rank's part: its tokens ``x_loc`` (T_loc, D) routed over all E
    experts (capacity from T_loc), the pairs of experts ``[m_idx·e_loc,
    (m_idx + 1)·e_loc)`` dispatched to the local expert weights (e_loc, …).
    → (partial output (T_loc, D), the shard's aux, the local experts'
    dropped pairs (a 0-d int tensor))."""
    t, d = x_loc.shape
    e, k = cfg.n_experts, cfg.top_k
    plan = route(x_loc, router_w, cfg)
    # a pair's rank within its expert is the same whether the other
    # experts' pairs are counted or not (a stable sort by expert)
    local_e = plan.flat_e - m_idx * e_loc
    mine = (local_e >= 0) & (local_e < e_loc)
    write_e = torch.where(mine, local_e, e_loc)   # other experts' pairs → a spare row
    slot = torch.clamp(plan.rank, max=plan.cap)   # dropped pairs → a spare slot
    buf = torch.zeros((e_loc + 1, plan.cap + 1, d), dtype=x_loc.dtype, device=x_loc.device)
    buf[write_e, slot] = x_loc[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = buf[:e_loc, :plan.cap]

    h = F.silu(torch.bmm(buf, e_wg.to(x_loc.dtype))) * torch.bmm(buf, e_wu.to(x_loc.dtype))
    y_e = torch.bmm(h, e_wd.to(x_loc.dtype))                   # (e_loc, C, D)

    kept = mine & plan.kept
    gathered = y_e[torch.clamp(write_e, max=e_loc - 1), torch.clamp(plan.rank, max=plan.cap - 1)]
    gathered = torch.where(kept[:, None], gathered, 0)
    w = plan.gates.reshape(-1).to(x_loc.dtype)
    y = (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)

    ones = torch.ones(t * k, dtype=torch.float32, device=x_loc.device)
    f_e = torch.zeros(e, dtype=torch.float32, device=x_loc.device).scatter_add_(
        0, plan.flat_e, ones) / (t * k)
    aux = e * torch.sum(f_e * plan.probs.mean(dim=0))
    return y, aux, (mine & ~plan.kept).sum()


def moe_ffn_sharded(x_loc: torch.Tensor, router_w: torch.Tensor, e_wg: torch.Tensor,
                    e_wu: torch.Tensor, e_wd: torch.Tensor, cfg: MoEConfig, mesh,
                    fsdp: tuple, tp: str, with_dropped: bool = False):
    """This rank's part of the reference's ``moe_ffn_sharded`` (module doc):
    ``x_loc`` (T_loc, D) the tokens of its data shard, ``router_w`` whole,
    ``e_w*`` its tp rank's experts (E/tp, …), whole over fsdp.
    → (output (T_loc, D), the aux mean over data shards), and with
    ``with_dropped`` the mesh's dropped pairs (a 0-d int tensor, the same
    on every rank).  Gradients flow through the two collectives."""
    e_loc = cfg.n_experts // mesh.shape[tp]
    if e_wg.shape[0] != e_loc:
        raise ValueError(f"{e_wg.shape[0]} local experts; {cfg.n_experts} over "
                         f"{mesh.shape[tp]} tp ranks gives {e_loc}")
    y, aux, dropped = _local_dispatch_compute(x_loc, router_w, e_wg, e_wu, e_wd, cfg,
                                              mesh.index(tp), e_loc)
    y = C.all_reduce(y, mesh, tp)
    aux = C.pmean(aux, mesh, fsdp)
    if not with_dropped:
        return y, aux
    return y, aux, C._raw_all_reduce(dropped, mesh, tuple(mesh.axis_names))


def moe_ffn_sharded_plain(x: torch.Tensor, router_w: torch.Tensor, e_wg: torch.Tensor,
                          e_wu: torch.Tensor, e_wd: torch.Tensor, cfg: MoEConfig,
                          n_fsdp: int, n_tp: int, with_dropped: bool = False):
    """`moe_ffn_sharded`'s semantics on ``n_fsdp`` × ``n_tp`` ranks, run in
    one process over the whole tokens (T, D) and experts (E, …): each
    data shard's tokens through each tp rank's experts, the partial
    outputs summed over tp, the shards' aux averaged.  → (output (T, D),
    aux) and with ``with_dropped`` the dropped pairs."""
    t = x.shape[0]
    e_loc = cfg.n_experts // n_tp
    if t % n_fsdp or cfg.n_experts % n_tp:
        raise ValueError(f"{t} tokens over {n_fsdp} shards, {cfg.n_experts} experts "
                         f"over {n_tp}")
    t_loc = t // n_fsdp
    ys, auxes, dropped = [], [], 0
    for di in range(n_fsdp):
        xd = x[di * t_loc:(di + 1) * t_loc]
        y = 0
        for m in range(n_tp):
            ex = slice(m * e_loc, (m + 1) * e_loc)
            part, aux, drop = _local_dispatch_compute(xd, router_w, e_wg[ex], e_wu[ex],
                                                      e_wd[ex], cfg, m, e_loc)
            y = y + part
            dropped = dropped + drop
        ys.append(y)
        auxes.append(aux)
    out = (torch.cat(ys), torch.stack(auxes).mean())
    return (*out, dropped) if with_dropped else out
