"""GQA attention: direct, chunked (online softmax) and decode paths
(PyTorch port).

Each path is explicit tensor math, not `scaled_dot_product_attention`, so
that the masks and the ``NEG_INF = -1e30`` fill match the reference: a
fully masked block still contributes ``exp(0)`` terms that the next
valid block's correction erases.  Scores are computed in the input dtype
and then cast to float32; the softmax runs in float32 and its output is
cast to ``v``'s dtype before the second product.

The chunked path bounds the score working set to (B, Hkv, G, chunk_q,
chunk_kv) per step, with a Python loop over query and key/value chunks.
The reference's scan computes and masks every block. In self-attention
(no query offset, as many queries as keys), where every query row reads
at least its own key, a block the mask covers wholly is skipped here and
one it leaves wholly open is not masked, which changes no bit of the
result: a covered block after a live one (one with any unmasked key)
adds p = exp(−1e30 − m) = 0 under a correction of exp(0) = 1, and one
before any live block is erased exactly by the correction exp(−1e30 − m)
= 0 of the first block where each query row has a key. While gradients
are recorded each query block is checkpointed, as the reference's is
(``jax.checkpoint``, ``nothing_saveable``): its float32 scores and
probabilities are recomputed in the backward pass instead of kept. The
reference's unused ``kv_valid_len`` and ``force_direct`` arguments are
not carried over.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _mask(pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
          window: "int | None") -> torch.Tensor:
    """(…, cq, ckv) bool mask from absolute positions."""
    d = pos_q[..., :, None] - pos_k[..., None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m &= d >= 0
    if window is not None:
        m &= d < window
    return m


def gqa_attention_direct(
    q: torch.Tensor,  # (B, Sq, Hq, hd)
    k: torch.Tensor,  # (B, Skv, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: "int | None" = None,
    q_offset: int = 0,
) -> torch.Tensor:
    b, sq, hq, hd = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k).float()
    s = s * (1.0 / math.sqrt(hd))
    pos_q = q_offset + torch.arange(sq, device=q.device)
    pos_k = torch.arange(skv, device=q.device)
    m = _mask(pos_q, pos_k, causal, window)
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), v)
    return o.reshape(b, sq, hq, hd)


def gqa_attention_chunked(
    q: torch.Tensor,  # (B, Sq, Hq, hd)
    k: torch.Tensor,  # (B, Skv, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: "int | None" = None,
    q_offset: int = 0,
    chunk_q: int = 512,
    chunk_kv: int = 1024,
) -> torch.Tensor:
    b, sq, hq, hd = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    cq = min(chunk_q, sq)
    ckv = min(chunk_kv, skv)
    if sq % cq or skv % ckv:
        # small/odd shapes (smoke tests) fall back to the direct path
        return gqa_attention_direct(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    nq, nk = sq // cq, skv // ckv
    scale = 1.0 / math.sqrt(hd)
    qs = q.reshape(b, nq, cq, hkv, g, hd)
    ks = k.reshape(b, nk, ckv, hkv, hd)
    vs = v.reshape(b, nk, ckv, hkv, hd)
    arange_q = torch.arange(cq, device=q.device)
    arange_k = torch.arange(ckv, device=q.device)

    def kv_blocks(qi: int) -> list:
        """(kj, masked) for the key/value blocks query block ``qi`` reads:
        a block the mask covers wholly is left out, and one it leaves
        wholly open is not masked (module doc).  Only in self-attention
        (no offset, as many queries as keys), where every query row
        reads its own key."""
        if q_offset or sq != skv:
            return [(kj, True) for kj in range(nk)]
        q_lo = qi * cq
        q_hi = q_lo + cq - 1
        out = []
        for kj in range(nk):
            k_lo, k_hi = kj * ckv, kj * ckv + ckv - 1
            if (causal and k_lo > q_hi) or (window is not None and q_lo - k_hi >= window):
                continue
            open_ = (not causal or k_hi <= q_lo) and (window is None or q_hi - k_lo < window)
            out.append((kj, not open_))
        return out

    def q_block(qc: torch.Tensor, pos_q: torch.Tensor, blocks: list) -> torch.Tensor:
        """One query block (B, cq, Hkv, G, hd) against its key/value
        ``blocks`` → (B, cq, Hq, hd)."""
        m_run = torch.full((b, hkv, g, cq), NEG_INF, dtype=torch.float32, device=q.device)
        l_run = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, cq, hd), dtype=v.dtype, device=q.device)
        for kj, masked in blocks:
            kc, vc = ks[:, kj], vs[:, kj]
            s = torch.einsum("bqkgd,btkd->bkgqt", qc, kc).float()
            s = s * scale
            if masked:
                msk = _mask(pos_q, kj * ckv + arange_k, causal, window)    # (cq, ckv)
                s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(vc.dtype), vc)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-20)[..., None].to(acc.dtype)
        # (B, Hkv, G, cq, hd) → (B, cq, Hq, hd)
        return out.permute(0, 3, 1, 2, 4).reshape(b, cq, hq, hd)

    outs = []
    for qi in range(nq):
        pos_q = q_offset + qi * cq + arange_q
        if torch.is_grad_enabled():
            # recompute the block's scores and probabilities in the
            # backward pass instead of keeping them
            outs.append(checkpoint(q_block, qs[:, qi], pos_q, kv_blocks(qi),
                                   use_reentrant=False))
        else:
            outs.append(q_block(qs[:, qi], pos_q, kv_blocks(qi)))
    return torch.cat(outs, dim=1)


def gqa_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                  chunk_q=256, chunk_kv=512):
    """Dispatch: direct while Sq·Skv <= 1024², chunked beyond."""
    if q.shape[1] * k.shape[1] <= 1024 * 1024:
        return gqa_attention_direct(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    return gqa_attention_chunked(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, chunk_q=chunk_q, chunk_kv=chunk_kv)


def decode_attention(
    q: torch.Tensor,        # (B, 1, Hq, hd)
    k_cache: torch.Tensor,  # (B, T, Hkv, hd)
    v_cache: torch.Tensor,
    pos: int,               # index of the *current* token
    *,
    window: "int | None" = None,
    ring: bool = False,     # cache is a ring buffer of size T (sliding layers)
) -> torch.Tensor:
    b, t, hkv, hd = k_cache.shape
    hq = q.shape[2]
    g = hq // hkv
    qg = q.reshape(b, 1, hkv, g, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k_cache).float()
    s = s * (1.0 / math.sqrt(hd))
    slots = torch.arange(t, device=q.device)
    if ring:
        # until the ring wraps every slot <= pos is valid; after, all are
        valid = (slots <= pos) | (pos >= t)
    else:
        valid = slots <= pos
        if window is not None:
            valid &= slots > pos - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, 1, hq, hd)
