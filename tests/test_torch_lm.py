"""The port's LM serving path against the reference.

All ten archs (attention, experts, RWKV6 and the attention + Mamba
hybrid) at ``smoke()`` size in float32, with the reference's
``lm.init_params(jax.random.key(0), cfg)`` carried across by
`params_from_reference`; inputs are seeded numpy arrays fed to both
packages.  The experts' smoke configs are dropless (capacity E/k), so
decode agrees with `forward`; `tests/test_torch_moe_ssm.py` forces drops,
and the granite-moe fixture drops pairs in decode.

Tolerance: ``TOL = 1e-5`` absolute on logits, caches, aux losses and
attention outputs.  Both packages compute the same float32 operations in
the same order of layers; their reductions (matrix products, the RMSNorm
mean, the softmax sums, the wkv einsums) group terms differently, which
moves results by a few ulps (measured: at most 5.5e-6 on these shapes,
the RWKV state).  The reference's own decode-against-forward bound is
5e-4 (`tests/test_models_smoke.py`).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as RA
from repro.models import lm as RLM
from repro.models import rope as RR
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import NoCudaDeviceError
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models import rope as R
from repro_torch.models import moe
from repro_torch.models.convert import (init_params, param_dtype, param_shapes,
                                        params_from_reference)
from repro_torch.models.lm import CausalLM
from repro_torch.serve.engine import Engine, Request

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_golden"))
import make_lm_golden  # noqa: E402

TOL = 1e-5
B, S = 2, 24
FIXTURES = {fx.name: fx for fx in make_lm_golden.FIXTURES}


def _trees(arch):
    """(reference cfg, reference params, port cfg, port params) at smoke
    size, the port's on the CPU."""
    rcfg = ref_get_config(arch).smoke()
    rparams = RLM.init_params(jax.random.key(0), rcfg)
    cfg = get_config(arch).smoke()
    tree = jax.tree.map(np.asarray, rparams)
    return rcfg, rparams, cfg, params_from_reference(tree, cfg, "cpu")


def _models(arch):
    """(reference cfg, reference params, port cfg, port model) at smoke size."""
    rcfg, rparams, cfg, params = _trees(arch)
    return rcfg, rparams, cfg, CausalLM(cfg, params, device="cpu")


def _inputs(cfg, s=S, seed=1):
    """Seeded tokens, or frame/patch embeddings for the frontend stubs."""
    rng = np.random.RandomState(seed)
    if cfg.frontend is not None:
        return "embeds", rng.randn(B, s, cfg.d_model).astype(np.float32)
    return "tokens", rng.randint(0, cfg.vocab, (B, s)).astype(np.int32)


def _close(port: torch.Tensor, ref) -> float:
    err = float(np.abs(port.numpy() - np.asarray(ref)).max())
    assert err <= TOL, err
    return err


def _close_caches(cache: dict, r_cache: dict) -> None:
    """Every tensor of the cache (k/v, the hybrid's global gk/gv and Mamba
    m_h/m_conv, RWKV's s/last_x/last_xc) equal to the reference's, and the
    position."""
    assert sorted(cache) == sorted(r_cache)
    assert cache["pos"] == int(r_cache["pos"])
    for name, want in r_cache.items():
        if name != "pos":
            assert tuple(cache[name].shape) == want.shape, name
            _close(cache[name], want)


def test_all_ten_archs_are_covered():
    assert ARCH_IDS == ("granite-moe-1b-a400m", "arctic-480b", "stablelm-12b", "llama3-405b",
                        "starcoder2-7b", "minitron-8b", "musicgen-medium", "qwen2-vl-7b",
                        "rwkv6-7b", "hymba-1.5b")
    kinds = {(get_config(a).block_kind, get_config(a).moe is not None) for a in ARCH_IDS}
    assert kinds == {("attn", False), ("attn", True), ("rwkv", False), ("hybrid", False)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_prefill_and_decode_match_the_reference(arch):
    """forward logits and aux loss, prefill logits and cache, and each
    decode step's logits and cache (the smoke window of 16 makes the
    21-token prefill wrap starcoder2's and hymba's rings; rwkv6's 21 tokens
    pad to 32)."""
    rcfg, rparams, cfg, model = _models(arch)
    key, full = _inputs(cfg)
    r_logits, r_aux, _ = RLM.forward(rparams, rcfg, **{key: jnp.asarray(full)})
    logits, aux, _ = model.forward(**{key: torch.from_numpy(full)})
    assert logits.shape == (B, S, cfg.vocab)
    assert abs(float(aux) - float(r_aux)) <= TOL and (float(aux) > 0) == (cfg.moe is not None)
    _close(logits, r_logits)

    p = S - 3
    r_last, r_cache = RLM.prefill(rparams, rcfg, max_len=S, **{key: jnp.asarray(full[:, :p])})
    last, cache = model.prefill(**{key: torch.from_numpy(full[:, :p])}, max_len=S)
    _close(last, r_last)
    assert cache["pos"] == p
    _close_caches(cache, r_cache)
    dec = "embed" if cfg.frontend is not None else "token"
    for t in range(p, S):
        r_lg, r_cache = RLM.decode_step(rparams, rcfg, r_cache, **{dec: jnp.asarray(full[:, t:t + 1])})
        lg, cache = model.decode_step(cache, **{dec: torch.from_numpy(full[:, t:t + 1])})
        _close(lg, r_lg)
        _close(lg, r_logits[:, t])  # and the sequence forward
        _close_caches(cache, r_cache)


def test_mrope_positions_match_the_reference():
    """qwen2-vl with distinct (t, h, w) position ids per token."""
    rcfg, rparams, cfg, model = _models("qwen2-vl-7b")
    _, embeds = _inputs(cfg)
    pos3 = np.random.RandomState(3).randint(0, 40, (B, S, 3)).astype(np.int32)
    r_logits, _, _ = RLM.forward(rparams, rcfg, embeds=jnp.asarray(embeds),
                                 positions=jnp.asarray(pos3))
    logits, _, _ = model.forward(embeds=torch.from_numpy(embeds),
                                 positions=torch.from_numpy(pos3))
    _close(logits, r_logits)


def test_mrope_prefill_and_embed_decode_match_the_reference():
    """qwen2-vl: ``prefill(embeds, positions)`` with an image grid at
    distinct (t, h, w) ids, then 4 ``decode_step(embed=)`` steps at the
    cache position on all three axes, against the reference's
    ``lm.prefill`` and ``lm.decode_step`` on the same inputs: logits and
    every cache tensor within TOL."""
    rcfg, rparams, cfg, model = _models("qwen2-vl-7b")
    _, embeds = _inputs(cfg)
    p = S - 4
    pos3 = make_lm_golden.vision_positions(B, p, (3, 5))
    assert len({tuple(r) for r in pos3[0, :15, 1:]}) == 15 and (pos3[0, :15, 0] == 0).all()
    r_last, r_cache = RLM.prefill(rparams, rcfg, embeds=jnp.asarray(embeds[:, :p]),
                                  positions=jnp.asarray(pos3), max_len=S)
    last, cache = model.prefill(embeds=torch.from_numpy(embeds[:, :p]),
                                positions=torch.from_numpy(pos3), max_len=S)
    _close(last, r_last)
    _close_caches(cache, r_cache)
    # M-RoPE's ids reach the cache: at (t, t, t) its keys differ
    _, flat = model.prefill(embeds=torch.from_numpy(embeds[:, :p]),
                            positions=torch.from_numpy(pos3[..., :1].repeat(3, axis=-1)),
                            max_len=S)
    assert float((flat["k"] - cache["k"]).abs().max()) > 1e-2
    for t in range(p, S):
        r_lg, r_cache = RLM.decode_step(rparams, rcfg, r_cache,
                                        embed=jnp.asarray(embeds[:, t:t + 1]))
        lg, cache = model.decode_step(cache, embed=torch.from_numpy(embeds[:, t:t + 1]))
        _close(lg, r_lg)
        _close_caches(cache, r_cache)


# -- attention -----------------------------------------------------------------

def _qkv(seed, b=2, sq=64, skv=64, hq=8, hkv=4, hd=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, hq, hd).astype(np.float32),
            rng.randn(b, skv, hkv, hd).astype(np.float32),
            rng.randn(b, skv, hkv, hd).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("chunks", [(16, 16), (32, 64), (64, 32)])
def test_chunked_equals_direct_and_the_reference(window, chunks):
    q, k, v = _qkv(0)
    direct = A.gqa_attention_direct(*_t(q, k, v), causal=True, window=window)
    chunked = A.gqa_attention_chunked(*_t(q, k, v), causal=True, window=window,
                                      chunk_q=chunks[0], chunk_kv=chunks[1])
    ref = RA.gqa_attention_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=True, window=window, chunk_q=chunks[0],
                                   chunk_kv=chunks[1])
    _close(chunked, ref)
    _close(direct, RA.gqa_attention_direct(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=True, window=window))
    np.testing.assert_allclose(direct.numpy(), chunked.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sq,skv,chunked", [(1024, 1024, False), (1280, 1024, True)])
def test_dispatch_threshold_is_the_references(sq, skv, chunked, monkeypatch):
    """Direct while Sq·Skv <= 1024², chunked beyond."""
    q, k, v = _qkv(5, b=1, sq=sq, skv=skv, hq=2, hkv=1, hd=8)
    calls = []
    real = A.gqa_attention_chunked
    monkeypatch.setattr(A, "gqa_attention_chunked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = A.gqa_attention(*_t(q, k, v), causal=True, window=64)
    assert bool(calls) is chunked
    ref = RA.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                           window=64)
    _close(out, ref)


def test_decode_ring_equals_windowed_decode_and_the_reference():
    b, t, hkv, hd, hq, w = 1, 12, 2, 8, 4, 4
    rng = np.random.RandomState(3)
    q = rng.randn(b, 1, hq, hd).astype(np.float32)
    k = rng.randn(b, t, hkv, hd).astype(np.float32)
    v = rng.randn(b, t, hkv, hd).astype(np.float32)
    pos = 9
    full = A.decode_attention(*_t(q, k, v), pos, window=w)
    ring_k, ring_v = np.zeros((b, w, hkv, hd), np.float32), np.zeros((b, w, hkv, hd), np.float32)
    for tok in range(pos - w + 1, pos + 1):
        ring_k[:, tok % w], ring_v[:, tok % w] = k[:, tok], v[:, tok]
    ring = A.decode_attention(*_t(q, ring_k, ring_v), pos, ring=True)
    np.testing.assert_allclose(full.numpy(), ring.numpy(), rtol=2e-5, atol=2e-5)
    _close(ring, RA.decode_attention(jnp.asarray(q), jnp.asarray(ring_k), jnp.asarray(ring_v),
                                     jnp.asarray(pos), ring=True))
    _close(full, RA.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(pos), window=w))


@pytest.mark.parametrize("head_dim", [16, 128])
def test_mrope_reduces_to_rope_and_matches_the_reference(head_dim):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 10, 3, head_dim).astype(np.float32)
    pos = np.tile(np.arange(10, dtype=np.int32) * 37, (2, 1))
    pos3 = np.repeat(pos[..., None], 3, axis=-1)
    rope = R.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    mrope = R.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 10_000.0)
    np.testing.assert_array_equal(rope.numpy(), mrope.numpy())
    _close(rope, RR.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    mixed = rng.randint(0, 500, (2, 10, 3)).astype(np.int32)
    _close(R.apply_mrope(torch.from_numpy(x), torch.from_numpy(mixed), 10_000.0),
           RR.apply_mrope(jnp.asarray(x), jnp.asarray(mixed), 10_000.0))
    if head_dim == 128:
        assert R.mrope_sections(64) == (16, 24, 24)


# -- the engine ----------------------------------------------------------------

def _requests(cls, vocab, n=5, new=6, temperature=0.0):
    rng = np.random.RandomState(7)
    return [cls(uid=i, prompt=rng.randint(0, vocab, rng.randint(5, 11)).astype(np.int32),
                max_new_tokens=new, temperature=temperature) for i in range(n)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_engine_greedy_tokens_equal_the_references(arch):
    """Batches of 3 with prompts of 5-10 tokens (the remainder replayed
    through decode).  Every step's top-2 logit margin in the reference is
    more than 10 × TOL, so an equal token is no tie."""
    rcfg, rparams, cfg, params = _trees(arch)
    margins = []
    ref = RefEngine(rcfg, rparams, batch_size=3, max_len=32)
    sample = ref._sample

    def recording(logits, temps):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        margins.extend(top2[:, 1] - top2[:, 0])
        return sample(logits, temps)

    ref._sample = recording
    want = ref.run(_requests(RefRequest, cfg.vocab))
    got = Engine(cfg, params, batch_size=3, max_len=32, device="cpu").run(
        _requests(Request, cfg.vocab))
    assert min(margins) > 10 * TOL, min(margins)
    assert [r.output for r in got] == [r.output for r in want]
    assert all(r.done and len(r.output) == 6 for r in got)


def test_engine_equals_a_hand_made_chain():
    """One batch of equal-length prompts: the engine's greedy tokens are
    the argmax chain of `prefill` and `decode_step`."""
    _, _, cfg, params = _trees("minitron-8b")
    rng = np.random.RandomState(2)
    prompts = rng.randint(0, cfg.vocab, (3, 9)).astype(np.int32)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=7) for i, p in enumerate(prompts)]
    engine = Engine(cfg, params, batch_size=3, max_len=20, device="cpu")
    engine.run(reqs)
    model = CausalLM(cfg, params, device="cpu")
    logits, cache = model.prefill(tokens=torch.from_numpy(prompts), max_len=20)
    chain = []
    for _ in range(7):
        tok = torch.argmax(logits, dim=-1)
        chain.append(tok.numpy())
        logits, cache = model.decode_step(cache, token=tok[:, None])
    assert [r.output for r in reqs] == np.stack(chain, axis=1).tolist()


def test_temperature_zero_is_greedy_and_a_seeded_temperature_run_reproduces():
    _, _, cfg, params = _trees("llama3-405b")
    greedy = Engine(cfg, params, batch_size=2, max_len=32, device="cpu").run(
        _requests(Request, cfg.vocab))
    runs = [Engine(cfg, params, batch_size=2, max_len=32, seed=s, device="cpu").run(
        _requests(Request, cfg.vocab, temperature=t)) for s, t in ((3, 0.0), (5, 1.5), (5, 1.5))]
    assert [r.output for r in runs[0]] == [r.output for r in greedy]
    assert [r.output for r in runs[1]] == [r.output for r in runs[2]]
    assert [r.output for r in runs[1]] != [r.output for r in greedy]
    assert all(0 <= t < cfg.vocab for r in runs[1] for t in r.output)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parameter_count_equals_the_references_and_the_formula(arch):
    """The port's tree has the reference's leaves and shapes; ``n_params()``
    is within the reference test's 3 % of the count; the formulas equal the
    reference's at smoke and full size."""
    rcfg, rparams, cfg, model = _models(arch)
    ref_count = sum(x.size for x in jax.tree.leaves(rparams))
    count = sum(p.numel() for p in model.parameters())
    assert count == ref_count
    assert jax.tree.map(np.shape, rparams) == param_shapes(cfg)
    assert abs(count - cfg.n_params()) / count < 0.03
    assert cfg.n_params() == rcfg.n_params() and cfg.active_params() == rcfg.active_params()
    full, ref_full = get_config(arch), ref_get_config(arch)
    assert full.n_params() == ref_full.n_params()
    assert full.active_params() == ref_full.active_params()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_trees_keep_the_references_dtypes(arch):
    """In bfloat16 the reference keeps the router, the RWKV decay and
    bonus leaves and the Mamba A and dt bias in float32: a random start
    has the reference's dtype at every leaf, `params_from_reference`
    carries the reference's bf16 tree, and refuses a leaf of another
    dtype."""
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="bfloat16")
    rcfg = dataclasses.replace(ref_get_config(arch).smoke(), dtype="bfloat16")
    rtree = jax.tree.map(np.asarray, RLM.init_params(jax.random.key(0), rcfg))
    mine = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for name, leaf in rtree["blocks"].items():
        assert mine["blocks"][name].dtype == param_dtype(cfg, name), name
        assert str(mine["blocks"][name].dtype).removeprefix("torch.") == leaf.dtype.name, name
    carried = params_from_reference(rtree, cfg, "cpu")
    assert carried["blocks"]["ln1"].dtype == torch.bfloat16
    f32 = [n for n in rtree["blocks"] if param_dtype(cfg, n) == torch.float32]
    assert bool(f32) == (arch in ("granite-moe-1b-a400m", "arctic-480b", "rwkv6-7b",
                                  "hymba-1.5b"))
    if f32:
        leaf = rtree["blocks"][f32[0]].astype(rtree["blocks"]["ln1"].dtype)
        bad = {**rtree, "blocks": {**rtree["blocks"], f32[0]: leaf}}
        with pytest.raises(ValueError, match=f32[0]):
            params_from_reference(bad, cfg, "cpu")


def test_a_random_start_has_the_references_layout():
    cfg = get_config("starcoder2-7b").smoke()
    g = torch.Generator().manual_seed(0)
    params = init_params(g, cfg, "cpu")
    again = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert torch.equal(params["blocks"]["wq"], again["blocks"]["wq"])
    model = CausalLM(cfg, params, device="cpu")
    logits, _, _ = model.forward(tokens=torch.zeros((1, 5), dtype=torch.int32))
    assert logits.shape == (1, 5, cfg.vocab) and bool(torch.isfinite(logits).all())
    assert "wg_f" not in params["blocks"]  # gelu: no gate matrix


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("minitron-8b").smoke()
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(NoCudaDeviceError):
        CausalLM(cfg, params)
    with pytest.raises(NoCudaDeviceError):
        Engine(cfg, params)
    with pytest.raises(NoCudaDeviceError):
        init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NoCudaDeviceError):
        params_from_reference(jax.tree.map(np.asarray, RLM.init_params(
            jax.random.key(0), ref_get_config("minitron-8b").smoke())), cfg)
    with pytest.raises(NoCudaDeviceError):
        serve.main(["--arch", "minitron-8b", "--smoke"])
    assert serve.main(["--arch", "minitron-8b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--new-tokens", "2"]) == 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_the_serve_launcher_runs_every_arch_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                       "--new-tokens", "2"]) == 0
    assert "'device': 'cpu'" in capsys.readouterr().out


# -- the committed fixtures ----------------------------------------------------

@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_the_fixture_is_what_its_script_writes(name):
    fx = FIXTURES[name]
    golden = dict(np.load(fx.path))
    built = make_lm_golden.build(fx)
    assert sorted(built) == sorted(golden)
    for k, v in built.items():
        if k.startswith("param/") or k in ("prompt", "tokens"):
            np.testing.assert_array_equal(v, golden[k], err_msg=k)
        else:
            np.testing.assert_allclose(v, golden[k], rtol=0, atol=1e-6, err_msg=k)
    assert os.path.getsize(fx.path) < 1 << 20


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_the_port_reproduces_the_fixture(name, monkeypatch):
    """Greedy tokens equal, logits within TOL; granite-moe's decode steps
    drop pairs (one slot per expert), rwkv6's prompt pads, hymba's ring
    wraps; the frontends prefill from embeddings (qwen2-vl's at distinct
    M-RoPE ids) and decode each greedy token's embedding row."""
    fx = FIXTURES[name]
    golden = dict(np.load(fx.path))
    cfg = fx.config(get_config)
    model = CausalLM(cfg, params_from_reference(make_lm_golden.param_tree(golden), cfg, "cpu"),
                     device="cpu")
    dropped = []
    real = moe.route

    def counting(*args):
        plan = real(*args)
        dropped.append(int((~plan.kept).sum()))
        return plan

    monkeypatch.setattr(moe, "route", counting)
    inputs = {k: torch.from_numpy(v) for k, v in make_lm_golden.prefill_inputs(golden).items()}
    assert ("embeds" in inputs) == (cfg.frontend is not None)
    assert ("positions" in inputs) == (cfg.rope_kind == "mrope")
    if "positions" in inputs:
        assert (inputs["positions"][..., 1] != inputs["positions"][..., 2]).any()
    logits, cache = model.prefill(**inputs, max_len=fx.prompt + make_lm_golden.NEW)
    _close(logits, golden["prefill_logits"])
    n_prefill = len(dropped)
    tokens = []
    for i in range(make_lm_golden.NEW):
        tok = torch.argmax(logits, dim=-1)
        tokens.append(tok.numpy())
        logits, cache = model.decode_step(
            cache, **make_lm_golden.decode_input(cfg.frontend, model.embed, tok))
        _close(logits, golden["decode_logits"][:, i])
    np.testing.assert_array_equal(np.stack(tokens, axis=1), golden["tokens"])
    if cfg.moe is not None:
        assert sum(dropped[n_prefill:]) > 0
    if cfg.block_kind == "rwkv":
        assert fx.prompt % 16
    if cfg.block_kind == "hybrid":
        assert fx.prompt > cache["k"].shape[2] == cfg.window
