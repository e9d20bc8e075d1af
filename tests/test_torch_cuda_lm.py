"""The LM serving path on the card, at smoke size.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the test, never at import).  This file imports neither JAX nor the
reference package, so it runs where only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_lm.py

  * `CausalLM`, `Engine` and `init_params` default to the card, and every
    parameter lives there (the float32 leaves of the experts and SSM
    blocks in float32);
  * at the same batch the engine's greedy tokens equal a hand-made
    prefill + decode argmax chain, in bfloat16, for minitron, the four
    expert and SSM archs, stablelm, llama3 and both embedding frontends;
  * the frontends' path: ``prefill(embeds=, positions=)`` (qwen2-vl's at
    distinct M-RoPE ids) then ``decode_step(embed=)`` decodes as `forward`
    over the whole sequence computes, in float32;
  * a prompt long enough for the chunked prefill (starcoder2's smoke
    window wrapped many times) decodes as `forward` computes, in float32;
  * the router's top k on the card breaks planted ties as on the CPU (to
    the lower expert id) and drops the same pairs;
  * each committed reference fixture (`tests/torch_golden/lm_*_smoke.npz`,
    the frontends' from embeddings) in float32: the same greedy tokens,
    logits within 1e-5.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import moe
from repro_torch.models.common import MoEConfig
from repro_torch.models.convert import init_params, param_dtype, params_from_reference
from repro_torch.models.lm import CausalLM
from repro_torch.serve.engine import Engine, Request

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_golden"))
import make_lm_golden  # noqa: E402  (numpy only until its build() runs)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _chain(model, prompts, steps, max_len):
    """Prefill ``prompts`` (token ids, or the prefill's inputs as a dict),
    then greedy decode steps: a frontend feeds each token's embedding row."""
    inputs = prompts if isinstance(prompts, dict) else {"tokens": prompts}
    logits, cache = model.prefill(**inputs, max_len=max_len)
    toks, seen = [], [logits]
    for i in range(steps):
        tok = torch.argmax(logits.float(), dim=-1)
        toks.append(tok)
        if i + 1 < steps:
            logits, cache = model.decode_step(
                cache, **make_lm_golden.decode_input(model.cfg.frontend, model.embed, tok))
            seen.append(logits)
    return torch.stack(toks, 1).cpu().numpy(), seen


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minitron-8b", "granite-moe-1b-a400m", "arctic-480b",
                                  "rwkv6-7b", "hymba-1.5b", "stablelm-12b", "llama3-405b",
                                  "qwen2-vl-7b", "musicgen-medium"])
def test_the_engine_on_the_card_equals_a_hand_made_chain_in_bf16(arch):
    _card()
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="bfloat16")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    model = CausalLM(cfg, params)
    assert model.device.type == "cuda"
    assert all(p.device.type == "cuda" for p in model.parameters())
    assert all(v.dtype == param_dtype(cfg, k) for k, v in model.blocks.items())
    prompts = np.random.RandomState(1).randint(0, cfg.vocab, (4, 20)).astype(np.int32)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=10) for i, p in enumerate(prompts)]
    Engine(cfg, params, batch_size=4, max_len=40).run(reqs)
    chain, _ = _chain(model, torch.as_tensor(prompts, device="cuda"), 10, 40)
    assert [r.output for r in reqs] == chain.tolist()


@pytest.mark.cuda
def test_a_chunked_prefill_on_the_card_decodes_as_forward_computes():
    _card()
    cfg = get_config("starcoder2-7b").smoke()          # window 16: the ring wraps
    model = CausalLM(cfg, init_params(torch.Generator(device="cuda").manual_seed(2), cfg))
    prompt = torch.as_tensor(np.random.RandomState(2).randint(0, cfg.vocab, (1, 1536)),
                             device="cuda")            # 1536² > 1024²: chunked, 6 × 3 blocks
    calls = []
    real = A.gqa_attention_chunked
    A.gqa_attention_chunked = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        toks, logits = _chain(model, prompt, 5, 1541)
    finally:
        A.gqa_attention_chunked = real
    assert len(calls) == cfg.n_layers
    seq = torch.cat([prompt, torch.as_tensor(toks[:, :4], device="cuda")], dim=1)
    full, _, _ = model.forward(tokens=seq)
    got = torch.stack([lg[0] for lg in logits])
    assert float((got - full[0, 1535:]).abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "musicgen-medium"])
def test_the_frontend_prefill_and_embed_decode_on_the_card_match_forward(arch):
    """Seeded embeddings made on the card, qwen2-vl's prompt at an image
    grid's distinct (t, h, w) ids; 6 decode steps feed the greedy tokens'
    embedding rows at the cache position (on all three M-RoPE axes); the
    logits of every step within 1e-4 of `forward` over the whole
    sequence, in float32."""
    _card()
    cfg = get_config(arch).smoke()
    model = CausalLM(cfg, init_params(torch.Generator(device="cuda").manual_seed(3), cfg))
    g = torch.Generator(device="cuda").manual_seed(4)
    s, steps = 20, 6
    inputs = {"embeds": torch.randn((2, s, cfg.d_model), generator=g, device="cuda")}
    if cfg.rope_kind == "mrope":
        inputs["positions"] = torch.as_tensor(make_lm_golden.vision_positions(2, s, (3, 4)),
                                              device="cuda")
    toks, logits = _chain(model, inputs, steps, s + steps)
    fed = model.embed[torch.as_tensor(toks[:, :steps - 1], device="cuda")]
    seq = {"embeds": torch.cat([inputs["embeds"], fed], dim=1)}
    if "positions" in inputs:
        later = torch.arange(s, s + steps - 1, dtype=torch.int32, device="cuda")
        seq["positions"] = torch.cat([inputs["positions"],
                                      later[None, :, None].expand(2, steps - 1, 3)], dim=1)
    full, _, _ = model.forward(**seq)
    got = torch.stack(logits, 1)
    assert float((got - full[:, s - 1:]).abs().max()) < 1e-4


@pytest.mark.cuda
def test_the_router_breaks_ties_and_drops_as_on_the_cpu():
    _card()
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(64, 16), dtype=torch.float32)
    router = torch.as_tensor(rng.randn(16, 8) * 0.5, dtype=torch.float32)
    router[:, [1, 3, 6]] = 0      # logits exactly 0 on any device: a tie of three
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=8, capacity_factor=0.5)
    cpu = moe.route(x, router, cfg)
    card = moe.route(x.cuda(), router.cuda(), cfg)
    assert torch.equal(card.flat_e.cpu(), cpu.flat_e) and torch.equal(card.rank.cpu(), cpu.rank)
    assert int((~cpu.kept).sum()) > 0
    assert torch.equal(moe.dispatch(x.cuda(), card).cpu(), moe.dispatch(x, cpu))


@pytest.mark.cuda
@pytest.mark.parametrize("fx", make_lm_golden.FIXTURES, ids=lambda fx: fx.name)
def test_the_reference_fixture_on_the_card(fx):
    _card()
    arrays = np.load(fx.path)
    cfg = fx.config(get_config)
    model = CausalLM(cfg, params_from_reference(make_lm_golden.param_tree(arrays), cfg))
    n_new = arrays["tokens"].shape[1]
    toks, logits = _chain(model, {k: torch.as_tensor(v, device="cuda") for k, v in
                                  make_lm_golden.prefill_inputs(arrays).items()},
                          n_new, fx.prompt + n_new)
    np.testing.assert_array_equal(toks, arrays["tokens"])
    want = np.concatenate([arrays["prefill_logits"][:, None],
                           arrays["decode_logits"][:, :n_new - 1]], axis=1)
    got = torch.stack(logits, 1).cpu().numpy()
    assert float(np.abs(got - want).max()) <= 1e-5
