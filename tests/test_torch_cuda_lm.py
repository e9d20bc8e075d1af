"""The attention-only LM serving path on the card, at smoke size.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the test, never at import).  This file imports neither JAX nor the
reference package, so it runs where only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_lm.py

  * `CausalLM`, `Engine` and `init_params` default to the card, and every
    parameter lives there;
  * at the same batch the engine's greedy tokens equal a hand-made
    prefill + decode argmax chain, in bfloat16;
  * a prompt long enough for the chunked prefill (starcoder2's smoke
    window wrapped many times) decodes as `forward` computes, in float32;
  * the committed reference fixture (`tests/torch_golden/lm_minitron_smoke.npz`)
    in float32: the same greedy tokens, logits within 1e-5.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models.convert import init_params, params_from_reference
from repro_torch.models.lm import CausalLM
from repro_torch.serve.engine import Engine, Request

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_golden"))
import make_lm_golden  # noqa: E402  (numpy only until its build() runs)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _chain(model, prompts, steps, max_len):
    logits, cache = model.prefill(tokens=prompts, max_len=max_len)
    toks, seen = [], [logits]
    for i in range(steps):
        tok = torch.argmax(logits.float(), dim=-1)
        toks.append(tok)
        if i + 1 < steps:
            logits, cache = model.decode_step(cache, token=tok[:, None])
            seen.append(logits)
    return torch.stack(toks, 1).cpu().numpy(), seen


@pytest.mark.cuda
def test_the_engine_on_the_card_equals_a_hand_made_chain_in_bf16():
    _card()
    cfg = dataclasses.replace(get_config("minitron-8b").smoke(), dtype="bfloat16")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    model = CausalLM(cfg, params)
    assert model.device.type == "cuda"
    assert all(p.device.type == "cuda" and p.dtype == torch.bfloat16 for p in model.parameters())
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
def test_the_reference_fixture_on_the_card():
    _card()
    arrays = np.load(make_lm_golden.PATH)
    cfg = get_config(make_lm_golden.ARCH).smoke()
    model = CausalLM(cfg, params_from_reference(make_lm_golden.param_tree(arrays), cfg))
    n_new = arrays["tokens"].shape[1]
    toks, logits = _chain(model, torch.as_tensor(arrays["prompt"], device="cuda"), n_new,
                          arrays["prompt"].shape[1] + n_new)
    np.testing.assert_array_equal(toks, arrays["tokens"])
    want = np.concatenate([arrays["prefill_logits"][:, None],
                           arrays["decode_logits"][:, :n_new - 1]], axis=1)
    got = torch.stack(logits, 1).cpu().numpy()
    assert float(np.abs(got - want).max()) <= 1e-5
