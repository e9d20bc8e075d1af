"""Sharded training and decode on the card, at smoke size.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the test, never at import).  This file imports neither JAX nor the
reference package, so it runs where only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_sharding.py

Four gloo ranks share the card as a 2 × 2 mesh (`chip_smoke.py`'s
``sharded`` phase, case (a), at smoke width): three sharded AdamW steps of
granite-moe and minitron smoke, then a prefill and 8 greedy decode steps
on the mesh, against the same 4-rank program on the CPU from one start
and batch: the losses within ``CARD_TOL["loss_rel"]``, every parameter
within ``CARD_TOL["param_atol"]`` (the single-device card tests' limits,
`tests/test_torch_cuda_train.py`), the decode tokens equal and the logits
within ``DECODE_ATOL``; every rank's local state on the card in its fitted
block's shape.
"""
import contextlib
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models.convert import init_params
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import make_train_state

# the rank programs' module, imported by each rank from this directory
RANKS = "torch_mesh_ranks"
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
CARD_TOL = {"loss_rel": 1e-5, "param_atol": 6e-3}   # tests/test_torch_cuda_train.py
DECODE_ATOL = 1e-4
ARCHS = ("granite-moe-1b-a400m", "minitron-8b")
B, S, PROMPT, MAX_LEN = 8, 32, 12, 24


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _payload() -> dict:
    train, decode = {}, {}
    rng = np.random.RandomState(0)
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch).smoke(), remat="full")
        opt = OptConfig(lr=1e-3)
        train[arch] = {"arch": arch, "kind": "adamw", "mb": 1, "steps": 3,
                       "state": make_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                                 "cpu"),
                       "batch": {"tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32),
                                 "labels": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)}}
        decode[arch] = {"arch": arch, "params": init_params(torch.Generator().manual_seed(1),
                                                            cfg, "cpu"),
                        "prompt": rng.randint(0, cfg.vocab, (B, PROMPT)).astype(np.int32),
                        "max_len": MAX_LEN, "steps": 8}
    return {"mesh": (2, 2), "train": train, "decode": decode}


@contextlib.contextmanager
def _ranks_on_path():
    """The ranks' ``PYTHONPATH`` with this directory on it, for `RANKS`."""
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join([TESTS_DIR] + ([saved] if saved else []))
    try:
        yield
    finally:
        if saved is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = saved


@pytest.fixture(scope="module")
def runs():
    _card()
    payload = _payload()
    with _ranks_on_path(), ThreadPoolExecutor(max_workers=2) as pool:
        card = pool.submit(spawn_ranks, RANKS + ":mesh_rank", payload, 4,
                           device="cuda", timeout_s=600)
        cpu = pool.submit(spawn_ranks, RANKS + ":mesh_rank", payload, 4,
                          device="cpu", timeout_s=600)
        return card.result(), cpu.result()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_on_the_card_equal_the_cpus(runs, arch):
    _card()
    card, cpu = runs
    got, want = card[0]["train"][arch], cpu[0]["train"][arch]
    assert all(r["train"][arch]["shapes_ok"] for r in card)
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= CARD_TOL["loss_rel"] * abs(b), (got["losses"], want["losses"])

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v for k in sorted(tree) for k2, v in leaves(tree[k], prefix + k + "/").items()}
        return {prefix: tree}

    g, w = leaves(got["params"]), leaves(want["params"])
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=CARD_TOL["param_atol"], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_the_mesh_on_the_card_equals_the_cpus(runs, arch):
    _card()
    card, cpu = runs
    got, want = card[0]["decode"][arch], cpu[0]["decode"][arch]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=DECODE_ATOL)
    assert got["cache_shapes"]["k"][2] == MAX_LEN // 2   # the sequence over tp = 2
    for r in card[1:]:
        np.testing.assert_array_equal(r["decode"][arch]["tokens"], got["tokens"])
    assert all(k.endswith(":gloo-host") for k in card[0]["stats"])
