"""hymba's prefill and decode on a mesh (`models.lm.CausalLM(..., mesh=)`,
the hybrid's split paths) on 2 × 4 gloo ranks of the CPU.

The weights are the reference's smoke draw, carried across by
`models/convert.py`.  A prompt of 20 tokens, past the smoke window of 16,
so that the sliding rings wrap, is prefilled into a cache of 32 and
decoded greedily for 8 steps:

  * ``test_hymba_mesh_decode_matches_the_reference``: the prefill logits
    and each decode step's logits within ``HYBRID_ATOL`` of the
    reference's ``lm.prefill``/``lm.decode_step`` under its 2 × 4 mesh of
    8 fake devices (``jit`` with the reference's parameter and cache
    shardings), and the tokens equal to the port's one-process decode;
  * ``test_hymba_mesh_cache_layout``: the rank's cache blocks are
    `cache_specs`' layout: the rings whole, ``gk``/``gv`` split along the
    sequence over tp (8 of 32 slots a rank), ``m_h`` and ``m_conv`` split
    by channel over tp (32 of 128), the batch over the 2 data shards;
  * ``test_a_misplaced_mamba_state_exceeds_the_limit``: the planted fault
    (each rank's Mamba state block replaced by the next tp rank's after
    the prefill, then the clean run's tokens fed) moves the logits by more
    than ``HYBRID_ATOL`` from one process's.

``HYBRID_ATOL`` is the other mesh decode tests' ``DECODE_ATOL``
(`tests/test_torch_mesh.py`): the mesh sums the global layers' softmax
and the Mamba mixer's two channel-reducing products over tp, in another
order than one process.  The gaps read 9.5e-7 against the reference's
mesh and 6.3e-7 against one process; the fault's 5.8e-3.
"""
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import lm as RLM
from repro_torch.configs import get_config
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models.convert import params_from_reference
from repro_torch.models.lm import CausalLM
from tests.conftest import run_multidevice

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
ARCH = "hymba-1.5b"
B, PROMPT, MAX_LEN, STEPS = 8, 20, 32, 8
HYBRID_ATOL = 1e-5
TIMEOUT_S = 300

REF_DECODE = """
import json, jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import make_host_mesh
from repro.models import lm
from repro.sharding.params import batch_specs, param_specs, tree_shardings
from repro.sharding.specs import MeshAxes, use_mesh_axes
mesh = make_host_mesh(data=2, model=4)
axes = MeshAxes.for_mesh(mesh)
cfg = get_config(%r).smoke()
prompt, max_len, steps = np.asarray(%r, np.int32), %d, %d
params = lm.init_params(jax.random.key(1), cfg)
psh = tree_shardings(mesh, params, param_specs(cfg, axes))
bsh = tree_shardings(mesh, {"tokens": prompt},
                     {"tokens": batch_specs(cfg, axes, "prefill")["tokens"]})
with mesh, use_mesh_axes(mesh):
    params = jax.device_put(params, psh)
    logits, cache = jax.jit(lambda p, t: lm.prefill(p, cfg, tokens=t, max_len=max_len),
                            in_shardings=(psh, bsh["tokens"]))(params, jnp.asarray(prompt))
    csh = tree_shardings(mesh, cache, {**lm.cache_specs(cfg, axes), "pos": P()})
    cache = jax.device_put(cache, csh)
    tsh = tree_shardings(mesh, {"token": prompt[:, :1]},
                         {"token": batch_specs(cfg, axes, "decode")["token"]})["token"]
    step = jax.jit(lambda p, c, t: lm.decode_step(p, cfg, c, token=t),
                   in_shardings=(psh, csh, tsh), out_shardings=(None, csh))
    out, tokens = [np.asarray(logits).tolist()], []
    for _ in range(steps):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok).tolist())
        logits, cache = step(params, cache, tok)
        out.append(np.asarray(logits).tolist())
print("RESULT " + json.dumps({"logits": out, "tokens": tokens}))
"""


def _prompt() -> np.ndarray:
    cfg = get_config(ARCH).smoke()
    return np.random.RandomState(5).randint(0, cfg.vocab, (B, PROMPT)).astype(np.int32)


def _params() -> dict:
    rcfg, cfg = ref_get_config(ARCH).smoke(), get_config(ARCH).smoke()
    tree = jax.tree.map(np.asarray, RLM.init_params(jax.random.key(1), rcfg))
    return params_from_reference(tree, cfg, "cpu")


def _one_process(params) -> tuple:
    model = CausalLM(get_config(ARCH).smoke(), params, device="cpu")
    logits, cache = model.prefill(torch.as_tensor(_prompt()), max_len=MAX_LEN)
    steps, tokens = [logits.numpy()], []
    for _ in range(STEPS):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        tokens.append(tok.numpy())
        logits, cache = model.decode_step(cache, tok)
        steps.append(logits.numpy())
    return np.stack(steps), np.concatenate(tokens, 1)


@pytest.fixture(scope="module")
def launched():
    params = _params()
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join([TESTS_DIR] + ([saved] if saved else []))
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            ref = pool.submit(run_multidevice, REF_DECODE % (ARCH, _prompt().tolist(), MAX_LEN,
                                                             STEPS), 8, TIMEOUT_S)
            ranks = pool.submit(spawn_ranks, "torch_dryrun_ranks:hymba_rank",
                                {"params": params, "prompt": _prompt(), "max_len": MAX_LEN,
                                 "steps": STEPS}, 8, device="cpu", timeout_s=TIMEOUT_S)
            one = _one_process(params)
            out = {"ref": json.loads(ref.result().split("RESULT ", 1)[1]),
                   "ranks": ranks.result(), "one": one}
    finally:
        if saved is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = saved
    return out


def test_hymba_mesh_decode_matches_the_reference(launched):
    r0 = launched["ranks"][0]
    ref_logits = np.asarray(launched["ref"]["logits"], np.float32)
    assert r0["logits"].shape == ref_logits.shape == (STEPS + 1, B, get_config(ARCH).smoke().vocab)
    np.testing.assert_allclose(r0["logits"], ref_logits, rtol=0, atol=HYBRID_ATOL)
    one_logits, one_tokens = launched["one"]
    np.testing.assert_array_equal(r0["tokens"], one_tokens)
    np.testing.assert_array_equal(np.concatenate(launched["ref"]["tokens"], 1), one_tokens)
    np.testing.assert_allclose(r0["logits"], one_logits, rtol=0, atol=HYBRID_ATOL)
    print(f"hymba mesh against the reference's mesh {np.abs(r0['logits'] - ref_logits).max():.3e}, "
          f"against one process {np.abs(r0['logits'] - one_logits).max():.3e}")
    for r in launched["ranks"][1:]:
        np.testing.assert_array_equal(r["tokens"], r0["tokens"])
        np.testing.assert_array_equal(r["logits"], r0["logits"])


def test_hymba_mesh_cache_layout(launched):
    cfg = get_config(ARCH).smoke()
    di = cfg.ssm.expand * cfg.d_model
    for r in launched["ranks"]:
        s = r["cache_shapes"]
        assert s["k"] == s["v"] == (cfg.n_layers, B // 2, cfg.window, cfg.n_kv_heads,
                                    cfg.head_dim)
        assert s["gk"] == s["gv"] == (len(cfg.global_layers), B // 2, MAX_LEN // 4,
                                      cfg.n_kv_heads, cfg.head_dim)
        assert s["m_h"] == (cfg.n_layers, B // 2, di // 4, cfg.ssm.state_dim)
        assert s["m_conv"] == (cfg.n_layers, B // 2, cfg.ssm.conv_dim - 1, di // 4)
        assert r["t"] == MAX_LEN
    assert PROMPT > cfg.window   # the rings wrapped in the prefill


def test_a_misplaced_mamba_state_exceeds_the_limit(launched):
    one_logits, _ = launched["one"]
    r0 = launched["ranks"][0]
    # the prefill is untouched; every decode step reads the misplaced state
    np.testing.assert_array_equal(r0["fault_logits"][0], r0["logits"][0])
    gap = float(np.abs(r0["fault_logits"][1:] - one_logits[1:]).max())
    print(f"the misplaced Mamba state moves the logits by {gap:.3e}")
    assert gap > HYBRID_ATOL, gap
