"""The port's sharded training and decode on gloo ranks of the CPU against
the reference's sharded programs on fake host devices.

  * ``test_sharded_moe_matches_reference`` (2 × 4 ranks): `moe_ffn_sharded`
    at capacity 4.0 within 1e-5 of the port's `moe_ffn`; at capacity 1.0,
    dropping pairs, within 1e-5 of the reference's ``moe_ffn_sharded`` on 8
    fake devices and of `moe_ffn_sharded_plain`, with the dropped pairs
    equal (the reference's counted per data shard);
  * ``test_minimesh_train_and_decode_lower_compile``, run rather than only
    compiled: three sharded train steps of granite-moe, rwkv6 and minitron
    smoke on 2 × 4 ranks at 1 and 2 microbatches, granite and minitron on
    a batch of 1 (which the data shards do not divide: it runs whole on
    every rank, and granite's experts take the reference's sharded branch
    on the rank's block of its tokens), and granite under adam8bit (its
    embedding's 64-wide block straddles the two data shards), from the
    reference's start on its batch: the losses and every
    parameter leaf against the reference's sharded step on 8 fake devices
    (``jit`` with ``train_state_specs`` shardings and ``grad_shardings``),
    within a relative L2 of ``TRAIN_REL`` per leaf, each rank's local
    shapes the fitted blocks; then a prefill and 8 greedy decode steps on
    the mesh (the cache's sequence split over tp, RWKV's heads split over
    tp), the tokens equal to one process's and the logits within 1e-5;
  * ``test_decode_of_a_batch_of_one_on_the_mesh``: the same decode for a
    batch of 1, held whole on every rank (granite's decode steps take
    `moe_ffn` with every expert: one token does not split over fsdp);
  * ``test_elastic_restore_multidevice``: a checkpoint the port saves on
    2 × 4 (adam8bit: float32, int8 and scale leaves) restored on 2 × 2
    bitwise, one the reference saves on its 2 × 4 fake mesh restored by
    the port on 2 × 2 bitwise, and the port's read by the reference's
    ``restore``;
  * ``test_compressed_psum_multidevice`` (4 ranks): `Compressor.compress`
    over a gloo group within the reference's bound;
  * the collectives over two mesh axes (a 2 × 2 × 2 pod mesh) in block
    order.

Limits.  The adamw cases hold every leaf to ``TRAIN_REL = 1e-5``, but for
rwkv6 (`WIDENED`), whose leaves are held, where the port's own
single-process step from the same start on the same batch is already
further than half that from the reference's sharded step, to twice that
gap and never more than ``WIDENED_CEIL = 9e-4`` (twice the largest mesh
gap measured, 4.47e-4 on ``u`` at 1 microbatch; the widened limits read
up to 9.9e-4 before the ceiling).  rwkv6's smoke model amplifies rounding
through its training dynamics (``u``'s gradient dominates the norm; step
2's norm is about 80 at lr 1e-3), so two programs that group their sums
differently part by more than 1e-5 after three steps, sharded or not.
``test_widened_gaps_are_rounding`` reads the witnesses: the reference's
own single-device step parts from its sharded step by more than 1e-5 (1.68e-4 at
1 microbatch, 7.66e-5 at 2; it must exceed ``REF_SELF_GAP_MIN``), and in
float64 the port's mesh steps equal its single-process steps within
``F64_REL`` (1.2e-13 measured).  granite-moe and minitron are held to
1e-5.  The adam8bit case is held to
``STEP_ATOL_ADAM8``, the single-device tests' limit
(`tests/test_torch_train.py`: a moment that rounds to the next int8 level
moves an element's update by up to lr/2), and
``test_sharded_adam8bit_update_is_the_whole_update`` holds its update on
straddling blocks bitwise to the unsharded one.

All processes of the file start together in one module fixture (the
reference's three programs, 8 port ranks); the 2 × 2 group starts when
the checkpoints it restores are written.
"""
import contextlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import lm as RLM
from repro.models import moe as RM
from repro.models.common import MoEConfig as RefMoEConfig
from repro.train import checkpoint as RC
from repro.train import optimizer as RO
from repro.train import train_step as RT
from repro_torch.configs import get_config
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import moe
from repro_torch.models.common import MoEConfig
from repro_torch.models.convert import params_from_reference, train_state_from_reference
from repro_torch.models.lm import CausalLM
from repro_torch.train import checkpoint as ckpt
from repro_torch.sharding.params import zip_tree
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import make_train_step
from tests.conftest import run_multidevice
from tests.torch_mesh_ranks import Float64, as_float64

# the rank programs' module, imported by each rank from this directory
RANKS = "torch_mesh_ranks"
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 300.0
TRAIN_REL = 1e-5
STEP_ATOL_ADAM8 = 5e-4   # tests/test_torch_train.py
LR = 1e-3
LOSS_REL = 1e-6
DECODE_ATOL = 1e-5
ARCHS = ("granite-moe-1b-a400m", "rwkv6-7b", "minitron-8b")
B, S = 8, 32
# name → (arch, optimizer, microbatches, batch rows); a batch of 1 does not
# split over the 2 data shards and runs whole on every rank
CASES = {f"{a}/adamw/{mb}": (a, "adamw", mb, B) for a in ARCHS for mb in (1, 2)}
CASES.update({f"{a}/adamw/1/b1": (a, "adamw", 1, 1)
              for a in ("granite-moe-1b-a400m", "minitron-8b")})
CASES["granite-moe-1b-a400m/adam8bit/1"] = ("granite-moe-1b-a400m", "adam8bit", 1, B)
CKPT_CASE = "granite-moe-1b-a400m/adam8bit/1"   # the last case: its state is saved
# the archs whose limits are widened by the reference's own gap between
# its single-device and its sharded step (module doc), and the ceiling on
# a widened limit
WIDENED = ("rwkv6-7b",)
WIDENED_CEIL = 9e-4
REF_SELF_GAP_MIN = 5 * TRAIN_REL
F64_REL = 1e-10
PROMPT, MAX_LEN, DECODE_STEPS = 12, 24, 8
MOE_T, MOE_D = 64, 32
MOE_CAPS = (4.0, 1.0)

REF_TRAIN = """
import json, jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_host_mesh
from repro.sharding.params import batch_specs, train_state_specs, tree_shardings
from repro.sharding.specs import MeshAxes, use_mesh_axes
from repro.train import checkpoint as ckpt
from repro.train.optimizer import OptConfig
from repro.train.train_step import make_train_state, make_train_step
from repro.train.checkpoint import _flatten
mesh = make_host_mesh(data=2, model=4)
axes = MeshAxes.for_mesh(mesh)
arch, out, cases, lr, whole, ckpt_dir, single = %r
cfg = get_config(arch).smoke()
res = {}
for kind, mb, rows in cases:
    batch = {k: np.asarray(v, np.int32)[:rows] for k, v in whole.items()}
    opt = OptConfig(kind=kind, lr=lr)
    state = make_train_state(jax.random.key(0), cfg, opt)
    sh = tree_shardings(mesh, state, train_state_specs(cfg, axes, kind))
    bsh = tree_shardings(mesh, batch, {k: batch_specs(cfg, axes, "train")[k] for k in batch})
    step = jax.jit(make_train_step(cfg, opt, microbatches=mb, grad_shardings=sh.params),
                   in_shardings=(sh, bsh), out_shardings=(sh, None))
    start = state
    state = jax.device_put(state, sh)
    losses = []
    with mesh, use_mesh_axes(mesh):
        for i in range(3):
            state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(m["loss"]))
    name = f"{out}_{kind}_{mb}_{rows}"
    np.savez(name + ".npz", **{k: np.asarray(v) for k, v in _flatten(state.params).items()})
    res[f"{kind}/{mb}/{rows}"] = losses
    if ckpt_dir and (kind, mb, rows) == ("adamw", 1, len(whole["tokens"])):
        ckpt.save(ckpt_dir, 3, state)
    if single:
        # the same three steps on one device, with no mesh
        step = jax.jit(make_train_step(cfg, opt, microbatches=mb))
        state = start
        for i in range(3):
            state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        np.savez(name + "_single.npz",
                 **{k: np.asarray(v) for k, v in _flatten(state.params).items()})
print("RESULT " + json.dumps(res))
"""

REF_MOE = """
import json, jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_host_mesh
from repro.models.common import MoEConfig
from repro.models.moe import moe_ffn_sharded
arrays = np.load(%r)
x, router, wg, wu, wd = (jnp.asarray(arrays[k]) for k in ("x", "router", "wg", "wu", "wd"))
mesh = make_host_mesh(data=2, model=4)
cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=1.0)
with mesh:
    y, aux = jax.jit(lambda *a: moe_ffn_sharded(*a, cfg, mesh, ("data",), "model"))(
        x, router, wg, wu, wd)
# drops per (expert x data shard), the reference's routing on each shard
dropped = 0
for d in range(2):
    xd = x[d * 32:(d + 1) * 32]
    _, idx = jax.lax.top_k(jax.nn.softmax(xd @ router, axis=-1), 2)
    cap = max(int(-(-32 * 2 // 8) * cfg.capacity_factor), 1)
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=8)
    dropped += int(np.maximum(counts - cap, 0).sum())
print("RESULT " + json.dumps({"y": np.asarray(y).tolist(), "aux": float(aux),
                              "dropped": dropped}))
"""


def _batch(cfg) -> dict:
    rng = np.random.RandomState(0)
    return {"tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)}


def _ref_state(arch: str, kind: str, lr: float):
    rcfg = ref_get_config(arch).smoke()
    return jax.tree.map(np.asarray, RT.make_train_state(jax.random.key(0), rcfg,
                                                        RO.OptConfig(kind=kind, lr=lr)))


def _moe_arrays() -> list:
    rng = np.random.RandomState(3)
    return [rng.randn(MOE_T, MOE_D).astype(np.float32),
            (rng.randn(MOE_D, 8) * 0.5).astype(np.float32),
            *((rng.randn(8, MOE_D, 16) * 0.1).astype(np.float32) for _ in range(2)),
            (rng.randn(8, 16, MOE_D) * 0.1).astype(np.float32)]


def _moe_cfg(cap: float) -> dict:
    return dict(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=cap)


def _decode_params(arch: str) -> dict:
    rcfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    tree = jax.tree.map(np.asarray, RLM.init_params(jax.random.key(1), rcfg))
    return params_from_reference(tree, cfg, "cpu")


def _prompt(cfg) -> np.ndarray:
    return np.random.RandomState(5).randint(0, cfg.vocab, (B, PROMPT)).astype(np.int32)


def _payload(ckpt_dir: str) -> dict:
    train = {}
    for name, (arch, kind, mb, rows) in CASES.items():
        cfg = get_config(arch).smoke()
        state = train_state_from_reference(_ref_state(arch, kind, LR), cfg, kind, "cpu")
        train[name] = {"arch": arch, "kind": kind, "mb": mb, "lr": LR, "steps": 3,
                       "state": state,
                       "batch": {k: v[:rows] for k, v in _batch(cfg).items()}}
    train[CKPT_CASE] = train.pop(CKPT_CASE)  # last: its state is saved
    decode = {}
    for arch in ARCHS:
        params, prompt = _decode_params(arch), _prompt(get_config(arch).smoke())
        for name, rows in ((arch, B), (arch + "/b1", 1)):
            decode[name] = {"arch": arch, "params": params, "prompt": prompt[:rows],
                            "max_len": MAX_LEN, "steps": DECODE_STEPS}
    moe_cases = {str(c): {"cfg": _moe_cfg(c), "arrays": _moe_arrays()} for c in MOE_CAPS}
    # the widened archs' first case again in float64 (`test_widened_gaps_are_rounding`)
    f64 = {a: train[f"{a}/adamw/1"] for a in WIDENED}
    return {"mesh": (2, 4), "train": train, "train_f64": f64, "decode": decode, "moe": moe_cases,
            "adam8": True, "ckpt_dir": ckpt_dir}


def _ref_train(arch: str, out: str, ckpt_dir: str) -> dict:
    cases = [(k, mb, rows) for a, k, mb, rows in CASES.values() if a == arch]
    script = REF_TRAIN % ((arch, out, cases, LR,
                           {k: v.tolist() for k, v in _batch(get_config(arch).smoke()).items()},
                           ckpt_dir, arch in WIDENED),)
    return json.loads(run_multidevice(script, 8, 300).split("RESULT ", 1)[1])


def _restore_group(port_future, ref_future, port_ckpt: str, ref_ckpt: str) -> list:
    port_future.result()
    ref_future.result()
    payload = {"mesh": (2, 2),
               "restores": {"port": (port_ckpt, "granite-moe-1b-a400m", "adam8bit"),
                            "reference": (ref_ckpt, "granite-moe-1b-a400m", "adamw")},
               "compress": (np.arange(32, dtype=np.float32).reshape(4, 8) / 7.3)}
    return spawn_ranks(RANKS + ":restore_rank", payload, 4, device="cpu",
                       timeout_s=TIMEOUT_S)


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
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    port_ckpt, ref_ckpt = str(tmp / "port_ck"), str(tmp / "ref_ck")
    t0 = time.perf_counter()
    with _ranks_on_path(), ThreadPoolExecutor(max_workers=8) as pool:
        refs = {a: pool.submit(_ref_train, a, str(tmp / a),
                               ref_ckpt if a == "granite-moe-1b-a400m" else "")
                for a in ARCHS}
        np.savez(tmp / "moe.npz", **dict(zip(("x", "router", "wg", "wu", "wd"), _moe_arrays())))
        ref_moe = pool.submit(run_multidevice, REF_MOE % (str(tmp / "moe.npz"),), 8, 300)
        port = pool.submit(spawn_ranks, RANKS + ":mesh_rank", _payload(port_ckpt),
                           8, device="cpu", timeout_s=TIMEOUT_S)
        restore = pool.submit(_restore_group, port, refs["granite-moe-1b-a400m"], port_ckpt,
                              ref_ckpt)
        pod = pool.submit(spawn_ranks, RANKS + ":pod_rank", {"mesh": (2, 2, 2)}, 8,
                          device="cpu", timeout_s=TIMEOUT_S)
        out = {"refs": {a: f.result() for a, f in refs.items()},
               "ref_moe": json.loads(ref_moe.result().split("RESULT ", 1)[1]),
               "port": port.result(), "restore": restore.result(), "pod": pod.result(),
               "tmp": tmp,
               "port_ckpt": port_ckpt, "reference_ckpt": ref_ckpt}
    out["wall_s"] = time.perf_counter() - t0
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree, prefix="") -> dict:
    """A nested dict's leaves by their "/"-joined keys after ``prefix``."""
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{prefix}/{k}" if prefix else k).items()}
    return {prefix: tree}


@pytest.mark.parametrize("cap", MOE_CAPS)
def test_sharded_moe_matches_reference(launched, cap):
    got = launched["port"][0]["moe"][str(cap)]
    x, router, wg, wu, wd = (torch.from_numpy(a) for a in _moe_arrays())
    cfg = MoEConfig(**_moe_cfg(cap))
    plain_y, plain_aux, plain_dropped = moe.moe_ffn_sharded_plain(
        x, router, wg, wu, wd, cfg, 2, 4, with_dropped=True)
    np.testing.assert_allclose(got["y"], plain_y.numpy(), rtol=0, atol=1e-5)
    assert abs(got["aux"] - float(plain_aux)) <= 1e-6
    assert got["dropped"] == int(plain_dropped)
    for rank in launched["port"][1:]:
        np.testing.assert_array_equal(rank["moe"][str(cap)]["y"], got["y"])
    if cap == 4.0:
        # dropless: the sharded experts are the whole moe_ffn
        y, _ = moe.moe_ffn(x, router, wg, wu, wd, cfg)
        np.testing.assert_allclose(got["y"], y.numpy(), rtol=0, atol=1e-5)
        assert got["dropped"] == 0
    else:
        ref = launched["ref_moe"]
        assert ref["dropped"] > 0 and got["dropped"] == ref["dropped"]
        np.testing.assert_allclose(got["y"], np.asarray(ref["y"], np.float32), rtol=0, atol=1e-5)
        assert abs(got["aux"] - ref["aux"]) <= 1e-6
        # the reference's own single-device moe_ffn drops other pairs
        ry, _ = RM.moe_ffn(*(jnp.asarray(a) for a in _moe_arrays()),
                           RefMoEConfig(**_moe_cfg(cap)))
        assert np.abs(np.asarray(ry) - got["y"]).max() > 1e-3


def _single_steps(arch: str, mb: int, float64: bool = False) -> dict:
    """The port's three single-process steps from the reference's start on
    its batch (``float64``: computed in float64): the parameters by their
    "/"-joined keys."""
    cfg = get_config(arch).smoke()
    state = train_state_from_reference(_ref_state(arch, "adamw", LR), cfg, "adamw", "cpu")
    step = make_train_step(cfg, OptConfig(lr=LR), microbatches=mb)
    with Float64() if float64 else contextlib.nullcontext():
        state = as_float64(state) if float64 else state
        for _ in range(3):
            state, _m = step(state, _batch(cfg))
    return _flat(zip_tree(lambda t: t.numpy(), state.params))


def _limits(arch: str, mb: int, want) -> dict:
    """Widened limits (module doc): for the `WIDENED` archs, twice the gap
    of the port's single-process steps to the reference's sharded ones,
    where that gap exceeds half of ``TRAIN_REL``, and never more than
    ``WIDENED_CEIL``; none for the others."""
    if arch not in WIDENED:
        return {}
    single = _single_steps(arch, mb)
    gaps = {k: _rel(single[k], want[k]) for k in want.files}
    return {k: min(2 * g, WIDENED_CEIL) for k, g in gaps.items() if g > TRAIN_REL / 2}


def _check_decode(ranks: list, name: str, rows: int) -> None:
    """The mesh's decode of ``name`` against one process's: tokens equal,
    logits within ``DECODE_ATOL``, every rank the same tokens, the cache
    blocks of `cache_specs`' layout."""
    dec = ranks[0]["decode"][name]
    arch = name.split("/")[0]
    cfg = get_config(arch).smoke()
    one = CausalLM(cfg, _decode_params(arch), device="cpu")
    logits, cache = one.prefill(torch.as_tensor(_prompt(cfg)[:rows]), max_len=MAX_LEN)
    steps, tokens = [logits.numpy()], []
    for _ in range(DECODE_STEPS):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        tokens.append(tok.numpy())
        logits, cache = one.decode_step(cache, tok)
        steps.append(logits.numpy())
    np.testing.assert_array_equal(dec["tokens"], np.concatenate(tokens, 1))
    np.testing.assert_allclose(dec["logits"], np.stack(steps), rtol=0, atol=DECODE_ATOL)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["decode"][name]["tokens"], dec["tokens"])
    split = dec["cache_shapes"]
    rows_held = rows // 2 if rows % 2 == 0 else rows   # over the 2 data shards, or whole
    if cfg.block_kind == "rwkv":   # 4 heads over tp = 4
        assert split["s"][1:3] == (rows_held, 1)
    else:                          # the sequence over tp = 4
        assert split["k"][1:3] == (rows_held, MAX_LEN // 4)


@pytest.mark.parametrize("case", list(CASES))
def test_minimesh_train_and_decode_lower_compile(launched, case):
    """Three sharded steps against the reference's sharded step (module
    doc), then decode on the mesh for the case's arch (its adamw/1 case
    on the whole batch)."""
    arch, kind, mb, rows = CASES[case]
    ranks = launched["port"]
    got = ranks[0]["train"][case]
    want_losses = launched["refs"][arch][f"{kind}/{mb}/{rows}"]
    for g, w in zip(got["losses"], want_losses):
        assert abs(g - w) <= LOSS_REL * abs(w), (got["losses"], want_losses)
    assert all(r["train"][case]["shapes_ok"] for r in ranks)
    assert all(r["train"][case]["losses"] == got["losses"] for r in ranks)
    name = str(launched["tmp"] / f"{arch}_{kind}_{mb}_{rows}")
    want = np.load(name + ".npz")
    flat = _flat(got["params"])
    assert sorted(flat) == sorted(want.files)
    if kind == "adam8bit":
        assert "embed" in got["straddling"], got["straddling"]
        for k in want.files:
            np.testing.assert_allclose(flat[k], want[k], rtol=0, atol=STEP_ATOL_ADAM8, err_msg=k)
    else:
        limits = _limits(arch, mb, want)
        for k in want.files:
            assert _rel(flat[k], want[k]) <= limits.get(k, TRAIN_REL), (case, k)
    if (kind, mb, rows) == ("adamw", 1, B):
        _check_decode(ranks, arch, B)


@pytest.mark.parametrize("arch", WIDENED)
def test_widened_gaps_are_rounding(launched, arch):
    """Why ``arch``'s limits are widened (module doc): the reference's own
    single-device and sharded steps part by more than ``REF_SELF_GAP_MIN``
    on some leaf at 1 and 2 microbatches, and in float64 the port's mesh
    steps equal its single-process steps within ``F64_REL`` on every
    leaf, so the mesh's partition adds nothing but rounding."""
    for mb in (1, 2):
        name = str(launched["tmp"] / f"{arch}_adamw_{mb}_{B}")
        want, single = np.load(name + ".npz"), np.load(name + "_single.npz")
        ref_gap = max(_rel(single[k], want[k]) for k in want.files)
        print(f"{arch} mb={mb}: the reference's single-device against sharded gap {ref_gap:.3e}")
        assert ref_gap > REF_SELF_GAP_MIN, ref_gap
    mesh64 = _flat(launched["port"][0]["train_f64"][arch])
    one64 = _single_steps(arch, 1, float64=True)
    assert sorted(mesh64) == sorted(one64)
    assert all(v.dtype == np.float64 for v in mesh64.values())
    gap64 = max(_rel(mesh64[k], one64[k]) for k in one64)
    print(f"{arch}: the port's mesh against single-process gap in float64 {gap64:.3e}")
    assert gap64 <= F64_REL, gap64


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_of_a_batch_of_one_on_the_mesh(launched, arch):
    """A batch of 1, which the 2 data shards do not divide, prefilled and
    decoded whole on every rank (the reference's fitted batch spec
    replicates it): the tokens of one process."""
    _check_decode(launched["port"], arch + "/b1", 1)


def test_sharded_adam8bit_update_is_the_whole_update(launched):
    """adam8bit on 2 × 4 blocks (straddling 256-blocks, aligned ones, scales
    that do not split) gives the unsharded update bit for bit: every
    block's absmax is the whole block's (no clip: the global norm's
    summation order is not compared)."""
    from repro_torch.train.optimizer import apply_updates
    from tests.torch_mesh_ranks import ADAM8_CFG, adam8_inputs

    got = launched["port"][0]["adam8"]
    assert set(got["straddling"]) == {"straddle", "scales_whole"}
    params, grads, state = adam8_inputs()
    want_p, want_s, _ = apply_updates(params, grads, state, OptConfig(**ADAM8_CFG))
    for k in params:
        np.testing.assert_array_equal(got["params"][k], want_p[k].numpy(), err_msg=k)
        for moment in ("m", "v"):
            for f in ("q", "scale"):
                np.testing.assert_array_equal(getattr(getattr(got["state"], moment)[k], f),
                                              getattr(getattr(want_s, moment)[k], f).numpy(),
                                              err_msg=f"{moment}.{k}.{f}")


def _files(path: str, step: int) -> dict:
    d = os.path.join(path, f"step_{step:08d}")
    manifest = json.load(open(os.path.join(d, "MANIFEST.json")))
    return {k: (np.load(os.path.join(d, m["file"])), m["dtype"])
            for k, m in manifest["leaves"].items()}


@pytest.mark.parametrize("source", ["port", "reference"])
def test_elastic_restore_multidevice(launched, source):
    """A checkpoint saved on 2 × 4 restored on 2 × 2, every leaf bitwise
    the file's (module doc)."""
    res = launched["restore"][0]["restored"][source]
    assert res["step"] == 3
    assert all(r["restored"][source]["shapes_ok"] for r in launched["restore"])
    files = _files(launched[source + "_ckpt"], 3)
    got = ckpt._flatten(res["state"])
    assert sorted(got) == sorted(files)
    for k, (arr, dtype) in files.items():
        assert str(got[k].dtype) == dtype, k
        np.testing.assert_array_equal(got[k], arr, err_msg=k)
    if source == "port":
        # the port's mesh checkpoint is the reference's format: its restore
        # reads it, leaf for leaf (float32, int8 words and scales)
        rcfg = ref_get_config("granite-moe-1b-a400m").smoke()
        template = RT.train_state_shapes(rcfg, RO.OptConfig(kind="adam8bit"))
        ref_state, step = RC.restore(launched["port_ckpt"], template)
        assert step == 3
        for k, v in RC._flatten(ref_state).items():
            np.testing.assert_array_equal(np.asarray(v), files[k][0], err_msg=k)
        # and it holds the state the mesh trained
        trained = _flat(launched["port"][0]["train"][CKPT_CASE]["params"], "params")
        for k, v in trained.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_compressed_psum_multidevice(launched):
    """The reference's test on 4 ranks: int8 error-feedback compression
    with a real all-reduce; each rank holds the mean within one level."""
    g = np.arange(32, dtype=np.float32).reshape(4, 8) / 7.3
    exact = g.mean(axis=0)
    scale = float(np.abs(g).max()) / 127.0
    for rank in launched["restore"]:
        err = float(np.abs(rank["compressed"] - exact).max())
        assert err <= scale + 1e-6, (err, scale)
    assert launched["restore"][0]["compressed"].tolist() == \
        launched["restore"][3]["compressed"].tolist()


def test_collectives_over_two_axes_are_in_block_order(launched):
    """On a 2 × 2 × 2 (pod, data, model) mesh the fsdp axes are ("pod",
    "data"): a group of two axes, made on first use, whose rank order is
    the block order, pod major (the reference's spec entry)."""
    ranks = launched["pod"]
    for r in ranks:
        c = r["coords"]
        assert r["index"] == c["pod"] * 2 + c["data"]
        np.testing.assert_array_equal(r["gathered"], np.repeat(np.arange(4.0), 2).reshape(4, 2))
        want = 4 * (c["model"] + 1) * np.array([[2.0 * r["index"]], [2.0 * r["index"] + 1]])
        np.testing.assert_array_equal(r["scattered"], want)
    assert sorted(r["index"] for r in ranks) == [0, 0, 1, 1, 2, 2, 3, 3]


def test_the_mesh_run_went_through_the_collectives(launched):
    """Every rank gathered parameters, scattered gradients and reduced over
    gloo on host tensors, and the file's processes finished in time."""
    for rank in launched["port"]:
        kinds = {k.split(":")[0] for k in rank["stats"]}
        assert {"all_gather", "reduce_scatter", "all_reduce", "all_reduce_max"} <= kinds
        assert all(k.endswith(":gloo") for k in rank["stats"])
    assert launched["wall_s"] < 240.0
