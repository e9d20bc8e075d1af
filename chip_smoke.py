#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero before the result:

  1. env      — the card (nvidia-smi name and power limit), torch / CUDA /
                nvcc versions, and the kernel library's build time (nvcc
                for sm_90a into build/repro_torch/, from the sources here).
  2. kernels  — each hand-written kernel against its plain PyTorch version
                on the card, bitwise, at the reference sweep's shapes, the
                full-width predict shape, a nomao-width tenant, n = 400,
                and spans with mixed widths, misaligned / negative /
                off-the-end offsets and the isolation case.
  3. predict  — the reference-fitted golden bundles (tests/torch_golden/)
                predict every row of their datasets through
                `ServableCircuit.predict` on the card; the class ids must
                equal the reference's committed ids exactly.
  4. serve    — a `CircuitRegistry` of six synthetic tenants, a nomao-width
                tenant, both golden bundles and a 3-member ensemble serves
                a few ticks of mixed-size requests through
                `CircuitServer(device="cuda")` at 1 and 2 shards.  Every
                result must equal the tenant's `predict` on the card (the
                golden tenants: the committed ids) and each tick must make
                one launch per shard with work.

Launch counts are set to 0 just before each main-path phase (3 and 4) and
read just after; a kernel of the path that did not launch fails the run.
Then each kernel is timed at its main-path shape beside its plain version
and its bound, and the script prints a ``{"kernels": [...]}`` line, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import encoding as E  # noqa: E402
from repro_torch.core.api import ServableCircuit, load_servable  # noqa: E402
from repro_torch.core.gates import BUF_A, NOT_A  # noqa: E402
from repro_torch.core.genome import CircuitSpec, init_genome, opcodes  # noqa: E402
from repro_torch.data import load_dataset  # noqa: E402
from repro_torch.kernels import circuit_eval  # noqa: E402
from repro_torch.kernels import ref as plain  # noqa: E402
from repro_torch.serve.circuits import CircuitRegistry, CircuitServer  # noqa: E402
from repro_torch.serve.planning import PlacementPolicy, ensemble_vote  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "torch_golden")
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and 32-bit integer
# logic ops/s = 132 SMs x 64 INT32 lanes/clock x 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# (features, bits/input, gates, classes) of the serving benchmark's tenants
SERVE_SHAPES = [(4, 2, 60, 2), (7, 4, 120, 3), (3, 2, 40, 4), (10, 4, 200, 5),
                (6, 2, 80, 2), (12, 4, 300, 8)]
# (inputs, gates, outputs, population, words) for the kernel checks
CHECK_SHAPES = [(4, 10, 1, 1, 2), (8, 50, 1, 4, 11), (16, 100, 2, 5, 32),
                (32, 300, 4, 3, 128), (100, 300, 2, 2, 313), (6, 17, 3, 7, 1),
                (116, 300, 1, 1, 3065), (476, 300, 1, 3, 700),
                (32, 400, 4, 3, 129)]


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def to_dev(*ts, device="cuda"):
    return [t.to(device) for t in ts]


def mismatch(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """(words that differ, max |difference| of the uint32 values)."""
    a64 = a.cpu().to(torch.int64) & 0xFFFFFFFF
    b64 = b.cpu().to(torch.int64) & 0xFFFFFFFF
    diff = (a64 - b64).abs()
    return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0


def random_population(g, n_in, n, n_out, pop, w):
    """A population of random genomes (all 8 opcodes) and random words."""
    spec = CircuitSpec(n_in, n, n_out, tuple(range(8)))
    gs = [init_genome(g, spec) for _ in range(pop)]
    opc = torch.stack([opcodes(x, spec) for x in gs])
    edge = torch.stack([x.edge_src for x in gs])
    outs = torch.stack([x.out_src for x in gs])
    x = torch.randint(-2**31, 2**31 - 1, (n_in, w), generator=g, dtype=torch.int32)
    return opc, edge, outs, x


def span_case(g, n_in, pop, w):
    """Spans arguments for a check shape: misaligned, negative and
    off-the-end word offsets, and input widths from 0 to I."""
    span = max(1, w // 3)
    woff = torch.tensor([(7 * p + 1) % w - (p % 2) * w for p in range(pop)],
                        dtype=torch.int32)
    iw = torch.randint(0, n_in + 1, (pop,), generator=g, dtype=torch.int32)
    return woff, iw, span


# -- phase 1 ----------------------------------------------------------------
def phase_env() -> dict:
    card = gpu_line()
    nvcc = subprocess.run([circuit_eval._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    circuit_eval.load_library()
    build_s = time.perf_counter() - t0
    log = circuit_eval.library_path().with_suffix(".log").read_text().splitlines()
    env = {
        "phase": "env", "card": card, "python": sys.version.split()[0],
        "torch": torch.__version__, "torch_cuda": torch.version.cuda,
        "nvcc": next((ln for ln in nvcc if "release" in ln), None),
        "device_name": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "capability": list(torch.cuda.get_device_capability(0)),
        "build_s": build_s,
        "ptxas": [ln.split("info    :")[-1].strip() for ln in log if "Used" in ln],
    }
    emit(env)
    return env


# -- phase 2 ----------------------------------------------------------------
def phase_kernel_checks() -> dict:
    g = torch.Generator().manual_seed(SEED)
    stats = {"eval_population": [0, 0, 0], "eval_population_spans": [0, 0, 0]}
    for n_in, n, n_out, pop, w in CHECK_SHAPES:
        opc, edge, outs, x = to_dev(*random_population(g, n_in, n, n_out, pop, w))
        want = plain.eval_population_packed(opc, edge, outs, x)
        got = circuit_eval.eval_population(opc, edge, outs, x)
        torch.cuda.synchronize()
        bad, err = mismatch(got, want)
        s = stats["eval_population"]
        s[0] += 1
        s[1] += bad
        s[2] = max(s[2], err)
        # spans: mixed widths (0 … I), misaligned / negative / off-the-end
        woff, iw, span = span_case(g, n_in, pop, w)
        woff, iw = to_dev(woff, iw)
        want = plain.eval_population_spans_packed(opc, edge, outs, x, woff, iw,
                                                  span_words=span)
        got = circuit_eval.eval_population_spans(opc, edge, outs, x, woff, iw,
                                                 span_words=span)
        torch.cuda.synchronize()
        bad, err = mismatch(got, want)
        s = stats["eval_population_spans"]
        s[0] += 1
        s[1] += bad
        s[2] = max(s[2], err)
    # isolation: rows past in_width are invisible even to edges that read them
    opc, edge, outs, x = to_dev(*random_population(g, 8, 10, 2, 1, 4))
    poisoned, clean = x.clone(), x.clone()
    poisoned[5:] = 0x5EADBEEF
    clean[5:] = 0
    woff = torch.zeros(1, dtype=torch.int32, device="cuda")
    iw = torch.full((1,), 5, dtype=torch.int32, device="cuda")
    a = circuit_eval.eval_population_spans(opc, edge, outs, poisoned, woff, iw, span_words=4)
    b = circuit_eval.eval_population_spans(opc, edge, outs, clean, woff, iw, span_words=4)
    bad, _ = mismatch(a, b)
    stats["eval_population_spans"][1] += bad
    out = {"phase": "kernels", "isolation_mismatches": bad}
    for name, (cases, bad, err) in stats.items():
        out[name] = {"cases": cases, "mismatches": bad, "max_abs_err": err}
        check(bad == 0, f"{name}: {bad} words differ from the plain version")
    emit(out)
    return {k: {"mismatches": v[1], "max_abs_err": v[2]} for k, v in stats.items()}


# -- phase 3 ----------------------------------------------------------------
def golden():
    out = {}
    for name in ("higgs", "led"):
        sc = load_servable(os.path.join(GOLDEN, f"{name}.circuit.npz"))
        ds = load_dataset(name)
        ids = np.load(os.path.join(GOLDEN, f"{name}.ids.npy")).astype(np.int64)
        check(ids.shape == (ds.n_rows,), f"{name}: committed ids do not cover the dataset")
        out[name] = (sc, ds, ids)
    return out


def phase_predict(gold) -> dict:
    circuit_eval.reset_launch_counts()
    results = {}
    for name, (sc, ds, _) in gold.items():
        t0 = time.perf_counter()
        results[name] = sc.predict(ds.x, device="cuda")
        results[name + "_s"] = time.perf_counter() - t0
    launches = {k.name: k.launches for k in circuit_eval.KERNELS}
    out = {"phase": "predict", "launches": launches}
    for name, (sc, ds, ids) in gold.items():
        got = results[name]
        bad = int((got != ids).sum())
        out[name] = {"rows": ds.n_rows, "mismatches": bad, "wall_s": results[name + "_s"],
                     "accuracy_vs_labels": float((got == ds.y).mean())}
        check(got.shape == ids.shape and bad == 0,
              f"predict {name}: {bad} ids differ from the reference's")
    check(launches["eval_population"] > 0, "predict never launched eval_population")
    emit(out)
    return launches


# -- phase 4 ----------------------------------------------------------------
def make_tenant(g, rng, n_feats, bits, n_nodes, n_classes, x_fit=None) -> ServableCircuit:
    if x_fit is None:
        x_fit = rng.randn(256, n_feats).astype(np.float32)
    enc = E.fit_encoder(x_fit, E.EncodingConfig("quantile", bits))
    n_out = max(1, int(np.ceil(np.log2(max(n_classes, 2)))))
    spec = CircuitSpec(enc.n_bits_total, n_nodes, n_out, (0, 1, 2, 3))
    return ServableCircuit(spec, init_genome(g, spec), enc, n_classes)


def build_registry(gold):
    g = torch.Generator().manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    reg = CircuitRegistry()
    sources = {}  # tenant → rows requests are cut from (and golden ids)
    for i, shape in enumerate(SERVE_SHAPES):
        reg.add(f"tenant{i}", make_tenant(g, rng, *shape))
        sources[f"tenant{i}"] = (rng.randn(4096, shape[0]).astype(np.float32), None)
    nomao = load_dataset("nomao", max_rows=8192)
    reg.add("nomao", make_tenant(g, rng, nomao.n_features, 4, 300, 2, x_fit=nomao.x))
    sources["nomao"] = (nomao.x, None)
    for name, (sc, ds, ids) in gold.items():
        reg.add(name, sc)
        sources[name] = (ds.x, ids)
    reg.add_ensemble("ensemble", [make_tenant(g, rng, 7, b, n, 3)
                                  for b, n in ((2, 30), (4, 64), (2, 120))])
    sources["ensemble"] = (rng.randn(4096, 7).astype(np.float32), None)
    return reg, sources


def phase_serve(gold, n_ticks=3, requests_per_tick=240) -> tuple[dict, dict]:
    reg, sources = build_registry(gold)
    tenants = list(reg)
    rng = np.random.RandomState(SEED + 1)
    out = {"phase": "serve", "tenants": len(tenants),
           "slots": sum(len(reg.members(t)) for t in tenants), "runs": []}
    total = {k.name: 0 for k in circuit_eval.KERNELS}
    timing_case = None
    for n_shards in (1, 2):
        server = CircuitServer(reg, device="cuda", policy=PlacementPolicy(n_shards=n_shards))
        plan = server.plan()
        ticks = []
        for _ in range(n_ticks):
            work = []
            for r in range(requests_per_tick):
                tenant = tenants[r % len(tenants)]
                x_all, _ = sources[tenant]
                size = min(int(rng.choice([1, 3, 17, 64, 200, 700])), len(x_all) - 1)
                lo = int(rng.randint(0, len(x_all) - size))
                work.append((tenant, lo, size))
            # expectations first, on the card, outside the counted window:
            # one predict per tenant over all its rows this tick
            expect = {}
            for tenant in tenants:
                mine = [(lo, size) for t, lo, size in work if t == tenant]
                x_all, _ = sources[tenant]
                x = np.concatenate([x_all[lo:lo + s] for lo, s in mine])
                ids = np.stack([m.predict(x, device="cuda") for m in reg.members(tenant)])
                expect[tenant] = np.split(ensemble_vote(ids, reg.get(tenant).n_classes),
                                          np.cumsum([s for _, s in mine])[:-1])
            circuit_eval.reset_launch_counts()
            tickets = [server.submit(t, sources[t][0][lo:lo + s]) for t, lo, s in work]
            t0 = time.perf_counter()
            report = server.tick()
            tick_s = time.perf_counter() - t0
            counts = {k.name: k.launches for k in circuit_eval.KERNELS}
            for k, v in counts.items():
                total[k] += v
            seen = {t: 0 for t in tenants}
            bad = gold_bad = 0
            for (tenant, lo, size), ticket in zip(work, tickets):
                got = server.result(ticket)
                want = expect[tenant][seen[tenant]]
                seen[tenant] += 1
                bad += int(got.shape != want.shape or (got != want).any())
                gold_ids = sources[tenant][1]
                if gold_ids is not None:
                    gold_bad += int((got != gold_ids[lo:lo + size]).any())
            busy = {ref.shard for t in tenants for ref in plan.placement[t]}
            ticks.append({"rows": report.rows, "requests": report.requests,
                          "launches": report.launches, "span_words": report.span_words,
                          "occupancy": report.occupancy, "tick_s": tick_s,
                          "phase_s": report.phase_s, "kernel_launches": counts,
                          "mismatches": bad, "golden_mismatches": gold_bad})
            check(bad == 0, f"serve at {n_shards} shard(s): {bad} requests differ from predict")
            check(gold_bad == 0, f"serve at {n_shards} shard(s): golden ids differ")
            check(report.launches == len(busy) == counts["eval_population_spans"],
                  f"serve: {report.launches} launches for {len(busy)} busy shards")
            check(counts["eval_population"] == 0, "the tick launched eval_population")
            if n_shards == 1:
                timing_case = (plan.shards[0], report.span_words)
        out["runs"].append({"n_shards": n_shards, "plan_hash": plan.content_hash,
                            "ticks": ticks})
    check(total["eval_population_spans"] > 0, "serve never launched the spans kernel")
    out["launches"] = total
    emit(out)
    return total, timing_case


# -- phase 5 ----------------------------------------------------------------
def device_ms(fn, reps=30) -> float:
    """Median device time of one call by CUDA events, with the queue held
    back (a sleep kernel) so host overhead does not land between events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))
    marks = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        marks.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def wall_ms(fn, reps=5) -> float:
    """Median host time of one call ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def live_work(opc, edge, outs, n_in: int, width: int) -> tuple[int, int]:
    """(gates, input rows) that one circuit's outputs depend on: the gates
    reached back from its taps (a NOT_A or BUF_A gate needs only its first
    operand) and the distinct input rows below ``width`` that they or the
    taps read.  Rows at or past ``width`` read as zero and are never
    fetched, and dead gates are work the function does not need."""
    opc, edge, outs = (np.asarray(a).tolist() for a in (opc, edge, outs))
    n = len(opc)
    live, rows, stack = [False] * n, set(), list(outs)
    while stack:
        a = int(stack.pop())
        if a < n_in:
            if 0 <= a < width:
                rows.add(a)
        elif a < n_in + n and not live[a - n_in]:
            i = a - n_in
            live[i] = True
            stack.extend(edge[i][:1] if opc[i] in (NOT_A, BUF_A) else edge[i])
    return sum(live), len(rows)


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_entry(kernel, checks, launches, shape, fn, plain_fn, nbytes, ops,
                 live_gates, rows_read) -> dict:
    ms = device_ms(fn)
    b_ms, b_by = bound(nbytes, ops)
    return {
        "name": kernel.name, "route": "cuda",
        "source": "src/repro_torch/csrc/circuit_eval.cu",
        "replaces": kernel.replaces, "launches": launches,
        "max_abs_err": checks["max_abs_err"], "mismatches": checks["mismatches"],
        "shape": shape, "ms": ms, "kernel_ms": ms,
        "kernel_wall_ms": wall_ms(fn, reps=20), "plain_ms": wall_ms(plain_fn),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops,
        "live_gates": live_gates, "input_rows_read": rows_read,
        "library_ms": None,
    }


def phase_timing(gold, checks, predict_launches, serve_launches, timing_case) -> list:
    entries = []
    # eval_population at the golden higgs predict shape (P = 1)
    sc, ds, _ = gold["higgs"]
    bits = E.encode(sc.encoder, ds.x)
    xw = E.pack_bits_rows(bits, E.n_words(ds.n_rows))
    opc, edge, outs, x = to_dev(opcodes(sc.genome, sc.spec)[None], sc.genome.edge_src[None],
                                sc.genome.out_src[None], torch.from_numpy(xw.view(np.int32)))
    n_in, w = x.shape
    n, n_out = sc.spec.n_nodes, sc.spec.n_outputs
    got = circuit_eval.eval_population(opc, edge, outs, x)
    bad, err = mismatch(got, plain.eval_population_packed(opc, edge, outs, x))
    check(bad == 0, "eval_population differs from plain at the predict shape")
    # bound: what these inputs need — the live gates' genome, the input
    # rows they read once each, and the output words
    live, rows = live_work(opc[0].cpu(), edge[0].cpu(), outs[0].cpu(), n_in, n_in)
    nbytes = 4 * (3 * live + n_out + rows * w + n_out * w)
    ops = live * w
    entries.append(kernel_entry(
        circuit_eval.EVAL_POPULATION, checks["eval_population"],
        predict_launches["eval_population"],
        {"P": 1, "I": n_in, "n": n, "O": n_out, "W": w},
        lambda: circuit_eval.eval_population(opc, edge, outs, x),
        lambda: plain.eval_population_packed(opc, edge, outs, x), nbytes, ops, live, rows))
    # spans at the one-shard tick's shape: every slot live, back-to-back spans
    shard, span = timing_case
    k = shard.n_slots
    g = torch.Generator().manual_seed(SEED + 2)
    i_max = shard.n_inputs_max
    x = torch.randint(-2**31, 2**31 - 1, (i_max, k * span), generator=g,
                      dtype=torch.int32).cuda()
    opc, edge, outs, iw = to_dev(*(torch.from_numpy(np.array(a)) for a in (
        shard.opcodes, shard.edge_src, shard.out_src, shard.in_width)))
    woff = (torch.arange(k, dtype=torch.int32) * span).cuda()
    got = circuit_eval.eval_population_spans(opc, edge, outs, x, woff, iw, span_words=span)
    want = plain.eval_population_spans_packed(opc, edge, outs, x, woff, iw, span_words=span)
    bad, _ = mismatch(got, want)
    check(bad == 0, "eval_population_spans differs from plain at the tick shape")
    n, n_out = shard.opcodes.shape[1], shard.out_src.shape[1]
    # bound: per slot, its live gates' genome, offset and width, and the
    # input rows below its width that they read, over its own span
    work = [live_work(shard.opcodes[p], shard.edge_src[p], shard.out_src[p], i_max,
                      int(shard.in_width[p])) for p in range(k)]
    live, rows = sum(a for a, _ in work), sum(r for _, r in work)
    nbytes = 4 * (3 * live + k * (n_out + 2) + rows * span + k * n_out * span)
    ops = live * span
    entries.append(kernel_entry(
        circuit_eval.EVAL_POPULATION_SPANS, checks["eval_population_spans"],
        serve_launches["eval_population_spans"],
        {"P": k, "I_max": i_max, "n": n, "O": n_out, "span_words": span,
         "W_total": k * span},
        lambda: circuit_eval.eval_population_spans(opc, edge, outs, x, woff, iw,
                                                   span_words=span),
        lambda: plain.eval_population_spans_packed(opc, edge, outs, x, woff, iw,
                                                   span_words=span),
        nbytes, ops, live, rows))
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_env()
    checks = phase_kernel_checks()
    gold = golden()
    predict_launches = phase_predict(gold)
    serve_launches, timing_case = phase_serve(gold)
    entries = phase_timing(gold, checks, predict_launches, serve_launches, timing_case)
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} was not launched on the main path")
    emit({"kernels": entries})
    print(gpu_line(), flush=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
