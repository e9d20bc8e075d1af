"""The fleet and the refit's own process on the card.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the test, never at import).  This file imports neither JAX nor the
reference package, so it runs where only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_fleet.py

  * a two-host in-process fleet on the card replays a skewed trace with a
    migration mid-replay: every id equals the plain version's on the host,
    and spans launches equal the hosts' ticks plus their prewarm launches;
  * a subprocess host on the card receives a tenant over a
    `SocketTransport`, answers the plain version's ids, and exits 0 on the
    ``shutdown`` RPC;
  * a `RefitWorker` on the card searches in its own process: its candidate
    is the inline `refit_circuit`'s on the card, bit for bit, and the
    process's launches are the search's generations plus one.
"""
import numpy as np
import pytest
import torch

from chip_smoke import evolve_rows, fleet_circuits
from repro_torch.core import encoding as E
from repro_torch.core.api import AutoTinyClassifier
from repro_torch.kernels import circuit_eval
from repro_torch.serve.circuits import CircuitRegistry
from repro_torch.serve.evolution import RefitConfig, RefitWorker, ReplayBuffer, refit_circuit
from repro_torch.serve.fleet import (
    FleetRouter,
    InProcTransport,
    ServingHost,
    SocketTransport,
    dump_bundle,
    generate,
    spawn_host_process,
)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _plain_ids(events, circuits):
    return [circuits[e.tenant].predict(e.features(circuits[e.tenant].encoder.n_features),
                                       device="cpu") for e in events]


@pytest.mark.cuda
def test_two_host_fleet_replay_on_the_card_equals_the_plain_version():
    _card()
    circuits = fleet_circuits()
    router = FleetRouter()
    hosts = []
    for h in ("host0", "host1"):
        hosts.append(ServingHost(h, CircuitRegistry(), device="cuda"))
        router.add_host(h, InProcTransport(hosts[-1]))
    for t, sc in sorted(circuits.items()):
        router.register(t, [sc])
    wl = generate("skew", n_events=3000, tenants=sorted(circuits), seed=1)

    def on_chunk(ci, r):
        if ci == 1:
            t = sorted(r.tenants())[0]
            r.migrate(t, "host1" if r.owner_of(t) == "host0" else "host0", reason="test")

    circuit_eval.reset_launch_counts()
    try:
        got = router.replay(wl.events, chunk_size=512, on_chunk=on_chunk)
        launches = circuit_eval.EVAL_POPULATION_SPANS.launches
        ticks = sum(h.server.stats.report()["launches"] for h in hosts)
        dead = sum(h.server.aot_stats["exec_warms"] for h in hosts)
    finally:
        router.close()
    assert len(router.migrations) == 1
    want = _plain_ids(wl.events, circuits)
    assert all(isinstance(a, np.ndarray) and np.array_equal(a, b) for a, b in zip(got, want))
    assert launches == ticks + dead and ticks > 0


@pytest.mark.cuda
def test_subprocess_host_on_the_card_serves_a_migrated_tenant():
    _card()
    circuits = fleet_circuits()
    proc, addr = spawn_host_process("proc0")
    try:
        tr = SocketTransport(addr, connect_timeout_s=30.0)
        assert tr.call("ping")["backend"] == "cuda"
        t = "tenant3"
        tr.call("add_tenant", {"tenant": t, "bundles": [dump_bundle(circuits[t])],
                               "action": "migrate_in"})
        wl = generate("skew", n_events=200, tenants=[t], seed=2)
        work = [[t, e.features(circuits[t].encoder.n_features)] for e in wl.events]
        out = tr.call("step", {"work": work})["y"]
        want = _plain_ids(wl.events, circuits)
        assert all(np.array_equal(a, b) for a, b in zip(out, want))
        stats = tr.call("stats")
        assert stats["migrations_in"] == 1 and stats["server"]["launches"] >= 1
        assert tr.call("shutdown") == {"ok": True}
        tr.close()
        assert proc.wait(60.0) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.mark.cuda
def test_refit_process_on_the_card_equals_the_inline_search():
    _card()
    px, py = evolve_rows(1500, shift=0.0, seed=1)
    live = AutoTinyClassifier(n_gates=100, max_gens=100, kappa=100, seed=1,
                              encodings=[E.EncodingConfig("quantile", 4)]).fit(px, py).to_servable()
    x, y = evolve_rows(1024, shift=1.5, seed=4)
    cfg = RefitConfig(max_gens=300, kappa=100, min_replay_rows=1024)
    want = refit_circuit("t", live, x, y, cfg, refit_index=0)
    buf = ReplayBuffer(1024)
    buf.extend(x, y)
    done = []
    worker = RefitWorker(cfg).start()
    try:
        assert worker.request("t", live, buf, done.append)
        assert worker.join(timeout=300.0)
    finally:
        worker.stop()
    (got,) = done
    assert (got.generations, got.val_fitness) == (want.generations, want.val_fitness)
    assert all(torch.equal(a, b) for a, b in zip(got.candidate.genome, want.candidate.genome))
    assert got.candidate.lineage == want.candidate.lineage
    assert worker.remote_launches["eval_population"] == got.generations + 1
