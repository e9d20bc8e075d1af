#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero before the result:

  1. env      — the card (nvidia-smi name and power limit), torch / CUDA /
                nvcc versions, the kernel library's build time (nvcc for
                sm_90a into build/repro_torch/, from the sources here) and
                each kernel's ``ptxas -v`` lines (registers, spills).
  2. kernels  — each hand-written kernel, run on a live-gate program, against
                both plain PyTorch versions on the card (genome level and
                program level), bitwise, at the reference sweep's shapes,
                the full-width predict shape, a nomao-width tenant and
                n = 400, on valid and on corrupt genomes (negative, forward
                and past-the-end ids, opcodes outside the table); spans with
                slot gather (repeats, a negative slot id, a pad slot),
                mixed widths, misaligned / negative / off-the-end offsets,
                and the isolation case.
                The fit shape: λ = 4 mutated children of a 300-gate genome
                over 116 input rows at W = 2,452 and a misaligned W; an
                island rank's (phase 4g): the same at W = 1,226.
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
  4b. swap    — plan swaps, a shadow slot and a cold boot at the serve
                phase's width, through `CircuitServer(device="cuda")`,
                whose ticks launch span-launch units (`runtime/aot.py`):
                (a) 3 warm ticks of 240 requests at one shard; (b) a
                golden bundle added under a new name, its requests pending
                across `swap_plan` (prewarmed: the new shard's units built
                and run once dead before the fence); (c) a grow to two
                shards through `PlanCompiler(...).recompile` and
                `swap_plan(compiler=...)`, then a stale plan refused with
                `StalePlanError`; (d) a shadow fourth member on the
                ensemble: served ids stay the 3-member vote, the hook gets
                the member's own ids; (e) the registry and the units
                exported to an `ArtifactStore`, and a fresh process that
                loads it, rebuilds the plan with `compile_from_placement`,
                preloads the units and answers probe rows — with no
                program compiled and no nvcc run, and the warm server's
                ids.  Every request is answered once and equals predict;
                each `RebalanceEvent` reuses exactly the untouched shards.
                The line has every event, the prewarms, `aot_stats`, the
                first post-swap tick beside the steady median, the boot's
                wall ms by step and the launch counts.
  4c. async   — the deadline-aware front end (`AsyncCircuitServer`) over the
                serve registry at one shard, prewarmed, its tenants cycling
                the reference bench's tight / standard / relaxed deadline
                tiers scaled by 8: open-loop Poisson traffic at 40
                requests/s for 3 s (1 + Poisson(8) rows each), drawn up
                front and replayed on the wall clock through `enqueue`
                with the background scheduler thread firing; then the one-call
                facade, ``async with golden.serve_async()`` and
                ``asyncio.gather`` over the golden higgs rows in chunks.
                Every future resolves once with predict's ids (the golden
                ones: the committed ids), the miss rate is 0.0, spans
                launches equal the fires times the shards with work, and
                the scheduler thread raises no warning.  The line has
                `FrontendStats.report()`, the first fire's latency beside
                the median, and the tick phase medians.
  4d. autoscale — `AutoscaleController` over the front end at 2 shards
                (`HysteresisPolicy(patience=1, cooldown_s=0.2,
                max_shards=3, device_cap=3, imbalance_high=1.3)`: the card
                count is 1, so the cap is explicit and up to three shards
                time-share the card): skewed open-loop traffic (85 % onto
                shard 0's tenants) at 60 requests/s for 4 s, a control step
                every 0.12 s, a scripted grow 2 → 3 and shrink 3 → 2, and a
                thread adding and removing a golden bundle under a new
                name, twice.  At least one organic rebalance and 3 events;
                every admitted future resolves once, only the churned
                tenant's may fail, the served ids equal predict; the
                scheduler holds an EWMA for every shard of each new plan;
                spans launches equal the ticks' plus the swaps' prewarm.
  4e. evolve  — online evolution on the card, `benchmarks/serve_evolve.py`'s
                `run()` at its defaults written as a phase: a parent fitted
                on the card on 3,000 pre-shift rows (6 features, n = 100,
                one 4-bit quantile encoding, G = 1,200, κ = 300) serves
                64-row requests through the front end (pumped inline) with
                label feedback; 10 stationary requests, then a shift of
                1.5 until a promoted circuit has served 5 requests (a
                canary rolled back on probation re-arms the loop, and the
                phase serves on past the benchmark's 2,000 for it), giving
                up after 4,000.  `EvolutionManager`
                (`observe_every=2`, a 2,048-row replay window, the
                benchmark's `DriftConfig` and `PromotionPolicy`) detects
                the drift, refits in its worker's own process on the card
                (`RefitConfig` at ``device=None``; the process boots
                before the traffic) while the ticks serve, shadows the
                candidate in the tick's spans launch and promotes it
                through the fenced swap; the stack's `TraceRecorder` times
                the refit and the ticks.  Then the oracle (a scratch refit
                at the same budget on 2,048 post-shift rows), the parent
                fit, the oracle and each refit replayed through the plain
                versions on the card (each refit on the replay window it
                ran on), the benchmark's interleaved overhead legs, and a
                `torch.profiler` trace of 50 requests outside a refit and
                50 during one.  Fails unless the drift is a divergence, at
                least one refit and one promotion complete within the
                2,000 post-shift requests, no request is
                lost and one is served while the refit runs, accuracy on
                post-shift rows rises, the promoted lineage names the
                audit's parent, every request's ids equal the plain
                version's and `predict` on the card of the circuit its tick
                served, each verdict's shadow evidence (the shadow slot's
                agreement, the scorer's accuracy) equals the plain
                version's on the requests it shadowed, each search equals
                its plain replay in genome, validation fitness and
                generations, every delivered refit was shadowed,
                eval_population launches equal Σ(generations + 1) over the
                parent fit and the oracle plus the shadow scorer's
                predicts here, and over the refits in the refit process
                (which counts its own), and spans launches equal the fires plus
                the swaps' prewarm.  The line has qps, the refit's
                generations/s, the audit with `swap_ms`, the tick medians
                while a refit runs and outside it, the profile's split of a
                request into torch ops, CUDA synchronisation and the rest,
                `accuracy_gap` and `evolution_overhead_pct` (reported, not
                enforced).
  4f. fleet   — multi-host serving on the card, `benchmarks/serve_fleet.py`'s
                `run()` at its defaults written as a phase: 2 in-process
                `ServingHost`s (``device="cuda"``) behind a `FleetRouter`,
                8 tenants of the serving benchmark's shapes (genomes from
                the port's generator), a seed-0 `skew` trace of 100,000
                events replayed in chunks of 2,048 after a warm prefix,
                with a `RebalanceCadence` on the trace's own clock (a
                third of the trace; a forced move of the hottest tenant
                when hashing already balanced, counted apart); then the
                committed `benchmarks/workloads/fleet_smoke.jsonl.gz` at
                chunk 500.  Each replay is held to the same trace on one
                host (every id) and to the plain version on the host
                (every row); it loses nothing, migrates at least once,
                routes every event, and its spans launches equal the
                hosts' ticks plus their prewarm launches.  Then a host in
                its own process on the card (`spawn_host_process`) joins
                over a `SocketTransport`, takes tenants by migration,
                serves 4,096 events with the one-host replay's ids,
                leaves and exits 0 on the ``shutdown`` RPC; a live fleet
                is exported (`export_fleet`) and booted
                (`FleetRouter.boot_from_artifact`) with no program
                compiled and no nvcc run, its first answers the live
                fleet's; one host's evolution RPCs (watch, submit,
                feedback, step, report) answer as the reference's test
                expects.  The line has each replay's requests/s, rows/s,
                wall s, migrations and router report, the subprocess
                host's boot s, the boot's ms and the launches.
  4g. islands — `examples/evolve_distributed.py`'s layout on the card:
                4 islands × 2 data shards = 8 ranks (`launch_islands`,
                fresh interpreters joined in one gloo group through a file
                store, all on the one card) on higgs at full size (W =
                2,452 training words, 1,226 per shard; one 4-bit quantile
                encoding, I = 116), n = 300, λ = 4, κ = 300, G = 1,000,
                migrate_every = 32.  Every rank's eval_population launches
                equal its evaluations (its island's generations + 1, in
                its own process); every island's final genomes,
                ``best_val``, ``best_train``, ``parent_fit`` and generation
                count equal `evolve_islands_plain` in this process on the
                card through the plain versions, which launches nothing;
                the final parents and bests, evaluated through 2 shards
                with a gloo ``all_reduce``, score bitwise as on 1 shard.
                The line has each island's generations/s, each rank's
                boot s and collective ms per generation (data
                ``all_reduce``, ring, live ``all_reduce``) and the best
                island's fitness.
  5. fit      — `AutoTinyClassifier(n_gates=300, λ=4, κ=300, G=2000)` over
                the four default encodings on higgs (98,050 rows, 80/20
                train/test split: W = 2,452 words of training rows), on
                the card.  Per encoding: generations, generations/s, best
                val and train fitness, and the mean host ms of each phase
                of a generation.  eval_population must launch exactly
                Σ(generations + 1) times; the fitted classifier's predict
                on the test rows must equal the plain version's ids, and
                its saved bundle must reload and predict the same ids.
  6. fit_parity — one encoding (quantile, 4 bits), 200 generations, run
                through the kernel and through the plain versions on the
                card from the same seed: the trajectories must be
                identical (history, generation count, best fitness and
                genome, parent).
  7. timing   — each kernel at its main-path shapes (eval_population at
                the golden predict and at the fit's λ children), on the
                live-gate program and on the uncompacted one (every gate
                kept), beside its plain version and its bound.
  8. sweep    — the golden higgs program over W = 32 … 32,768 words.
  9. profile  — one tick under `torch.profiler`: the device work it
                launches (one spans kernel per shard and copies, nothing
                else) and the device's busy share of the tick.
 10. toolflow — the paper's toolflow on the port.  The higgs circuit of
                phase 5: its netlist (gates, GE, buffer bits, depth), its
                Verilog, C and hardware reports with their host ms, and
                three evaluations of it on the held-out rows that must
                agree bit for bit (`eval_netlist`, the kernel's unpacked
                output words, `simulate_verilog` of the emitted Verilog).
                `blood` and `led` fitted on the card as
                `benchmarks/hw_costs.py` fits them (n = 300, G = 2,000, the
                quickstart's two encodings), checked the same way, with
                their hardware reports against `gbdt_hw` and `mlp_hw` for
                both technologies, the area and power ratios, and the cost
                model's calibration beside the paper's Table 2.  Then the
                baselines as `benchmarks/fig9_11_baselines.py` trains them:
                the 2-bit smallest MLP (3x64) on blood and led, the 2-bit
                best MLP at full width (9x512) on higgs (20,000 rows), all
                on the card (every parameter must live there), with the
                eager step's mean time on the stream (CUDA events around
                the run); the float 3x64 MLP trained on blood on the
                card and on the CPU from one start, parameters within
                1e-4 of the largest and 99 % of predictions equal; GBDT on
                the host; balanced accuracy of each beside the tiny
                classifier's.
 11. mlp_profile — the first steps (at least 100) of each MLP run of
                phase 10 under `torch.profiler`: per step the stream's
                period and the device's busy ms, and the device's idle
                share of an unprofiled step.
 12. lm       — the LM serving path (`CausalLM`, `Engine`) for every
                block kind, plain PyTorch on the card (the reference runs
                it in `jnp`, outside any Pallas kernel, so no kernel of the
                table runs here and none is launched).  (a) minitron-8b at
                full width and depth (32 layers, d = 4,096, vocab 256,000:
                7.73 B random bf16 parameters drawn on the card, every one
                of them there): `Engine(batch_size=4, max_len=512)` serves 8
                requests of 256-token prompts and 32 new tokens, greedy;
                its tokens must equal a hand-made prefill + decode argmax
                chain at the same batch.  Then, the served model freed,
                the same draw in float32 (unrounded) decodes one request,
                whose logits must agree with `forward` over its whole
                sequence: every position's relative L2 gap within
                `LM_REL_L2_LIMIT`, and the gap of each checked planted
                fault past it (RoPE one position on, a zeroed cache row).  The
                line has prefill ms, decode ms per token beside its bound
                (every weight read once a step at 3.35 TB/s: `decode_bound`)
                and tokens/s.  (b) starcoder2-7b at full width with 4 of
                its 32 layers: a 4,608-token prompt through the chunked
                prefill (4 calls), its ring wrapped past the 4,096 window,
                then 8 decoded tokens (the check in float32, as in
                (a)).  (c) the committed
                reference fixtures (`lm_*_smoke.npz`: minitron; granite-moe
                dropping pairs in decode; rwkv6 with a padded prompt; hymba
                with its ring wrapped; stablelm, llama3; qwen2-vl and
                musicgen from embeddings) in float32: the same greedy
                tokens, logits within 1e-5.  (d) as (a), the expert and
                SSM archs:
                granite-moe-1b-a400m (24 layers, 32 experts, top-8, 1.33 B
                parameters), rwkv6-7b (32 layers, d = 4,096, 7.53 B) and
                hymba-1.5b (32 layers, 3 global) at full size, arctic-480b
                at full width with 1 of its 35 layers (128 experts, top-2
                and the dense residual, 14.07 B).  The experts serve at the
                production capacity factor 1.25 and the line reports the
                pairs dropped by a prefill and by a decode step; their
                decode check runs at a dropless E/k.  rwkv6's check
                request has 251 tokens, no multiple of the wkv chunk;
                hymba's has 1,280 tokens at max_len 1,344, past its
                1,024-slot ring.  (e) as (a), the last four archs:
                stablelm-12b at full size (40 layers, d = 5,120, head_dim
                160, 12.14 B parameters), qwen2-vl-7b (8 of 28 layers) and
                musicgen-medium (8 of 48) through their token ids, and
                llama3-405b at full width with 2 of its 126 layers (10.58 B;
                the float32 check at 4 would hold 67.8 GB of weights).  (f)
                the embedding frontends' own path for qwen2-vl-7b and
                musicgen-medium: seeded embeddings made on the card in the
                model's dtype, `prefill(embeds=, positions=)` (qwen2-vl's
                prompt a 12 x 16 image grid at distinct (t, h, w) M-RoPE
                ids, then text), then `decode_step(embed=)` fed each greedy
                token's embedding row: bf16 prefill and decode ms at batch 4
                beside the bound, M-RoPE's cost a call; then in float32
                against `forward` over the whole sequence (decode at the
                cache position on all three axes), its own limit, with
                `mrope_hw_dropped` (the prefill rotating by (t, t, t))
                planted beside the cache faults.  Each line has its peak
                memory and its seconds.
  13. train   — training on the card (`train/`, `models.lm.forward` with
                remat).  (a) granite-moe-1b-a400m at full size (24 layers,
                1.33 B parameters, 32 experts top-8 at capacity 1.25, remat
                "full", bf16 weights, AdamW at lr 3e-4) for `TRAIN_STEPS`
                steps of 4 x 4,096 tokens of the seeded structured
                `TokenStream`, prefetched: each step's loss, grad norm and
                ms, tokens/s, peak memory, the pairs the router dropped in
                step 0's forward, and a profiled step (device busy ms, idle
                share, kernels) beside the step's bound (8 x active
                parameters x tokens at 989 TFLOP/s bf16); the mean of the
                last 3 losses must lie `TRAIN_LOSS_FALL` below step 0's.
                (b) minitron-8b at full width with 2 of its 32 layers and
                its 2 microbatches (a float32 accumulator, the untied
                256,000 x 4,096 head): 3 steps of 2 x 4,096 tokens.  (c) one
                step's loss and every gradient leaf in float32 against the
                same step in float64 on the card (granite at a dropless E/k,
                and minitron; full width, 2 layers, a loss mask with
                zeros): the largest relative L2 gap within
                `TRAIN_GRAD_LIMIT`, each planted fault's (the aux term
                dropped; the loss mask ignored) past it.  (d) granite at
                full width with 2 layers: 6 steps straight equal, bitwise,
                to 3 steps, an async checkpoint, a restore into a freshly
                made state and 3 more; the checkpoint restored on the CPU
                equal to the card's state; the step's ms with
                `torch.use_deterministic_algorithms` on beside off;
                ``python -m repro_torch.launch.train`` in a subprocess,
                resumed at its checkpoint's step.  (e) adam8bit against
                AdamW from one start over 25 steps: the means of their last
                5 losses within 0.25, the optimizer state's bytes under
                each, one `Compressor` step's int8 levels.
  14. sharded — training and decode over a mesh (`sharding/`,
                `launch/mesh.py`): 4 gloo ranks share the card as
                ``make_host_mesh(data=2, model=2)`` (`spawn_ranks`; NCCL
                refuses two ranks on one device), each rank's program
                `sharded_rank` here.  First every collective the port
                issues on CUDA tensors (float32, bf16, int8) against its
                value.  (a) granite-moe at full width, 2 of 24 layers,
                float32, 3 AdamW steps of 2 x 1,024 tokens at capacity
                1.25, then a prefill and 4 forced decode steps (dropless):
                every loss, parameter leaf and step's logits against the
                same 4-rank program on the CPU from one start, within
                `SHARDED_REL_LIMIT`, and each planted fault past it (one
                data shard's gradients left out of the reduce-scatter,
                the other tp rank's experts, a cache row on the other tp
                rank's slice).  (b) `moe_ffn_sharded` at full width and
                capacity 1.25 on 2 x 4,096 tokens a data shard against
                `moe_ffn_sharded_plain` on the card, drops equal.  (c)
                granite at full width, 4 layers, bf16, 6 AdamW steps of 4 x
                4,096 stream tokens: losses, step ms, each rank's peak
                memory, collective bytes and ms a step by kind, every
                rank's state on the card in its fitted blocks; the state
                saved from the mesh.  (d) granite (dropless), rwkv6-7b and
                hymba-1.5b at full width, 2 layers, float32: a prefill of
                4 x 64 and 16 greedy steps on the mesh (weights gathered
                once; hymba's global cache split over tp, its Mamba state
                by channel) equal to one process's tokens, logits within
                the limit.  (e) (c)'s checkpoint restored on a 1 x 2 mesh
                of 2 new ranks and in this process, bitwise the files.
                (f) the dry run's prediction of (c)'s step (phase 15's
                worker traced it on a fake 2 x 2 world of card tensors
                before the ranks spawned): each collective kind's calls
                and bytes a step equal to rank 0's real steps, the
                argument bytes equal to its state's and batch block's, the
                traced peak within 10 % of a real step's peak.
  15. dryrun — the port's dry run (`launch/dryrun.py`) on the card's host,
                in a process started before phase 4e that runs beside the
                later phases: (f)'s trace, then a few production cells
                (`DRYRUN_CELLS`) over fake worlds of 256 and 512 ranks on
                fake card tensors, every record ``ok``: memory, FLOPs and
                collective bytes a rank.

Launch counts are set to 0 just before each main-path phase (3, 4, 4b, 4c,
4d, 4e, 4f, 5, 10, 12, 13 and 14: the fits, then each fitted classifier's
predict and its netlist check; in 4b before each tick, swap and the boot;
in 4c before the traffic and before the facade; in 4e before the parent's
fit, read after the oracle, the refit process counting its own searches'
launches; in 4f before each replay, the subprocess host's join, replay and
leave, the boot and its first answers, and the evolution RPCs' submit; in
4g each rank counts its own from its start, and the replay is counted from
0; in 12, 13, 14 and 15 nothing may launch, in 14 each rank counts its own
from its start, summed with the parent's, and in 15 the worker counts its
own) and read just after; a kernel of the
path that did not launch fails the run.
Then the script prints a ``{"kernels": [...]}`` line, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --ab DIR

runs this tree's smoke run and DIR's (another checkout, e.g. the parent
commit unpacked with ``git archive``) in turns on one card and prints each
run's kernel times, launch phases and swap numbers (``swap_ms``, the first
post-swap and the steady tick latency), then the medians per tree.

    python3 chip_smoke.py --lm-calibrate N

runs only phase 12's decode-against-forward reading, over N seeds of
weights and prompt, clean and with each planted fault: the readings that
`LM_REL_L2_LIMIT` is set from.

    python3 chip_smoke.py --train-calibrate N

runs only phase 13's float32-against-float64 gradient reading, over N
seeds of weights and batch, clean and with each planted fault: the
readings that `TRAIN_GRAD_LIMIT` is set from.

    python3 chip_smoke.py --sharded-calibrate N

runs only phase 14's (a) over N seeds, clean and with each planted fault,
then (d) once: the readings that `SHARDED_REL_LIMIT` is set from.

    python3 chip_smoke.py --dryrun-worker OUT

is phase 15's worker (the main run starts it): its traces, written to
OUT as JSON.

    python3 chip_smoke.py --evolve-rollbacks N

runs only phase 4e, with the first N promoted canaries forced into a
rollback at their first probation check (their bar set just past their
labeled accuracy): the late rollback that makes the phase serve on past
the benchmark's 2,000 post-shift requests.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import runtime  # noqa: E402
from repro_torch.core import encoding as E  # noqa: E402
from repro_torch.core import fitness as F  # noqa: E402
from repro_torch.core import hardware as hw  # noqa: E402
from repro_torch.core.api import (  # noqa: E402
    DEFAULT_ENCODINGS, AutoTinyClassifier, ServableCircuit, load_servable, save_servable)
from repro_torch.core.evolve import (  # noqa: E402
    EvolveConfig, evolve, evolve_with_history, make_eval_fn)
from repro_torch.core.baselines.gbdt import (  # noqa: E402
    GBDTConfig, balanced_accuracy, gbdt_predict, train_gbdt)
from repro_torch.core.baselines.mlp import (  # noqa: E402
    BEST_MLP, SMALLEST_MLP, mlp_params_from_arrays, mlp_predict, train_mlp)
from repro_torch.core.gates import BUF_A, FULL_FS, NOT_A  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.genome import CircuitSpec, Genome, init_genome, opcodes  # noqa: E402
from repro_torch.core.islands import (  # noqa: E402
    COLLECTIVES, IslandConfig, best_island, evolve_islands_plain, pad_words_for)
from repro_torch.core.mutate import mutate_children  # noqa: E402
from repro_torch.core.netlist import eval_netlist  # noqa: E402
from repro_torch.core.verilog import simulate_verilog  # noqa: E402
from repro_torch.data import load_dataset, train_test_split  # noqa: E402
from repro_torch.kernels import circuit_eval  # noqa: E402
from repro_torch.kernels import ref as plain  # noqa: E402
from repro_torch.kernels.program import compile_program  # noqa: E402
from repro_torch.launch.islands import launch_islands, spawn_ranks  # noqa: E402
from repro_torch.models import attention as lm_attention  # noqa: E402
from repro_torch.models import blocks as lm_blocks  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import rope as lm_rope  # noqa: E402
from repro_torch.data.pipeline import TokenStream  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    init_params, param_dtype, param_shapes, params_from_reference)
from repro_torch.models.lm import CausalLM  # noqa: E402
from repro_torch.train import checkpoint as train_ckpt  # noqa: E402
from repro_torch.train import train_step as train_lib  # noqa: E402
from repro_torch.train.grad_compress import Compressor, quantize_with_feedback  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    OptConfig, init_opt_state, tree_leaves, tree_map)
from repro_torch.runtime import aot  # noqa: E402
from repro_torch.serve.artifacts import ArtifactStore  # noqa: E402
from repro_torch.serve.async_frontend import AsyncCircuitServer  # noqa: E402
from repro_torch.serve.autoscale import (  # noqa: E402
    AutoscaleController, AutoscaleDecision, HysteresisPolicy)
from repro_torch.serve import engine as lm_engine  # noqa: E402
from repro_torch.serve.circuits import (  # noqa: E402
    CircuitRegistry, CircuitServer, StalePlanError, TenantQoS)
from repro_torch.serve.evolution import (  # noqa: E402
    DriftConfig, EvolutionManager, PromotionPolicy, RefitConfig, RefitWorker, ReplayBuffer,
    bit_activation_stats, refit_circuit)
from repro_torch.serve.evolution.refit import _refit_key  # noqa: E402
from repro_torch.serve.fleet import (  # noqa: E402
    FleetRouter, InProcTransport, RebalanceCadence, ServingHost, SocketTransport, dump_bundle,
    generate, load_trace, spawn_host_process)
from repro_torch.serve.observability import TraceRecorder  # noqa: E402
from repro_torch.serve.planning import (  # noqa: E402
    PlacementPolicy, PlanCompiler, circuit_digest, ensemble_vote)

GOLDEN = os.path.join(ROOT, "tests", "torch_golden")
sys.path.insert(0, GOLDEN)
import make_lm_golden  # noqa: E402  (numpy only until its build() runs)
SEED = 0
DEVICE = "cuda"  # every tensor and entry point of the run
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and 32-bit integer
# logic ops/s = 132 SMs x 64 INT32 lanes/clock x 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# (features, bits/input, gates, classes) of the serving benchmark's tenants
SERVE_SHAPES = [(4, 2, 60, 2), (7, 4, 120, 3), (3, 2, 40, 4), (10, 4, 200, 5),
                (6, 2, 80, 2), (12, 4, 300, 8)]
# (inputs, gates, outputs, population, words) for the kernel checks; then
# the evolve path's three: the refit's and the oracle's λ children over a
# 2,048-row window, the parent fit's over 3,000 rows, and the scorer's
# one-circuit predicts and a tick's two slots (live and shadow) of 64 rows;
# last the islands path's: an island rank's λ children over its shard of
# the higgs training words (2,452 / 2)
CHECK_SHAPES = [(4, 10, 1, 1, 2), (8, 50, 1, 4, 11), (16, 100, 2, 5, 32),
                (32, 300, 4, 3, 128), (100, 300, 2, 2, 313), (6, 17, 3, 7, 1),
                (116, 300, 1, 1, 3065), (476, 300, 1, 3, 700),
                (32, 400, 4, 3, 129), (24, 100, 1, 4, 64), (24, 100, 1, 4, 94),
                (24, 100, 1, 2, 6), (116, 300, 1, 4, 1226)]
# the fit path: λ children of a 300-gate genome over the higgs training
# rows at 4 bits per input (I = 29 x 4), at its W and a misaligned W
FIT_CHECK = (116, 300, 1, 4)  # (inputs, gates, outputs, population)
FIT_CHECK_WORDS = (2452, 2453)
FIT_KW = dict(n_gates=300, lam=4, kappa=300, max_gens=2000, seed=SEED)
PARITY_GENS = 200
# the toolflow: the paper's two hardware datasets as benchmarks/hw_costs.py
# fits them (dataset, XGBoost trees, tree depth), with the quickstart's two
# encodings; the baselines as benchmarks/fig9_11_baselines.py trains them
HW_DATASETS = (("blood", 1, 6), ("led", 10, 5))
HW_ENCODINGS = (E.EncodingConfig("quantize", 2), E.EncodingConfig("quantile", 2))
HW_FIT_KW = dict(n_gates=300, kappa=300, max_gens=2000, seed=SEED)
BASELINE_ROWS = 20_000
SMALL_MLP_2BIT = dataclasses.replace(SMALLEST_MLP, weight_bits=2, act_bits=2)
# full width and BEST_MLP's own 60 epochs (about a minute on an H100): the
# script's time needs no cut
BEST_MLP_2BIT = dataclasses.replace(BEST_MLP, weight_bits=2, act_bits=2)
MLP_RUNS = (("blood", SMALL_MLP_2BIT), ("led", SMALL_MLP_2BIT), ("higgs", BEST_MLP_2BIT))
# each MLP's first steps are profiled; the float smallest MLP is trained on
# the card and on the CPU from one start for MLP_PARITY_EPOCHS epochs, and
# its parameters must agree within MLP_PARITY_TOL of the largest one
MLP_PROFILE_STEPS = 100
MLP_PROFILE_ATTEMPTS = 3
MLP_PARITY_EPOCHS = 5
MLP_PARITY_TOL = 1e-4
GBDT_CFG = GBDTConfig(n_rounds=40)  # fig9_11_baselines.py's quick setting
# the paper's Table 2 values the cost model is calibrated to (FlexIC XGBoost)
PAPER_TABLE2 = {"xgb_blood_flexic_area_mm2": 5.4, "xgb_led_flexic_area_mm2": 27.74,
                "xgb_blood_flexic_power_mw": 4.12}
# the async front end: the reference bench's deadline tiers
# (benchmarks/serve_async.py), cycled over the tenants and scaled by 8 as
# the verify skill's CI leg runs it (--deadline-scale 8 --qps 40); open-loop
# Poisson arrivals, each request 1 + Poisson(8) rows
ASYNC_TIERS = (("tight", 0.150), ("standard", 0.400), ("relaxed", 1.500))
ASYNC_SCALE, ASYNC_QPS, ASYNC_S, ASYNC_MEAN_ROWS = 8.0, 40.0, 3.0, 8
PREWARM_SPANS = (1, 2, 4, 8)  # the span buckets such traffic fires at
FACADE_CHUNK = 4096           # golden higgs rows per serve_async request
# autoscale: benchmarks/serve_autoscale.py's load (1 + Poisson(4) rows,
# 2.5 s deadline, 85 % skew onto shard 0's tenants, a control step every
# 0.12 s) at 60 requests/s for 4 s, with a scripted grow and shrink and a
# churned golden bundle
AUTOSCALE_QPS, AUTOSCALE_S, AUTOSCALE_MEAN_ROWS = 60.0, 4.0, 4
AUTOSCALE_DEADLINE_S, AUTOSCALE_SKEW, CONTROL_INTERVAL_S = 2.5, 0.85, 0.12
SCRIPTED_SWAPS = ((1.5, AutoscaleDecision("grow", 3, "scripted grow to 3")),
                  (3.0, AutoscaleDecision("shrink", 2, "scripted shrink to 2")))
CHURN_AT_S = ((0.5, "add"), (1.3, "remove"), (2.1, "add"), (2.9, "remove"))
# evolve: benchmarks/serve_evolve.py's run() at its defaults — 6 features,
# the parent fitted at n = 100 with one 4-bit quantile encoding on 3,000
# pre-shift rows, G = 1,200 and κ = G / 4 for the fit, the refit and the
# oracle; 64-row requests; 10 stationary requests, then a shift of 1.5 until
# 5 requests after the promotion, giving up after EVOLVE_WINDOW post-shift
# requests; a 2,048-row replay window.  One departure: a canary rolled back
# within those 5 requests re-arms the loop (the benchmark would stop with the
# parent live), and the phase serves on past the window, up to
# EVOLVE_MAX_REQUESTS, until a promoted circuit has served 5; the first
# promotion must still come within the window
EVOLVE_TENANT, EVOLVE_FEATS, EVOLVE_GATES = "t0", 6, 100
EVOLVE_ROWS, EVOLVE_GENS, EVOLVE_SHIFT = 64, 1200, 1.5
EVOLVE_WINDOW, EVOLVE_STATIONARY, EVOLVE_TAIL = 2000, 10, 5
EVOLVE_MAX_REQUESTS = 2 * EVOLVE_WINDOW
EVOLVE_REPLAY, EVOLVE_OBSERVE_EVERY = 2048, 2
EVOLVE_TRACE_EVENTS = 1 << 20   # the stack's timeline: about 25 events a request
# fleet: benchmarks/serve_fleet.py's run() at its defaults — 2 in-process
# hosts behind a FleetRouter, 8 tenants of the serving benchmark's shapes
# (benchmarks/serve_circuits.py's make_fleet: a 256-row quantile encoder
# each, the full function set; genomes from the port's generator), a seed-0
# skew trace of 100,000 events replayed in chunks of 2,048 with a
# RebalanceCadence on the trace's clock (a third of the trace), the same
# trace on one host as the oracle; then the CI leg's committed trace at
# chunk 500, a subprocess host, an exported and booted fleet and one host's
# evolution RPCs
FLEET_HOSTS, FLEET_TENANTS, FLEET_EVENTS, FLEET_CHUNK = 2, 8, 100_000, 2048
FLEET_TRACE = os.path.join(ROOT, "benchmarks", "workloads", "fleet_smoke.jsonl.gz")
FLEET_TRACE_CHUNK, FLEET_PROC_EVENTS = 500, 4096
# islands: examples/evolve_distributed.py's layout (4 islands x 2 data
# shards = 8 ranks, all on the one card) on higgs at full size (W = 2,452
# training words, 1,226 per shard), the fit's n = 300, lambda = 4,
# kappa = 300, G = 1,000 and the reference's migrate_every = 32
ISLANDS, ISLAND_SHARDS, ISLAND_GATES, ISLAND_GENS, ISLAND_MIGRATE = 4, 2, 300, 1000, 32
ISLAND_TIMEOUT_S = 600.0
# lm: (a) minitron-8b at full width with 8 of its 32 layers, random bf16
# weights, Engine
# at batch 4 and max_len 512 serving 8 requests of 256-token prompts and
# 32 new tokens, greedy; (b) starcoder2-7b at full width with 4 of its 32
# layers, one 4,608-token prompt (a multiple of both chunk sizes, past the
# 4,096 window) and 8 decoded tokens; (c) the committed reference fixtures
# in float32, within the CPU tests' tolerance; (d) the expert and SSM archs
# served as (a): granite-moe-1b-a400m at full width with 8 of its 24
# layers, rwkv6-7b and hymba-1.5b with 8 of their 32 (hymba's layer 0
# global, the rest sliding), arctic-480b at full width with 1 of its 35
# layers (35 are 477 B parameters, past one card's 80 GB); (e) the last
# four archs served as (a): stablelm-12b at full size (40 layers, head_dim
# 160), qwen2-vl-7b with 8 of its 28 layers, musicgen-medium with 8 of its
# 48, llama3-405b at full width with 2 of its 126 layers (its float32
# check at 4 would hold 67.8 GB of weights alone); (f) the two embedding
# frontends' own path (`LM_FRONTENDS`): seeded embeddings made on the card
# in the model's dtype, qwen2-vl's prompt an image of `LM_IMAGE_GRID`
# patches at distinct (t, h, w) ids then text, each decode step fed the
# greedy token's embedding row
LM_REQUESTS, LM_BATCH, LM_PROMPT, LM_NEW, LM_MAX_LEN = 8, 4, 256, 32, 512
STARCODER_LAYERS, STARCODER_PROMPT, STARCODER_NEW = 4, 4608, 8
LM_NEW_MODELS = ("granite-moe-1b-a400m", "arctic-480b", "rwkv6-7b", "hymba-1.5b",
                 "stablelm-12b", "qwen2-vl-7b", "musicgen-medium", "llama3-405b")
LM_FRONTENDS = ("qwen2-vl-7b", "musicgen-medium")
LM_IMAGE_GRID = (12, 16)        # 192 of the 256-token prompt, then 64 of text
LM_FRAME_SEED = 1000            # the frontends' embeddings: SEED + this
# depth cuts: arctic's and llama3's for one card's memory, the others for
# the script's time (PERF.md §4); stablelm runs at full depth
LM_LAYERS = {"starcoder2-7b": STARCODER_LAYERS, "arctic-480b": 1, "minitron-8b": 8,
             "granite-moe-1b-a400m": 8, "rwkv6-7b": 8, "hymba-1.5b": 8,
             "qwen2-vl-7b": 8, "musicgen-medium": 8, "llama3-405b": 2}
# the decode-against-forward request of each model: (prompt, new tokens,
# max_len).  rwkv6's prompt is no multiple of the wkv chunk of 16 (the
# padding path); hymba's wraps the 1,024-slot ring of its sliding layers
# while its global layers keep every token
LM_CHECK = {"minitron-8b": (LM_PROMPT, LM_NEW, LM_MAX_LEN),
            "starcoder2-7b": (STARCODER_PROMPT, STARCODER_NEW, STARCODER_PROMPT + STARCODER_NEW),
            "granite-moe-1b-a400m": (LM_PROMPT, LM_NEW, LM_MAX_LEN),
            "arctic-480b": (LM_PROMPT, LM_NEW, LM_MAX_LEN),
            "rwkv6-7b": (251, LM_NEW, LM_MAX_LEN),
            "hymba-1.5b": (1280, LM_NEW, 1344),
            **{arch: (LM_PROMPT, LM_NEW, LM_MAX_LEN) for arch in (
                "stablelm-12b", "qwen2-vl-7b", "musicgen-medium", "llama3-405b")}}
LM_GOLDEN_TOL = 1e-5
# decode against `forward` over the same sequence, on float32 weights
# (`decode_check`): at every position the relative L2 gap of the logits,
# ||decode - forward|| / ||forward|| over the vocabulary, stays within this
# limit, and each planted fault (`LM_FAULTS`, planted in a decode of the
# same tokens by `forced_decode`) goes past it.  The limit is twice the
# largest clean gap that `python3 chip_smoke.py --lm-calibrate 4` read over
# 4 seeds (H100 80GB HBM3, 700 W; PERF.md §6): minitron 2.309e-6 (32
# layers; 2.345e-6 at 8), starcoder2 (4 layers) 3.560e-6, granite-moe
# 1.121e-6 (24 layers; 1.181e-6 at 8), arctic (1 layer) 4.141e-6, rwkv6
# (8 layers) 2.670e-5 (float32 rounding through the wkv recurrence: in
# float64 decode and forward agree to 1e-12, `tests/test_torch_moe_ssm.py`;
# 1.472e-4 at 32 layers), hymba 5.004e-6 (32 layers; 5.103e-6 at 8),
# stablelm (40 layers) 4.485e-6, qwen2-vl (8 layers) 3.553e-6 and on its
# embeddings request (``/embeds``: `frontend_prompt`) 5.469e-6, musicgen
# (8 layers) 1.474e-6 and 1.826e-6, llama3 (2 layers) 9.949e-6.  A
# depth cut keeps a limit unless twice its own maximum is tighter (rwkv6's
# was); each kept limit is at least 1.96x its 8-layer maximum.
# Every fault landed at least 1,400x past its model's clean gap (a fault
# within 3x would be read, not checked; the new requests' smallest,
# musicgen's zeroed cache row, 0.02556, 8,670x past its limit).  The
# expert archs are checked at a dropless capacity factor E/k (at the
# production 1.25 a decode step drops pairs that `forward` keeps)
LM_REL_L2_LIMIT = {"minitron-8b": 4.62e-6, "starcoder2-7b": 7.12e-6,
                   "granite-moe-1b-a400m": 2.24e-6, "arctic-480b": 8.28e-6,
                   "rwkv6-7b": 5.34e-5, "hymba-1.5b": 1.00e-5,
                   "stablelm-12b": 8.98e-6, "qwen2-vl-7b": 7.11e-6,
                   "qwen2-vl-7b/embeds": 1.10e-5, "musicgen-medium": 2.95e-6,
                   "musicgen-medium/embeds": 3.66e-6, "llama3-405b": 1.99e-5}
LM_FAULTS = {arch: ("rope_position_plus_one", "cache_row_zeroed")
             for arch in ("minitron-8b", "starcoder2-7b", "granite-moe-1b-a400m", "arctic-480b",
                          "stablelm-12b", "qwen2-vl-7b", "musicgen-medium", "llama3-405b",
                          "musicgen-medium/embeds")}
LM_FAULTS["rwkv6-7b"] = ("wkv_state_zeroed", "token_shift_zeroed")
LM_FAULTS["hymba-1.5b"] = ("rope_position_plus_one", "mamba_state_zeroed", "cache_row_zeroed")
# in decode M-RoPE's three ids are equal: only the prefill's cache tests it
LM_FAULTS["qwen2-vl-7b/embeds"] = ("rope_position_plus_one", "cache_row_zeroed",
                                   "mrope_hw_dropped")
# the decode step's recurrent state, read and written once (decode_bound)
LM_STATE_KEYS = ("s", "last_x", "last_xc", "m_h", "m_conv")

# train: (a) granite-moe-1b-a400m at full size (24 layers, d 1,024, vocab
# 49,155, 32 experts top-8 at capacity 1.25, remat "full", bf16 weights,
# AdamW, its config's optimizer) on the seeded structured TokenStream at
# 4 x 4,096 tokens, the largest batch whose step fits beside the state
# (PERF.md §6); (b) minitron-8b at full width with 2 of its 32 layers
# and its 2 microbatches; (c) the float32 gradient check against float64;
# (d) resume; (e) adam8bit against AdamW.  (b)–(e) cut granite and
# minitron to `TRAIN_CUT_LAYERS` layers, never their widths.
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 4096, 12, 3e-4
# the mean loss of the last 3 steps lies at least this far below step 0's
# (PERF.md §6: 0.0674 read after 12 steps in a first run, which the same
# seed repeats; the loss rises in the first steps, as Adam moves every
# weight by ±lr, and falls by 0.149 after 30)
TRAIN_LOSS_FALL = 0.04
TRAIN_CUT_LAYERS = 2
MINITRON_BATCH, MINITRON_STEPS = 2, 3
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 1024   # (c), (d) and (e)
RESUME_STEPS, ADAM8_STEPS, ADAM8_BAND = 6, 25, 0.25
BF16_DENSE_FLOPS = 989e12   # the H100's dense bf16 peak (SXM data sheet)
# (c): the largest relative L2 gap of the float32 loss and of any gradient
# leaf against the same step in float64 on the card, twice the largest
# clean gap that `python3 chip_smoke.py --train-calibrate 3` read
# (H100 80GB HBM3, 700 W; PERF.md §6): granite 8.828e-6, minitron
# 1.434e-5; each planted fault (`TRAIN_FAULTS`) must go past it: their
# smallest gaps were 0.0509 (granite's aux term dropped) and 0.4994 (the
# mask ignored), 2,880x past the limit at least
TRAIN_GRAD_LIMIT = {"granite-moe-1b-a400m": 1.77e-5, "minitron-8b": 2.87e-5}
TRAIN_FAULTS = {"granite-moe-1b-a400m": ("aux_dropped", "loss_mask_ignored"),
                "minitron-8b": ("loss_mask_ignored",)}


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


def launch_counts() -> dict:
    return {k.name: k.launches for k in circuit_eval.KERNELS}


def cut_depth(cfg: ModelConfig, layers: "int | None") -> ModelConfig:
    """``cfg`` with its first ``layers`` layers (all of them for
    ``None``), never a narrower one: a hybrid keeps the global layers that
    lie under the cut."""
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers, global_layers=tuple(
        i for i in cfg.global_layers if i < layers))


def to_dev(*ts):
    return [t.to(DEVICE) for t in ts]


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


def fit_population(g, n_in, n, n_out, pop, w):
    """λ = pop children of a random genome (the full gate set), as the fit
    path makes them: half at the search's rate 1/n, half at 0.05, beside
    random words."""
    spec = CircuitSpec(n_in, n, n_out, FULL_FS)
    parent = init_genome(g, spec)
    kids = [mutate_children(g, parent, spec, rate, k)
            for rate, k in ((1 / n, pop - pop // 2), (0.05, pop // 2)) if k]
    gate_fn, edge, outs = (torch.cat(parts) for parts in zip(*kids))
    x = torch.randint(-2**31, 2**31 - 1, (n_in, w), generator=g, dtype=torch.int32)
    return spec.fn_table()[gate_fn.long()], edge, outs, x


def corrupt_population(g, n_in, n, n_out, pop, w):
    """Genomes outside the contract: ids anywhere in [-2(I+n), 2(I+n))
    (negative, forward and past-the-end) and opcodes in [-2, 16)."""
    t = n_in + n
    opc = torch.randint(-2, 16, (pop, n), generator=g, dtype=torch.int32)
    edge = torch.randint(-2 * t, 2 * t, (pop, n, 2), generator=g, dtype=torch.int32)
    outs = torch.randint(-2 * t, 2 * t, (pop, n_out), generator=g, dtype=torch.int32)
    x = torch.randint(-2**31, 2**31 - 1, (n_in, w), generator=g, dtype=torch.int32)
    return opc, edge, outs, x


def span_case(g, n_in, pop, w):
    """Spans launch arguments for a check shape: pop + 1 launch slots with
    repeats and one negative slot id, misaligned, negative and off-the-end
    word offsets, per-circuit widths from 0 to I, and one pad slot
    (live = 0).  Returns (slots, word_off, in_width, live, span)."""
    span = max(1, w // 3)
    k = pop + 1
    slots = torch.tensor([(3 * j + 1) % pop for j in range(k - 1)] + [-1],
                         dtype=torch.int32)
    woff = torch.tensor([(7 * j + 1) % w - (j % 2) * w for j in range(k)],
                        dtype=torch.int32)
    iw = torch.randint(0, n_in + 1, (pop,), generator=g, dtype=torch.int32)
    live = torch.tensor([int(j % 4 != 2) for j in range(k)], dtype=torch.int32)
    return slots, woff, iw, live, span


def spans_by_genome(opc, edge, outs, x, slots, woff, iw, live, span):
    """The genome-level plain version of one spans launch: the reference's
    fused tick (gather the slots' genomes, mask the widths), then spans."""
    s = plain.land_slots(slots, opc.shape[0])
    return plain.eval_population_spans_packed(opc[s], edge[s], outs[s], x, woff,
                                              iw[s] * live, span_words=span)


# -- phase 1 ----------------------------------------------------------------
def ptxas_report(log: list[str]) -> dict:
    """Each kernel's ``ptxas -v`` lines: registers, barriers, stack and
    spills."""
    out, kernel = {}, None
    for ln in log:
        if "Compiling entry function" in ln or "Function properties for" in ln:
            kernel = next((k for k in ("eval_program_spans_kernel", "eval_program_kernel")
                           if k in ln), None)
        elif kernel and ("Used" in ln or "spill" in ln):
            out.setdefault(kernel, []).append(ln.split("info    :")[-1].strip())
    return out


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
        "ptxas": ptxas_report(log),
    }
    emit(env)
    return env


# -- phase 2 ----------------------------------------------------------------
def check_pair(stats, name, got, want_genome, want_program) -> None:
    """Fold one kernel result into ``stats[name]``: [cases, mismatches
    against the genome-level plain version, against the program-level
    one, max |difference|]."""
    torch.cuda.synchronize()
    s = stats[name]
    s[0] += 1
    for i, want in ((1, want_genome), (2, want_program)):
        bad, err = mismatch(got, want)
        s[i] += bad
        s[3] = max(s[3], err)


def phase_kernel_checks() -> dict:
    g = torch.Generator().manual_seed(SEED)
    stats = {"eval_population": [0, 0, 0, 0], "eval_population_spans": [0, 0, 0, 0]}
    for shape in CHECK_SHAPES:
        n_in, n, n_out, pop, w = shape
        for make in (random_population, corrupt_population):
            opc, edge, outs, x = to_dev(*make(g, *shape))
            prog = compile_program(opc, edge, outs, n_in).to(DEVICE)
            check_pair(stats, "eval_population", circuit_eval.eval_program(prog, x),
                       plain.eval_population_packed(opc, edge, outs, x),
                       plain.eval_program(prog, x))
            slots, woff, iw, live, span = span_case(g, n_in, pop, w)
            slots, woff, iw, live = to_dev(slots, woff, iw, live)
            check_pair(stats, "eval_population_spans",
                       circuit_eval.eval_program_spans(prog, x, slots, woff, iw, live,
                                                       span_words=span),
                       spans_by_genome(opc, edge, outs, x, slots, woff, iw, live, span),
                       plain.eval_program_spans(prog, x, slots, woff, iw, live,
                                                span_words=span))
    # the fit path's shape: λ mutated children over the training words
    fit_bad = 0
    for w in FIT_CHECK_WORDS:
        n_in = FIT_CHECK[0]
        opc, edge, outs, x = to_dev(*fit_population(g, *FIT_CHECK, w))
        prog = compile_program(opc, edge, outs, n_in).to(DEVICE)
        before = stats["eval_population"][1] + stats["eval_population"][2]
        check_pair(stats, "eval_population", circuit_eval.eval_program(prog, x),
                   plain.eval_population_packed(opc, edge, outs, x),
                   plain.eval_program(prog, x))
        fit_bad += stats["eval_population"][1] + stats["eval_population"][2] - before
    # isolation: rows past in_width are invisible even to edges that read them
    opc, edge, outs, x = to_dev(*random_population(g, 8, 10, 2, 1, 4))
    prog = compile_program(opc, edge, outs, 8).to(DEVICE)
    poisoned, clean = x.clone(), x.clone()
    poisoned[5:] = 0x5EADBEEF
    clean[5:] = 0
    zero, one, five = to_dev(*(torch.full((1,), v, dtype=torch.int32) for v in (0, 1, 5)))
    a = circuit_eval.eval_program_spans(prog, poisoned, zero, zero, five, one, span_words=4)
    b = circuit_eval.eval_program_spans(prog, clean, zero, zero, five, one, span_words=4)
    bad, _ = mismatch(a, b)
    stats["eval_population_spans"][1] += bad
    out = {"phase": "kernels", "isolation_mismatches": bad,
           "fit_shape": {"shape": dict(zip(("I", "n", "O", "P"), FIT_CHECK)),
                         "words": FIT_CHECK_WORDS, "mismatches": fit_bad}}
    for name, (cases, bad_g, bad_p, err) in stats.items():
        out[name] = {"cases": cases, "mismatches_vs_genome": bad_g,
                     "mismatches_vs_program": bad_p, "max_abs_err": err}
        check(bad_g == 0 and bad_p == 0,
              f"{name}: {bad_g} + {bad_p} words differ from the plain versions")
    emit(out)
    return {k: {"mismatches": v[1] + v[2], "max_abs_err": v[3]} for k, v in stats.items()}


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
        results[name] = sc.predict(ds.x, device=DEVICE)
        results[name + "_s"] = time.perf_counter() - t0
    launches = launch_counts()
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


def draw_work(rng, tenants, sources, n_requests) -> list:
    """``n_requests`` requests round-robin over ``tenants``: (tenant, first
    row, rows), 1 to 700 rows each, cut from the tenant's source rows."""
    work = []
    for r in range(n_requests):
        tenant = tenants[r % len(tenants)]
        x_all, _ = sources[tenant]
        size = min(int(rng.choice([1, 3, 17, 64, 200, 700])), len(x_all) - 1)
        lo = int(rng.randint(0, len(x_all) - size))
        work.append((tenant, lo, size))
    return work


def expected_ids(work, sources, members) -> dict:
    """Per tenant, the ids each of its requests must get: one predict on
    the card per member over all the tenant's rows, voted over
    ``members[tenant]`` and split per request."""
    expect = {}
    for tenant, ms in members.items():
        mine = [(lo, size) for t, lo, size in work if t == tenant]
        if not mine:
            continue
        x_all, _ = sources[tenant]
        x = np.concatenate([x_all[lo:lo + s] for lo, s in mine])
        ids = np.stack([m.predict(x, device=DEVICE) for m in ms])
        expect[tenant] = np.split(ensemble_vote(ids, ms[0].n_classes),
                                  np.cumsum([s for _, s in mine])[:-1])
    return expect


def count_mismatches(server, work, tickets, sources, expect) -> tuple[int, int]:
    """(requests whose ids differ from ``expect``, golden requests whose
    ids differ from the reference's committed ids); reads every ticket
    once."""
    seen = {t: 0 for t in expect}
    bad = gold_bad = 0
    for (tenant, lo, size), ticket in zip(work, tickets):
        got = server.result(ticket)
        want = expect[tenant][seen[tenant]]
        seen[tenant] += 1
        bad += int(got.shape != want.shape or (got != want).any())
        gold_ids = sources[tenant][1]
        if gold_ids is not None:
            gold_bad += int((got != gold_ids[lo:lo + size]).any())
    return bad, gold_bad


def phase_serve(gold, n_ticks=3, requests_per_tick=240) -> tuple:
    reg, sources = build_registry(gold)
    tenants = list(reg)
    members = {t: reg.members(t) for t in tenants}
    rng = np.random.RandomState(SEED + 1)
    out = {"phase": "serve", "tenants": len(tenants),
           "slots": sum(len(reg.members(t)) for t in tenants), "runs": []}
    total = {k.name: 0 for k in circuit_eval.KERNELS}
    timing_case = None
    for n_shards in (1, 2):
        server = CircuitServer(reg, device=DEVICE, policy=PlacementPolicy(n_shards=n_shards))
        plan = server.plan()
        ticks = []
        for _ in range(n_ticks):
            work = draw_work(rng, tenants, sources, requests_per_tick)
            # expectations first, on the card, outside the counted window
            expect = expected_ids(work, sources, members)
            circuit_eval.reset_launch_counts()
            tickets = [server.submit(t, sources[t][0][lo:lo + s]) for t, lo, s in work]
            t0 = time.perf_counter()
            report = server.tick()
            tick_s = time.perf_counter() - t0
            counts = launch_counts()
            for k, v in counts.items():
                total[k] += v
            bad, gold_bad = count_mismatches(server, work, tickets, sources, expect)
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
                profile_case = (server, [(t, sources[t][0][lo:lo + s]) for t, lo, s in work])
        out["runs"].append({"n_shards": n_shards, "plan_hash": plan.content_hash,
                            "ticks": ticks})
    check(total["eval_population_spans"] > 0, "serve never launched the spans kernel")
    out["launches"] = total
    emit(out)
    return total, timing_case, profile_case


# -- phase 4b: swap ----------------------------------------------------------
# a fresh process boots from the exported store: loads the registry,
# rebuilds the exact plan with compile_from_placement, preloads the
# stored span-launch units and answers the probe rows; it reports the
# cold work it did (programs compiled, nvcc runs) and each step's wall ms
BOOT_SCRIPT = r"""
import json, os, sys, time
import numpy as np
import torch
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
from repro_torch.kernels import circuit_eval
from repro_torch.runtime import aot
from repro_torch.serve.artifacts import ArtifactStore
from repro_torch.serve.circuits import CircuitServer
from repro_torch.serve.planning import PlacementPolicy

path, spawned = sys.argv[1], float(sys.argv[2])
aot.reset_compile_count(); aot.reset_build_count(); circuit_eval.reset_launch_counts()
clock = time.perf_counter
ms = {"imports_ms": (time.time() - spawned) * 1e3}
t = clock(); torch.zeros(1, device="cuda"); torch.cuda.synchronize()
ms["cuda_init_ms"] = (clock() - t) * 1e3
t = clock()
store = ArtifactStore(path)
reg = store.load_registry()
with open(os.path.join(path, "plan.json")) as f:
    meta = json.load(f)
probes = dict(np.load(os.path.join(path, "probe.npz")))
ms["store_load_ms"] = (clock() - t) * 1e3
t = clock()
server = CircuitServer(reg, device="cuda", policy=PlacementPolicy(n_shards=meta["n_shards"]))
plan = server.compiler.compile_from_placement(reg.catalog(), meta["placement"], meta["n_shards"])
server.swap_plan(plan, action="boot", reason="artifact", prewarm=False)
ms["plan_rebuild_ms"] = (clock() - t) * 1e3
t = clock()
summary = server.preload_executables(store)
torch.cuda.synchronize()
ms["preload_ms"] = (clock() - t) * 1e3
t = clock()
tickets = {name: server.submit(name, x) for name, x in probes.items()}
report = server.tick()
ids = {name: server.result(k) for name, k in tickets.items()}
ms["first_tick_ms"] = (clock() - t) * 1e3
ms["start_to_first_answer_ms"] = (time.time() - spawned) * 1e3
np.savez(os.path.join(path, "cold_ids.npz"), **ids)
print(json.dumps({"boot": {
    "wall_ms": ms, "plan_hash": plan.content_hash, "compile_count": aot.compile_count(),
    "build_count": aot.build_count(), "preload": summary, "aot_stats": server.aot_stats,
    "launches": {k.name: k.launches for k in circuit_eval.KERNELS},
    "tick_launches": report.launches, "span_words": report.span_words}}))
"""


class PathCounts:
    """Launches of one main path, and the programs it compiled, summed over
    the calls that drive it: each call runs with the launch counts set to
    0 just before it and read just after, so the predicts that check the
    path between calls are not counted."""

    def __init__(self):
        self.total = {k.name: 0 for k in circuit_eval.KERNELS}
        self.programs = 0

    def __call__(self, fn, *args, **kw):
        circuit_eval.reset_launch_counts()
        programs = aot.compile_count()
        try:
            return fn(*args, **kw)
        finally:
            for k, v in launch_counts().items():
                self.total[k] += v
            self.programs += aot.compile_count() - programs


def swap_tick(drive, server, rng, reg, sources, members, n_requests=240) -> dict:
    """One tick of fresh traffic over every tenant of ``reg``, its ids
    held to ``members``' vote."""
    work = draw_work(rng, list(reg), sources, n_requests)
    expect = expected_ids(work, sources, members)
    tickets = [server.submit(t, sources[t][0][lo:lo + s]) for t, lo, s in work]
    return run_tick(drive, server, work, tickets, sources, expect)


def run_tick(drive, server, work, tickets, sources, expect) -> dict:
    """Tick the server (counted), check every ticket once against
    ``expect``; latency by the host clock around the tick, which ends in
    the readback."""
    units = server.aot_stats["compiles"]
    spans = drive.total["eval_population_spans"]
    t0 = time.perf_counter()
    report = drive(server.tick)
    tick_ms = (time.perf_counter() - t0) * 1e3
    bad, gold_bad = count_mismatches(server, work, tickets, sources, expect)
    check(bad == 0 and gold_bad == 0, f"swap: {bad} requests differ from predict, "
          f"{gold_bad} from the golden ids")
    check(not server._results, "swap: a request was answered twice")
    spans = drive.total["eval_population_spans"] - spans
    check(spans == report.launches, f"swap: {spans} spans launches for {report.launches} "
          "busy shards")
    return {"tick_ms": tick_ms, "launches": report.launches, "span_words": report.span_words,
            "shards": report.plan_shards, "rows": report.rows,
            "units_built": server.aot_stats["compiles"] - units,
            "launch_phase_ms": report.phase_s["launch"] * 1e3}


def checked_swap(drive, server, plan, label: str, **kw) -> dict:
    """``swap_plan`` (prewarmed) with requests pending; the event's reuse
    must be the shards whose content hash the old plan already had.
    Returns the event and the units the prewarm built or warmed."""
    old = {s.content_hash for s in server.peek_plan().shards}
    before = dict(server.aot_stats)
    event = drive(server.swap_plan, plan, **kw)
    reused = sum(s.content_hash in old for s in plan.shards)
    check(event.shards_reused == reused and event.shards_rebuilt == len(plan.shards) - reused,
          f"swap {label}: {event.shards_reused} reused, {event.shards_rebuilt} rebuilt; "
          f"{reused} shards were untouched")
    check(event.inflight_requests > 0, f"swap {label}: nothing was pending")
    check(server.peek_plan() is plan, f"swap {label}: the plan was not installed")
    prewarm = {k: server.aot_stats[k] - before[k] for k in ("compiles", "exec_warms", "loads")}
    check(prewarm["compiles"] > 0 and prewarm["exec_warms"] >= prewarm["compiles"],
          f"swap {label}: the prewarm before the fence built {prewarm}")
    return {"event": dataclasses.asdict(event), "prewarm": prewarm}


def cold_boot(server, reg, probes: dict) -> tuple:
    """Export the registry and the span-launch units to an `ArtifactStore`
    (the plan's placement beside it as JSON), boot a fresh process from
    it and return (its report, ids that differ from the warm server's,
    units stored, export ms)."""
    tickets = {t: server.submit(t, x) for t, x in probes.items()}
    server.tick()
    warm_ids = {t: server.result(k) for t, k in tickets.items()}
    build = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(build, exist_ok=True)
    path = tempfile.mkdtemp(prefix="swap_store_", dir=build)
    try:
        store = ArtifactStore(path)
        store.put_registry(reg)
        t0 = time.perf_counter()
        keys = server.export_executables(store)
        export_ms = (time.perf_counter() - t0) * 1e3
        plan = server.plan()
        with open(os.path.join(path, "plan.json"), "w") as f:
            json.dump({"n_shards": plan.n_shards, "plan_hash": plan.content_hash,
                       "placement": {t: [[int(r.shard), int(r.slot)] for r in refs]
                                     for t, refs in plan.placement.items()}}, f)
        np.savez(os.path.join(path, "probe.npz"), **probes)
        spawned = time.time()
        res = subprocess.run([sys.executable, "-c", BOOT_SCRIPT, path, repr(spawned)],
                             cwd=ROOT, capture_output=True, text=True, timeout=300)
        process_ms = (time.time() - spawned) * 1e3
        check(res.returncode == 0, f"swap: the cold boot failed:\n{res.stderr[-3000:]}")
        boot = json.loads(res.stdout.strip().splitlines()[-1])["boot"]
        cold = np.load(os.path.join(path, "cold_ids.npz"))
        bad = sum(int(cold[t].shape != warm_ids[t].shape or (cold[t] != warm_ids[t]).any())
                  for t in warm_ids)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    boot["process_wall_ms"] = process_ms
    check(boot["plan_hash"] == plan.content_hash,
          "boot: compile_from_placement rebuilt another plan")
    return boot, bad, keys, export_ms


def phase_swap(gold) -> dict:
    """Plan swaps, a shadow slot, export and a cold boot on the card, at
    the serve phase's width (steps a–e of the module doc)."""
    reg, sources = build_registry(gold)
    rng = np.random.RandomState(SEED + 5)
    g = torch.Generator().manual_seed(SEED + 5)
    members = {t: reg.members(t) for t in reg}
    drive = PathCounts()
    t_phase = time.perf_counter()
    server = CircuitServer(reg, device=DEVICE)
    out = {"phase": "swap", "card": gpu_line(), "tenants": len(reg)}
    # (a) warm up
    out["warm_ticks"] = [swap_tick(drive, server, rng, reg, sources, members)
                         for _ in range(3)]
    # (b) a new tenant (a golden bundle under a new name), its requests
    # pending across a prewarmed swap
    reg.add("led_v2", gold["led"][0])
    sources["led_v2"], members["led_v2"] = sources["led"], reg.members("led_v2")
    work = draw_work(rng, list(reg), sources, 240)
    expect = expected_ids(work, sources, members)
    tickets = [server.submit(t, sources[t][0][lo:lo + s]) for t, lo, s in work]
    prewarmed = server.spans_seen()
    add = checked_swap(drive, server, server.compiler.recompile(reg.catalog(),
                                                                server.peek_plan()),
                       "add", action="swap", reason="tenant added")
    add["first_tick"] = run_tick(drive, server, work, tickets, sources, expect)
    check(add["first_tick"]["span_words"] not in prewarmed
          or add["first_tick"]["units_built"] == 0,
          "swap: the first tick after a prewarmed swap built a unit")
    add["next_ticks"] = [swap_tick(drive, server, rng, reg, sources, members)
                         for _ in range(2)]
    out["add"] = add
    # (c) grow to two shards; then a plan compiled before a registry change
    grow = PlanCompiler(server.backend, PlacementPolicy(n_shards=2))
    work = draw_work(rng, list(reg), sources, 240)
    expect = expected_ids(work, sources, members)
    tickets = [server.submit(t, sources[t][0][lo:lo + s]) for t, lo, s in work]
    out["grow"] = checked_swap(drive, server, grow.recompile(reg.catalog(), server.peek_plan()),
                               "grow", compiler=grow, action="grow", reason="1 -> 2 shards")
    check(out["grow"]["event"]["to_shards"] == 2 and server.policy.n_shards == 2,
          "swap: the plan did not grow")
    out["grow"]["first_tick"] = run_tick(drive, server, work, tickets, sources, expect)
    stale = grow.recompile(reg.catalog(), server.peek_plan())
    reg.add("late", gold["higgs"][0])
    try:
        drive(server.swap_plan, stale)
        refused = False
    except StalePlanError:
        refused = True
    check(refused, "swap: a stale plan was installed")
    reg.remove("late")
    out["grow"]["stale_plan_refused"] = refused
    # (d) a shadow fourth member on the ensemble: the served ids stay the
    # 3-member vote, the hook gets the shadow member's own ids
    shadow = make_tenant(g, rng, 7, 4, 80, 3)
    seen = []
    server.shadow_hook = lambda tenant, shadow_ids, served: seen.append(
        (tenant, shadow_ids[0]))
    server.set_shadow("ensemble", 4, 1)
    reg.add_ensemble("ensemble", (*members["ensemble"], shadow), replace=True)
    work = draw_work(rng, list(reg), sources, 240)
    expect = expected_ids(work, sources, members)
    tickets = [server.submit(t, sources[t][0][lo:lo + s]) for t, lo, s in work]
    shadow_tick = run_tick(drive, server, work, tickets, sources, expect)
    x = np.concatenate([sources["ensemble"][0][lo:lo + s]
                        for t, lo, s in work if t == "ensemble"])
    check(len(seen) == 1 and seen[0][0] == "ensemble", f"swap: {len(seen)} shadow hook calls")
    shadow_bad = int((seen[0][1] != shadow.predict(x, device=DEVICE)).sum())
    check(shadow_bad == 0, f"swap: {shadow_bad} shadow ids differ from the member's predict")
    server.clear_shadow("ensemble")
    reg.add_ensemble("ensemble", members["ensemble"], replace=True)
    out["shadow"] = {"tick": shadow_tick, "rows": len(x), "shadow_mismatches": shadow_bad}
    # (e) export, then a cold boot in a fresh process
    probes = {t: sources[t][0][:300] for t in reg}
    boot, boot_bad, keys, export_ms = drive(cold_boot, server, reg, probes)
    check(boot["compile_count"] == 0 and boot["build_count"] == 0,
          f"boot: compiled {boot['compile_count']} programs, ran nvcc {boot['build_count']} "
          "times")
    check(boot["preload"]["loaded"] == len(keys) and boot["preload"]["load_failures"] == 0
          and boot["aot_stats"]["compiles"] == 0,
          f"boot: {boot['preload']} for {len(keys)} stored units, {boot['aot_stats']}")
    check(boot["launches"]["eval_population_spans"]
          == boot["preload"]["exec_warmed"] + boot["tick_launches"],
          f"boot: launches {boot['launches']}")
    check(boot_bad == 0, f"boot: {boot_bad} tenants' ids differ from the warm server's")
    steady = [t["tick_ms"] for t in out["warm_ticks"][1:] + add["next_ticks"]]
    out.update({
        "export": {"units": len(keys), "export_ms": export_ms},
        "boot": {**boot, "mismatches": boot_bad},
        "aot_stats": dict(server.aot_stats), "programs_compiled": drive.programs,
        "first_post_swap_tick_ms": add["first_tick"]["tick_ms"],
        "steady_tick_ms_median": statistics.median(steady),
        "events": [dataclasses.asdict(e) for e in server.stats.rebalances],
        "launches": drive.total, "wall_s": time.perf_counter() - t_phase,
    })
    emit(out)
    check(drive.total["eval_population"] == 0, "swap: the path launched eval_population")
    busy = server.stats.launches
    check(drive.total["eval_population_spans"] == busy + server.aot_stats["exec_warms"],
          f"swap: {drive.total['eval_population_spans']} spans launches; ticks made {busy} "
          f"and the prewarms {server.aot_stats['exec_warms']}")
    return {"swap": drive.total["eval_population_spans"],
            "boot": boot["launches"]["eval_population_spans"]}


# -- phases 4c and 4d: the async front end and autoscale ---------------------
def poisson_schedule(rng, weights: dict, qps, duration_s, mean_rows, sources) -> list:
    """Open-loop arrivals drawn up front: ``(t, tenant, first row, rows)``,
    a Poisson process at ``qps`` in all, each request's tenant drawn by
    ``weights`` and its 1 + Poisson(``mean_rows``) rows cut from the
    tenant's source rows."""
    tenants = list(weights)
    p = np.array([weights[t] for t in tenants], np.float64)
    p /= p.sum()
    out, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / qps))
        if t >= duration_s:
            return out
        tenant = tenants[int(rng.choice(len(tenants), p=p))]
        rows = 1 + int(rng.poisson(mean_rows))
        lo = int(rng.randint(0, len(sources[tenant][0]) - rows))
        out.append((t, tenant, lo, rows))


def replay(fe, schedule, sources, on_time=None) -> tuple:
    """Replay ``schedule`` on the wall clock through ``fe.enqueue`` (the
    background scheduler thread fires); ``on_time(elapsed)`` runs before each
    arrival.  Returns the admitted ``(tenant, lo, rows, future)`` and the
    tenants turned away at the door (unknown: churned away)."""
    admitted, refused = [], []
    t0 = time.monotonic()
    for t, tenant, lo, rows in schedule:
        if on_time is not None:
            on_time(time.monotonic() - t0)
        delay = t0 + t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        try:
            fut = fe.enqueue(tenant, sources[tenant][0][lo:lo + rows])
        except KeyError:
            refused.append(tenant)
            continue
        admitted.append((tenant, lo, rows, fut))
    return admitted, refused


def future_mismatches(admitted, sources, members, may_fail=()) -> dict:
    """Every admitted future must be resolved; a failed one is allowed only
    for tenants in ``may_fail`` (churned away).  The served ones are held
    to ``members``' vote by predict on the card (and the golden tenants to
    the committed ids)."""
    served, failed = [], 0
    for tenant, lo, rows, fut in admitted:
        check(fut.done(), f"a future of {tenant} was never resolved")
        err = fut.exception(0)
        if err is not None:
            check(tenant in may_fail and isinstance(err, KeyError),
                  f"a request of {tenant} failed: {type(err).__name__}: {err}")
            failed += 1
            continue
        served.append((tenant, lo, rows, fut.result(0)))
    work = [(t, lo, n) for t, lo, n, _ in served]
    expect = expected_ids(work, sources, {t: members[t] for t in {w[0] for w in work}})
    seen = {t: 0 for t in expect}
    bad = gold_bad = 0
    for tenant, lo, rows, got in served:
        want = expect[tenant][seen[tenant]]
        seen[tenant] += 1
        bad += int(got.shape != want.shape or (got != want).any())
        gold_ids = sources[tenant][1]
        if gold_ids is not None:
            gold_bad += int((got != gold_ids[lo:lo + rows]).any())
    return {"served": len(served), "failed": failed, "mismatches": bad,
            "golden_mismatches": gold_bad}


def record_ticks(server) -> list:
    """Every `TickReport` the server's ticks make from now on (each front
    end fire is one `step`, which is one tick)."""
    reports, tick = [], server.tick

    def recorded():
        report = tick()
        reports.append(report)
        return report

    server.tick = recorded
    return reports


def tick_summary(reports) -> dict:
    lat = [r.latency_s * 1e3 for r in reports if r.launches]
    return {"ticks": len(reports),
            "fire_ms": lat if len(lat) <= 32 else None,
            "first_fire_ms": lat[0] if lat else None,
            "median_fire_ms": statistics.median(lat) if lat else None,
            "phase_median_ms": {p: statistics.median(r.phase_s[p] * 1e3 for r in reports)
                                for p in reports[0].phase_s} if reports else {}}


def thread_warnings(caught) -> list:
    return [str(w.message)[:2000] for w in caught if issubclass(w.category, RuntimeWarning)]


def phase_async(gold) -> dict:
    """The deadline-aware front end on the card (phase 4c of the module
    doc): Poisson traffic over the serve registry through the background
    scheduler thread, then the one-call `serve_async` facade from asyncio."""
    reg, sources = build_registry(gold)
    members = {t: reg.members(t) for t in reg}
    for i, t in enumerate(reg):
        _, d = ASYNC_TIERS[i % len(ASYNC_TIERS)]
        reg.set_qos(t, TenantQoS(max_batch=256, max_wait_s=0.25 * d * ASYNC_SCALE,
                                 default_deadline_s=d * ASYNC_SCALE))
    t_phase = time.perf_counter()
    server = CircuitServer(reg, device=DEVICE)
    prewarm = server.prewarm_plan(server.plan(), spans=PREWARM_SPANS)
    rng = np.random.RandomState(SEED + 6)
    schedule = poisson_schedule(rng, {t: 1.0 for t in reg}, ASYNC_QPS, ASYNC_S,
                                ASYNC_MEAN_ROWS, sources)
    fe = AsyncCircuitServer(server)
    reports = record_ticks(server)
    circuit_eval.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with fe:  # the exit stops the scheduler thread and drains
            admitted, refused = replay(fe, schedule, sources)
        traffic = launch_counts()
    report = fe.stats.report()
    out = {"phase": "async", "card": gpu_line(), "tenants": len(reg),
           "offered": len(schedule), "prewarm": prewarm, "frontend": report,
           "fires": tick_summary(reports), "launches": traffic,
           "thread_warnings": thread_warnings(caught)}
    check(not out["thread_warnings"], f"async: the scheduler thread warned: "
          f"{out['thread_warnings'][:1]}")
    check(not refused and report["rejected"] == 0, f"async: {len(refused)} requests refused")
    out["ids"] = future_mismatches(admitted, sources, members)
    check(out["ids"]["served"] == len(admitted) == report["completed"],
          f"async: {out['ids']} for {len(admitted)} admitted, {report['completed']} completed")
    check(out["ids"]["mismatches"] == 0 and out["ids"]["golden_mismatches"] == 0,
          f"async: ids differ from predict: {out['ids']}")
    check(report["miss_rate"] == 0.0, f"async: miss rate {report['miss_rate']}")
    shard_fires = sum(report["shard_fires"].values())
    check(traffic["eval_population_spans"] == shard_fires == server.stats.launches
          and traffic["eval_population"] == 0,
          f"async: {traffic} for {report['fires']} fires on {shard_fires} shards with work")
    # the one-call facade: golden higgs rows in chunks, from a coroutine
    sc, ds, ids = gold["higgs"]
    chunks = [ds.x[lo:lo + FACADE_CHUNK] for lo in range(0, ds.n_rows, FACADE_CHUNK)]

    async def facade():
        async with sc.serve_async() as afe:
            got = await asyncio.gather(*(afe.submit("default", x, deadline_s=60.0)
                                         for x in chunks))
            return afe, got

    circuit_eval.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        afe, got = asyncio.run(facade())
        facade_s = time.perf_counter() - t0
        counts = launch_counts()
    frep = afe.stats.report()
    bad = int((np.concatenate(got) != ids).sum())
    out["facade"] = {"requests": len(chunks), "rows": ds.n_rows, "wall_s": facade_s,
                     "golden_mismatches": bad, "frontend": frep, "launches": counts,
                     "thread_warnings": thread_warnings(caught)}
    check(not out["facade"]["thread_warnings"], "async facade: the scheduler thread warned")
    check(bad == 0, f"async facade: {bad} ids differ from the committed golden ids")
    check(frep["completed"] == len(chunks) and frep["miss_rate"] == 0.0,
          f"async facade: {frep}")
    check(counts["eval_population_spans"] == frep["fires"] == afe.server.stats.launches,
          f"async facade: {counts} for {frep['fires']} fires")
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    return {"async": traffic["eval_population_spans"] + counts["eval_population_spans"]}


def phase_autoscale(gold) -> dict:
    """The autoscale controller on the card (phase 4d of the module doc):
    skewed open-loop traffic at 2 shards, organic decisions every control
    interval, a scripted grow and shrink, and a churned golden bundle."""
    reg, sources = build_registry(gold)
    qos = TenantQoS(max_batch=256, max_wait_s=min(0.06, 0.25 * AUTOSCALE_DEADLINE_S),
                    default_deadline_s=AUTOSCALE_DEADLINE_S)
    for t in reg:
        reg.set_qos(t, qos)
    churn = "higgs_churn"  # the golden higgs bundle under a new name
    sources[churn] = sources["higgs"]
    members = {t: reg.members(t) for t in reg}
    members[churn] = members["higgs"]
    t_phase = time.perf_counter()
    server = CircuitServer(reg, device=DEVICE, policy=PlacementPolicy(n_shards=2))
    server.prewarm_plan(server.plan(), spans=PREWARM_SPANS)
    fe = AsyncCircuitServer(server)
    # the card count is 1: the explicit cap lets up to three shards
    # time-share it, as the swap phase's grow does
    ctl = AutoscaleController(fe, HysteresisPolicy(patience=1, cooldown_s=0.2, max_shards=3,
                                                   device_cap=3, imbalance_high=1.3))
    hot = [t for t in reg if server.shard_of(t) == 0]
    cold = [t for t in reg if t not in hot]
    weights = {t: AUTOSCALE_SKEW / len(hot) for t in hot}
    weights.update({t: (1.0 - AUTOSCALE_SKEW) / (len(cold) + 1) for t in cold + [churn]})
    rng = np.random.RandomState(SEED + 7)
    schedule = poisson_schedule(rng, weights, AUTOSCALE_QPS, AUTOSCALE_S,
                                AUTOSCALE_MEAN_ROWS, sources)
    rebinds = []
    real_rebind = fe.rebind_shards

    def rebind(carry, n_shards):
        real_rebind(carry, n_shards)
        with fe._lock:
            known = sorted(fe.scheduler._shard_latency)
        rebinds.append({"carry": {str(k): v for k, v in carry.items()}, "n_shards": n_shards,
                        "ewma_shards": known})

    fe.rebind_shards = rebind
    stop = threading.Event()

    def churner():
        t0 = time.monotonic()
        for at, op in CHURN_AT_S:
            if stop.wait(max(t0 + at - time.monotonic(), 0.0)):
                return
            if op == "add":
                reg.add(churn, gold["higgs"][0], qos=qos)
            else:
                reg.remove(churn)

    # the first control step comes one interval in, once fires have fed
    # the windows and the EWMAs (an empty window reads as idle)
    control = {"next": CONTROL_INTERVAL_S, "scripted": list(SCRIPTED_SWAPS), "organic": 0,
               "stale": 0}

    def on_time(elapsed):
        if elapsed < control["next"]:
            return
        control["next"] = elapsed + CONTROL_INTERVAL_S
        if ctl.step() is not None:
            control["organic"] += 1
        if control["scripted"] and elapsed >= control["scripted"][0][0]:
            _, decision = control["scripted"].pop(0)
            for _ in range(5):
                try:
                    ctl.apply(decision)
                    break
                except StalePlanError:  # the churn raced every retry
                    control["stale"] += 1

    thread = threading.Thread(target=churner, name="churn")
    warms = server.aot_stats["exec_warms"]
    circuit_eval.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            with fe:  # the exit stops the scheduler thread and drains
                thread.start()
                admitted, refused = replay(fe, schedule, sources, on_time)
        finally:
            stop.set()
            thread.join(10.0)
        counts = launch_counts()
    check(not thread.is_alive(), "autoscale: the churn thread did not stop")
    dead = server.aot_stats["exec_warms"] - warms
    report, frep = server.stats.report(), fe.stats.report()
    events = [{k: dataclasses.asdict(e)[k] for k in ("action", "reason", "from_shards",
                                                     "to_shards", "swap_ms", "shards_reused",
                                                     "shards_rebuilt", "inflight_requests")}
              for e in ctl.events]
    out = {"phase": "autoscale", "card": gpu_line(), "tenants": len(reg), "hot": hot,
           "offered": len(schedule), "refused_churned": len(refused),
           "device_cap": "explicit 3: the card count is 1, so up to 3 shards time-share it",
           "events": events, "organic_events": control["organic"],
           "stale_retries": control["stale"], "rebinds": rebinds,
           "miss_rate": frep["miss_rate"], "frontend": frep,
           "n_rebalances": report["n_rebalances"],
           "shards_reused_frac": report["shards_reused_frac"],
           "launches": counts, "tick_launches": report["launches"],
           "prewarm_dead_launches": dead, "thread_warnings": thread_warnings(caught)}
    check(not out["thread_warnings"], f"autoscale: the scheduler thread warned: "
          f"{out['thread_warnings'][:1]}")
    check(all(t == churn for t in refused), f"autoscale: refused {set(refused)}")
    out["ids"] = future_mismatches(admitted, sources, members, may_fail=(churn,))
    check(out["ids"]["served"] + out["ids"]["failed"] == len(admitted)
          == frep["completed"] + frep["shed"],
          f"autoscale: {out['ids']} for {len(admitted)} admitted")
    check(out["ids"]["mismatches"] == 0 and out["ids"]["golden_mismatches"] == 0,
          f"autoscale: ids differ from predict: {out['ids']}")
    check(not server._results, "autoscale: a request was answered twice")
    check(any(e.action == "rebalance" and not e.reason.startswith("scripted")
              for e in ctl.events), f"autoscale: no organic rebalance in {events}")
    check(len(ctl.events) >= 3, f"autoscale: {len(ctl.events)} events")
    check(report["n_rebalances"] == len(ctl.events) and report["shards_reused_frac"] > 0,
          f"autoscale: {report['n_rebalances']} rebalances, reused "
          f"{report['shards_reused_frac']}")
    check(len(rebinds) == len(ctl.events)
          and all(set(range(r["n_shards"])) <= set(r["ewma_shards"]) for r in rebinds),
          f"autoscale: EWMAs after the swaps {rebinds}")
    check(counts["eval_population_spans"] == report["launches"] + dead
          and counts["eval_population"] == 0,
          f"autoscale: {counts}; ticks launched {report['launches']}, prewarms {dead}")
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    return {"autoscale": counts["eval_population_spans"]}


# -- phase 4e: online evolution ---------------------------------------------
def evolve_rows(n: int, *, shift: float, seed: int):
    """The benchmark's covariate shift with concept tracking: x ~ N(shift,
    1) over 6 features, class 1 where x0 + x1 > 2 shift."""
    r = np.random.RandomState(seed)
    x = (r.randn(n, EVOLVE_FEATS) + shift).astype(np.float32)
    return x, (x[:, 0] + x[:, 1] > 2.0 * shift).astype(np.int64)


def evolve_stack(sc, tracer=None):
    """One tenant behind the front end on the card; max_batch is the
    request size, so each enqueue fires at the next pump."""
    reg = CircuitRegistry()
    reg.add(EVOLVE_TENANT, sc, qos=TenantQoS(max_batch=EVOLVE_ROWS, default_deadline_s=30.0))
    server = CircuitServer(reg, device=DEVICE, tracer=tracer)
    return reg, server, AsyncCircuitServer(server)


def evolve_serve(fe, x, labels=None):
    """One request, pumped inline (this loop is the serving thread), and
    its label feedback.  Returns the served ids, or None if it failed."""
    fut = fe.enqueue(EVOLVE_TENANT, x, deadline_s=30.0)
    fe.pump()
    try:
        ids = fut.result(timeout=30.0)
    except Exception:  # noqa: BLE001 — a failed request counts as lost
        return None
    if labels is not None:
        fe.submit_feedback(EVOLVE_TENANT, fut.request_id, labels)
    return ids


class ForcedRollbacks(EvolutionManager):
    """`EvolutionManager` whose first ``forced`` promoted canaries are
    rolled back at their first probation check: the bar is set just past
    the canary's labeled accuracy, so the manager's own rule rolls back."""

    def __init__(self, *args, forced: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.to_force = forced

    def _check_probation(self, summary: dict) -> None:
        with self._lock:
            for prob in self._probation.values():
                # the rule below rolls the canary back in this call
                if self.to_force and prob["labeled"] >= self.policy.min_labeled_rows:
                    self.to_force -= 1
                    prob["baseline"] = (prob["correct"] / prob["labeled"]
                                        + self.policy.rollback_margin + 1e-3)
        super()._check_probation(summary)


def evolve_overhead(sc, seed: int, blocks: int = 64, block_batches: int = 4,
                    step_every: int = 4) -> dict:
    """The benchmark's `measure_overhead`: the same stationary stream
    through a watched stack (hooks, feedback, `step()` every few requests)
    and a bare one, in alternating blocks; the smallest per-third median
    of the paired differences over the bare median."""
    streams = [evolve_rows(EVOLVE_ROWS, shift=0.0, seed=seed * 7 + i)
               for i in range(block_batches)]
    _, _, fe_off = evolve_stack(sc)
    _, _, fe_on = evolve_stack(sc)
    mgr = EvolutionManager(fe_on, drift=DriftConfig(), observe_every=2)
    mgr.watch(EVOLVE_TENANT)
    count = [0]

    def block(fe, m) -> float:
        t0 = time.perf_counter()
        for x, y in streams:
            check(evolve_serve(fe, x, labels=y if m is not None else None) is not None,
                  "evolve: an overhead request failed")
            count[0] += 1
            if m is not None and count[0] % step_every == 0:
                m.step()
        return time.perf_counter() - t0

    for _ in range(2):
        block(fe_off, None)
        block(fe_on, mgr)
    gc.collect()   # the fit's garbage out before anything is timed
    offs, ons = [], []
    for _ in range(blocks):
        offs.append(block(fe_off, None))
        ons.append(block(fe_on, mgr))
    check(not mgr.detector(EVOLVE_TENANT).drifted, "evolve: the overhead leg escalated")
    mgr.stop()
    third = max(blocks // 3, 1)
    best = float("inf")
    for lo in range(0, blocks, third):
        off_c = sorted(offs[lo:lo + third])
        diff_c = sorted(on - off for off, on in zip(offs[lo:lo + third], ons[lo:lo + third]))
        best = min(best, diff_c[len(diff_c) // 2] / off_c[len(off_c) // 2] * 100.0)
    med_off = sorted(offs)[blocks // 2]
    return {"qps_disabled": block_batches / med_off,
            "qps_enabled": block_batches / (med_off * (1.0 + max(best, 0.0) / 100.0)),
            "evolution_overhead_pct": max(0.0, best)}


def trace_spans(events) -> list:
    """The (name, track, begin, end) of every matched B/E pair on a
    `TraceRecorder` timeline (an E closes the innermost open B of its
    track)."""
    open_, spans = {}, []
    for e in events:
        if e.phase == "B":
            open_.setdefault(e.track, []).append(e)
        elif e.phase == "E" and open_.get(e.track):
            b = open_[e.track].pop()
            spans.append((b.name, b.track, b.ts, e.ts))
    return spans


def evolve_ticks(spans) -> tuple:
    """The refit spans' durations in s, and the ticks split by whether a
    refit span was open when the tick began: per side the tick count, and
    the median ms of the tick and of each of its phase spans."""
    refits = sorted((b, e) for name, _, b, e in spans if name == "evolution.refit")
    ticks = sorted((b, e, track) for name, track, b, e in spans if name == "tick")
    phases: dict = {}
    for name, track, b, e in spans:
        if name.startswith("tick."):
            phases.setdefault(track, []).append((b, e, name))
    sides = {True: [], False: []}
    for b, e, track in ticks:
        row = {"tick": (e - b) * 1e3}
        for pb, pe, name in phases.get(track, ()):
            if b <= pb and pe <= e:
                row[name] = row.get(name, 0.0) + (pe - pb) * 1e3
        sides[any(rb <= b < re for rb, re in refits)].append(row)

    def summary(rows):
        keys = sorted({k for r in rows for k in r})
        return {"ticks": len(rows),
                "median_ms": {k: statistics.median(r.get(k, 0.0) for r in rows) for k in keys}}

    return [e - b for b, e in refits], summary(sides[True]), summary(sides[False])


def plain_search(x, y, circuit, enc, cfg: EvolveConfig, val_fraction, split_seed, generator,
                 seed_genome=None):
    """A search set up as `AutoTinyClassifier.fit` and `refit_circuit` set
    it up (``enc``'s bits packed on the card, masks from ``split_seed``),
    run through the plain versions on the card."""
    data = E.pack_dataset(E.encode(enc, x), y, circuit.n_classes, circuit.spec.n_outputs,
                          device=DEVICE)
    masks = E.split_masks(len(y), data.x_words.shape[1], val_fraction, seed=split_seed,
                          device=DEVICE)
    eval_fn = make_eval_fn(circuit.spec, data, *masks, backend="torch-ref")
    return evolve(generator, circuit.spec, cfg, eval_fn, seed_genome=seed_genome)


def same_search(genome, val_fitness, generations, plain_state) -> dict:
    return {"genome": all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(genome, plain_state.best)),
            "val_fitness": float(val_fitness) == float(plain_state.best_val),
            "generations": int(generations) == int(plain_state.gen)}


def replay_window(served, since: int, candidate):
    """The replay snapshot a refit ran on: the last EVOLVE_REPLAY labeled
    rows up to some request at or after ``since`` (the buffer evicts whole
    64-row requests), found as the one window whose refitted encoder and
    bit statistics are the candidate's.  Returns (x, y) or None."""
    per = EVOLVE_REPLAY // EVOLVE_ROWS
    strategy, bits = candidate.encoder.strategy, candidate.encoder.bits
    for j in range(max(since, per - 1), len(served)):
        x = np.concatenate([s[0] for s in served[j - per + 1:j + 1]])
        enc = E.fit_encoder(x, E.EncodingConfig(strategy, bits))
        if (np.array_equal(enc.thresholds, candidate.encoder.thresholds)
                and np.array_equal(bit_activation_stats(enc, x), candidate.ref_stats)):
            return x, np.concatenate([s[1] for s in served[j - per + 1:j + 1]])
    return None


def request_profile(prof) -> dict:
    """Per ``evolve.request`` range of a `torch.profiler` run, on its
    thread: the wall time, the time inside torch ops (each releases the
    interpreter lock while it runs), the CUDA synchronisation and memcpy
    calls among them, and the rest (Python, and waits for the lock); and
    the device's kernels in the window."""
    import bisect

    from torch.autograd import DeviceType
    events = prof.events()
    reqs = sorted((e for e in events if e.name == "evolve.request"
                   and e.device_type == DeviceType.CPU), key=lambda e: e.time_range.start)
    if not reqs:
        return {"requests": 0}
    tid = reqs[0].thread
    mine = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.thread == tid and e.device_type == DeviceType.CPU
                   and e.name != "evolve.request"))
    starts = [m[0] for m in mine]
    rows = {"wall": [], "torch": [], "sync": [], "memcpy": [], "rest": []}
    for r in reqs:
        lo, hi = r.time_range.start, r.time_range.end
        inner = mine[bisect.bisect_left(starts, lo):bisect.bisect_right(starts, hi)]
        inner = [m for m in inner if m[1] <= hi]
        covered, reach = 0.0, lo
        for s, e, _ in inner:   # the union of the op intervals
            if e > reach:
                covered += e - max(s, reach)
                reach = e
        rows["wall"].append(hi - lo)
        rows["torch"].append(covered)
        rows["sync"].append(sum(e - s for s, e, n in inner if "Synchronize" in n))
        rows["memcpy"].append(sum(e - s for s, e, n in inner if n.startswith("cudaMemcpy")))
        rows["rest"].append(hi - lo - covered)
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name != "evolve.request"
              and reqs[0].time_range.start <= e.time_range.start <= reqs[-1].time_range.end]
    kernels: dict = {}
    for e in device:
        kernels[e.name] = kernels.get(e.name, 0) + 1
    window = reqs[-1].time_range.end - reqs[0].time_range.start
    busy = sum(e.time_range.elapsed_us() for e in device)
    return {"requests": len(reqs),
            "median_us": {k: statistics.median(v) for k, v in rows.items()},
            "p90_wall_us": sorted(rows["wall"])[int(0.9 * (len(reqs) - 1))],
            "device_events": kernels, "device_busy_us": busy, "window_us": window,
            "device_idle_share": 1 - busy / window if window else None}


def evolve_contention(parent, refit_cfg, requests: int = 50) -> dict:
    """One `torch.profiler` trace of `requests` inline requests with no
    refit running, then as many while a refit searches on its background
    thread (`RefitWorker` on a full replay window of post-shift rows):
    whether the tick's extra time during a refit is spent waiting on the
    card (the search's work queued ahead of the readback on the shared
    stream: synchronisation grows) or on the host (the interpreter lock:
    the time outside torch ops grows)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    _, _, fe = evolve_stack(parent)
    rows = [evolve_rows(EVOLVE_ROWS, shift=EVOLVE_SHIFT, seed=SEED + 1000 + i)[0]
            for i in range(20 + 2 * requests)]
    for x in rows[:20]:
        check(evolve_serve(fe, x) is not None, "evolve: a contention request failed")
    worker = RefitWorker(refit_cfg).start()   # the child's boot, before any window
    buf = ReplayBuffer(EVOLVE_REPLAY)
    buf.extend(*evolve_rows(EVOLVE_REPLAY, shift=EVOLVE_SHIFT, seed=SEED + 600))
    out, done = {}, []
    try:
        for side, batch in (("outside_refit", rows[20:20 + requests]),
                            ("during_refit", rows[20 + requests:])):
            if side == "during_refit":
                check(worker.request(EVOLVE_TENANT, parent, buf, done.append),
                      "evolve: the contention refit was refused")
                time.sleep(0.05)   # past the refit's encode and pack, into its search
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for x in batch:
                    with record_function("evolve.request"):
                        check(evolve_serve(fe, x) is not None,
                              "evolve: a contention request failed")
            out[side] = {"refit_running_at_end": worker.busy(EVOLVE_TENANT),
                         **request_profile(prof)}
        check(worker.join(timeout=300.0), "evolve: the contention refit did not end")
    finally:
        worker.stop()
    out["refit_generations"] = done[0].generations if done else None
    return out


def phase_evolve(forced_rollbacks: int = 0) -> dict:
    """Online evolution on the card (phase 4e of the module doc): the
    benchmark's drift → background refit → shadow → promote scenario, then
    its oracle, the three searches replayed through the plain versions on
    the card, the overhead legs and a profile of the tick during a refit.
    ``forced_rollbacks`` promoted canaries are rolled back by
    `ForcedRollbacks` (``--evolve-rollbacks``).  Returns the path's
    launches of both kernels."""
    t_phase = time.perf_counter()
    refit_cfg = RefitConfig(max_gens=EVOLVE_GENS, kappa=max(EVOLVE_GENS // 4, 50),
                            min_replay_rows=EVOLVE_REPLAY)
    circuit_eval.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        # the parent: fitted on the pre-shift distribution, on the card
        px, py = evolve_rows(3000, shift=0.0, seed=SEED)
        clf = AutoTinyClassifier(n_gates=EVOLVE_GATES, max_gens=EVOLVE_GENS,
                                 kappa=max(EVOLVE_GENS // 4, 50),
                                 encodings=[E.EncodingConfig("quantile", 4)],
                                 seed=SEED).fit(px, py)
        parent = clf.to_servable()
        tracer = TraceRecorder(capacity=EVOLVE_TRACE_EVENTS)
        reg, server, fe = evolve_stack(parent, tracer)
        manager = (functools.partial(ForcedRollbacks, forced=forced_rollbacks)
                   if forced_rollbacks else EvolutionManager)
        mgr = manager(
            fe, drift=DriftConfig(
                window=512,
                min_rows=(EVOLVE_STATIONARY * EVOLVE_ROWS + EVOLVE_REPLAY)
                // EVOLVE_OBSERVE_EVERY,
                divergence_threshold=0.10),
            refit=refit_cfg,
            policy=PromotionPolicy(min_shadow_rows=512, min_labeled_rows=256,
                                   min_accuracy_delta=0.0),
            replay_capacity=EVOLVE_REPLAY, observe_every=EVOLVE_OBSERVE_EVERY)
        # the refit's own process boots here, before any traffic
        t_boot = time.perf_counter()
        mgr.worker.start()
        refit_boot_s = time.perf_counter() - t_boot
        mgr.watch(EVOLVE_TENANT)
        warms = server.aot_stats["exec_warms"]
        # per request: rows, labels, served ids, the circuit its tick served
        # and the candidate it shadowed (None outside a shadow), all read
        # before the request; shadows and swaps change only in step()
        served = []
        lost = during_refit = 0
        drift_reasons, scheduled_at = [], []
        promoted_at = None
        t0 = time.perf_counter()

        def serve(x, y):
            live = reg.members(EVOLVE_TENANT)[0]
            cand = (mgr.promoter.scorer.candidate(EVOLVE_TENANT)
                    if mgr.promoter.shadowing(EVOLVE_TENANT) else None)
            ids = evolve_serve(fe, x, labels=y)
            served.append((x, y, ids, live, cand))
            return ids is None

        for i in range(EVOLVE_STATIONARY):
            lost += serve(*evolve_rows(EVOLVE_ROWS, shift=0.0, seed=SEED * 11 + i))
            mgr.step()
        check(not mgr.detector(EVOLVE_TENANT).drifted, "evolve: a false trigger pre-shift")
        tail = 0
        for i in range(EVOLVE_MAX_REQUESTS):
            lost += serve(*evolve_rows(EVOLVE_ROWS, shift=EVOLVE_SHIFT,
                                       seed=SEED * 13 + 100 + i))
            during_refit += mgr.worker.busy(EVOLVE_TENANT)
            summary = mgr.step()
            drift_reasons += [reason for _, reason in summary["drift"]]
            scheduled_at += [len(served)] * len(summary["refits"])
            if promoted_at is None and (EVOLVE_TENANT, "promoted") in summary["verdicts"]:
                promoted_at = i + 1
            # the benchmark stops 5 requests after a promotion; a canary
            # rolled back on probation within them re-arms the loop, so
            # the phase serves on, past the benchmark's window if a
            # rollback came late in it, until a promoted circuit has
            # served 5
            promoted = (reg.get(EVOLVE_TENANT).lineage or {}).get("verdict") == "promoted"
            tail = tail + 1 if promoted else 0
            if tail >= EVOLVE_TAIL:
                break
        wall = time.perf_counter() - t0
        busy_at_end = mgr.worker.busy(EVOLVE_TENANT)
        child_pid = mgr.worker._child.pid
        mgr.stop()
        # the refit searches' launches, made in the worker's process
        remote = dict(mgr.worker.remote_launches)
        # the oracle: a scratch search at the same budget on a same-size
        # window of post-shift rows
        ox, oy = evolve_rows(EVOLVE_REPLAY, shift=EVOLVE_SHIFT, seed=SEED + 500)
        oracle_cfg = dataclasses.replace(refit_cfg, seed_from_live=False)
        oracle = refit_circuit("oracle", parent, ox, oy, oracle_cfg)
        counts = launch_counts()
    scenario_s = time.perf_counter() - t_phase
    dead = server.aot_stats["exec_warms"] - warms
    report, frep, srep = mgr.report(), fe.stats.report(), server.stats.report()
    live = reg.get(EVOLVE_TENANT)
    # every refit the worker delivered was shadowed: its candidate is the
    # one the requests above saw, in order
    cands = list({id(c): c for *_, c in served if c is not None}.values())
    refit_gens = [c.lineage["search_generations"] for c in cands]
    evals = {"parent_fit": sum(r.generations + 1 for r in clf.records_),
             "refits": sum(g + 1 for g in refit_gens),
             "oracle": oracle.generations + 1,
             "shadow_scorer_predicts": sum(c is not None for *_, c in served)}
    # served ids against the plain version on the host and against predict
    # on the card, of the circuit each tick served
    bad_plain = bad_card = 0
    for circuit in {id(s[3]): s[3] for s in served}.values():
        mine = [(x, ids) for x, _, ids, c, _ in served if c is circuit and ids is not None]
        xs, ids = np.concatenate([x for x, _ in mine]), np.concatenate([i for _, i in mine])
        bad_plain += int((ids != circuit.predict(xs, device="cpu")).sum())
        bad_card += int((ids != circuit.predict(xs, device=DEVICE)).sum())
    # the shadow slot's ids and the scorer's predicts: each verdict's
    # evidence equals what the plain version of its candidate gives on
    # the requests it shadowed
    shadow_bad = []
    for rec in mgr.records:
        if rec.verdict not in ("promoted", "rejected"):
            continue
        cand = [c for c in cands if circuit_digest(c) == rec.candidate_hash]
        mine = [(x, y, ids) for x, y, ids, _, c in served if cand and c is cand[0]]
        if not mine:
            shadow_bad.append(rec.candidate_hash)
            continue
        xs, ys, ids = (np.concatenate(a) for a in zip(*mine))
        pred = cand[0].predict(xs, device="cpu")
        n_rows, agree = len(ids), int((pred == ids).sum())
        sc, lc = int((pred == ys).sum()), int((ids == ys).sum())
        want = {"rows": n_rows, "agreement": round(agree / n_rows, 4), "labeled_rows": n_rows,
                "shadow_accuracy": sc / n_rows, "live_accuracy": lc / n_rows,
                "accuracy_delta": (sc - lc) / n_rows}
        if rec.shadow != want:
            shadow_bad.append(rec.candidate_hash)
    # the three searches replayed through the plain versions on the card:
    # the same generators, data and masks, so the same trajectories
    enc_cfg = E.EncodingConfig(parent.encoder.strategy, parent.encoder.bits)
    before = launch_counts()
    t_replay = time.perf_counter()
    replays = {"parent_fit": same_search(
        clf.genome_, clf.records_[0].val_fitness, clf.records_[0].generations,
        plain_search(px, py, parent, E.fit_encoder(px, clf.encodings[0]), clf.cfg,
                     clf.val_fraction, SEED, torch.Generator().manual_seed(SEED * 1000)))}
    replays["oracle"] = same_search(
        oracle.candidate.genome, oracle.val_fitness, oracle.generations,
        plain_search(ox, oy, parent, E.fit_encoder(ox, enc_cfg), refit_cfg.evolve_config(),
                     refit_cfg.val_fraction, 0, _refit_key("oracle", 0)))
    for k, cand in enumerate(cands):
        # refit k was scheduled in the step after request scheduled_at[k] - 1,
        # seeded from the circuit that request was served by
        window = replay_window(served, scheduled_at[k] - 1, cand)
        if window is None:
            replays[f"refit_{k}"] = {"window_found": False}
            continue
        replays[f"refit_{k}"] = same_search(
            cand.genome, cand.lineage["val_fitness"], cand.lineage["search_generations"],
            plain_search(*window, cand, cand.encoder, refit_cfg.evolve_config(),
                         refit_cfg.val_fraction, k, _refit_key(EVOLVE_TENANT, k),
                         seed_genome=served[scheduled_at[k] - 1][3].genome))
    replay_s = time.perf_counter() - t_replay
    replay_launches = {k: v - before[k] for k, v in launch_counts().items()}
    tx, ty = evolve_rows(2000, shift=EVOLVE_SHIFT, seed=SEED + 900)
    acc_before = float((parent.predict(tx, device=DEVICE) == ty).mean())
    acc_after = float((live.predict(tx, device=DEVICE) == ty).mean())
    acc_oracle = float((oracle.candidate.predict(tx, device=DEVICE) == ty).mean())
    legs_s = {"checks_and_replays": time.perf_counter() - t_phase - scenario_s}
    t_leg = time.perf_counter()
    overhead = evolve_overhead(parent, SEED + 700)
    legs_s["overhead"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    contention = evolve_contention(parent, refit_cfg)
    legs_s["contention_profile"] = time.perf_counter() - t_leg
    refit_s, during, outside = evolve_ticks(trace_spans(tracer.events()))
    audit = [{"verdict": r.verdict, "parent_hash": r.parent_hash,
              "candidate_hash": r.candidate_hash, "shadow": r.shadow,
              "generation": r.generation, "swap_ms": r.swap_ms} for r in mgr.records]
    n = len(served)
    out = {"phase": "evolve", "card": gpu_line(), "n_requests": n,
           "requests_to_promotion": promoted_at, "benchmark_window": EVOLVE_WINDOW,
           "served_past_benchmark_window": max(n - EVOLVE_STATIONARY - EVOLVE_WINDOW, 0),
           "forced_rollbacks": forced_rollbacks,
           "promoted_tail": tail,
           "promoted_within_benchmark_window": promoted_at is not None
           and promoted_at <= EVOLVE_WINDOW,
           "batch_rows": EVOLVE_ROWS, "search_gens": EVOLVE_GENS, "shift": EVOLVE_SHIFT,
           "qps": n / wall, "rows_per_s": n * EVOLVE_ROWS / wall, "wall_s": wall,
           "drift_reason": drift_reasons[0] if drift_reasons else "",
           "refits": report["refits_completed"], "promotions": report["promotions"],
           "rejections": report["rejections"], "rollbacks": report["rollbacks"],
           "served_during_refit": during_refit, "lost_requests": lost,
           "mismatched_ids": bad_plain, "mismatched_ids_vs_card_predict": bad_card,
           "shadow_evidence_mismatches": shadow_bad,
           "accuracy_before": acc_before, "accuracy_after": acc_after,
           "oracle_accuracy": acc_oracle, "accuracy_gap": acc_oracle - acc_after,
           "refit": [{"generations": g, "duration_s": s, "gens_per_s": g / s,
                      "val_fitness": c.lineage["val_fitness"],
                      "replay_rows": c.lineage["replay_rows"]}
                     for g, s, c in zip(refit_gens, refit_s, cands)],
           "parent_fit": {"generations": clf.records_[0].generations,
                          "search_s": clf.records_[0].search_s},
           "oracle": {"generations": oracle.generations, "duration_s": oracle.duration_s},
           "plain_replays": replays, "replay_s": replay_s, "replay_launches": replay_launches,
           "lineage": live.lineage, "promotion_audit": audit,
           "ticks_during_refit": during, "ticks_outside_refit": outside,
           "trace_events": len(tracer), "trace_dropped": tracer.dropped,
           "contention_profile": contention,
           "evolution_report": report, "frontend": frep,
           "launches": counts, "refit_process": {
               "boot_s": refit_boot_s, "pid": child_pid, "parent_pid": os.getpid(),
               "launches": remote},
           "evaluations": evals, "fires": frep["fires"],
           "tick_launches": srep["launches"], "prewarm_dead_launches": dead,
           "thread_warnings": thread_warnings(caught), **overhead}
    out["phase_s"] = time.perf_counter() - t_phase
    out["scenario_s"], out["legs_s"] = scenario_s, legs_s
    emit(out)
    check(not out["thread_warnings"], f"evolve: a thread warned: {out['thread_warnings'][:1]}")
    check(out["drift_reason"] == "divergence", f"evolve: drift {drift_reasons}")
    check(out["refits"] >= 1 and out["promotions"] >= 1,
          f"evolve: {out['refits']} refits, {out['promotions']} promotions")
    check(out["promoted_within_benchmark_window"],
          f"evolve: no promotion within the benchmark's {EVOLVE_WINDOW} post-shift requests")
    check(out["rollbacks"] >= forced_rollbacks,
          f"evolve: {out['rollbacks']} rollbacks, {forced_rollbacks} forced")
    check(tail >= EVOLVE_TAIL, f"evolve: no promoted circuit served {EVOLVE_TAIL} requests "
          f"within {EVOLVE_MAX_REQUESTS} post-shift requests "
          f"({out['rollbacks']} rollbacks)")
    check(lost == 0, f"evolve: {lost} requests lost")
    check(during_refit >= 1, "evolve: no request was served while the refit ran")
    check(acc_after > acc_before, f"evolve: accuracy {acc_before} -> {acc_after}")
    promo = [a for a in audit if a["verdict"] == "promoted"][-1]
    check(live.lineage["parent_hash"] == promo["parent_hash"],
          "evolve: the promoted lineage names another parent than the audit")
    check(bad_plain == 0 and bad_card == 0,
          f"evolve: served ids differ from the plain version in {bad_plain} rows and "
          f"from predict on the card in {bad_card}")
    check(not shadow_bad, f"evolve: shadow evidence differs from the plain version for "
          f"{shadow_bad}")
    check(all(v for r in replays.values() for v in r.values()),
          f"evolve: a search differs from its plain replay: {replays}")
    check(not any(replay_launches.values()), f"evolve: a plain replay launched {replay_launches}")
    check(report["refits_completed"] == len(cands) and mgr.worker.discarded == 0
          and report["pending_candidates"] == 0 and not busy_at_end,
          f"evolve: {report['refits_completed']} refits delivered, {len(cands)} shadowed")
    check(remote.get("eval_population", 0) == evals["refits"]
          and counts["eval_population"] == sum(evals.values()) - evals["refits"],
          f"evolve: {counts['eval_population']} eval_population launches here and "
          f"{remote} in the refit process for {evals}")
    check(counts["eval_population_spans"] == srep["launches"] + dead
          and srep["launches"] == frep["fires"] == during["ticks"] + outside["ticks"],
          f"evolve: {counts} for {frep['fires']} fires and {dead} prewarm launches")
    return ({"evolve": counts["eval_population_spans"]},
            counts["eval_population"] + remote.get("eval_population", 0))


# -- phase 4f ---------------------------------------------------------------
def fleet_circuits() -> dict:
    """The benchmark's tenants: `SERVE_SHAPES` cycled, one 256-row quantile
    encoder each, the full function set, genomes from the port's generator."""
    g = torch.Generator().manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    out = {}
    for i in range(FLEET_TENANTS):
        f, b, n, c = SERVE_SHAPES[i % len(SERVE_SHAPES)]
        enc = E.fit_encoder(rng.randn(256, f).astype(np.float32),
                            E.EncodingConfig("quantile", b))
        spec = CircuitSpec(enc.n_bits_total, n, max(1, int(np.ceil(np.log2(c)))), FULL_FS)
        out[f"tenant{i}"] = ServableCircuit(spec, init_genome(g, spec), enc, c)
    return out


def fleet_router(n_hosts: int, circuits: dict) -> FleetRouter:
    """``n_hosts`` started in-process hosts on the card behind a router, the
    tenants registered (each shipped to its owner as a bundle)."""
    router = FleetRouter()
    for i in range(n_hosts):
        host = ServingHost(f"host{i}", CircuitRegistry(), device=DEVICE)
        host.start()
        router.add_host(f"host{i}", InProcTransport(host))
    for t, sc in sorted(circuits.items()):
        router.register(t, [sc])
    return router


def local_hosts(router) -> list:
    return [tr.host for tr in router._transports.values() if isinstance(tr, InProcTransport)]


def plain_mismatches(events, results, circuits) -> int:
    """Rows whose served ids differ from the plain version on the host
    (each tenant's events' rows predicted in one call)."""
    bad = 0
    for t, sc in circuits.items():
        idx = [i for i, e in enumerate(events) if e.tenant == t]
        if not idx:
            continue
        x = np.concatenate([events[i].features(sc.encoder.n_features) for i in idx])
        got = np.concatenate([results[i] for i in idx])
        bad += int((got != sc.predict(x, device="cpu")).sum())
    return bad


def id_mismatches(results, want) -> int:
    return sum(1 for a, b in zip(results, want) if not (
        isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
        and np.array_equal(a, b))) + abs(len(results) - len(want))


def fleet_replay(workload, chunk: int, circuits: dict, counts: PathCounts) -> tuple:
    """The benchmark's `run()`: warm on a prefix, zero the stats, replay the
    trace with the cadence on its clock (a scripted move of the hottest
    tenant when hashing already balanced, counted as forced).  Returns (the
    line, the results)."""
    router = fleet_router(FLEET_HOSTS, circuits)
    hosts = local_hosts(router)
    try:
        warm = min(4 * len(circuits) * 8, max(workload.n_events // 10, 1))
        router.replay(workload.events[:warm], chunk_size=warm)
        router.reset_stats()
        now = [0.0]
        cadence = RebalanceCadence(router, interval_s=max(workload.events[-1].t / 3.0, 1e-9),
                                   min_rows=chunk, clock=lambda: now[0])
        forced = 0

        def on_chunk(ci: int, r) -> None:
            nonlocal forced
            now[0] = workload.events[min((ci + 1) * chunk, workload.n_events) - 1].t
            moved = cadence.tick()
            if moved is not None and not moved and not r.migrations:
                loads = r.observed_loads()
                hot = max(sorted(loads), key=lambda t: loads[t])
                r.migrate(hot, min(h for h in r.hosts if h != r.owner_of(hot)),
                          reason="bench-forced")
                forced += 1

        warms = [h.server.aot_stats["exec_warms"] for h in hosts]
        before = dict(counts.total)
        t0 = time.perf_counter()
        results = counts(router.replay, workload.events, chunk_size=chunk, on_chunk=on_chunk)
        wall = time.perf_counter() - t0
        launched = {k: counts.total[k] - v for k, v in before.items()}
        ticks = sum(h.server.stats.report()["launches"] for h in hosts)
        dead = sum(h.server.aot_stats["exec_warms"] - w for h, w in zip(hosts, warms))
        report = router.report()
        moves = [{"tenant": m.tenant, "from": m.from_host, "to": m.to_host,
                  "reason": m.reason, "drained": m.drained, "buffered": m.buffered,
                  "duration_ms": m.duration_s * 1e3} for m in router.migrations]
        fires = cadence.fires
    finally:
        router.close()
    lost = sum(not isinstance(y, np.ndarray) for y in results)
    line = {"n_events": workload.n_events, "total_rows": workload.total_rows,
            "shape": workload.meta.get("shape"), "chunk_size": chunk,
            "qps": workload.n_events / wall, "rows_per_s": workload.total_rows / wall,
            "wall_s": wall, "migrations": len(moves), "cadence_fires": fires,
            "forced_migrations": forced, "migration_events": moves, "lost_requests": lost,
            "launches": launched, "tick_launches": ticks, "prewarm_dead_launches": dead,
            "router": report["router"], "hosts": report["hosts"]}
    return line, results


def fleet_subprocess(circuits: dict, events, want, counts: PathCounts) -> dict:
    """A host in its own process on the card: spawned empty, joined over a
    `SocketTransport` (the ring migrates tenants into it, else one is
    moved), served, left (its tenants migrate back) and shut down by the
    ``shutdown`` RPC.  Its ids must equal the in-process oracle's."""
    router = fleet_router(1, circuits)
    t0 = time.perf_counter()
    proc, addr = spawn_host_process("proc0")
    boot_s = time.perf_counter() - t0
    try:
        transport = SocketTransport(addr, connect_timeout_s=30.0)
        counts(router.add_host, "proc0", transport)
        joined = [m.tenant for m in router.migrations]
        if not joined:
            counts(router.migrate, sorted(circuits)[0], "proc0", reason="smoke")
        remote = router.plan.tenants_of("proc0")
        got = counts(router.replay, events, chunk_size=FLEET_CHUNK)
        stats = transport.call("stats")
        ping = transport.call("ping")
        served_remote = sum(e.tenant in remote for e in events)
        counts(router.remove_host, "proc0")
        code = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        router.close()
    return {"boot_s": boot_s, "joined_by_ring": joined, "tenants": list(remote),
            "events": len(events), "events_on_process_host": served_remote,
            "mismatches": id_mismatches(got, want), "backend": ping["backend"],
            "tick_launches": stats["server"]["launches"],
            "migrations_in": stats["migrations_in"], "exit_code": code}


def fleet_boot(circuits: dict, events, counts: PathCounts) -> dict:
    """`export_fleet` of a live 2-host fleet that has served, then
    `FleetRouter.boot_from_artifact`: no program compiled, no nvcc, and the
    booted fleet's first answers equal the live fleet's."""
    router = fleet_router(FLEET_HOSTS, circuits)
    build = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(build, exist_ok=True)
    path = tempfile.mkdtemp(prefix="fleet_store_", dir=build)
    try:
        router.replay(events, chunk_size=len(events))
        t0 = time.perf_counter()
        summary = router.export_fleet(path)
        export_ms = (time.perf_counter() - t0) * 1e3
        live = router.replay(events, chunk_size=len(events))
        programs, builds = aot.compile_count(), aot.build_count()
        t0 = time.perf_counter()
        booted = counts(FleetRouter.boot_from_artifact, path, device=DEVICE)
        boot_ms = (time.perf_counter() - t0) * 1e3
        try:
            t0 = time.perf_counter()
            first = counts(booted.replay, events, chunk_size=len(events))
            first_ms = (time.perf_counter() - t0) * 1e3
            same_plan = booted.plan.content_hash == router.plan.content_hash
            preload = [h.server.aot_stats for h in local_hosts(booted)]
        finally:
            booted.close()
        compiled, built = aot.compile_count() - programs, aot.build_count() - builds
    finally:
        router.close()
        shutil.rmtree(path, ignore_errors=True)
    return {"export": summary, "export_ms": export_ms, "boot_ms": boot_ms,
            "first_answers_ms": first_ms, "events": len(events), "compile_count": compiled,
            "build_count": built, "mismatches": id_mismatches(first, live),
            "same_plan": same_plan, "aot_stats": preload}


def fleet_evolution_rpcs(counts: PathCounts) -> dict:
    """One host's evolution RPC round trip on the card, as the reference's
    `test_host_evolution_rpcs_end_to_end` drives it: watch, submit,
    feedback, step, report."""
    rng = np.random.RandomState(SEED + 23)
    x = rng.randn(200, 4).astype(np.float32)
    sc = make_tenant(torch.Generator().manual_seed(SEED + 23), rng, 4, 2, 30, 2, x_fit=x)
    sc = dataclasses.replace(sc, ref_stats=bit_activation_stats(sc.encoder, x))
    host = ServingHost("evo0", CircuitRegistry(), device=DEVICE)
    tr = InProcTransport(host)
    tr.call("add_tenant", {"tenant": "t", "bundles": [dump_bundle(sc)]})
    host.start()
    try:
        watch = tr.call("evolution_watch", {"tenant": "t", "synchronous_refit": True,
                                            "accuracy_baseline": 0.9})
        rows = rng.randn(32, 4).astype(np.float32)
        served = counts(tr.call, "submit", {"tenant": "t", "x": rows, "deadline_s": 5.0})
        fb = tr.call("feedback", {"tenant": "t", "request_id": served["request_id"],
                                  "labels": np.asarray(served["y"])})
        step = tr.call("evolution_step", {})
        report = tr.call("evolution_report", {})
    finally:
        host.stop()
    return {"watched": watch["watched"], "accepted": fb["accepted"],
            "step_enabled": step["enabled"], "report_watched": report["watched"],
            "feedback_rows": report["feedback_rows"],
            "refit_device": str(host.evolution.refit_cfg.device),
            "mismatches": int((np.asarray(served["y"]) != sc.predict(rows, device="cpu")).sum())}


def phase_fleet() -> dict:
    """The multi-host fleet on the card (phase 4f of the module doc).
    Returns the path's spans launches."""
    t_phase = time.perf_counter()
    circuits = fleet_circuits()
    counts = PathCounts()
    out = {"phase": "fleet", "card": gpu_line(), "hosts": FLEET_HOSTS,
           "tenants": FLEET_TENANTS}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legs = {}
        for name, workload, chunk in (
                ("skew_100k", generate("skew", n_events=FLEET_EVENTS,
                                       tenants=sorted(circuits), seed=SEED), FLEET_CHUNK),
                ("committed_trace", load_trace(FLEET_TRACE), FLEET_TRACE_CHUNK)):
            t0 = time.perf_counter()
            line, results = fleet_replay(workload, chunk, circuits, counts)
            solo = fleet_router(1, circuits)
            try:
                oracle = solo.replay(workload.events, chunk_size=chunk)
            finally:
                solo.close()
            line["oracle_mismatches"] = id_mismatches(results, oracle)
            line["plain_mismatches"] = plain_mismatches(workload.events, results, circuits)
            line["leg_s"] = time.perf_counter() - t0
            legs[name] = line
            if name == "skew_100k":
                proc_events = workload.events[:FLEET_PROC_EVENTS]
                proc_want = oracle[:FLEET_PROC_EVENTS]
            del results, oracle
        t0 = time.perf_counter()
        out["subprocess_host"] = fleet_subprocess(circuits, proc_events, proc_want, counts)
        out["subprocess_host"]["leg_s"] = time.perf_counter() - t0
        out["boot"] = fleet_boot(circuits, proc_events[:FLEET_CHUNK], counts)
        out["evolution_rpcs"] = fleet_evolution_rpcs(counts)
    out["replays"] = legs
    out["launches"] = counts.total
    out["thread_warnings"] = thread_warnings(caught)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    check(not out["thread_warnings"], f"fleet: a thread warned: {out['thread_warnings'][:1]}")
    for name, line in legs.items():
        check(line["lost_requests"] == 0, f"fleet {name}: {line['lost_requests']} requests lost")
        check(line["migrations"] >= 1, f"fleet {name}: no migration")
        check(line["router"]["requests_routed"] == line["n_events"],
              f"fleet {name}: routed {line['router']['requests_routed']} of {line['n_events']}")
        check(line["oracle_mismatches"] == 0 and line["plain_mismatches"] == 0,
              f"fleet {name}: {line['oracle_mismatches']} ids differ from the single host's "
              f"and {line['plain_mismatches']} rows from the plain version")
        check(line["launches"]["eval_population_spans"]
              == line["tick_launches"] + line["prewarm_dead_launches"],
              f"fleet {name}: {line['launches']} for {line['tick_launches']} ticks and "
              f"{line['prewarm_dead_launches']} prewarm launches")
    proc = out["subprocess_host"]
    check(proc["mismatches"] == 0 and proc["exit_code"] == 0
          and proc["backend"] == runtime.backend_for(torch.device(DEVICE)).name
          and proc["events_on_process_host"] > 0 and proc["tick_launches"] > 0,
          f"fleet: the subprocess host {proc}")
    boot = out["boot"]
    check(boot["compile_count"] == 0 and boot["build_count"] == 0 and boot["mismatches"] == 0
          and boot["same_plan"] and boot["export"]["executables"] > 0,
          f"fleet: the booted fleet {boot}")
    evo = out["evolution_rpcs"]
    check(evo["watched"] == ["t"] and evo["accepted"] == 32 and evo["feedback_rows"] == 32
          and evo["report_watched"] == 1 and evo["mismatches"] == 0,
          f"fleet: the evolution RPCs {evo}")
    return {"fleet": counts.total["eval_population_spans"]}


# -- phase 4g: islands ------------------------------------------------------
def island_problem(split):
    """higgs's training rows at full size (W = 2,452 words), one 4-bit
    quantile encoding (I = 116), packed on the host and padded for the
    shards, with the fit's train/val masks."""
    ds, tr, _ = split
    enc = E.fit_encoder(tr.x, E.EncodingConfig("quantile", 4))
    bits = E.encode(enc, tr.x)
    data = E.pack_dataset(bits, tr.y, ds.n_classes, pad_words_to=pad_words_for(ISLAND_SHARDS),
                          device="cpu")
    masks = E.split_masks(len(tr.y), data.x_words.shape[1], 0.5, SEED, device="cpu")
    spec = CircuitSpec(bits.shape[1], ISLAND_GATES, data.n_outputs, FULL_FS)
    return spec, data, masks


def island_fitness_check(spec, data, masks, genomes) -> dict:
    """A population's fitness through 2 shards (two processes on the card,
    the counts summed by a gloo ``all_reduce``) against 1 shard, bitwise."""
    payload = {"problems": [{"data": [a.numpy() for a in data],
                             "masks": [m.numpy() for m in masks], "spec": spec,
                             "genomes": genomes}]}
    ranks = spawn_ranks("repro_torch.launch.islands:fitness_rank", payload, 2,
                        device=DEVICE, timeout_s=ISLAND_TIMEOUT_S)
    bad = 0
    for r in ranks:
        for a, b in zip(r["sharded"][0], r["whole"][0]):
            bad += int((np.asarray(a).view(np.uint32) != np.asarray(b).view(np.uint32)).sum())
    return {"population": int(genomes.gate_fn.shape[0]), "shards": 2, "mismatches": bad,
            "launches_per_rank": [r["launches"]["eval_population"] for r in ranks]}


def same_island(a, b) -> bool:
    return (all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a.best, b.best))
            and all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a.parent, b.parent))
            and all(getattr(a, f).tobytes() == getattr(b, f).tobytes()
                    for f in ("best_val", "best_train", "parent_fit"))
            and int(a.gen) == int(b.gen))


def phase_islands(split) -> int:
    """Island-parallel evolution on the card (phase 4g of the module doc);
    returns the ranks' eval_population launches."""
    t_phase = time.perf_counter()
    spec, data, masks = island_problem(split)
    cfg = EvolveConfig(lam=FIT_KW["lam"], kappa=FIT_KW["kappa"], max_gens=ISLAND_GENS)
    icfg = IslandConfig(migrate_every=ISLAND_MIGRATE, n_data=ISLAND_SHARDS)
    t0 = time.perf_counter()
    run = launch_islands(SEED, spec, cfg, icfg, ISLANDS, data, *masks, device=DEVICE,
                         timeout_s=ISLAND_TIMEOUT_S)
    launch_s = time.perf_counter() - t0
    ranks = []
    for r in run.ranks:
        t, state = r["timings"], run.states[r["island"]]
        ranks.append({
            "rank": r["rank"], "island": r["island"], "shard": r["shard"],
            "boot_s": r["boot_s"], "evolve_s": t["evolve_s"], "iterations": t["iterations"],
            "evaluations": t["evaluations"], "launches": r["launches"],
            "gens_per_s": int(state.gen) / t["evolve_s"], "phase_ms": t["phase_ms"],
            "collective_ms_per_generation": {k: 1e3 * t[k] / max(t["iterations"], 1)
                                             for k in COLLECTIVES}})
        check(r["launches"]["eval_population"] > 0
              and r["launches"]["eval_population"] == t["evaluations"] == int(state.gen) + 1,
              f"islands rank {r['rank']}: {r['launches']} launches for {t['evaluations']} "
              f"evaluations (island {r['island']}: {int(state.gen)} generations + 1)")
        check(r["launches"]["eval_population_spans"] == 0, "an island rank launched spans")
    # the same program in one process on the card through the plain versions
    circuit_eval.reset_launch_counts()
    t0 = time.perf_counter()
    plain_states = evolve_islands_plain(SEED, spec, cfg, icfg, ISLANDS,
                                        E.PackedDataset(*to_dev(*data)), *to_dev(*masks),
                                        backend="torch-ref")
    replay_s = time.perf_counter() - t0
    replay_launches = launch_counts()
    same = [same_island(a, b) for a, b in zip(run.states, plain_states)]
    pop = Genome(*(torch.stack([getattr(s, g)[i] for s in run.states for g in ("parent", "best")])
                   for i in range(3)))
    fitness = island_fitness_check(spec, data, masks, pop)
    best = best_island(run.states)
    out = {"phase": "islands", "card": gpu_line(), "islands": ISLANDS, "shards": ISLAND_SHARDS,
           "words": int(data.x_words.shape[1]),
           "words_per_shard": int(data.x_words.shape[1]) // ISLAND_SHARDS,
           "inputs": spec.n_inputs, "gates": spec.n_nodes, "lam": cfg.lam,
           "kappa": cfg.kappa, "max_gens": cfg.max_gens, "migrate_every": ISLAND_MIGRATE,
           "launch_s": launch_s, "ranks": ranks,
           "island_generations": [int(s.gen) for s in run.states],
           "island_best_val": [float(s.best_val) for s in run.states],
           "best_island_val": float(best.best_val), "best_island_train": float(best.best_train),
           "plain_replay": {"same": same, "seconds": replay_s, "launches": replay_launches},
           "sharded_fitness": fitness, "phase_s": time.perf_counter() - t_phase}
    emit(out)
    check(all(same), f"islands: the run differs from the plain replay: {same}")
    check(replay_launches["eval_population"] == 0 and replay_launches["eval_population_spans"] == 0,
          f"the plain replay launched a kernel: {replay_launches}")
    check(fitness["mismatches"] == 0,
          f"islands: 2-shard fitness differs from 1 shard in {fitness['mismatches']} values")
    check(len(run.ranks) == ISLANDS * ISLAND_SHARDS, "islands: a rank is missing")
    return sum(r["launches"]["eval_population"] for r in run.ranks)


# -- phase 5 ----------------------------------------------------------------
def higgs_split():
    """higgs (98,050 rows), split 80/20 by the port's `train_test_split`."""
    ds = load_dataset("higgs")
    return (ds, *train_test_split(ds, 0.2, seed=SEED))


def phase_fit(gold, split) -> dict:
    """`AutoTinyClassifier.fit` → `predict` on the card; returns the
    eval_population launches of each (fit, then the fitted predict)."""
    ds, tr, te = split
    circuit_eval.reset_launch_counts()
    t0 = time.perf_counter()
    clf = AutoTinyClassifier(encodings=DEFAULT_ENCODINGS, **FIT_KW).fit(tr.x, tr.y, ds.n_classes)
    fit_s = time.perf_counter() - t0
    fit_launches = launch_counts()
    circuit_eval.reset_launch_counts()
    ids = clf.predict(te.x)
    predict_launches = launch_counts()
    evals = sum(r.generations + 1 for r in clf.records_)
    out = {"phase": "fit", "rows": {"train": len(tr.y), "test": len(te.y)},
           "words": E.n_words(len(tr.y)), "fit_s": fit_s,
           "launches": fit_launches, "predict_launches": predict_launches,
           "evaluations": evals, "encodings": []}
    for r in clf.records_:
        out["encodings"].append({
            "encoding": f"{r.encoding.strategy}/{r.encoding.bits}",
            "inputs": tr.x.shape[1] * r.encoding.bits, "generations": r.generations,
            "search_s": r.search_s, "gens_per_s": r.generations / r.search_s,
            "best_val": r.val_fitness, "best_train": r.train_fitness,
            "phase_ms": r.clock.mean_ms(), "phase_laps": r.clock.laps})
    # the fitted classifier: kernel against the plain version on the card,
    # its bundle, and its held-out balanced accuracy beside the golden one
    sc = clf.to_servable()
    plain_ids = sc.predict(te.x, device="cpu")  # the plain version
    os.makedirs(os.path.join(ROOT, "build", "chip_smoke"), exist_ok=True)
    path = save_servable(sc, os.path.join(ROOT, "build", "chip_smoke", "higgs_fit"))
    back_ids = load_servable(path).predict(te.x, device=DEVICE)
    gold_ids = gold["higgs"][0].predict(te.x, device=DEVICE)
    every = np.ones(len(te.y), bool)
    out["predict"] = {
        "rows": len(te.y), "mismatches_vs_plain": int((ids != plain_ids).sum()),
        "bundle_mismatches": int((back_ids != ids).sum()),
        "test_balanced_accuracy": F.balanced_accuracy_rows(ids, te.y, every, ds.n_classes),
        "golden_test_balanced_accuracy": F.balanced_accuracy_rows(gold_ids, te.y, every,
                                                                  ds.n_classes),
        "encoding": f"{clf.encoder_.strategy}/{clf.encoder_.bits}"}
    emit(out)
    check(fit_launches["eval_population"] == evals,
          f"fit: {fit_launches['eval_population']} eval_population launches for "
          f"{evals} evaluations (Σ generations + 1)")
    check(fit_launches["eval_population_spans"] == 0, "the fit launched the spans kernel")
    check(predict_launches["eval_population"] == 1, "the fitted predict did not launch once")
    check(ids.shape == (len(te.y),) and out["predict"]["mismatches_vs_plain"] == 0,
          "fitted predict differs from the plain version")
    check(out["predict"]["bundle_mismatches"] == 0, "the reloaded bundle predicts other ids")
    return {"fit": fit_launches["eval_population"],
            "fit_predict": predict_launches["eval_population"]}, clf


# -- phase 6 ----------------------------------------------------------------
def parity_search(split, backend: str):
    """The fit's first search at one encoding (quantile, 4 bits), set up as
    `fit` sets it up (generator seed·1000, split seed), for PARITY_GENS
    generations with history, through ``backend`` on the card."""
    ds, tr, _ = split
    enc = E.fit_encoder(tr.x, E.EncodingConfig("quantile", 4))
    bits = E.encode(enc, tr.x)
    data = E.pack_dataset(bits, tr.y, ds.n_classes, device=DEVICE)
    masks = E.split_masks(len(tr.y), data.x_words.shape[1], 0.5, SEED, device=DEVICE)
    spec = CircuitSpec(bits.shape[1], FIT_KW["n_gates"], data.n_outputs, FULL_FS)
    cfg = EvolveConfig(lam=FIT_KW["lam"], kappa=FIT_KW["kappa"], max_gens=PARITY_GENS)
    eval_fn = make_eval_fn(spec, data, *masks, backend)
    t0 = time.perf_counter()
    final, hist = evolve_with_history(torch.Generator().manual_seed(SEED * 1000), spec,
                                      cfg, eval_fn)
    return final, hist, eval_fn, time.perf_counter() - t0


def phase_fit_parity(split):
    """The same search through the kernel and through the plain versions:
    every draw comes from the same CPU generator and every fitness is
    bitwise, so the trajectories must be identical.  Returns the kernel
    run's eval function and final state (the fit's timing case)."""
    runs = {b: parity_search(split, b) for b in ("cuda", "torch-ref")}
    (fk, hk, ek, sk), (fp, hp, _, sp) = runs["cuda"], runs["torch-ref"]
    same = {"history": all(np.array_equal(a, b) for a, b in zip(hk, hp)),
            "gen": int(fk.gen) == int(fp.gen),
            "best_val": fk.best_val.tobytes() == fp.best_val.tobytes(),
            "best_train": fk.best_train.tobytes() == fp.best_train.tobytes(),
            "best_genome": all(torch.equal(a, b) for a, b in zip(fk.best, fp.best)),
            "parent": all(torch.equal(a, b) for a, b in zip(fk.parent, fp.parent))}
    emit({"phase": "fit_parity", "generations": int(fk.gen), "same": same,
          "kernel_s": sk, "plain_s": sp, "best_val": float(fk.best_val),
          "kernel_phase_ms": ek.clock.mean_ms(),
          "plain_phase_ms": runs["torch-ref"][2].clock.mean_ms()})
    check(int(fk.gen) == PARITY_GENS, f"parity search stopped at {fk.gen}")
    check(all(same.values()), f"kernel and plain trajectories differ: {same}")
    return ek, fk


# -- phase 7 ----------------------------------------------------------------
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


def launch_floor_ms() -> float:
    """Device time of the least kernel, timed as the kernels are: a
    one-word ``zero_``.  What a launch costs this way before any work."""
    one = torch.empty(1, dtype=torch.int32, device=DEVICE)
    return device_ms(one.zero_)


def kernel_entry(kernel, checks, launches, timing: dict) -> dict:
    """One kernel's line: what it replaces, its checks, its main-path
    launches and its `timing` at its main-path shape."""
    return {
        "name": kernel.name, "route": "cuda",
        "source": "src/repro_torch/csrc/circuit_eval.cu",
        "replaces": kernel.replaces, "launches": launches,
        "max_abs_err": checks["max_abs_err"], "mismatches": checks["mismatches"],
        **timing, "kernel_ms": timing["ms"],
        "launch_floor_ms": launch_floor_ms(), "library_ms": None,
    }


def timing(shape, threads, fn, full_fn, plain_fn, nbytes, ops, live_gates, rows_read) -> dict:
    """A kernel call timed on the card (live and uncompacted program, its
    wall time with a synchronize) beside its plain version and its bound."""
    b_ms, b_by = bound(nbytes, ops)
    return {"shape": shape, "threads": threads, "ms": device_ms(fn),
            "uncompacted_ms": device_ms(full_fn), "kernel_wall_ms": wall_ms(fn, reps=20),
            "plain_ms": wall_ms(plain_fn), "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "ops": ops, "live_gates": live_gates,
            "input_rows_read": rows_read}


def golden_predict_case(gold, w=None):
    """The golden higgs bundle's genome and packed words on the card: its
    dataset (W = 3,065) or ``w`` random words."""
    sc, ds, _ = gold["higgs"]
    genome = (opcodes(sc.genome, sc.spec)[None], sc.genome.edge_src[None],
              sc.genome.out_src[None])
    if w is None:
        bits = E.encode(sc.encoder, ds.x)
        x = torch.from_numpy(E.pack_bits_rows(bits, E.n_words(ds.n_rows)).view(np.int32))
    else:
        g = torch.Generator().manual_seed(SEED + 3)
        x = torch.randint(-2**31, 2**31 - 1, (sc.spec.n_inputs, w), generator=g,
                          dtype=torch.int32)
    return genome, x.to(DEVICE)


def fit_case(fit_parity_case):
    """The fit's eval: λ children of the parity search's final parent (its
    rate, 1/n) and that search's training words on the card (W = 2,452)."""
    eval_fn, final = fit_parity_case
    spec = eval_fn.spec
    g = torch.Generator().manual_seed(SEED + 4)
    kids = mutate_children(g, final.parent, spec, 1 / spec.n_nodes, FIT_KW["lam"])
    return (opcodes(kids, spec), kids.edge_src, kids.out_src), eval_fn.data.x_words


def program_bound(genome, n_in, w) -> tuple:
    """(bytes, ops, [(live gates, rows read)] per circuit) that one program
    eval of P circuits over w words needs: per circuit, its live gates'
    genome, the input rows they read once each, and its output words."""
    opc, edge, outs = genome
    pop, n_out = outs.shape
    work = [live_work(opc[p], edge[p], outs[p], n_in, n_in) for p in range(pop)]
    live, rows = sum(a for a, _ in work), sum(r for _, r in work)
    return 4 * (3 * live + pop * n_out + rows * w + pop * n_out * w), live * w, work


def population_timing(genome, x, what: str, sms: int) -> dict:
    """eval_population over ``genome``'s P circuits and words ``x`` on the
    card, held to the genome-level plain version (live and uncompacted
    program), then timed."""
    n_in, w = x.shape
    host = compile_program(*genome, n_in)
    prog = host.to(DEVICE)
    full = compile_program(*genome, n_in, compact=False).to(DEVICE)
    for p in (prog, full):
        bad, _ = mismatch(circuit_eval.eval_program(p, x),
                          plain.eval_population_packed(*to_dev(*genome), x))
        check(bad == 0, f"eval_population differs from plain at the {what} shape")
    nbytes, ops, work = program_bound(genome, n_in, w)
    # the bound's own count of the work guards the compiler's
    check(work == list(zip(host.n_live.tolist(), host.n_rows.tolist())),
          f"{what}: live_work counts {work}; the program {host.n_live.tolist()} gates "
          f"and {host.n_rows.tolist()} rows")
    pop = genome[0].shape[0]
    return timing(
        {"P": pop, "I": n_in, "n": genome[0].shape[1], "O": genome[2].shape[1], "W": w,
         "R": prog.n_rows_max, "L": prog.n_gates},
        circuit_eval.threads_per_block(prog, w, pop, sms),
        lambda: circuit_eval.eval_program(prog, x),
        lambda: circuit_eval.eval_program(full, x),
        lambda: plain.eval_program(prog, x), nbytes, ops,
        sum(a for a, _ in work), sum(r for _, r in work))


def phase_timing(gold, checks, population_launches, serve_launches, path_launches,
                 timing_case, fit_parity_case) -> list:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # eval_population at the golden higgs predict (P = 1) and at the fit's
    # λ children (P = 4); its launches are those of every main path
    entry = kernel_entry(circuit_eval.EVAL_POPULATION, checks["eval_population"],
                         sum(population_launches.values()),
                         population_timing(*golden_predict_case(gold), "predict", sms))
    entry["launches_by_path"] = population_launches
    entry["fit"] = population_timing(*fit_case(fit_parity_case), "fit", sms)
    entry["fit"]["launches"] = population_launches["fit"]
    entries = [entry]
    # spans at the one-shard tick's shape: every slot live, back-to-back spans
    shard, span = timing_case
    k = shard.n_slots
    g = torch.Generator().manual_seed(SEED + 2)
    i_max = shard.n_inputs_max
    x = torch.randint(-2**31, 2**31 - 1, (i_max, k * span), generator=g,
                      dtype=torch.int32).to(DEVICE)
    opc, edge, outs, iw = to_dev(*(torch.from_numpy(np.array(a)) for a in (
        shard.opcodes, shard.edge_src, shard.out_src, shard.in_width)))
    host = compile_program(opc, edge, outs, i_max)
    prog = host.to(DEVICE)
    full = compile_program(opc, edge, outs, i_max, compact=False).to(DEVICE)
    slots = torch.arange(k, dtype=torch.int32, device=DEVICE)
    live_k = torch.ones_like(slots)
    woff = slots * span
    want = spans_by_genome(opc, edge, outs, x, slots, woff, iw, live_k, span)
    for p in (prog, full):
        bad, _ = mismatch(circuit_eval.eval_program_spans(p, x, slots, woff, iw, live_k,
                                                          span_words=span), want)
        check(bad == 0, "eval_population_spans differs from plain at the tick shape")
    n, n_out = shard.opcodes.shape[1], shard.out_src.shape[1]
    # bound: per slot, its live gates' genome, offset and width, and the
    # input rows below its width that they read, over its own span
    work = [live_work(shard.opcodes[p], shard.edge_src[p], shard.out_src[p], i_max,
                      int(shard.in_width[p])) for p in range(k)]
    staged = [int((host.rows[p, :int(host.n_rows[p])] < int(shard.in_width[p])).sum())
              for p in range(k)]
    check([a for a, _ in work] == host.n_live.tolist() and [r for _, r in work] == staged,
          f"spans: live_work counts {work}; the program {host.n_live.tolist()} gates "
          f"and {staged} rows below the widths")
    live, rows = sum(a for a, _ in work), sum(r for _, r in work)
    nbytes = 4 * (3 * live + k * (n_out + 2) + rows * span + k * n_out * span)
    spans_by_path = {"serve": serve_launches["eval_population_spans"], **path_launches}
    entries.append(kernel_entry(
        circuit_eval.EVAL_POPULATION_SPANS, checks["eval_population_spans"],
        sum(spans_by_path.values()), timing(
            {"P": k, "I_max": i_max, "n": n, "O": n_out, "span_words": span,
             "W_total": k * span, "R": prog.n_rows_max, "L": prog.n_gates},
            circuit_eval.threads_per_block(prog, span, k, sms),
            lambda: circuit_eval.eval_program_spans(prog, x, slots, woff, iw, live_k,
                                                    span_words=span),
            lambda: circuit_eval.eval_program_spans(full, x, slots, woff, iw, live_k,
                                                    span_words=span),
            lambda: plain.eval_program_spans(prog, x, slots, woff, iw, live_k,
                                             span_words=span),
            nbytes, live * span, live, rows)))
    entries[-1]["launches_by_path"] = spans_by_path
    return entries


# -- phase 8 ----------------------------------------------------------------
def phase_sweep(gold, widths=(32, 256, 3065, 32768)) -> dict:
    """The golden higgs program over W words: kernel time against W, live
    and uncompacted, beside the bound."""
    out = {"phase": "sweep", "kernel": "eval_population", "program": "golden higgs",
           "points": []}
    for w in widths:
        genome, x = golden_predict_case(gold, w)
        n_in = x.shape[0]
        prog = compile_program(*genome, n_in).to(DEVICE)
        full = compile_program(*genome, n_in, compact=False).to(DEVICE)
        bad, _ = mismatch(circuit_eval.eval_program(prog, x),
                          circuit_eval.eval_program(full, x))
        check(bad == 0, f"sweep W={w}: the live and the full program disagree")
        nbytes, ops, work = program_bound(genome, n_in, w)
        b_ms, b_by = bound(nbytes, ops)
        out["points"].append({
            "W": w, "ms": device_ms(lambda: circuit_eval.eval_program(prog, x)),
            "uncompacted_ms": device_ms(lambda: circuit_eval.eval_program(full, x)),
            "bound_ms": b_ms, "bound_by": b_by, "live_gates": work[0][0],
            "n": genome[0].shape[1],
        })
    emit(out)
    return out


# -- phase 9 ----------------------------------------------------------------
def phase_profile(profile_case) -> dict:
    """One one-shard tick under `torch.profiler`: the device work it
    launches and the device's busy share of the tick."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    server, work = profile_case
    tickets = [server.submit(t, x) for t, x in work]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = server.tick()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    for t in tickets:
        server.result(t)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names: dict = {}
    for e in device:
        names[e.name] = names.get(e.name, 0) + 1
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    spans = sum(v for k, v in names.items() if "eval_program_spans_kernel" in k)
    other = {k: v for k, v in names.items()
             if "eval_program_spans_kernel" not in k and not k.startswith(("Memcpy", "Memset"))}
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
    out = {"phase": "profile", "device_events": names, "device_busy_us": busy_us,
           "host_top": [(e.key, e.count, e.self_cpu_time_total) for e in host],
           "tick_wall_us": wall_us, "launches": report.launches,
           "launch_phase_ms": report.phase_s["launch"] * 1e3,
           "idle_share": None if not device else 1 - busy_us / wall_us}
    emit(out)
    if device:  # the profiler saw the card: the tick is one kernel per shard
        check(spans == report.launches, f"profiled tick: {spans} spans kernels "
              f"for {report.launches} launches")
        check(not other, f"profiled tick launched other kernels: {other}")
    return out


# -- phase 10 ---------------------------------------------------------------
def unpack_bits(words: torch.Tensor, n_rows: int) -> np.ndarray:
    """Packed output words [O, W] → uint8[n_rows, O] on the host."""
    return E.unpack_words(words.cpu(), n_rows).numpy().T


def netlist_check(clf: AutoTinyClassifier, x: np.ndarray) -> dict:
    """A fitted circuit's netlist, Verilog, C and hardware reports (host ms
    of each), and its output bits on the rows ``x`` three ways: the
    netlist interpreter, the kernel's output words (one launch on the
    card) and the emitted Verilog text; the three must agree."""
    t = {}
    t0 = time.perf_counter()
    net = clf.netlist()
    t["netlist"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    verilog = clf.to_verilog()
    t["verilog"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    registered = clf.to_verilog(registered=True)
    t["verilog_registered"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c_text = clf.to_c()
    t["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reports = [clf.hardware_report(tech) for tech in (hw.SILICON_45NM, hw.FLEXIC_08UM)]
    t["hardware_reports"] = time.perf_counter() - t0
    bits = E.encode(clf.encoder_, np.asarray(x, np.float32))
    x_words = torch.from_numpy(E.pack_bits_rows(bits, E.n_words(len(bits))).view(np.int32))
    dev = torch.device(DEVICE)
    words = runtime.backend_for(dev).eval_program(clf.to_servable().program(dev),
                                                  x_words.to(dev))[0]
    ways = {"netlist": eval_netlist(net, bits), "kernel": unpack_bits(words, len(bits)),
            "verilog": simulate_verilog(verilog, bits)}
    bad = {f"{a}_vs_{b}": int((ways[a] != ways[b]).any(axis=1).sum())
           for a, b in (("netlist", "kernel"), ("netlist", "verilog"), ("kernel", "verilog"))}
    check(all(w.shape == (len(bits), net.n_outputs) for w in ways.values()),
          f"netlist check: shapes {[w.shape for w in ways.values()]}")
    check(not any(bad.values()), f"netlist check: rows that differ {bad}")
    check(registered.count("<= x_in[") == len(net.used_inputs) and c_text.startswith("#include"),
          "the registered Verilog or the C text is malformed")
    return {"rows": len(bits), "n_gates": net.n_gates, "logic_ge": net.logic_ge(),
            "buffer_bits": net.buffer_bits(), "depth": net.depth(),
            "used_inputs": len(net.used_inputs), "verilog_lines": verilog.count("\n"),
            "c_lines": c_text.count("\n"), "mismatched_rows": bad,
            "host_ms": {k: v * 1e3 for k, v in t.items()},
            "reports": [r.row() for r in reports]}, net


def hw_fit(name: str, xgb_trees: int, xgb_depth: int) -> dict:
    """One of the paper's hardware datasets fitted on the card, its circuit
    checked and reported beside the XGBoost and smallest-MLP hardware."""
    ds = load_dataset(name, max_rows=BASELINE_ROWS)
    tr, te = train_test_split(ds, 0.2, seed=SEED)
    t0 = time.perf_counter()
    clf = AutoTinyClassifier(encodings=HW_ENCODINGS, **HW_FIT_KW).fit(tr.x, tr.y, ds.n_classes)
    fit_s = time.perf_counter() - t0
    gens = sum(r.generations for r in clf.records_)
    out = {"dataset": name, "rows": {"train": len(tr.y), "test": len(te.y)},
           "fit_s": fit_s, "generations": gens, "gens_per_s": gens / fit_s,
           "evaluations": sum(r.generations + 1 for r in clf.records_),
           "encodings": [{"encoding": f"{r.encoding.strategy}/{r.encoding.bits}",
                          "generations": r.generations, "search_s": r.search_s,
                          "best_val": r.val_fitness} for r in clf.records_],
           "test_balanced_accuracy": clf.balanced_score(te.x, te.y)}
    out["netlist"], net = netlist_check(clf, te.x)
    out["hardware"] = []
    for tech in (hw.SILICON_45NM, hw.FLEXIC_08UM):
        tiny = hw.tiny_classifier_report(net, tech, design=f"tiny-{name}")
        xgb = hw.gbdt_hw(xgb_trees, xgb_depth, ds.n_features, tech=tech, design=f"xgb-{name}")
        mlp = hw.mlp_hw(SMALLEST_MLP.layer_sizes(ds.n_features, ds.n_classes), tech=tech,
                        design=f"mlp-{name}")
        out["hardware"].append({
            "tech": tech.name, "rows": [r.row() for r in (tiny, xgb, mlp)],
            "area_ratio_xgb": xgb.area_mm2 / tiny.area_mm2,
            "power_ratio_xgb": xgb.power_mw / tiny.power_mw,
            "area_ratio_mlp": mlp.area_mm2 / tiny.area_mm2,
            "power_ratio_mlp": mlp.power_mw / tiny.power_mw,
            "fpga_lut_ratio_xgb": xgb.luts / max(tiny.luts, 1),
            "fpga_lut_ratio_mlp": mlp.luts / max(tiny.luts, 1)})
    return out


def train_on_the_card(tr, n_classes: int, cfg) -> tuple:
    """`train_mlp` on the card: (model, norm, host wall s, the stream's
    ms from a CUDA event before the call to one after it)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    model, norm = train_mlp(tr.x, tr.y, n_classes, cfg)
    end.record()
    torch.cuda.synchronize()
    return model, norm, time.perf_counter() - t0, start.elapsed_time(end)


def mlp_profile(tr, n_classes: int, cfg) -> dict:
    """The first epochs of the same training (at least MLP_PROFILE_STEPS
    steps) under `torch.profiler`.  A step runs one log-softmax forward
    kernel, so the device trace splits into steps from one to the next:
    per step the stream's period and the device's busy time (kernels and
    copies), their medians, and the device's idle share of the steps.
    The profiler's own host work lengthens the period."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    per_epoch = len(tr.y) // min(cfg.batch_size, len(tr.y))
    cut = dataclasses.replace(cfg, epochs=min(cfg.epochs, -(-MLP_PROFILE_STEPS // per_epoch)))
    steps = cut.epochs * per_epoch
    # a trace that lost device records (CUPTI drops some of the 9x512 run's
    # ~70,000 once in a few runs) cannot be split into steps: take it again
    short = []
    for _ in range(MLP_PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            train_mlp(tr.x, tr.y, n_classes, cut)
            torch.cuda.synchronize()
        device = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(device)
                 if "softmax" in e.name.lower() and "backward" not in e.name.lower()]
        if not device or len(marks) == steps:
            break
        short.append(len(marks))
    out = {"epochs": cut.epochs, "steps": steps, "device_events": len(device),
           "incomplete_traces": short}
    if not device:  # the profiler did not see the card
        return out
    starts = [e.time_range.start for e in device]
    check(len(marks) == steps, f"MLP profile: {len(marks)} log-softmax kernels in {steps} steps "
          f"(earlier traces: {short})")
    period, busy, events = [], [], []
    for a, b in zip(marks, marks[1:]):
        window = device[a:b]
        period.append((starts[b] - starts[a]) / 1e3)
        busy.append(sum(e.time_range.elapsed_us() for e in window) / 1e3)
        events.append(len(window))
    top: dict = {}
    for e in device[marks[0]:marks[-1]]:
        top[e.name[:60]] = top.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    out.update({"period_ms_median": statistics.median(period),
                "busy_ms_median": statistics.median(busy),
                "events_per_step_median": statistics.median(events),
                "idle_share": 1 - sum(busy) / sum(period),
                "device_ms_top": sorted(top.items(), key=lambda kv: -kv[1])[:6]})
    return out


def mlp_device_parity() -> dict:
    """The float smallest MLP trained on blood from one start (weights from
    a numpy seed) on the card and on the CPU: the largest parameter
    difference against MLP_PARITY_TOL times the largest parameter, and
    the share of equal test predictions."""
    ds = load_dataset("blood")
    tr, te = train_test_split(ds, 0.2, seed=SEED)
    cfg = dataclasses.replace(SMALLEST_MLP, epochs=MLP_PARITY_EPOCHS)
    rng = np.random.RandomState(SEED)
    sizes = cfg.layer_sizes(ds.n_features, ds.n_classes)
    ws = [rng.randn(a, b).astype(np.float32) * np.sqrt(2 / a) for a, b in zip(sizes, sizes[1:])]
    bs = [np.zeros(b, np.float32) for b in sizes[1:]]
    runs = {}
    for dev in (DEVICE, "cpu"):
        init = mlp_params_from_arrays(ws, bs, cfg, dev)
        model, norm = train_mlp(tr.x, tr.y, ds.n_classes, cfg, device=dev, init=init)
        runs[dev] = ([p.detach().cpu().numpy() for p in model.parameters()],
                     mlp_predict(model, norm, te.x))
    (pc, yc), (ph, yh) = runs[DEVICE], runs["cpu"]
    diff = max(float(np.abs(a - b).max()) for a, b in zip(pc, ph))
    scale = max(float(np.abs(b).max()) for b in ph)
    same = float((yc == yh).mean())
    out = {"epochs": cfg.epochs, "steps": cfg.epochs * (len(tr.y) // cfg.batch_size),
           "max_abs_param_diff": diff, "max_abs_param": scale,
           "tolerance": MLP_PARITY_TOL * scale, "equal_predictions": same}
    check(diff <= MLP_PARITY_TOL * scale and same >= 0.99,
          f"the MLP trained on the card and on the CPU differ: {out}")
    return out


def baseline_run(name: str, cfg) -> dict:
    """The MLP ``cfg`` trained on the card and GBDT on the host over one
    dataset (at most 20,000 rows, 80/20): balanced accuracy of each, the
    MLP's wall time and its mean step on the stream (two CUDA events
    around the run)."""
    ds = load_dataset(name, max_rows=BASELINE_ROWS)
    tr, te = train_test_split(ds, 0.2, seed=SEED)
    model, norm, wall_s, stream_ms = train_on_the_card(tr, ds.n_classes, cfg)
    steps = cfg.epochs * (len(tr.y) // min(cfg.batch_size, len(tr.y)))
    off = [n for n, p in list(model.named_parameters()) + list(model.named_buffers())
           if p.device.type != "cuda"]
    check(not off, f"MLP on {name}: tensors off the card {off}")
    pred = mlp_predict(model, norm, te.x)
    t0 = time.perf_counter()
    gbdt = train_gbdt(tr.x, tr.y, ds.n_classes, GBDT_CFG)
    gbdt_s = time.perf_counter() - t0
    return {
        "dataset": name, "rows": {"train": len(tr.y), "test": len(te.y)},
        "mlp": {"layers": model.layer_sizes, "weight_bits": cfg.weight_bits,
                "act_bits": cfg.act_bits, "epochs": cfg.epochs, "steps": steps,
                "device": str(model.ws[0].device), "wall_s": wall_s,
                "stream_ms_per_step": stream_ms / steps,
                "test_balanced_accuracy": balanced_accuracy(pred, te.y, ds.n_classes)},
        "gbdt": {"rounds": GBDT_CFG.n_rounds, "estimators": gbdt.n_estimators,
                 "host_s": gbdt_s, "test_balanced_accuracy": balanced_accuracy(
                     gbdt_predict(gbdt, te.x), te.y, ds.n_classes)}}


def phase_toolflow(clf: AutoTinyClassifier, split) -> tuple:
    """The paper's toolflow on the port (phase 10); returns its
    eval_population launches (Σ(generations + 1) per fit, one per fitted
    predict and one per netlist check) and the MLP runs."""
    circuit_eval.reset_launch_counts()
    higgs, _ = netlist_check(clf, split[2].x)
    fits = [hw_fit(*spec) for spec in HW_DATASETS]
    launches = launch_counts()
    want = sum(f["evaluations"] + 1 for f in fits) + 1 + len(fits)
    calibration = {
        "xgb_blood_flexic_area_mm2": hw.gbdt_hw(1, 6, 4, tech=hw.FLEXIC_08UM).area_mm2,
        "xgb_led_flexic_area_mm2": hw.gbdt_hw(10, 5, 7, tech=hw.FLEXIC_08UM).area_mm2,
        "xgb_blood_flexic_power_mw": hw.gbdt_hw(1, 6, 4, tech=hw.FLEXIC_08UM).power_mw}
    baselines = [baseline_run(name, cfg) for name, cfg in MLP_RUNS]
    parity = mlp_device_parity()
    for f in fits:
        b = next(b for b in baselines if b["dataset"] == f["dataset"])
        b["tiny_test_balanced_accuracy"] = f["test_balanced_accuracy"]
    emit({"phase": "toolflow", "higgs_circuit": higgs, "hw_fits": fits,
          "calibration_model_vs_paper": {k: [v, PAPER_TABLE2[k]] for k, v in calibration.items()},
          "baselines": baselines, "mlp_card_vs_cpu": parity,
          "best_mlp_epochs": {"config": BEST_MLP.epochs, "run": BEST_MLP_2BIT.epochs},
          "launches": launches, "expected_eval_population": want})
    check(launches["eval_population"] == want,
          f"toolflow: {launches['eval_population']} eval_population launches, expected "
          f"{want} (Σ generations + 1, a predict and a netlist check per fit, the higgs check)")
    check(launches["eval_population_spans"] == 0, "the toolflow launched the spans kernel")
    return launches["eval_population"], baselines


# -- phase 11 ---------------------------------------------------------------
def phase_mlp_profile(baselines) -> dict:
    """The toolflow's MLP runs profiled (after phase 9, whose tick profile
    is the run's first `torch.profiler` session): per step the device's
    busy ms and the stream's period, and the idle share of the step
    against the unprofiled run's mean step."""
    runs = []
    for (name, cfg), b in zip(MLP_RUNS, baselines):
        ds = load_dataset(name, max_rows=BASELINE_ROWS)
        tr, _ = train_test_split(ds, 0.2, seed=SEED)
        prof = {"dataset": name, "layers": b["mlp"]["layers"],
                "stream_ms_per_step": b["mlp"]["stream_ms_per_step"],
                **mlp_profile(tr, ds.n_classes, cfg)}
        if "busy_ms_median" in prof:
            prof["idle_share_unprofiled"] = 1 - prof["busy_ms_median"] / prof["stream_ms_per_step"]
        runs.append(prof)
    out = {"phase": "mlp_profile", "runs": runs}
    emit(out)
    return out


# -- phase 12: the LM serving path ------------------------------------------
def rel_l2(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each position's ||got - want|| / ||want|| over the vocabulary."""
    got, want = got.float(), want.float()
    return (got - want).norm(dim=-1) / want.norm(dim=-1)


def plant(cache: dict, fault: str, prompt_len: int) -> None:
    """A fault planted in a cache after the prefill: ``cache_row_zeroed``,
    every layer's cached k and v of the prompt's last token (the ring's
    slot on the hybrid's sliding layers); ``wkv_state_zeroed``, every
    RWKV layer's wkv state; ``token_shift_zeroed``, both of RWKV's carried
    tokens; ``mamba_state_zeroed``, every Mamba state ``m_h``."""
    if fault == "cache_row_zeroed":
        slot = (prompt_len - 1) % cache["k"].shape[2]
        cache["k"][:, :, slot] = 0
        cache["v"][:, :, slot] = 0
    elif fault == "wkv_state_zeroed":
        cache["s"].zero_()
    elif fault == "token_shift_zeroed":
        cache["last_x"].zero_()
        cache["last_xc"].zero_()
    elif fault == "mamba_state_zeroed":
        cache["m_h"].zero_()


def lm_inputs(prompt: torch.Tensor, positions: "torch.Tensor | None" = None) -> dict:
    """The prefill's (and `forward`'s) inputs: token ids (B, S), or an
    embedding frontend's embeddings (B, S, d) with their positions (M-RoPE's
    (B, S, 3); none for RoPE's default)."""
    if prompt.dim() == 2:
        return {"tokens": prompt}
    return {"embeds": prompt, **({} if positions is None else {"positions": positions})}


def step_input(model, tok: torch.Tensor, embeds: bool) -> dict:
    """A decode step's input for the greedy tokens ``tok`` (B,): their ids,
    or after an embeddings prompt their embedding rows (``embed=``)."""
    return make_lm_golden.decode_input(model.cfg.frontend if embeds else None, model.embed, tok)


def frontend_prompt(cfg, batch: int, s: int, seed: int) -> tuple:
    """An embedding frontend's prompt made on the card in the model's
    dtype: (seeded N(0, 1) embeddings (batch, s, d), qwen2-vl's M-RoPE ids
    of an image of `LM_IMAGE_GRID` patches then text, or None)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed + LM_FRAME_SEED)
    embeds = torch.randn((batch, s, cfg.d_model), generator=g, device=DEVICE).to(cfg.torch_dtype)
    positions = None
    if cfg.rope_kind == "mrope":
        positions = torch.as_tensor(make_lm_golden.vision_positions(batch, s, LM_IMAGE_GRID),
                                    device=DEVICE)
    return embeds, positions


@contextlib.contextmanager
def mrope_hw_dropped():
    """A planted fault: M-RoPE rotates by (t, t, t) in place of (t, h, w)."""
    real = lm_blocks.apply_mrope
    lm_blocks.apply_mrope = lambda x, p3, theta: real(x, p3[..., :1].expand(p3.shape), theta)
    try:
        yield
    finally:
        lm_blocks.apply_mrope = real


def forced_decode(model, prompt: torch.Tensor, fed: torch.Tensor, max_len: int,
                  fault: str, positions: "torch.Tensor | None" = None) -> torch.Tensor:
    """Prefill ``prompt`` (`lm_inputs`), then decode the tokens ``fed``
    (1, n - 1) one by one (their embedding rows after an embeddings
    prompt) with ``fault`` planted: the n steps' logits (n, V), the
    prefill's first.  ``rope_position_plus_one``: decode rotates q and k
    one position too far; ``mrope_hw_dropped``: the prefill rotates by
    (t, t, t); the others are planted in the cache (`plant`)."""
    if fault == "rope_position_plus_one":
        real = model._positions
        model._positions = lambda b, s, offset=0: real(b, s, offset + 1 if s == 1 else offset)
    embeds = prompt.dim() == 3
    try:
        with mrope_hw_dropped() if fault == "mrope_hw_dropped" else contextlib.nullcontext():
            logits, cache = model.prefill(**lm_inputs(prompt, positions), max_len=max_len)
        plant(cache, fault, prompt.shape[1])
        out = [logits[0]]
        for i in range(fed.shape[1]):
            logits, cache = model.decode_step(cache, **step_input(model, fed[:, i], embeds))
            out.append(logits[0])
    finally:
        model.__dict__.pop("_positions", None)
    return torch.stack(out)


def synced(fn):
    """(result, host ms) of ``fn`` ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def greedy_chain(model, prompt: torch.Tensor, steps: int, max_len: int,
                 positions: "torch.Tensor | None" = None) -> tuple:
    """Prefill ``prompt`` (token ids, or embeddings with ``positions``:
    `lm_inputs`) then ``steps`` greedy decode steps by hand, an embeddings
    prompt feeding each token's embedding row: (tokens (B, steps), each
    step's logits, prefill ms, each decode step's ms)."""
    embeds = prompt.dim() == 3
    logits, prefill_ms = synced(lambda: model.prefill(**lm_inputs(prompt, positions),
                                                      max_len=max_len))
    logits, cache = logits
    out, steps_logits, decode_ms = [], [logits], []
    for i in range(steps):
        tok = torch.argmax(logits.float(), dim=-1)
        out.append(tok)
        if i + 1 < steps:
            (logits, cache), ms = synced(lambda: model.decode_step(
                cache, **step_input(model, tok, embeds)))
            steps_logits.append(logits)
            decode_ms.append(ms)
    return torch.stack(out, dim=1).cpu().numpy(), steps_logits, prefill_ms, decode_ms


def against_forward(model, prompt: torch.Tensor, chain_tokens: np.ndarray, chain_logits,
                    max_len: int, positions: "torch.Tensor | None" = None,
                    key: "str | None" = None) -> dict:
    """One request's decode logits against `forward` over its whole
    sequence (prompt and the tokens fed back; after an embeddings prompt
    their embedding rows, at the positions decode gives them: the cache
    position, on all three M-RoPE axes): the largest relative L2 gap of a
    position (`rel_l2`), and the same for a decode of those tokens with
    each of the request's `LM_FAULTS` planted (``key``: the model's name,
    with ``/embeds`` for a frontend's request).  The tokens must agree
    wherever forward's top-2 margin exceeds twice the largest logit gap
    measured, which no gap of that size can flip."""
    name = key or model.cfg.name
    n = len(chain_logits)
    fed = torch.as_tensor(chain_tokens[:1, :n - 1], device=DEVICE)
    if prompt.dim() == 3:
        seq = lm_inputs(torch.cat([prompt, model.embed[fed]], dim=1))
        if positions is not None:
            seq["positions"] = torch.cat(
                [positions, model._positions(1, n - 1, offset=prompt.shape[1])], dim=1)
    else:
        seq = {"tokens": torch.cat([prompt, fed], dim=1)}
    full, _, _ = model.forward(**seq)
    want = full[0, prompt.shape[1] - 1:]                      # (n, V)
    got = torch.stack([lg[0] for lg in chain_logits])         # (n, V)
    err = float((got.float() - want.float()).abs().max())
    top2 = torch.topk(want.float(), 2, dim=-1).values
    sure = ((top2[:, 0] - top2[:, 1]) > 2 * err).cpu().numpy()
    agree = torch.argmax(want.float(), -1).cpu().numpy() == chain_tokens[0, :n]
    gaps = rel_l2(got, want)
    faults = {f: rel_l2(forced_decode(model, prompt, fed, max_len, f, positions), want)
              for f in LM_FAULTS[name]}
    return {"prompt": prompt.shape[1], "positions": n, "max_rel_l2": float(gaps.max()),
            "limit": LM_REL_L2_LIMIT.get(name),
            "faults_max_rel_l2": {f: float(g.max()) for f, g in faults.items()},
            "checked_faults": list(LM_FAULTS[name]),
            "max_abs_err": err, "max_abs_logit": float(want.float().abs().max()),
            "tokens_agree": int(agree.sum()), "tokens_sure": int(sure.sum()),
            "sure_tokens_disagree": int((~agree & sure).sum())}


def check_decode(name: str, r: dict) -> None:
    """`against_forward`'s largest gap within its limit, and every checked
    fault past it."""
    check(r["limit"] is not None, f"{name}: no decode limit is set")
    check(r["max_rel_l2"] <= r["limit"],
          f"{name}: decode differs from forward by a relative L2 of "
          f"{r['max_rel_l2']} > {r['limit']}")
    for fault in r["checked_faults"]:
        gap = r["faults_max_rel_l2"][fault]
        check(gap > r["limit"], f"{name}: the planted fault {fault} moves decode by "
                                f"{gap}, within the limit {r['limit']}")
    check(r["sure_tokens_disagree"] == 0, f"{name}: a sure greedy token differs")


def decode_check(cfg, seed: int, frontend: bool = False) -> dict:
    """`against_forward` on the model's check request (`LM_CHECK`), its
    prompt drawn from ``seed`` as the smoke run draws it (with
    ``frontend``, the frontend's embeddings: `frontend_prompt`), on a
    float32 model drawn from ``seed`` (the served bf16 draw before its
    rounding), the expert archs at a dropless capacity factor E/k.  The
    caller frees the served model first: arctic's 56 GB of float32 do not
    fit beside its 28 GB of bf16."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    n_prompt, n_new, max_len = LM_CHECK[cfg.name]
    torch.cuda.reset_peak_memory_stats()
    model = CausalLM(cfg, init_params(torch.Generator(device=DEVICE).manual_seed(seed),
                                      cfg, DEVICE), device=DEVICE)
    positions = None
    if frontend:
        prompt, positions = frontend_prompt(cfg, 1, n_prompt, seed)
    else:
        prompt = torch.as_tensor(np.random.RandomState(seed).randint(
            0, cfg.vocab, (1, n_prompt)).astype(np.int32), device=DEVICE)
    toks, logits, _, _ = greedy_chain(model, prompt, n_new, max_len, positions)
    out = {"dtype": cfg.dtype,
           **against_forward(model, prompt, toks, logits, max_len, positions,
                             cfg.name + "/embeds" if frontend else None),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if cfg.moe is not None:
        out["capacity_factor"] = cfg.moe.capacity_factor
    return out


class RouteReadings:
    """Within the block, every `moe.route` call's dropped pairs, pairs and
    distinct experts, read on the host (so kept out of timed work)."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self):
        self.real = lm_moe.route

        def reading(*args):
            plan = self.real(*args)
            self.calls.append({"dropped": int((~plan.kept).sum()), "pairs": plan.flat_e.numel(),
                               "capacity": plan.cap,
                               "experts_routed": int(plan.flat_e.unique().numel())})
            return plan

        lm_moe.route = reading
        return self

    def __exit__(self, *exc):
        lm_moe.route = self.real

    def summary(self) -> dict:
        return {"dropped": sum(c["dropped"] for c in self.calls),
                "pairs": sum(c["pairs"] for c in self.calls),
                "capacity": self.calls[0]["capacity"] if self.calls else None}


def decode_bound(model, cache: dict, batch: int, routes: "RouteReadings") -> float:
    """The least ms of one decode step at 3.35 TB/s: every weight read
    once (the embedding table only for the batch's rows unless it is also
    the head; of the experts, only those the step's tokens routed to, per
    layer), and the recurrent state read and written.  Attention caches
    are not counted."""
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    if not model.cfg.tie_embeddings:
        row = model.cfg.d_model * model.embed.element_size()
        weights += batch * row - model.embed.numel() * model.embed.element_size()
    if model.cfg.moe is not None:
        expert = sum(model.blocks[k][0, 0].numel() * model.blocks[k].element_size()
                     for k in ("e_wg", "e_wu", "e_wd"))
        weights -= sum(model.cfg.moe.n_experts - c["experts_routed"]
                       for c in routes.calls) * expert
    state = sum(cache[k].numel() * cache[k].element_size() for k in LM_STATE_KEYS if k in cache)
    return (weights + 2 * state) / HBM_BYTES_PER_S * 1e3


def decode_profile(model, cache: dict, step: dict) -> dict:
    """One decode step (``step``: its ``token`` or ``embed``) under
    `torch.profiler`: its kernels, the device's busy ms and the step's
    wall ms (the device's idle share between)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode_step(cache, **step)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    return {"device_events": len(device), "device_busy_ms": busy_ms, "wall_ms": wall_ms,
            "idle_share": None if not device else 1 - busy_ms / wall_ms}


def mrope_cost(cfg) -> dict:
    """`apply_mrope` against `apply_rope` on one decode step's q (batch 4,
    one token): host ms a call ending in a synchronize, median of 50.
    `apply_mrope` builds its section ids on the host and copies them to
    the card on every call, twice a layer a step (q and k)."""
    q = torch.randn((LM_BATCH, 1, cfg.n_heads, cfg.head_dim), device=DEVICE).to(cfg.torch_dtype)
    pos = torch.zeros((LM_BATCH, 1), dtype=torch.int32, device=DEVICE)
    pos3 = pos[..., None].expand(LM_BATCH, 1, 3)
    return {"mrope_ms_per_call": wall_ms(lambda: lm_rope.apply_mrope(q, pos3, cfg.rope_theta),
                                         reps=50),
            "rope_ms_per_call": wall_ms(lambda: lm_rope.apply_rope(q, pos, cfg.rope_theta),
                                        reps=50),
            "calls_per_decode_step": 2 * cfg.n_layers}


def frontend_timing(model) -> dict:
    """(f), in the served dtype at batch 4: the frontend's prefill from
    `frontend_prompt` and `LM_NEW` greedy decode steps fed embedding rows
    (`greedy_chain`), twice (the first warms up); decode ms a token beside
    `decode_bound`, one profiled step's idle share; for M-RoPE its cost a
    call (`mrope_cost`)."""
    cfg = model.cfg
    embeds, positions = frontend_prompt(cfg, LM_BATCH, LM_PROMPT, SEED)
    greedy_chain(model, embeds, 2, LM_MAX_LEN, positions)                     # warm-up
    toks, _, prefill_ms, decode_ms = greedy_chain(model, embeds, LM_NEW, LM_MAX_LEN, positions)
    _, cache = model.prefill(**lm_inputs(embeds, positions), max_len=LM_MAX_LEN)
    step = step_input(model, torch.as_tensor(toks[:, 0], device=DEVICE), True)
    bound_ms = decode_bound(model, cache, LM_BATCH, RouteReadings())
    profiled = decode_profile(model, cache, step)
    out = {"batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
           "embeds": {"shape": list(embeds.shape), "dtype": str(embeds.dtype).removeprefix(
               "torch."), "device": embeds.device.type},
           "prefill_ms": prefill_ms, "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / (
               prefill_ms / 1e3),
           "decode_ms_per_token_median": statistics.median(decode_ms),
           "decode_ms_per_token_min": min(decode_ms), "decode_bound_ms": bound_ms,
           "decode_profile": profiled}
    if positions is not None:
        t, h, w = positions.unbind(-1)
        out["positions"] = {"shape": list(positions.shape), "image_grid": list(LM_IMAGE_GRID),
                            "distinct_thw": bool((t != h).any() and (h != w).any())}
        out["mrope"] = mrope_cost(cfg)
    return out


def lm_model(arch: str) -> dict:
    """(a), (d) and (e): one model at full width (depth cut by
    `LM_LAYERS`), random bf16 weights drawn on the card from `SEED`, served
    by the engine and held to a hand-made chain and to `forward`; for an
    embedding frontend (`LM_FRONTENDS`) also (f), its embeddings path."""
    t_entry = time.perf_counter()
    cfg = cut_depth(get_config(arch), LM_LAYERS.get(arch))
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = synced(lambda: init_params(
        torch.Generator(device=DEVICE).manual_seed(SEED), cfg, DEVICE))
    model = CausalLM(cfg, params, device=DEVICE)   # shares the tensors of params
    n = sum(p.numel() for p in model.parameters())
    n_shapes = sum(int(np.prod(shape)) for shape in
                   [*(v for k, v in param_shapes(cfg).items() if k != "blocks"),
                    *param_shapes(cfg)["blocks"].values()])
    on_card = all(p.device.type == "cuda" for p in model.parameters())
    dtypes_ok = all(v.dtype == param_dtype(cfg, k) for k, v in model.blocks.items())
    prompts = list(np.random.RandomState(SEED).randint(
        0, cfg.vocab, (LM_REQUESTS, LM_PROMPT)).astype(np.int32))
    n_check = LM_CHECK[arch][0]
    greedy_chain(model, torch.as_tensor(prompts[0][None, :8], device=DEVICE), 2, 16)  # warm-up
    engine = lm_engine.Engine(cfg, params, batch_size=LM_BATCH, max_len=LM_MAX_LEN, seed=SEED)
    del params
    reqs = [lm_engine.Request(uid=i, prompt=p, max_new_tokens=LM_NEW)
            for i, p in enumerate(prompts)]
    report = lm_engine.throughput_report(engine, reqs)
    chains, prefill_ms, decode_ms = [], [], []
    for b in range(0, LM_REQUESTS, LM_BATCH):
        toks, _, pms, dms = greedy_chain(
            model, torch.as_tensor(np.stack(prompts[b:b + LM_BATCH]), device=DEVICE),
            LM_NEW, LM_MAX_LEN)
        chains.append(toks)
        prefill_ms.append(pms)
        decode_ms.extend(dms)
    chain = np.concatenate(chains)
    engine_mismatches = int((np.asarray([r.output for r in reqs]) != chain).sum())
    first = torch.as_tensor(np.stack(prompts[:LM_BATCH]), device=DEVICE)
    with RouteReadings() as prefill_routes:
        _, cache = model.prefill(tokens=first, max_len=LM_MAX_LEN)
    with RouteReadings() as step_routes:
        model.decode_step(cache, token=torch.as_tensor(chain[:LM_BATCH, :1], device=DEVICE))
    bound_ms = decode_bound(model, cache, LM_BATCH, step_routes)
    profiled = decode_profile(model, cache,
                              {"token": torch.as_tensor(chain[:LM_BATCH, 1:2], device=DEVICE)})
    del cache
    frontend = frontend_timing(model) if arch in LM_FRONTENDS else None
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated()
    ring_slots = model.cache_len(LM_CHECK[arch][2])
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    vs_forward = released(lambda: decode_check(cfg, SEED))
    if frontend is not None:
        frontend["decode_vs_forward"] = released(lambda: decode_check(cfg, SEED, frontend=True))
    out = {"arch": cfg.name, "layers": cfg.n_layers, "of_layers": get_config(arch).n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab, "dtype": cfg.dtype, "parameters": n,
           "n_params_formula": cfg.n_params(), "weight_bytes": weight_bytes,
           "all_on_card": on_card, "f32_leaves_in_f32": dtypes_ok, "init_ms": init_ms,
           "peak_memory_bytes": peak, "peak_mem_gb": peak / 1e9,
           "requests": LM_REQUESTS, "batch": LM_BATCH, "prompt": LM_PROMPT,
           "new_tokens": LM_NEW, "max_len": LM_MAX_LEN, "engine": report,
           "engine_vs_chain_mismatches": engine_mismatches,
           "prefill_ms": prefill_ms, "prefill_tokens_per_s": [
               LM_BATCH * LM_PROMPT / (ms / 1e3) for ms in prefill_ms],
           "decode_ms_per_token_median": statistics.median(decode_ms),
           "decode_ms_per_token_min": min(decode_ms),
           "decode_bound_ms": bound_ms,
           "decode_bound_by": "bytes: every weight read once per step (the embedding table "
                              "only for the batch's rows unless tied to the head; only the "
                              "experts the step routed to), the recurrent state read and "
                              "written, at 3.35 TB/s; attention caches not counted",
           "decode_profile": profiled, "decode_vs_forward": vs_forward,
           "launches": launch_counts()}
    if cfg.moe is not None:
        out["capacity_factor"] = cfg.moe.capacity_factor
        out["dropped_pairs"] = {"prefill": prefill_routes.summary(),
                                "decode_step": step_routes.summary()}
        out["experts_routed_per_layer_decode_step"] = [c["experts_routed"]
                                                       for c in step_routes.calls]
    if cfg.block_kind == "rwkv":
        out["odd_prompt"] = {"tokens": n_check, "chunk": 16, "padded_to": -(-n_check // 16) * 16}
    if cfg.block_kind == "hybrid":
        max_len = LM_CHECK[arch][2]
        out["ring"] = {"prompt": n_check, "max_len": max_len, "ring_slots": ring_slots,
                       "global_slots": max_len, "global_layers": list(cfg.global_layers)}
        out["ring_wrapped"] = n_check >= ring_slots
    out["phase_s"] = time.perf_counter() - t_entry
    check(on_card, f"{arch}: a parameter is not on the card")
    check(dtypes_ok, f"{arch}: a leaf is not in the reference's dtype")
    check(n == n_shapes, f"{arch}: {n} parameters; its shapes say {n_shapes}")
    if cfg.block_kind == "attn" and cfg.moe is None:
        check(n == cfg.n_params() - cfg.d_model,
              f"{arch}: {n} parameters; the formula says {cfg.n_params()} (+ d for ln_f)")
    check(engine_mismatches == 0, f"{arch}: the engine's tokens differ from the hand-made "
                                  f"chain in {engine_mismatches} places")
    check(not any(out["launches"].values()), f"{arch}: the LM path launched a circuit kernel")
    if cfg.block_kind == "hybrid":
        check(out["ring_wrapped"], f"{arch}: the check request did not wrap the ring")
    check_decode(arch, vs_forward)
    if frontend is not None:
        out["frontend"] = frontend
        check(frontend["embeds"]["device"] == "cuda"
              and frontend["embeds"]["dtype"] == str(cfg.torch_dtype).removeprefix("torch."),
              f"{arch}: the frontend's embeddings are not on the card in the model's dtype")
        check(cfg.rope_kind != "mrope" or frontend["positions"]["distinct_thw"],
              f"{arch}: the prompt's M-RoPE ids are not distinct over (t, h, w)")
        check_decode(arch + "/embeds", frontend["decode_vs_forward"])
    return out


def lm_starcoder2() -> dict:
    """(b): starcoder2-7b at full width, 4 of its 32 layers: a 4,608-token
    prompt through the chunked path, the ring wrapped past the 4,096
    window, then 8 decoded tokens; then `decode_check` in float32."""
    cfg = dataclasses.replace(get_config("starcoder2-7b"), n_layers=STARCODER_LAYERS)
    model = CausalLM(cfg, init_params(torch.Generator(device=DEVICE).manual_seed(SEED + 1),
                                      cfg, DEVICE), device=DEVICE)
    prompt = torch.as_tensor(np.random.RandomState(SEED + 1).randint(
        0, cfg.vocab, (1, STARCODER_PROMPT)).astype(np.int32), device=DEVICE)
    chunked = []
    real = lm_attention.gqa_attention_chunked

    def counting(*a, **kw):
        chunked.append(a[0].shape[1])
        return real(*a, **kw)

    lm_attention.gqa_attention_chunked = counting
    try:
        _, _, prefill_ms, decode_ms = greedy_chain(
            model, prompt, STARCODER_NEW, STARCODER_PROMPT + STARCODER_NEW)
    finally:
        lm_attention.gqa_attention_chunked = real
    ring = model.cache_len(STARCODER_PROMPT + STARCODER_NEW)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    vs_forward = decode_check(cfg, SEED + 1)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "of_layers": get_config(cfg.name).n_layers,
           "d_model": cfg.d_model, "window": cfg.window, "prompt": STARCODER_PROMPT,
           "ring_slots": ring, "ring_wrapped": STARCODER_PROMPT >= ring,
           "chunked_prefill_calls": len(chunked), "prefill_ms": prefill_ms,
           "decode_ms": decode_ms, "decode_vs_forward": vs_forward}
    check(len(chunked) == cfg.n_layers and STARCODER_PROMPT > ring,
          f"starcoder2: the prefill took the chunked path {len(chunked)} times "
          f"(ring of {ring} slots)")
    check_decode("starcoder2-7b", vs_forward)
    return out


def lm_golden() -> dict:
    """(c): each reference smoke fixture in float32 on the card."""
    out = {}
    for fx in make_lm_golden.FIXTURES:
        arrays = np.load(fx.path)
        cfg = fx.config(get_config)
        model = CausalLM(cfg, params_from_reference(make_lm_golden.param_tree(arrays), cfg,
                                                    DEVICE), device=DEVICE)
        want = arrays["tokens"]
        inputs = {k: torch.as_tensor(v, device=DEVICE)
                  for k, v in make_lm_golden.prefill_inputs(arrays).items()}
        prompt = inputs.get("tokens", inputs.get("embeds"))
        toks, logits, _, _ = greedy_chain(model, prompt, want.shape[1],
                                          fx.prompt + want.shape[1], inputs.get("positions"))
        want_logits = np.concatenate([arrays["prefill_logits"][:, None],
                                      arrays["decode_logits"][:, :want.shape[1] - 1]], axis=1)
        got_logits = torch.stack(logits, dim=1).cpu().numpy()
        err = float(np.abs(got_logits - want_logits).max())
        out[fx.name] = {"arch": cfg.name, "dtype": cfg.dtype, "prompt": fx.prompt,
                        "inputs": sorted(inputs),
                        "capacity_factor": cfg.moe.capacity_factor if cfg.moe else None,
                        "token_mismatches": int((toks != want).sum()), "max_abs_err": err,
                        "tolerance": LM_GOLDEN_TOL}
        check(out[fx.name]["token_mismatches"] == 0,
              f"the {fx.name} LM fixture's greedy tokens differ on the card")
        check(err <= LM_GOLDEN_TOL,
              f"the {fx.name} LM fixture's logits differ by {err} on the card")
    return out


def released(fn):
    """``fn()``, then the card's memory handed back for the next model."""
    out = fn()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_lm() -> dict:
    """The LM serving path on the card (phase 12 of the module doc).  No
    kernel of the table runs on it."""
    t_phase = time.perf_counter()
    circuit_eval.reset_launch_counts()
    out = {"phase": "lm", "card": gpu_line(),
           "minitron_8b": released(lambda: lm_model("minitron-8b"))}
    out["starcoder2_7b"] = released(lm_starcoder2)
    out["golden"] = released(lm_golden)
    for arch in LM_NEW_MODELS:
        out[arch.replace("-", "_").replace(".", "_")] = released(lambda: lm_model(arch))
    out["launches"] = launch_counts()
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    check(not any(out["launches"].values()),
          f"the LM path launched a circuit kernel: {out['launches']}")
    return out


def lm_calibrate(seeds: int) -> int:
    """``--lm-calibrate N``: the readings that `LM_REL_L2_LIMIT` is set
    from.  For each of the phase's models (at its depth, with its check
    request, `LM_CHECK`) and each of N seeds of weights and prompt:
    `decode_check`'s clean gap and each planted fault's, and for the
    embedding frontends (`LM_FRONTENDS`) the same on their embeddings
    request (``<arch>/embeds``).  One line per run, then
    one with the largest clean gap and each fault's smallest gap per
    request."""
    runs, summary = [], {}
    for arch in ("minitron-8b", "starcoder2-7b", *LM_NEW_MODELS):
        cfg = cut_depth(get_config(arch), LM_LAYERS.get(arch))
        for key in (arch, arch + "/embeds") if arch in LM_FRONTENDS else (arch,):
            for seed in range(seeds):
                run = {"arch": key, "layers": cfg.n_layers, "seed": seed,
                       **released(lambda: decode_check(cfg, seed, frontend=key != arch))}
                emit(run)
                runs.append(run)
            mine = [r for r in runs if r["arch"] == key]
            summary[key] = {"clean_max": max(r["max_rel_l2"] for r in mine),
                            **{f + "_min": min(r["faults_max_rel_l2"][f] for r in mine)
                               for f in LM_FAULTS[key]}}
    emit({"phase": "lm_calibrate", "card": gpu_line(), "seeds": seeds, "summary": summary})
    return 0


# -- phase 13: training ------------------------------------------------------
def state_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def all_on_card(tree) -> bool:
    return all(t.device.type == "cuda" for t in tree_leaves(tree))


def train_profile(step, state, batch) -> tuple:
    """One train step under `torch.profiler` (device activity only; the
    trace's raw events, not its parsed tree): (state, metrics, its
    kernels, the device's busy ms, the step's wall ms and the idle share
    between, the seconds the profiler took to stop, the 8 kernels that
    took the most device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stop_s = time.perf_counter() - t0 - wall_ms / 1e3
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    busy_ms = sum(e.duration_ns() for e in device) / 1e6
    kernels = sum(1 for e in device if not any(w in e.name().lower() for w in ("memcpy", "memset")))
    by_name: dict = {}
    for e in device:
        count_ms = by_name.setdefault(e.name(), [0, 0.0])
        count_ms[0] += 1
        count_ms[1] += e.duration_ns() / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return state, m, {"device_events": len(device), "kernels": kernels, "device_busy_ms": busy_ms,
                      "wall_ms": wall_ms, "idle_share": None if not device else 1 - busy_ms / wall_ms,
                      "profiler_stop_s": stop_s, "distinct_kernels": len(by_name),
                      "top_kernels_by_ms": [{"name": name[:90], "count": c, "ms": ms}
                                            for name, (c, ms) in top]}


def train_granite() -> dict:
    """(a): granite-moe-1b-a400m at full size trained `TRAIN_STEPS` steps
    on the card from weights drawn from `SEED`; step 0 reads the router's
    drops (each reading waits for the card) and the last step is profiled,
    so the median step ms is of the steps between."""
    t_entry = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    opt = OptConfig(kind=cfg.optimizer, lr=TRAIN_LR)
    torch.cuda.reset_peak_memory_stats()
    state, init_ms = synced(lambda: train_lib.make_train_state(
        torch.Generator(device=DEVICE).manual_seed(SEED), cfg, opt, DEVICE))
    n = sum(p.numel() for p in tree_leaves(state.params))
    step = train_lib.make_train_step(cfg, opt)
    feed = TokenStream(vocab=cfg.vocab, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                       seed=SEED).prefetching(0)
    losses, norms, step_ms = [], [], []
    for i in range(TRAIN_STEPS):
        _, batch = next(feed)
        if i == 0:
            with RouteReadings() as routes:
                (state, m), first_ms = synced(lambda: step(state, batch))
        elif i == TRAIN_STEPS - 1:
            state, m, profiled = train_profile(step, state, batch)
        else:
            (state, m), ms = synced(lambda: step(state, batch))
            step_ms.append(ms)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    feed.close()
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    median_ms = statistics.median(step_ms)
    bound_ms = 8 * cfg.active_params() * tokens / BF16_DENSE_FLOPS * 1e3
    forward_routes = routes.calls[:cfg.n_layers]     # then the remat's recompute
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
           "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
           "capacity_factor": cfg.moe.capacity_factor, "remat": cfg.remat, "dtype": cfg.dtype,
           "optimizer": opt.kind, "lr": opt.lr, "parameters": n,
           "active_parameters": cfg.active_params(), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "tokens_per_step": tokens, "init_ms": init_ms,
           "first_step_ms": first_ms, "step_ms": step_ms, "step_ms_median": median_ms,
           "tokens_per_s": tokens / (median_ms / 1e3), "losses": losses, "grad_norms": norms,
           "loss_fall": losses[0] - statistics.mean(losses[-3:]),
           "predicted_loss_fall_at_least": TRAIN_LOSS_FALL,
           "dropped_pairs_step0": {
               "dropped": sum(c["dropped"] for c in forward_routes),
               "pairs": sum(c["pairs"] for c in forward_routes),
               "capacity": forward_routes[0]["capacity"],
               "per_layer": [c["dropped"] for c in forward_routes]},
           "route_calls_step0": len(routes.calls),
           "state_bytes": {"params": state_bytes(state.params), "m": state_bytes(state.opt.m),
                           "v": state_bytes(state.opt.v)},
           "peak_memory_bytes": peak, "peak_mem_gb": peak / 1e9, "all_on_card": all_on_card(state),
           "profiled_step": profiled, "step_bound_ms": bound_ms,
           "step_bound_by": "operations: 8 x active parameters x tokens (6 for the forward "
                            "and backward, 2 for remat's recompute) at 989 TFLOP/s bf16 dense",
           "phase_s": time.perf_counter() - t_entry}
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"granite: a loss or grad norm is not finite: {losses} {norms}")
    check(out["loss_fall"] >= TRAIN_LOSS_FALL,
          f"granite: the loss fell {out['loss_fall']} in {TRAIN_STEPS} steps, "
          f"under the predicted {TRAIN_LOSS_FALL}: {losses}")
    check(out["all_on_card"], "granite: a tensor of the train state is not on the card")
    check(n == cfg.n_params() - cfg.d_model,
          f"granite: {n} parameters; the formula says {cfg.n_params()} (+ d for ln_f)")
    return out


def train_minitron() -> dict:
    """(b): minitron-8b at full width with `TRAIN_CUT_LAYERS` of its 32
    layers: its config's microbatches and float32 accumulator, dense GELU,
    the untied 256,000 x 4,096 head."""
    cfg = dataclasses.replace(get_config("minitron-8b"), n_layers=TRAIN_CUT_LAYERS)
    opt = OptConfig(kind=cfg.optimizer, lr=TRAIN_LR)
    torch.cuda.reset_peak_memory_stats()
    state = train_lib.make_train_state(torch.Generator(device=DEVICE).manual_seed(SEED), cfg,
                                       opt, DEVICE)
    step = train_lib.make_train_step(cfg, opt, microbatches=cfg.train_microbatches)
    stream = TokenStream(vocab=cfg.vocab, batch=MINITRON_BATCH, seq_len=TRAIN_SEQ, seed=SEED)
    losses, step_ms = [], []
    for i in range(MINITRON_STEPS):
        batch = stream.batch_at(i)
        (state, m), ms = synced(lambda: step(state, batch))
        losses.append(float(m["loss"]))
        step_ms.append(ms)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "of_layers": get_config(cfg.name).n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab, "act": cfg.act,
           "head": list(state.params["head"].shape), "microbatches": cfg.train_microbatches,
           "grad_accum_dtype": cfg.grad_accum_dtype, "batch": MINITRON_BATCH, "seq": TRAIN_SEQ,
           "parameters": sum(p.numel() for p in tree_leaves(state.params)),
           "losses": losses, "step_ms": step_ms,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "all_on_card": all_on_card(state)}
    check(all(np.isfinite(losses)), f"minitron: a loss is not finite: {losses}")
    check(out["all_on_card"], "minitron: a tensor of the train state is not on the card")
    check(cfg.train_microbatches == 2 and not cfg.tie_embeddings and cfg.act == "gelu",
          "minitron: not its config's microbatches, head or activation")
    return out


class Float64:
    """Inside the block the port computes in float64: every ``.float()`` a
    ``.double()`` and every config's dtype float64."""

    def __enter__(self):
        self.saved = (torch.Tensor.float, ModelConfig.torch_dtype)
        torch.Tensor.float = torch.Tensor.double
        ModelConfig.torch_dtype = property(lambda self: torch.float64)
        return self

    def __exit__(self, *exc):
        torch.Tensor.float, ModelConfig.torch_dtype = self.saved


def check_batch(cfg, seed: int) -> dict:
    """(c)–(e)'s batch: the seeded stream's tokens and labels and a loss
    mask with zeros (a quarter of the tokens)."""
    b = TokenStream(vocab=cfg.vocab, batch=TRAIN_CHECK_BATCH, seq_len=TRAIN_CHECK_SEQ,
                    seed=seed).batch_at(0)
    b["loss_mask"] = (np.random.RandomState(seed).rand(TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ)
                      < 0.75).astype(np.float32)
    return {k: torch.as_tensor(v, device=DEVICE) for k, v in b.items()}


def faulty_grads(params, cfg, batch: dict, fault: str):
    """`_value_and_grad` with a planted fault: ``aux_dropped`` leaves the
    experts' aux term out of the loss, ``loss_mask_ignored`` the mask."""
    if fault == "loss_mask_ignored":
        batch = {k: v for k, v in batch.items() if k != "loss_mask"}
    weight = train_lib.AUX_LOSS_WEIGHT
    if fault == "aux_dropped":
        train_lib.AUX_LOSS_WEIGHT = 0.0
    try:
        return train_lib._value_and_grad(params, cfg, batch)
    finally:
        train_lib.AUX_LOSS_WEIGHT = weight


def grad_check(arch: str, seed: int) -> dict:
    """(c): the loss and every gradient leaf of one step in float32 on the
    card against the same step in float64 on the card, at full width with
    `TRAIN_CUT_LAYERS` layers, weights drawn from ``seed`` (the experts at
    a dropless E/k): the largest relative L2 gap, clean and with each of
    `TRAIN_FAULTS` planted.  The rotary frequency table is float32 in
    both steps."""
    cfg = dataclasses.replace(get_config(arch), n_layers=TRAIN_CUT_LAYERS, dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device=DEVICE).manual_seed(seed), cfg, DEVICE)
    batch = check_batch(cfg, seed)
    with Float64():
        p64 = tree_map(torch.Tensor.double, params)
        loss64, _, g64 = train_lib._value_and_grad(p64, cfg, batch)
        del p64
    g64 = tree_leaves(g64)
    readings = {}
    for fault in ("clean", *TRAIN_FAULTS[arch]):
        loss, _, grads = faulty_grads(params, cfg, batch, fault)
        gaps = [float((g.double() - w).norm() / w.norm()) for g, w in zip(tree_leaves(grads), g64)]
        del grads
        loss_gap = abs(float(loss) - float(loss64)) / abs(float(loss64))
        readings[fault] = max(loss_gap, *gaps)
        if fault == "clean":
            clean = {"loss_rel": loss_gap, "worst_leaf_rel": max(gaps)}
    return {"arch": arch, "layers": cfg.n_layers, "seed": seed, "max_rel_l2": readings["clean"],
            **clean, "faults_max_rel_l2": {f: readings[f] for f in TRAIN_FAULTS[arch]},
            "checked_faults": list(TRAIN_FAULTS[arch]), "limit": TRAIN_GRAD_LIMIT[arch],
            "loss64": float(loss64), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def check_grads(r: dict) -> None:
    name = r["arch"]
    check(r["limit"] is not None, f"{name}: no gradient limit is set")
    check(r["max_rel_l2"] <= r["limit"], f"{name}: float32 gradients differ from float64 by a "
                                         f"relative L2 of {r['max_rel_l2']} > {r['limit']}")
    for fault in r["checked_faults"]:
        gap = r["faults_max_rel_l2"][fault]
        check(gap > r["limit"], f"{name}: the planted fault {fault} moves the gradients by "
                                f"{gap}, within the limit {r['limit']}")


def cut_granite():
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_CUT_LAYERS)
    return cfg, OptConfig(kind=cfg.optimizer, lr=TRAIN_LR)


def run_steps(step, state, stream, start: int, n: int) -> tuple:
    """``n`` steps from ``start``: (state, losses, each step's ms)."""
    losses, ms = [], []
    for i in range(start, start + n):
        batch = stream.batch_at(i)
        (state, m), t = synced(lambda: step(state, batch))
        losses.append(float(m["loss"]))
        ms.append(t)
    return state, losses, ms


def train_launcher(ckpt_dir: str) -> dict:
    """``python -m repro_torch.launch.train`` on the card (its default) in
    a subprocess: 4 steps of the smoke config at a 64-token sequence with a
    checkpoint every 2, then ``--resume`` to 6."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--smoke",
            "--batch", "4", "--seq", "64", "--ckpt-dir", ckpt_dir, "--ckpt-every", "2",
            "--log-every", "1"]
    runs = []
    for extra in (["--steps", "4"], ["--steps", "6", "--resume"]):
        t0 = time.perf_counter()
        r = subprocess.run(base + extra, capture_output=True, text=True, timeout=300, env=env,
                           cwd=ROOT)
        runs.append({"exit_code": r.returncode, "wall_s": time.perf_counter() - t0,
                     "stdout": r.stdout.splitlines(), "stderr_tail": r.stderr[-600:]})
    resumed = runs[1]["stdout"]
    out = {"runs": runs, "latest_step": train_ckpt.latest_step(ckpt_dir),
           "resumed_line": resumed[0] if resumed else None,
           "resumed_steps": [ln.split(":")[0] for ln in resumed[1:]]}
    check(all(r["exit_code"] == 0 for r in runs), f"the train launcher failed: {runs}")
    check(out["resumed_line"] == "resumed from step 4" and
          out["resumed_steps"] == ["step 4", "step 5"] and out["latest_step"] == 6,
          f"the train launcher did not resume at its checkpoint's step: {resumed}")
    return out


def train_resume() -> dict:
    """(d): granite at full width with `TRAIN_CUT_LAYERS` layers, 6 steps
    straight against 3 steps, an async save, a restore into a freshly
    made state and 3 more: losses, parameters, both moments and the steps
    bitwise; the checkpoint restored on the CPU equal to the card's state;
    a step's ms with `torch.use_deterministic_algorithms` on; the launcher
    resuming in a subprocess."""
    cfg, opt = cut_granite()
    stream = TokenStream(vocab=cfg.vocab, batch=TRAIN_CHECK_BATCH, seq_len=TRAIN_CHECK_SEQ,
                         seed=SEED)
    step = train_lib.make_train_step(cfg, opt)

    def fresh():
        return train_lib.make_train_state(torch.Generator(device=DEVICE).manual_seed(SEED), cfg,
                                          opt, DEVICE)

    full, l_full, ms_full = run_steps(step, fresh(), stream, 0, RESUME_STEPS)
    half, l_half, _ = run_steps(step, fresh(), stream, 0, RESUME_STEPS // 2)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        t0 = time.perf_counter()
        writer = train_ckpt.save(d, RESUME_STEPS // 2, half, blocking=False)
        save_return_ms = (time.perf_counter() - t0) * 1e3
        writer.join(timeout=300)
        write_s = time.perf_counter() - t0
        restored, at = train_ckpt.restore(d, fresh(), device=DEVICE)
        on_cpu, _ = train_ckpt.restore(d, half, device="cpu")
        cpu_same = all(torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(half),
                                                               tree_leaves(on_cpu)))
        n_leaves = len(train_ckpt._flatten(half))
        launcher = train_launcher(os.path.join(d, "launcher"))
    resumed, l_rest, _ = run_steps(step, restored, stream, RESUME_STEPS // 2, RESUME_STEPS // 2)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(full), tree_leaves(resumed)))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, _, ms_flag = run_steps(step, fresh(), stream, 0, 3)
    finally:
        torch.use_deterministic_algorithms(False)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": TRAIN_CHECK_BATCH,
           "seq": TRAIN_CHECK_SEQ, "losses_straight": l_full, "losses_resumed": l_half + l_rest,
           "restored_step": at, "checkpoint_leaves": n_leaves, "save_return_ms": save_return_ms,
           "save_write_s": write_s, "bitwise_equal": same and l_half + l_rest == l_full,
           "cpu_restore_equal": cpu_same, "step_ms": ms_full,
           "deterministic_flag_step_ms": ms_flag, "launcher": launcher}
    check(out["bitwise_equal"], f"resume is not bitwise: {l_full} against {l_half + l_rest}")
    check(cpu_same, "the checkpoint restored on the CPU differs from the card's state")
    check(at == RESUME_STEPS // 2 and n_leaves == 38, f"restored step {at}, {n_leaves} leaves")
    return out


def train_adam8() -> dict:
    """(e): adam8bit against AdamW from one start, `ADAM8_STEPS` steps at
    (c)'s shape; the optimizer state's bytes under each; one `Compressor`
    step's int8 levels."""
    cfg, _ = cut_granite()
    params = init_params(torch.Generator(device=DEVICE).manual_seed(SEED), cfg, DEVICE)
    stream = TokenStream(vocab=cfg.vocab, batch=TRAIN_CHECK_BATCH, seq_len=TRAIN_CHECK_SEQ,
                         seed=SEED)
    n = sum(p.numel() for p in tree_leaves(params))
    out = {"arch": cfg.name, "layers": cfg.n_layers, "steps": ADAM8_STEPS, "parameters": n}
    for kind in ("adamw", "adam8bit"):
        opt = OptConfig(kind=kind, lr=TRAIN_LR)
        state = train_lib.TrainState(params, init_opt_state(params, opt),
                                     torch.zeros((), dtype=torch.int32, device=DEVICE))
        opt_bytes = state_bytes(state.opt.m) + state_bytes(state.opt.v)
        state, losses, ms = run_steps(train_lib.make_train_step(cfg, opt), state, stream, 0,
                                      ADAM8_STEPS)
        out[kind] = {"losses": losses, "last5_mean": statistics.mean(losses[-5:]),
                     "step_ms_median": statistics.median(ms), "opt_state_bytes": opt_bytes,
                     "opt_state_bytes_per_parameter": opt_bytes / n}
        del state
    out["last5_gap"] = abs(out["adam8bit"]["last5_mean"] - out["adamw"]["last5_mean"])
    out["band"] = ADAM8_BAND
    _, _, grads = train_lib._value_and_grad(params, cfg, check_batch(cfg, SEED))
    sent, comp = Compressor.init(params).compress(grads)
    levels = {}
    for name, g, payload in (("embed", grads["embed"], sent["embed"]),
                             ("e_wg", grads["blocks"]["e_wg"], sent["blocks"]["e_wg"])):
        # a first step has no residual: the levels are round(g / scale)
        scale = torch.amax(torch.abs(g.float())) / 127.0
        q, _ = quantize_with_feedback(g, torch.zeros(g.shape, device=DEVICE), scale)
        levels[name] = {"max_abs_level": int(q.abs().max()),
                        "distinct_levels": int(q.unique().numel()),
                        "integral": bool(torch.equal(q, torch.round(q))), "scale": float(scale),
                        "payload_is_levels_times_scale": bool(torch.equal(
                            payload, (q * scale).to(g.dtype)))}
    out["compressor"] = {"levels": levels,
                         "residual_max": max(float(e.abs().max()) for e in tree_leaves(comp.err))}
    check(np.isfinite(out["adam8bit"]["losses"]).all(), "adam8bit: a loss is not finite")
    check(out["last5_gap"] < ADAM8_BAND, f"adam8bit's last 5 losses are {out['last5_gap']} "
                                         f"from AdamW's, past {ADAM8_BAND}")
    check(all(v["max_abs_level"] <= 127 and v["integral"] and v["payload_is_levels_times_scale"]
              for v in levels.values()), f"the compressor's payload is not int8 levels: {levels}")
    return out


def phase_train() -> dict:
    """Training on the card (phase 13 of the module doc).  No kernel of
    the table runs on it."""
    t_phase = time.perf_counter()
    circuit_eval.reset_launch_counts()
    out = {"phase": "train", "card": gpu_line(),
           "granite_moe_1b_a400m": released(train_granite),
           "minitron_8b": released(train_minitron)}
    checks = {}
    for arch in TRAIN_FAULTS:
        checks[arch.replace("-", "_")] = r = released(lambda: grad_check(arch, SEED))
        check_grads(r)
    out["grad_check"] = checks
    out["resume"] = released(train_resume)
    out["adam8bit"] = released(train_adam8)
    out["launches"] = launch_counts()
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    check(not any(out["launches"].values()),
          f"the training path launched a circuit kernel: {out['launches']}")
    return out


def train_calibrate(seeds: int) -> int:
    """``--train-calibrate N``: the readings that `TRAIN_GRAD_LIMIT` is
    set from: `grad_check` clean and with each planted fault, for each
    model and each of N seeds of weights and batch; one line per run, then
    the largest clean gap and each fault's smallest per model."""
    summary = {}
    for arch in TRAIN_FAULTS:
        runs = []
        for seed in range(seeds):
            run = released(lambda: grad_check(arch, seed))
            emit(run)
            runs.append(run)
        summary[arch] = {"clean_max": max(r["max_rel_l2"] for r in runs),
                         **{f + "_min": min(r["faults_max_rel_l2"][f] for r in runs)
                            for f in TRAIN_FAULTS[arch]}}
    emit({"phase": "train_calibrate", "card": gpu_line(), "seeds": seeds, "summary": summary})
    return 0


# -- 14. sharded training and decode on a mesh --------------------------------
# Four gloo ranks share the card as make_host_mesh(data=2, model=2): NCCL
# refuses two ranks on one device.  Each rank is a fresh interpreter
# (`spawn_ranks`) that imports this file for its program (`sharded_rank`).
SHARDED_MESH = (2, 2)
SHARDED_ARCH = "granite-moe-1b-a400m"
PARITY_LR = 3e-4
SHARDED_TIMEOUT_S = 900.0
# (a): full width, 2 of 24 layers, float32, 2 x 1,024 tokens at the real
# capacity 1.25, 3 AdamW steps; then, from the start, a prefill of the
# first 64 tokens and 4 decode steps fed the next ones (a cache of 128
# slots: 64 a tp rank)
PARITY_LAYERS, PARITY_BATCH, PARITY_SEQ, PARITY_STEPS = 2, 2, 1024, 3
PARITY_PROMPT, PARITY_DECODE, PARITY_MAX_LEN = 64, 4, 128
# (a)'s limits on the largest relative gap of the card's run to the same
# 4-rank program on the CPU, twice the largest clean gaps that
# `python3 chip_smoke.py --sharded-calibrate 3` read (H100 80GB HBM3,
# 700 W; PERF.md §6): "train" over every loss and parameter leaf, 4.49e-4
# at most (at capacity 1.25 a pair that routes or drops differently near
# a tie parts the two runs), and "decode" over every decode step's
# logits, (a)'s and (d)'s, 4.38e-6 at most (rwkv6's mesh decode); the
# faults' smallest readings were 0.0382 (train) and 0.319 (decode)
SHARDED_REL_LIMIT = {"train": 8.99e-4, "decode": 8.76e-6}
# each planted fault and the reading it moves
SHARDED_FAULTS = {"shard_grad_dropped": "train", "wrong_tp_experts": "train",
                  "cache_row_wrong_shard": "decode"}
# (b): the experts at full width and the real capacity, 2 x 4,096 tokens a
# data shard
EXPERT_TOKENS_PER_SHARD = 2 * 4096
EXPERT_ATOL = 1e-5
# (c): bf16 training at full width, 4 of 24 layers, 4 x 4,096 tokens of the
# TokenStream, 6 AdamW steps, whose losses must fall
# (6 steps on a fresh stream batch each rose at 3e-4 and 1e-3, as the
# train phase's first steps do: PERF.md §6), so its steps repeat the
# stream's first batch, at the train phase's 3e-4
BF16_LAYERS, BF16_BATCH, BF16_SEQ, BF16_STEPS = 4, 4, 4096, 6
BF16_LR = 3e-4
# (d): decode on the mesh at full width with these depth cuts, float32, the
# experts at a dropless E/k: batch 4, a 64-token prompt, 16 greedy steps
# (hymba's layer 0 global, its cache split over tp, layer 1 sliding, its
# ring whole; its Mamba state split by channel over tp)
MESH_DECODE_LAYERS = {"granite-moe-1b-a400m": 2, "rwkv6-7b": 2, "hymba-1.5b": 2}
MESH_DECODE_BATCH, MESH_DECODE_PROMPT, MESH_DECODE_STEPS, MESH_DECODE_MAX_LEN = 4, 64, 16, 96


def mesh_rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.to(got.device).double()
    return float((got.double() - want).norm() / want.norm().clamp_min(1e-30))


def gloo_on_cuda(mesh) -> dict:
    """Every collective the port issues, over the world on the card's
    tensors in float32, bfloat16 and int8, each result against its value
    computed here: which ones gloo takes on CUDA tensors."""
    import torch.distributed as dist

    from repro_torch.sharding import collectives as C

    world, rank = dist.get_world_size(), dist.get_rank()
    axes = tuple(mesh.axis_names)
    out = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        def mine(r, n=8):
            return (torch.arange(n, device=mesh.device) % 5 + r).to(dtype)

        every = torch.stack([mine(r) for r in range(world)])
        name = str(dtype).removeprefix("torch.")
        got = {
            "all_gather": C._raw_all_gather(mine(rank), mesh, axes, 0),
            "reduce_scatter": C._raw_reduce_scatter(
                torch.cat([mine(rank, 2)] * world), mesh, axes, 0),
            "all_reduce": C._raw_all_reduce(mine(rank), mesh, axes),
            "all_reduce_max": C.all_reduce_max(mine(rank), mesh, axes),
        }
        want = {"all_gather": every.reshape(-1),
                "reduce_scatter": torch.stack([mine(r, 2) for r in range(world)]).sum(0).to(dtype),
                "all_reduce": every.sum(0).to(dtype), "all_reduce_max": every.amax(0)}
        for kind, t in got.items():
            out[f"{kind}:{name}"] = bool(t.device.type == "cuda" and torch.equal(t, want[kind]))
    return out


def parity_cfg():
    return dataclasses.replace(get_config(SHARDED_ARCH), n_layers=PARITY_LAYERS, dtype="float32")


@contextlib.contextmanager
def planted(fault: str):
    """(a)'s planted faults: ``shard_grad_dropped`` zeroes data shard 1's
    contribution to every gradient reduce-scatter over the data axis,
    ``wrong_tp_experts`` dispatches each tp rank's pairs to the other
    rank's experts, ``cache_row_wrong_shard`` writes each decode row into
    the other tp rank's slice of the cache."""
    from repro_torch.models import blocks as lm_blocks
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.specs import _names

    saved = (C._raw_reduce_scatter, lm_moe._local_dispatch_compute, lm_blocks._cache_write)
    if fault == "shard_grad_dropped":
        def reduce_scatter(x, mesh, axes, dim):
            if "data" in _names(axes) and mesh.coords["data"] == 1:
                x = torch.zeros_like(x)
            return saved[0](x, mesh, axes, dim)

        C._raw_reduce_scatter = reduce_scatter
    elif fault == "wrong_tp_experts":
        def dispatch(x, router, wg, wu, wd, cfg, m_idx, e_loc):
            return saved[1](x, router, wg, wu, wd, cfg, (m_idx + 1) % (cfg.n_experts // e_loc),
                            e_loc)

        lm_moe._local_dispatch_compute = dispatch
    elif fault == "cache_row_wrong_shard":
        def cache_write(cache, row, pos, offset=0):
            t = cache.shape[1]
            return saved[2](cache, row, pos, offset - t if offset >= t else offset + t)

        lm_blocks._cache_write = cache_write
    try:
        yield
    finally:
        C._raw_reduce_scatter, lm_moe._local_dispatch_compute, lm_blocks._cache_write = saved


def parity_run(mesh, seed: int) -> dict:
    """(a)'s training: the whole start drawn on the host from ``seed`` (the
    same on the card and on the CPU), 3 sharded AdamW steps on the seeded
    stream's batch.  → the batch, losses, the parameters' blocks and
    gathered whole."""
    from repro_torch.sharding import collectives as C

    cfg = parity_cfg()
    opt = OptConfig(lr=PARITY_LR)
    shs = train_lib.train_state_shardings(cfg, opt, mesh)
    state = train_lib.make_train_state(torch.Generator().manual_seed(seed), cfg, opt,
                                       shardings=shs)
    start = state.params   # the step writes nothing in place
    batch = TokenStream(vocab=cfg.vocab, batch=PARITY_BATCH, seq_len=PARITY_SEQ,
                        seed=seed).batch_at(0)
    step = train_lib.make_train_step(cfg, opt, grad_shardings=shs.params)
    losses = []
    for _ in range(PARITY_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return {"batch": batch, "losses": losses, "start": start,
            "params": tree_leaves(C.gather_tree(state.params, shs.params))}


def parity_decode(mesh, run: dict) -> torch.Tensor:
    """(a)'s decode: from the start (the trained states part at ties), a
    prefill of the batch's first tokens and decode steps fed the next
    ones, on the mesh, the experts at a dropless E/k; every step's
    logits."""
    cfg = parity_cfg()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    model = CausalLM(cfg, run["start"], mesh=mesh)
    tokens = torch.as_tensor(run["batch"]["tokens"])
    logits, cache = model.prefill(tokens[:, :PARITY_PROMPT], max_len=PARITY_MAX_LEN)
    steps = [logits]
    for i in range(PARITY_DECODE):
        fed = tokens[:, PARITY_PROMPT + i:PARITY_PROMPT + i + 1]
        logits, cache = model.decode_step(cache, fed)
        steps.append(logits)
    return torch.stack(steps)


def parity_full(mesh, seed: int) -> dict:
    run = parity_run(mesh, seed)
    return {**run, "logits": parity_decode(mesh, run)}


def parity_gap(run: dict, ref: dict) -> dict:
    """(a)'s readings: "train", the largest relative gap of a loss or a
    parameter leaf; "decode", of a decode step's logits."""
    losses = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"]))
    params = max(mesh_rel_l2(a, b) for a, b in zip(run["params"], ref["params"]))
    logits = max(mesh_rel_l2(a, b) for a, b in zip(run["logits"], ref["logits"]))
    return {"losses": losses, "params": params, "train": max(losses, params),
            "decode": logits}


def parity_cpu(mesh, payload: dict) -> dict:
    """(a) on the CPU ranks: rank 0 writes the run for the card's ranks."""
    import torch.distributed as dist

    run = parity_full(mesh, payload["seed"])
    if dist.get_rank() == 0:
        tmp = payload["parity_file"] + ".tmp"
        torch.save({k: run[k] for k in ("losses", "params", "logits")}, tmp)
        os.replace(tmp, payload["parity_file"])
    return {"losses": run["losses"]}


def parity_card(mesh, payload: dict) -> dict:
    """(a) on the card: clean and with each planted fault, every run's gap
    to the CPU ranks' run (waited for)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    runs = {"clean": parity_full(mesh, payload["seed"])}
    for fault in SHARDED_FAULTS:
        with planted(fault):
            if fault == "cache_row_wrong_shard":   # the clean training, a faulty decode
                runs[fault] = {**runs["clean"], "logits": parity_decode(mesh, runs["clean"])}
            else:
                runs[fault] = parity_full(mesh, payload["seed"])
    card_s = time.perf_counter() - t0
    if dist.get_rank() != 0:
        return {}
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    while not os.path.exists(payload["parity_file"]):
        check(time.monotonic() < deadline, "(a): the CPU ranks' run never arrived")
        time.sleep(0.5)
    ref = torch.load(payload["parity_file"], weights_only=False)
    gaps = {k: parity_gap(r, ref) for k, r in runs.items()}
    return {"seed": payload["seed"], "layers": PARITY_LAYERS,
            "tokens": PARITY_BATCH * PARITY_SEQ, "steps": PARITY_STEPS,
            "losses": runs["clean"]["losses"], "cpu_losses": ref["losses"],
            "clean": gaps["clean"], "faults": {f: gaps[f] for f in SHARDED_FAULTS},
            "limit": SHARDED_REL_LIMIT, "card_runs_s": card_s}


def experts_case(mesh, payload: dict) -> dict:
    """(b): `moe_ffn_sharded` at full width and capacity 1.25 on this rank's
    tokens and experts against `moe_ffn_sharded_plain` over the whole
    tensors, both on the card."""
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.specs import MeshAxes, local_block

    axes = MeshAxes.for_mesh(mesh)
    cfg = get_config(SHARDED_ARCH)
    moe_cfg = cfg.moe
    n_fsdp, n_tp = mesh.axis_size(axes.fsdp), mesh.shape[axes.tp]
    g = torch.Generator(device=mesh.device).manual_seed(SEED)
    dev, d, e, fe = mesh.device, cfg.d_model, moe_cfg.n_experts, moe_cfg.d_ff_expert
    # one direction shared by every token, as real activations share one:
    # it favours some experts, which then overflow their capacity
    x = (torch.randn(EXPERT_TOKENS_PER_SHARD * n_fsdp, d, generator=g, device=dev)
         + torch.randn(d, generator=g, device=dev))
    router = torch.randn(d, e, generator=g, device=dev) * 0.02
    wg, wu = (torch.randn(e, d, fe, generator=g, device=dev) / d ** 0.5 for _ in range(2))
    wd = torch.randn(e, fe, d, generator=g, device=dev) / fe ** 0.5
    with torch.no_grad():
        ex = [local_block(w, mesh, (axes.tp, None, None)) for w in (wg, wu, wd)]
        x_loc = local_block(x, mesh, (axes.fsdp, None))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux, dropped = lm_moe.moe_ffn_sharded(x_loc, router, *ex, moe_cfg, mesh, axes.fsdp,
                                                 axes.tp, with_dropped=True)
        torch.cuda.synchronize()
        sharded_ms = (time.perf_counter() - t0) * 1e3
        y = C.all_gather(y, mesh, axes.fsdp, 0)
        t0 = time.perf_counter()
        py, paux, pdropped = lm_moe.moe_ffn_sharded_plain(x, router, wg, wu, wd, moe_cfg, n_fsdp,
                                                          n_tp, with_dropped=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((y - py).abs().max())
    return {"tokens_per_shard": EXPERT_TOKENS_PER_SHARD, "capacity_factor": moe_cfg.capacity_factor,
            "dropped_pairs": int(dropped), "plain_dropped_pairs": int(pdropped),
            "pairs": x.shape[0] * moe_cfg.top_k, "max_abs_err": err,
            "bitwise": bool(torch.equal(y, py)), "aux": float(aux), "plain_aux": float(paux),
            "sharded_ms": sharded_ms, "plain_ms": plain_ms}


def bf16_case(mesh, payload: dict) -> dict:
    """(c): bf16 AdamW training at full width with `BF16_LAYERS` layers on
    the stream; the state saved from the mesh for (e)."""
    from repro_torch.sharding import collectives as C

    from repro_torch.sharding.params import shard_batch
    from repro_torch.utils.collective_stats import collective_stats

    cfg = dataclasses.replace(get_config(SHARDED_ARCH), n_layers=BF16_LAYERS)
    opt = OptConfig(lr=BF16_LR)
    torch.cuda.reset_peak_memory_stats()
    shs = train_lib.train_state_shardings(cfg, opt, mesh)
    state = train_lib.make_train_state(torch.Generator(device=mesh.device).manual_seed(SEED),
                                       cfg, opt, shardings=shs)
    fitted = all(tuple(t.shape) == sh.local_shape
                 for t, sh in zip(tree_leaves(state), tree_leaves(shs)))
    stream = TokenStream(vocab=cfg.vocab, batch=BF16_BATCH, seq_len=BF16_SEQ, seed=SEED)
    step = train_lib.make_train_step(cfg, opt, grad_shardings=shs.params)
    losses, step_ms, per_step, records = [], [], [], []
    batch = stream.batch_at(0)
    # (f): the bytes of the step's inputs on this rank (its state and its
    # block of the batch), and each step's own peak (steps after the first)
    arguments = state_bytes(state) + state_bytes(shard_batch(
        mesh, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg, "train"))
    gc.collect()
    peak, step_peaks = torch.cuda.max_memory_allocated(), []
    for i in range(BF16_STEPS):
        C.STATS.reset()
        if i:
            peak = max(peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with C.STATS.timed(), C.STATS.recording() as calls:
            state, m = step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(C.STATS.snapshot())
        records.append(collective_stats(calls))
        if i:
            step_peaks.append(torch.cuda.max_memory_allocated())
    peak = max([peak] + step_peaks)
    kinds = sorted({k for s in per_step[1:] for k in s})
    collectives = {k: {f: statistics.mean(s.get(k, {}).get(f, 0) for s in per_step[1:])
                       for f in ("calls", "bytes", "ms")} for k in kinds}
    on_card = all_on_card(state)
    t0 = time.perf_counter()
    train_ckpt.save(payload["ckpt_dir"], BF16_STEPS, state, shardings=shs)
    save_s = time.perf_counter() - t0
    return {"layers": BF16_LAYERS, "tokens_per_step": BF16_BATCH * BF16_SEQ,
            "parameters": sum(math.prod(sh.shape) for sh in tree_leaves(shs.params)),
            "losses": losses, "step_ms": step_ms,
            "step_ms_median": statistics.median(step_ms[1:]),
            "peak_mem_gb": peak / 1e9, "step_peak_bytes": step_peaks,
            "argument_bytes": arguments,
            "local_state_gb": state_bytes(state) / 1e9, "all_on_card": on_card,
            "fitted_shapes": fitted, "collectives_per_step": collectives, "save_s": save_s,
            "stats_per_step": per_step[1:], "records_per_step": records[1:]}


def decode_greedy(model, prompt: torch.Tensor) -> tuple:
    logits, cache = model.prefill(prompt, max_len=MESH_DECODE_MAX_LEN)
    tokens, steps = [], [logits]
    t0 = time.perf_counter()
    for _ in range(MESH_DECODE_STEPS):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        tokens.append(tok)
        logits, cache = model.decode_step(cache, tok)
        steps.append(logits)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / MESH_DECODE_STEPS
    return torch.cat(tokens, 1), torch.stack(steps), ms


def decode_case(mesh, payload: dict) -> dict:
    """(d): greedy decode on the mesh against one process's on the card
    (rank 0), from the same draw."""
    import torch.distributed as dist

    from repro_torch.sharding.params import local_tree, param_shardings

    out = {}
    for arch, layers in MESH_DECODE_LAYERS.items():
        cfg = dataclasses.replace(cut_depth(get_config(arch), layers), dtype="float32")
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        whole = init_params(torch.Generator(device=mesh.device).manual_seed(SEED), cfg,
                            mesh.device)
        model = CausalLM(cfg, local_tree(whole, param_shardings(cfg, mesh)), mesh=mesh)
        if dist.get_rank() != 0:
            del whole
        prompt = torch.as_tensor(np.random.RandomState(SEED).randint(
            0, cfg.vocab, (MESH_DECODE_BATCH, MESH_DECODE_PROMPT)).astype(np.int32))
        tokens, logits, mesh_ms = decode_greedy(model, prompt)
        del model
        if dist.get_rank() == 0:
            one = CausalLM(cfg, whole, device=mesh.device)
            del whole
            want_tokens, want_logits, one_ms = decode_greedy(one, prompt)
            del one
            out[arch.replace("-", "_").replace(".", "_")] = {
                "layers": layers, "token_mismatches": int((tokens != want_tokens).sum()),
                "max_rel_l2": max(mesh_rel_l2(a, b) for a, b in zip(logits, want_logits)),
                "limit": SHARDED_REL_LIMIT["decode"], "mesh_decode_ms_per_token": mesh_ms,
                "one_process_decode_ms_per_token": one_ms}
        gc.collect()
        torch.cuda.empty_cache()
    return out


def restore_case(mesh, payload: dict) -> dict:
    """(e) on a smaller mesh: (c)'s checkpoint restored as this mesh's
    blocks, gathered whole, each leaf against its file, bitwise."""
    from repro_torch.sharding import collectives as C

    cfg = dataclasses.replace(get_config(SHARDED_ARCH), n_layers=BF16_LAYERS)
    opt = OptConfig(lr=BF16_LR)
    shs = train_lib.train_state_shardings(cfg, opt, mesh)
    t0 = time.perf_counter()
    state, step = train_ckpt.restore(payload["ckpt_dir"], train_lib.train_state_shapes(cfg, opt),
                                     shardings=shs)
    restore_s = time.perf_counter() - t0
    fitted = all(tuple(t.shape) == sh.local_shape and t.device.type == "cuda"
                 for t, sh in zip(tree_leaves(state), tree_leaves(shs)))
    whole = C.gather_tree(state, shs)
    return {"step": step, "fitted_shapes": fitted, "restore_s": restore_s,
            "bitwise_equal": ckpt_equal(payload["ckpt_dir"], step, whole)}


def ckpt_equal(ckpt_dir: str, step: int, tree) -> bool:
    """Every leaf of ``tree`` bitwise its checkpoint file's."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        leaves = json.load(f)["leaves"]
    flat = train_ckpt._flatten(tree)
    same = sorted(flat) == sorted(leaves)
    for k, meta in leaves.items():
        want = train_ckpt._read_leaf(os.path.join(d, meta["file"]), meta["dtype"])
        same &= bool(torch.equal(flat[k], want.to(flat[k].device)))
    return same


SHARDED_CASES = {"gloo": lambda mesh, payload: gloo_on_cuda(mesh), "experts": experts_case,
                 "decode": decode_case, "bf16": bf16_case, "parity": parity_card,
                 "parity_cpu": parity_cpu, "restore": restore_case}


def sharded_rank(payload: dict, device: torch.device) -> dict:
    """One rank of the sharded phase: its mesh, then each case of the
    payload in order, the card's memory handed back between."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(*payload["mesh"], device=device)
    out = {"coords": mesh.coords}
    circuit_eval.reset_launch_counts()
    for case in payload["cases"]:
        t0 = time.perf_counter()
        out[case] = SHARDED_CASES[case](mesh, payload)
        out[case + "_s"] = time.perf_counter() - t0
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["launches"] = launch_counts()   # this rank's, over its cases
    return out


def sharded_groups(cases: list, seed: int, tmp: str) -> tuple:
    """The card's ranks (``cases``) and, when (a) runs, the CPU's ranks
    started together: → (card ranks, CPU ranks or None)."""
    from concurrent.futures import ThreadPoolExecutor

    os.environ["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    common = {"mesh": SHARDED_MESH, "seed": seed, "parity_file": os.path.join(tmp, "parity.pt"),
              "ckpt_dir": os.path.join(tmp, "ckpt")}
    world = SHARDED_MESH[0] * SHARDED_MESH[1]
    with ThreadPoolExecutor(max_workers=2) as pool:
        cpu = None
        if "parity" in cases:
            cpu = pool.submit(spawn_ranks, "chip_smoke:sharded_rank",
                              {**common, "cases": ["parity_cpu"]}, world, device="cpu",
                              timeout_s=SHARDED_TIMEOUT_S)
        card = pool.submit(spawn_ranks, "chip_smoke:sharded_rank", {**common, "cases": cases},
                           world, device=DEVICE, timeout_s=SHARDED_TIMEOUT_S)
        return card.result(), None if cpu is None else cpu.result()


def check_parity(r: dict) -> None:
    for reading, limit in r["limit"].items():
        check(limit is not None, "(a): no limit is set (--sharded-calibrate)")
        check(r["clean"][reading] <= limit, f"(a): the card's sharded {reading} differs from the "
                                            f"CPU's by {r['clean'][reading]} > {limit}")
    for fault, reading in SHARDED_FAULTS.items():
        gap, limit = r["faults"][fault][reading], r["limit"][reading]
        check(gap > limit, f"(a): the planted fault {fault} moves the {reading} reading by "
                           f"{gap}, within the limit {limit}")


def dry_prediction(traced: dict, real: dict) -> dict:
    """(f): the dry run's trace of (c)'s step against rank 0's real steps:
    each kind's calls and bytes a step (`STATS`' units, and the
    reference's record), the argument bytes, the peak."""
    def kinds(snap):
        return {k.split(":")[0]: {f: v[f] for f in ("calls", "bytes")} for k, v in snap.items()}

    want = kinds(traced["stats"])
    peak = traced["memory"]["peak_size_in_bytes"]
    real_peak = max(real["step_peak_bytes"])
    return {"traced_per_step": want, "real_per_step": kinds(real["stats_per_step"][0]),
            "stats_equal": all(kinds(snap) == want for snap in real["stats_per_step"]),
            "records_equal": all(r == traced["collectives"] for r in real["records_per_step"]),
            "traced_argument_bytes": traced["memory"]["argument_size_in_bytes"],
            "real_argument_bytes": real["argument_bytes"],
            "traced_peak_bytes": peak, "real_step_peak_bytes": real["step_peak_bytes"],
            "peak_gap": peak / real_peak - 1.0, "peak_band": DRY_PEAK_BAND,
            "traced_flops": traced["cost"]["flops"], "trace_s": traced["trace_s"]}


def phase_sharded(dry: dict) -> dict:
    """Sharded training and decode on a 2 x 2 mesh of gloo ranks sharing
    the card (phase 14 of the module doc), (c) held to the dry run's trace
    of its step in ``dry`` (`dry_worker`, run before the ranks spawn).  No
    kernel of the table runs on it."""
    t_phase = time.perf_counter()
    circuit_eval.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="sharded-") as tmp:
        card, cpu = sharded_groups(["gloo", "experts", "decode", "bf16", "parity"], SEED, tmp)
        small = spawn_ranks("chip_smoke:sharded_rank",
                            {"mesh": (1, 2), "cases": ["restore"],
                             "ckpt_dir": os.path.join(tmp, "ckpt")}, 2, device=DEVICE,
                            timeout_s=SHARDED_TIMEOUT_S)
        cfg = dataclasses.replace(get_config(SHARDED_ARCH), n_layers=BF16_LAYERS)
        t0 = time.perf_counter()
        one, step = train_ckpt.restore(os.path.join(tmp, "ckpt"),
                                       train_lib.train_state_shapes(cfg, OptConfig()),
                                       device=DEVICE)
        one_s = time.perf_counter() - t0
        one_equal = ckpt_equal(os.path.join(tmp, "ckpt"), step, one)
        del one
    r0 = card[0]
    bf16 = r0["bf16"]
    out = {"phase": "sharded", "card": gpu_line(), "mesh": "x".join(map(str, SHARDED_MESH)),
           "ranks": len(card), "transport": "gloo",
           "boot_s": [r["boot_s"] for r in card], "gloo_on_cuda": r0["gloo"],
           "parity": r0["parity"], "experts": r0["experts"],
           "bf16_training": {**{k: v for k, v in bf16.items()
                                if k not in ("stats_per_step", "records_per_step")},
                             "peak_mem_gb": [r["bf16"]["peak_mem_gb"] for r in card],
                             "all_on_card": all(r["bf16"]["all_on_card"] for r in card),
                             "fitted_shapes": all(r["bf16"]["fitted_shapes"] for r in card)},
           "dry_run": dry_prediction(dry["sharded_c"], bf16),
           "decode": r0["decode"],
           "elastic": {"saved_on": "2x2", "mesh_1x2": small[0]["restore"],
                       "one_process": {"step": step, "bitwise_equal": one_equal,
                                       "restore_s": one_s}},
           "case_s": {k[:-2]: v for k, v in r0.items() if k.endswith("_s") and k != "boot_s"},
           "cpu_ranks_parity_s": cpu[0]["parity_cpu_s"],
           # every process of the phase: the card's ranks, the 1 x 2 ranks
           # and this process's restore
           "launches": {k: v + sum(r["launches"][k] for r in card + small)
                        for k, v in launch_counts().items()},
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    check(all(out["gloo_on_cuda"].values()), f"gloo on CUDA tensors: {out['gloo_on_cuda']}")
    check_parity(out["parity"])
    ex = out["experts"]
    check(ex["dropped_pairs"] == ex["plain_dropped_pairs"] and ex["dropped_pairs"] > 0,
          f"(b): dropped pairs {ex['dropped_pairs']} against {ex['plain_dropped_pairs']}")
    check(ex["max_abs_err"] <= EXPERT_ATOL, f"(b): the sharded experts differ by "
                                            f"{ex['max_abs_err']}")
    b = out["bf16_training"]
    check(all(math.isfinite(x) for x in b["losses"]) and b["losses"][-1] < b["losses"][0],
          f"(c): losses {b['losses']}")
    check(b["all_on_card"] and b["fitted_shapes"], "(c): a rank's state is off the card or "
                                                   "not its fitted block")
    f = out["dry_run"]
    check(f["stats_equal"] and f["records_equal"],
          f"(f): the dry run's collectives {f['traced_per_step']} differ from a real step's "
          f"{f['real_per_step']}")
    check(f["traced_argument_bytes"] == f["real_argument_bytes"],
          f"(f): argument bytes {f['traced_argument_bytes']} traced, "
          f"{f['real_argument_bytes']} held")
    check(abs(f["peak_gap"]) <= DRY_PEAK_BAND,
          f"(f): the traced peak {f['traced_peak_bytes']} is {f['peak_gap']:+.3%} off a real "
          f"step's {f['real_step_peak_bytes']}")
    for name, r in out["decode"].items():
        check(r["token_mismatches"] == 0, f"(d) {name}: {r['token_mismatches']} tokens differ")
        check(r["max_rel_l2"] <= r["limit"], f"(d) {name}: logits differ by "
                                             f"{r['max_rel_l2']} > {r['limit']}")
    e = out["elastic"]
    check(e["mesh_1x2"]["bitwise_equal"] and e["mesh_1x2"]["fitted_shapes"]
          and e["one_process"]["bitwise_equal"], f"(e): {e}")
    check(not any(out["launches"].values()),
          f"the sharded path launched a circuit kernel: {out['launches']}")
    return out


def sharded_calibrate(seeds: int) -> int:
    """``--sharded-calibrate N``: (a) over N seeds of weights and batch,
    clean and with each planted fault (the readings `SHARDED_REL_LIMIT`
    is set from), then (d)'s gaps once; one line per run, then the
    largest clean gap and each fault's smallest."""
    runs = []
    for seed in range(seeds):
        with tempfile.TemporaryDirectory(prefix="sharded-") as tmp:
            card, _ = sharded_groups(["parity"], seed, tmp)
        runs.append(card[0]["parity"])
        emit({"phase": "sharded_calibrate_run", **runs[-1]})
    with tempfile.TemporaryDirectory(prefix="sharded-") as tmp:
        card, _ = sharded_groups(["decode"], SEED, tmp)
    emit({"phase": "sharded_calibrate_decode", **card[0]["decode"]})
    emit({"phase": "sharded_calibrate", "card": gpu_line(), "seeds": seeds,
          "train_clean_max": max(run["clean"]["train"] for run in runs),
          "decode_clean_max": max([run["clean"]["decode"] for run in runs]
                                  + [r["max_rel_l2"] for r in card[0]["decode"].values()]),
          **{f"{f}_{r}_min": min(run["faults"][f][r] for run in runs)
             for f, r in SHARDED_FAULTS.items()}})
    return 0


# -- 15. the dry run on the card's host ---------------------------------------
# `dry_worker` runs in a process of its own, started before phase 4e (so
# that its CPU-bound traces overlap the card's phases): (f)'s trace of
# (c)'s step on a fake 2 x 2 world of card tensors, then these production
# cells over fake worlds of 256 and 512 ranks.  Chosen by trace time (PERF.md
# §6): the decode of the hybrid on the multi-pod mesh, the island cell and
# granite's decode, seconds each; a full-size train cell (granite's took
# 289 s on the card's host) slowed the phases it ran beside, and (f)
# already traces a train step.
DRYRUN_CELLS = (("hymba-1.5b", "decode_32k", "multi_pod_2x16x16"),
                ("autotc", "tab_small", "single_pod_16x16"),
                ("granite-moe-1b-a400m", "decode_32k", "single_pod_16x16"))
DRY_PEAK_BAND = 0.10    # (f): the traced peak within 10 % of a real step's
DRY_TIMEOUT_S = 900.0


def dry_worker(out_path: str) -> int:
    """``python3 chip_smoke.py --dryrun-worker OUT``: phase 15's traces
    (module doc), written to OUT as JSON."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.sharding import collectives as C

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    mesh = dryrun.fake_host_mesh(SHARDED_MESH, DEVICE)
    cfg = dataclasses.replace(get_config(SHARDED_ARCH), n_layers=BF16_LAYERS)
    C.STATS.reset()
    traced = dryrun.trace_step(cfg, ShapeConfig("sharded_c", "train", BF16_SEQ, BF16_BATCH),
                               mesh, OptConfig(lr=BF16_LR))
    out = {"sharded_c": {**{k: v for k, v in traced.items() if k != "ops"},
                         "stats": C.STATS.snapshot()}, "cells": []}
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        for arch, shape, mesh_name in DRYRUN_CELLS:
            t_cell = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, dryrun.production_mesh(mesh_name, DEVICE),
                                  mesh_name, tmp, force=True)
            rec.pop("ops", None)
            out["cells"].append({**rec, "wall_s": time.perf_counter() - t_cell})
    out["launches"] = launch_counts()
    out["worker_s"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


@contextlib.contextmanager
def dry_worker_running():
    """`dry_worker` started in a process of its own for the block, and
    killed at its end if it still runs."""
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        path = os.path.join(tmp, "dry.json")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(ROOT, "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                                 "--dryrun-worker", path], cwd=ROOT, env=env,
                                stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
        try:
            yield proc, path, time.perf_counter()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def finish_dry_worker(worker: tuple) -> dict:
    """The worker's result (it has had the phases since 4e to run); it is
    killed past `DRY_TIMEOUT_S` from its start."""
    proc, path, t0 = worker
    try:
        _, err = proc.communicate(timeout=max(1.0, DRY_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure(f"the dry-run worker did not finish within {DRY_TIMEOUT_S} s")
    check(proc.returncode == 0, f"the dry-run worker failed:\n{err[-4000:]}")
    with open(path) as f:
        out = json.load(f)
    out["waited_s"] = time.perf_counter() - t0
    return out


def phase_dryrun(dry: dict) -> dict:
    """Phase 15: each production cell's record from the card's host
    (`launch/dryrun.py`), every one ``ok``; memory, FLOPs and collective
    bytes a rank.  The FLOPs are also read at the card's dense bf16 peak
    (989 TFLOP/s, an H100 SXM's data sheet) beside the card's name and
    power limit."""
    cells = []
    for rec in dry["cells"]:
        cell = {k: rec.get(k) for k in ("arch", "shape", "mesh", "n_devices", "status", "kind",
                                        "tokens", "trace_s", "wall_s", "error")}
        if rec.get("status") == "ok":
            cell.update(memory=rec["memory"], flops=rec["cost"].get("flops"),
                        collectives=rec["collectives"], first_step=rec.get("first_step"))
            if rec["kind"] != "evolve":
                cell["flops_ms_at_bf16_dense_peak"] = rec["cost"]["flops"] / BF16_DENSE_FLOPS * 1e3
        cells.append(cell)
    out = {"phase": "dryrun", "card": gpu_line(), "cells": cells,
           "worker_s": dry["worker_s"], "waited_s": dry["waited_s"],
           "launches": dry["launches"]}
    emit(out)
    for c in cells:
        check(c["status"] == "ok", f"dryrun {c['arch']} x {c['shape']} on {c['mesh']}: "
                                   f"{c['status']} {c.get('error')}")
    check(not any(out["launches"].values()), f"the dry run launched a kernel: {out['launches']}")
    return out


# -- A/B against another tree ----------------------------------------------
def run_summary(text: str) -> dict:
    """Each kernel's ``ms`` and uncompacted ms, the one-shard ticks'
    launch-phase ms and the swap phase's swap ms and tick latencies, from
    one run's standard output."""
    out = {"kernels": {}, "launch_ms": [], "swap": None}
    for line in text.splitlines():
        if not line.startswith("{"):
            continue
        obj = json.loads(line)
        if "kernels" in obj:
            out["kernels"] = {k["name"]: {"ms": k["ms"], "uncompacted_ms": k.get("uncompacted_ms")}
                              for k in obj["kernels"]}
        elif obj.get("phase") == "serve":
            out["launch_ms"] = [t["phase_s"]["launch"] * 1e3 for r in obj["runs"]
                                if r["n_shards"] == 1 for t in r["ticks"]]
        elif obj.get("phase") == "env":
            out["card"] = obj["card"]
        elif obj.get("phase") == "swap":
            out["swap"] = {"swap_ms": [e["swap_ms"] for e in obj["events"]],
                           "first_post_swap_tick_ms": obj["first_post_swap_tick_ms"],
                           "steady_tick_ms_median": obj["steady_tick_ms_median"],
                           "boot_start_to_first_answer_ms":
                               obj["boot"]["wall_ms"]["start_to_first_answer_ms"]}
    return out


def run_ab(other: str) -> int:
    """``python3 chip_smoke.py --ab DIR``: this tree's smoke run against the
    one in DIR (another checkout, such as the parent commit) on the same
    card, in turns other, this, this, other.  Each run's output goes to
    ``chiprun_out/ab<i>_<tree>.txt``; one summary line per run, then the
    medians per tree (steady ticks: all but each run's first)."""
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    trees = {"other": os.path.abspath(other), "this": ROOT}
    per_tree: dict = {"other": [], "this": []}
    failed = 0
    for i, which in enumerate(("other", "this", "this", "other"), 1):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=trees[which],
                             capture_output=True, text=True, timeout=1200)
        run_s = time.perf_counter() - t0
        with open(os.path.join(ROOT, "chiprun_out", f"ab{i}_{which}.txt"), "w") as f:
            f.write(res.stdout + res.stderr)
        summ = run_summary(res.stdout)
        failed += res.returncode != 0
        per_tree[which].append(summ)
        emit({"ab": i, "tree": which, "rc": res.returncode, "run_s": run_s, **summ})
    for which, runs in per_tree.items():
        names = runs[0]["kernels"] if runs else {}
        emit({"ab": "median", "tree": which,
              "kernel_ms": {n: [r["kernels"].get(n, {}).get("ms") for r in runs] for n in names},
              "launch_median_ms": statistics.median(
                  [v for r in runs for v in r["launch_ms"]] or [float("nan")]),
              "steady_launch_median_ms": statistics.median(
                  [v for r in runs for v in r["launch_ms"][1:]] or [float("nan")]),
              "swap": [r["swap"] for r in runs]})
    return 1 if failed else 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        return run_ab(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--lm-calibrate":
        return lm_calibrate(int(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--train-calibrate":
        return train_calibrate(int(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--sharded-calibrate":
        return sharded_calibrate(int(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--dryrun-worker":
        return dry_worker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--evolve-rollbacks":
        phase_env()
        phase_evolve(int(sys.argv[2]))
        return 0
    t_start = time.perf_counter()
    phase_env()
    checks = phase_kernel_checks()
    gold = golden()
    predict_launches = phase_predict(gold)
    serve_launches, timing_case, profile_case = phase_serve(gold)
    path_launches = {**phase_swap(gold), **phase_async(gold), **phase_autoscale(gold)}
    # the dry-run worker traces beside the phases from 4e on
    with dry_worker_running() as worker:
        evolve_spans, evolve_population = phase_evolve()
        path_launches.update(evolve_spans)
        path_launches.update(phase_fleet())
        split = higgs_split()
        island_launches = phase_islands(split)
        fit_launches, higgs_clf = phase_fit(gold, split)
        population_launches = {"predict": predict_launches["eval_population"], **fit_launches,
                               "evolve": evolve_population, "islands": island_launches}
        fit_parity_case = phase_fit_parity(split)
        population_launches["toolflow"], baselines = phase_toolflow(higgs_clf, split)
        entries = phase_timing(gold, checks, population_launches, serve_launches, path_launches,
                               timing_case, fit_parity_case)
        phase_sweep(gold)
        phase_profile(profile_case)
        phase_mlp_profile(baselines)
        phase_lm()
        phase_train()
        dry = finish_dry_worker(worker)
        phase_sharded(dry)
        phase_dryrun(dry)
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} was not launched on the main path")
    check(all(v > 0 for v in population_launches.values()),
          f"eval_population was not launched on every path: {population_launches}")
    emit({"kernels": entries})
    print(gpu_line(), flush=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
