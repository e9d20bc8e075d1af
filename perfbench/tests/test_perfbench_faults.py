"""A run with the timed path broken underneath comes out as not correct, once
for each fault that a cell can have: a step that returns its state
unchanged (the search), half of the batch left out, and an answer altered
where it is produced.  (Every cell runs on one chip: no exchange between
chips to leave out.)"""
import time

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import MIXES, SMALL


def run_cell(workload: str):
    cell = harness.mix_cell(*MIXES[workload], SMALL)
    run = harness.driver(cell).run(harness.Context(cell, 2**31 + 3, 1.0, False, "cpu",
                                                   time.perf_counter()))
    return run


def state_unchanged(mp):
    from repro_torch.core import evolve
    step = evolve.generation_step

    def broken(state, *args):
        step(state, *args)
        return state
    mp.setattr(evolve, "generation_step", broken)


def half_the_rows_for_fitness(mp):
    from repro_torch.core import fitness
    counts = fitness.confusion_counts

    def broken(out_words, data, mask_words, count=None):
        half = mask_words.clone()
        half[..., half.shape[-1] // 2:] = 0
        return counts(out_words, data, half)   # the mean over the rest
    mp.setattr(fitness, "confusion_counts", broken)


def fitness_altered(mp):
    from repro_torch.core import fitness
    acc = fitness.balanced_accuracy_from_counts

    def broken(correct, count, *, in_loop=True):
        fit = acc(correct, count, in_loop=in_loop).copy()
        fit[..., 0] = np.nextafter(fit[..., 0], np.float32(2))
        return fit
    mp.setattr(fitness, "balanced_accuracy_from_counts", broken)


def half_the_rows_served(mp, module):
    decode = module.decode_predictions

    def broken(out_words, n_rows, n_classes):
        words = np.array(out_words, copy=True)
        words[..., words.shape[-1] // 2:] = 0
        return decode(words, n_rows, n_classes)
    mp.setattr(module, "decode_predictions", broken)


def answer_altered(mp, module):
    decode = module.decode_predictions

    def broken(out_words, n_rows, n_classes):
        ids = decode(out_words, n_rows, n_classes).copy()
        ids[:1] = 1 - ids[:1]
        return ids
    mp.setattr(module, "decode_predictions", broken)


def served(fault):
    def plant(mp):
        from repro_torch.serve.circuits import server
        fault(mp, server)
    return plant


@pytest.mark.parametrize("workload, plant", [
    ("higgs.search", state_unchanged),
    ("higgs.search", half_the_rows_for_fitness),
    ("higgs.search", fitness_altered),
    ("higgs.serve", served(half_the_rows_served)),
    ("higgs.serve", served(answer_altered)),
])
def test_a_broken_timed_path_is_not_correct(workload, plant, monkeypatch):
    assert run_cell(workload).correct
    with monkeypatch.context() as mp:
        plant(mp)
        run = run_cell(workload)
    assert not run.correct, run.checks
    torch.manual_seed(0)
