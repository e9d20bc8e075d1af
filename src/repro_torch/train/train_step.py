"""Train step: loss → grad → optimizer update, with microbatch gradient
accumulation and optional int8 error-feedback gradient compression
(PyTorch port of the reference's ``train_step.py``).

The step is a function of (TrainState, batch) → (TrainState, metrics)
that writes nothing in place: the state it is given stays valid, as a
checkpoint or a second run needs.  Gradients come from
``torch.autograd.grad`` over the parameter tree (`models.lm.forward`,
rematerialised as ``cfg.remat`` says).  The reference's
``grad_shardings`` (gradients and the accumulator pinned to the
parameters' layout on a mesh) belongs to the sharding slice and is not
carried over: on one device there is no layout to pin.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import init_params, param_dtype, param_shapes
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.train.optimizer import (OptConfig, OptState, apply_updates, init_opt_state,
                                         tree_leaves, tree_map)

AUX_LOSS_WEIGHT = 0.01  # MoE load-balance coefficient


class TrainState(NamedTuple):
    params: dict
    opt: OptState
    step: torch.Tensor  # () int32


def make_train_state(generator: torch.Generator, cfg: ModelConfig, opt_cfg: OptConfig,
                     device: "str | torch.device | None" = None) -> TrainState:
    """A random start (`init_params`, drawn on the generator's device) and
    zero moments on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    params = init_params(generator, cfg, device)
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def train_state_shapes(cfg: ModelConfig, opt_cfg: OptConfig) -> TrainState:
    """The TrainState's shapes and dtypes on the ``meta`` device (no
    allocation), standing for the reference's ``jax.eval_shape``."""
    def meta(name, shape):
        return torch.empty(shape, dtype=param_dtype(cfg, name), device="meta")

    shapes = param_shapes(cfg)
    params = {k: ({n: meta(n, s) for n, s in v.items()} if isinstance(v, dict) else meta(k, v))
              for k, v in shapes.items()}
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device="meta"))


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    """→ (ce + `AUX_LOSS_WEIGHT` · aux, {"ce", "aux"})."""
    logits, aux, _ = lm.forward(params, cfg, tokens=batch.get("tokens"),
                                embeds=batch.get("embeds"), positions=batch.get("positions"))
    ce = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
    return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux}


def _value_and_grad(params: dict, cfg: ModelConfig, batch: dict):
    """(loss, metrics, grads) with grads a tree like ``params``, each in
    its parameter's dtype."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def _grads(params: dict, cfg: ModelConfig, batch: dict, microbatches: int):
    if microbatches <= 1:
        return _value_and_grad(params, cfg, batch)

    # split the global batch on the leading axis and accumulate in
    # cfg.grad_accum_dtype (fp32 by default; bf16 for the 405B-class configs)
    acc_dt = torch.bfloat16 if cfg.grad_accum_dtype == "bfloat16" else torch.float32

    def split(x, i):
        b = x.shape[0]
        assert b % microbatches == 0, (b, microbatches)
        n = b // microbatches
        return x[i * n:(i + 1) * n]

    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt, device=p.device), params)
    loss_sum = 0.0
    for i in range(microbatches):
        loss, _m, g = _value_and_grad(params, cfg, {k: split(v, i) for k, v in batch.items()})
        acc = tree_map(lambda a, b: a + b.to(acc_dt), acc, g)
        loss_sum = loss_sum + loss
    inv = 1.0 / microbatches
    loss = loss_sum * inv
    # the reference reports the mean loss as "ce" and aux 0 on this path
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=loss.device)}, \
        tree_map(lambda g: g * inv, acc)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, microbatches: int = 1, compress=None):
    """→ ``train_step(state, batch) -> (state, metrics)`` with metrics
    {ce, aux, loss, grad_norm} as 0-d tensors on the state's device (no
    wait for the host).  ``batch``: tensors or numpy arrays ("tokens" or
    "embeds", "labels", optional "positions" and "loss_mask"), moved to
    the state's device.  ``compress``: a callable grads → grads, such as
    a `grad_compress.Compressor` step."""
    def train_step(state: TrainState, batch: dict):
        device = state.step.device
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        loss, metrics, grads = _grads(state.params, cfg, batch, microbatches)
        if compress is not None:
            grads = compress(grads)
        new_params, new_opt, opt_metrics = apply_updates(state.params, grads, state.opt, opt_cfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
