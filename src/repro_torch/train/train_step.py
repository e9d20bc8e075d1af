"""Train step: loss → grad → optimizer update, with microbatch gradient
accumulation and optional int8 error-feedback gradient compression
(PyTorch port of the reference's ``train_step.py``).

The step is a function of (TrainState, batch) → (TrainState, metrics)
that writes nothing in place: the state it is given stays valid, as a
checkpoint or a second run needs.  Gradients come from
``torch.autograd.grad`` over the parameter tree (`models.lm.forward`,
rematerialised as ``cfg.remat`` says).

**On a mesh** (``make_train_step(..., grad_shardings=)``, the parameters'
`Sharding` tree from `train_state_shardings`): the state holds this
rank's blocks (`make_train_state(..., shardings=)`: every rank draws the
same whole start from one seeded generator and keeps its blocks), the
step takes the whole batch and runs its rows of it (`shard_batch`; all
of it on every rank when the fsdp axes do not divide it), each
layer's parameters are gathered as it runs, and the gradients come back
reduced and scattered into the parameters' layout (the gathers'
backward): the reference's ``grad_shardings``.  The microbatch
accumulator lives in that layout too.  Each rank differentiates its share
of the loss (`loss_fn`): its tokens' summed cross entropy over the whole
batch's token count, over the ranks that hold the same tokens, plus the
aux loss over the world size; the shares sum to the reference's loss, and
the metrics are their sum over the mesh.  The optimizer updates the
blocks (`optimizer.apply_updates(..., shardings=)`).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import init_params, param_dtype, param_shapes
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.sharding import collectives as C
from repro_torch.sharding.params import (batch_divides, local_tree, shard_batch,
                                         train_state_specs, tree_shardings, zip_tree)
from repro_torch.sharding.specs import (MeshAxes, batch_split, current_mesh, local_block,
                                        use_mesh_axes)
from repro_torch.train.optimizer import (OptConfig, OptState, apply_updates, init_opt_state,
                                         tree_leaves, tree_map)

AUX_LOSS_WEIGHT = 0.01  # MoE load-balance coefficient


class TrainState(NamedTuple):
    params: dict
    opt: OptState
    step: torch.Tensor  # () int32


def make_train_state(generator: torch.Generator, cfg: ModelConfig, opt_cfg: OptConfig,
                     device: "str | torch.device | None" = None,
                     shardings: "TrainState | None" = None) -> TrainState:
    """A random start (`init_params`, drawn on the generator's device) and
    zero moments on ``device`` (``None``: the card).  With ``shardings``
    (`train_state_shardings`): this rank's blocks of that start, on the
    mesh's device."""
    if shardings is not None:
        device = shardings.step.mesh.device
        params = local_tree(init_params(generator, cfg, generator.device), shardings.params)
        params = tree_map(lambda t: t.to(device), params)
        opt = zip_tree(lambda t, sh: torch.zeros(sh.local_shape, dtype=t.dtype, device=device),
                       train_state_shapes(cfg, opt_cfg).opt, shardings.opt)
        return TrainState(params=params, opt=opt,
                          step=torch.zeros((), dtype=torch.int32, device=device))
    device = resolve_device(device)
    params = init_params(generator, cfg, device)
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def train_state_shapes(cfg: ModelConfig, opt_cfg: OptConfig,
                       shardings: "TrainState | None" = None) -> TrainState:
    """The TrainState's shapes and dtypes on the ``meta`` device (no
    allocation), standing for the reference's ``jax.eval_shape``; with
    ``shardings``, this rank's local shapes."""
    def meta(name, shape):
        return torch.empty(shape, dtype=param_dtype(cfg, name), device="meta")

    shapes = param_shapes(cfg)
    params = {k: ({n: meta(n, s) for n, s in v.items()} if isinstance(v, dict) else meta(k, v))
              for k, v in shapes.items()}
    whole = TrainState(params=params, opt=init_opt_state(params, opt_cfg),
                       step=torch.zeros((), dtype=torch.int32, device="meta"))
    if shardings is None:
        return whole
    return zip_tree(lambda t, sh: torch.empty(sh.local_shape, dtype=t.dtype, device="meta"),
                    whole, shardings)


def train_state_shardings(cfg: ModelConfig, opt_cfg: OptConfig, mesh) -> TrainState:
    """The TrainState's `Sharding`s on ``mesh``: `train_state_specs` fitted
    to `train_state_shapes` (the reference's ``tree_shardings``)."""
    return tree_shardings(mesh, train_state_shapes(cfg, opt_cfg),
                          train_state_specs(cfg, MeshAxes.for_mesh(mesh), opt_cfg.kind))


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    """→ (ce + `AUX_LOSS_WEIGHT` · aux, {"ce", "aux"}).  Under a mesh
    (``batch`` this rank's rows): → (this rank's share of the loss, {"ce",
    "aux", "loss"} over the whole batch) (module doc)."""
    logits, aux, _ = lm.forward(params, cfg, tokens=batch.get("tokens"),
                                embeds=batch.get("embeds"), positions=batch.get("positions"))
    ctx = current_mesh()
    if ctx is None:
        ce = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
        return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux}
    mesh, axes = ctx
    labels, mask = batch["labels"], batch.get("loss_mask")
    b, s = labels.shape
    if lm._seq_split(s):  # the logits are of this rank's block of the sequence
        labels = local_block(labels, mesh, (None, axes.tp))
        mask = None if mask is None else local_block(mask, mesh, (None, axes.tp))
    row_blocks = mesh.axis_size(axes.fsdp) if batch_split() else 1
    tokens_held = row_blocks * (mesh.shape[axes.tp] if lm._seq_split(s) else 1)
    replicas = mesh.size // tokens_held  # ranks holding the same tokens
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        count = float(b * row_blocks * s)
        nll_sum = nll.sum()
    else:
        mask = mask.float()
        nll_sum = (nll * mask).sum()
        count = torch.clamp(C._raw_all_reduce(mask.sum(), mesh, mesh.axis_names) / replicas,
                            min=1.0)
    share = nll_sum / count / replicas + AUX_LOSS_WEIGHT * aux / mesh.size
    ce = C._raw_all_reduce((nll_sum / count / replicas).detach(), mesh, mesh.axis_names)
    return share, {"ce": ce, "aux": aux.detach(),
                   "loss": C._raw_all_reduce(share.detach(), mesh, mesh.axis_names)}


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
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (metrics.pop("loss", loss.detach()), metrics, tree_map(lambda _: next(it), params))


def _grads(params: dict, cfg: ModelConfig, batch: dict, microbatches: int):
    """(loss, metrics, grads) over the whole ``batch``; under a mesh each
    (micro)batch is cut to this rank's rows first."""
    ctx = current_mesh()

    def value_and_grad(b: dict):
        if ctx is None:
            return _value_and_grad(params, cfg, b)
        mesh = ctx[0]
        split = batch_divides(mesh, next(iter(b.values())).shape[0])
        with use_mesh_axes(mesh, split):
            return _value_and_grad(params, cfg, shard_batch(mesh, b, cfg, "train"))

    if microbatches <= 1:
        return value_and_grad(batch)

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
        loss, _m, g = value_and_grad({k: split(v, i) for k, v in batch.items()})
        acc = tree_map(lambda a, b: a + b.to(acc_dt), acc, g)
        loss_sum = loss_sum + loss
    inv = 1.0 / microbatches
    loss = loss_sum * inv
    # the reference reports the mean loss as "ce" and aux 0 on this path
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=loss.device)}, \
        tree_map(lambda g: g * inv, acc)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, microbatches: int = 1, compress=None,
                    grad_shardings=None):
    """→ ``train_step(state, batch) -> (state, metrics)`` with metrics
    {ce, aux, loss, grad_norm} as 0-d tensors on the state's device (no
    wait for the host).  ``batch``: tensors or numpy arrays ("tokens" or
    "embeds", "labels", optional "positions" and "loss_mask"), moved to
    the state's device.  ``compress``: a callable grads → grads, such as
    a `grad_compress.Compressor` step.  ``grad_shardings``: the
    parameters' `Sharding` tree on a mesh; the state is then this rank's
    blocks and ``batch`` the whole batch (module doc)."""
    mesh = None if grad_shardings is None else tree_leaves(grad_shardings)[0].mesh

    def train_step(state: TrainState, batch: dict):
        device = state.step.device
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        with (use_mesh_axes(mesh) if mesh is not None else contextlib.nullcontext()):
            loss, metrics, grads = _grads(state.params, cfg, batch, microbatches)
            if compress is not None:
                grads = compress(grads)
            new_params, new_opt, opt_metrics = apply_updates(state.params, grads, state.opt,
                                                             opt_cfg, grad_shardings)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
