"""Int8 error-feedback gradient compression (1-bit-Adam / EF-SGD family;
PyTorch port of the reference's ``grad_compress.py``).

In the data-parallel regime the gradient all-reduce moves 2 bytes a
parameter a step (bf16); quantising the *communicated* payload to int8
halves it, and error feedback (the quantisation residual carried into the
next step) keeps convergence unchanged to first order.

A shared fp32 absmax scale is agreed with a MAX all-reduce, each rank
contributes round(g/scale) int8 values, the payload is SUM all-reduced and
divided by the group's size, and the residual e = g − deq(q) is carried.
The reference's ``axis_names`` (a ``pmax`` and a ``psum`` inside
``shard_map``) are a ``torch.distributed`` process group here.  Without a
group it is the single-device quantise → error-feedback loop.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.train.optimizer import tree_map


def quantize_with_feedback(g: torch.Tensor, err: torch.Tensor, scale: torch.Tensor):
    """→ (q int8-valued f32 payload, new_err).  scale: scalar fp32."""
    u = g.float() + err
    q = torch.clamp(torch.round(u / torch.clamp(scale, min=1e-12)), -127, 127)
    deq = q * scale
    return q, u - deq


class Compressor:
    """Error-feedback int8 compressor for a gradient tree.

    Usage:
        comp = Compressor.init(params)
        grads, comp = comp.compress(grads, group=None)
    Stateless-functional: compress returns the new compressor.
    """

    def __init__(self, err):
        self.err = err

    @staticmethod
    def init(params) -> "Compressor":
        return Compressor(tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))

    def compress(self, grads, group: "dist.ProcessGroup | None" = None):
        def leaf(g, e):
            scale = torch.amax(torch.abs(g.float() + e)) / 127.0
            if group is not None:
                dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
            q, e_new = quantize_with_feedback(g, e, scale)
            if group is not None:
                dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
                q = q / dist.get_world_size(group)
            return (q * scale).to(g.dtype), e_new

        out = tree_map(leaf, grads, self.err)
        return tree_map(lambda o: o[0], out), Compressor(tree_map(lambda o: o[1], out))
