"""GPipe pipeline parallelism over a "pipe" mesh dim (port of
``svt_speechbrain_tpu/parallel/pipeline.py``).

A stack of ``S`` identically shaped stages lives one stage a rank. The
``M`` micro-batches pass through in ``M + S - 1`` ticks (warm-up, steady
state, drain): at each tick every rank runs its stage on what it holds and
sends the result to the next rank, stage 0 taking the next micro-batch and
the last stage keeping its output; the bubble is ``(S-1)/(M+S-1)``. The
sends are point-to-point with autograd (the gradients travel back along the
ring), and the outputs are summed over the ranks at the end, so every rank
holds them, as the JAX ``psum`` gives them.

Example
-------
>>> bubble_fraction(4, 2), schedule_ticks(4, 2)
(0.2, 5)
"""
from __future__ import annotations

import functools

import torch
from torch.utils._pytree import tree_map


def stack_stage_params(stage_param_list):
    """[stage trees] → one tree with a leading stage axis.

    Example
    -------
    >>> import torch
    >>> stack_stage_params([{"w": torch.ones(2)}, {"w": torch.zeros(2)}])["w"]
    tensor([[1., 1.],
            [0., 0.]])
    """
    return tree_map(lambda *leaves: torch.stack(leaves), *stage_param_list)


def bubble_fraction(m, s):
    """Idle fraction of the GPipe schedule of ``s`` stages and ``m``
    micro-batches: ``(s-1)/(m+s-1)``.

    Example
    -------
    >>> bubble_fraction(1, 8)
    0.875
    """
    return (s - 1) / (m + s - 1)


def schedule_ticks(m, s):
    """The ticks ``spmd_pipeline`` runs: ``m + s - 1``."""
    return m + s - 1


class _RingShift(torch.autograd.Function):
    """Send ``y`` to the next rank of the ring and receive the previous
    rank's; the backward sends the gradient the other way."""

    @staticmethod
    def forward(ctx, y, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _exchange(y, group, nxt, prv)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, ctx.prv, ctx.nxt), None, None, None


def _exchange(y, group, to, frm):
    import torch.distributed as dist

    y = y.contiguous()
    out = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y, to, group),
           dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _SumOverRanks(torch.autograd.Function):
    """The outputs summed over the pipe ranks; every rank computes the same
    loss of them, so the gradient passes back unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def spmd_pipeline(stage_fn, stacked_params, x_microbatches, mesh,
                  axis="pipe"):
    """``stage_{S-1}(…stage_0(x)…)`` for each of the ``M`` micro-batches
    of ``x_microbatches`` (M, ...), the ``S`` stages on the ``S`` ranks of
    ``axis``. ``stacked_params`` holds every stage's parameters on a leading
    axis of size S (``stack_stage_params``); this rank runs
    ``stage_fn(its slice, x)``, whose output has the shape of ``x``.
    Returns the (M, ...) outputs on every rank."""
    import torch.distributed as dist

    sub = (mesh[axis] if mesh.mesh_dim_names and len(mesh.mesh_dim_names) > 1
           else mesh)
    s = sub.size()
    m = x_microbatches.shape[0]
    stage = sub.get_local_rank()
    group = sub.get_group()
    nxt = dist.get_global_rank(group, (stage + 1) % s)
    prv = dist.get_global_rank(group, (stage - 1) % s)
    params_here = tree_map(lambda p: p[stage], stacked_params)

    # every rank builds the same graph (``where`` in place of branches, as
    # the JAX scan does), so the ring's backward exchanges run in the same
    # order on all of them
    first = torch.tensor(stage == 0, device=x_microbatches.device)
    last = torch.tensor(stage == s - 1, device=x_microbatches.device)
    state = torch.zeros_like(x_microbatches[0])
    outputs = [torch.zeros_like(state) for _ in range(m)]
    for t in range(schedule_ticks(m, s)):
        cur = torch.where(first, x_microbatches[min(t, m - 1)], state)
        y = stage_fn(params_here, cur)
        out_idx = t - (s - 1)
        if out_idx >= 0:
            outputs[out_idx] = torch.where(last, y, outputs[out_idx])
        if s > 1:
            state = _RingShift.apply(y, group, nxt, prv)
    stacked = torch.stack(outputs)
    return _SumOverRanks.apply(stacked, group) if s > 1 else stacked


def pipeline_transformer_layers(layer, stacked_params, x_microbatches, mesh,
                                axis="pipe", **layer_kwargs):
    """``spmd_pipeline`` over a stack of identical layers: ``layer`` (a
    module) is called with each stage's parameters (name → tensor, stacked
    by ``stack_stage_params`` of the layers' ``named_parameters``)."""
    fn = functools.partial(_call_layer, layer, layer_kwargs)
    return spmd_pipeline(fn, stacked_params, x_microbatches, mesh, axis=axis)


def _call_layer(layer, layer_kwargs, params, x):
    return torch.func.functional_call(layer, params, (x,), layer_kwargs)
