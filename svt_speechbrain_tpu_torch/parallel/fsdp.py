"""Fully sharded data parallelism (port of
``svt_speechbrain_tpu/parallel/fsdp.py``) on FSDP2 (``fully_shard``).

The JAX rule places each tensor: it is sharded over the "data" mesh axis
along its largest axis divisible by the axis size, ties going to the later
axis (usually the output features); a tensor with no divisible axis stays
replicated. Axes that tensor parallelism already took (``base``) are not
candidates, so on a ("data", "model") mesh FSDP shards a free axis over
"data" (the hybrid FSDP + TP layout).

``fsdp_shardings`` gives that rule as ``Shard(dim)``/``Replicate()``
placements by parameter name. ``apply_fsdp`` applies it with FSDP2: each
transformer layer (a child named ``layers.<i>``, outside the conv feature
extractor), then the root, is
``fully_shard``-ed over the "data" mesh dim, each parameter split along the
rule's dim (after ``tp.apply_tp`` the axes it split are taken). FSDP2 shards every parameter it manages: where the rule says
"replicated" (no divisible axis) it splits axis 0 unevenly, padded, instead.
The numbers are the same; only where the tensor lives differs.

Example
-------
>>> import torch
>>> fsdp_shardings({"w": torch.ones(16, 8), "b": torch.ones(3)}, 8)
{'w': Shard(dim=0), 'b': Replicate()}
"""
from __future__ import annotations

import re


def _fsdp_dim(shape, axis_size, taken=()):
    """The largest axis divisible by ``axis_size`` not in ``taken`` (the
    later one on ties), or None (``fsdp.py:29``)."""
    best = None
    for i, d in enumerate(shape):
        if i in taken:
            continue
        if d % axis_size == 0 and d >= axis_size and (
                best is None or d >= shape[best]):
            best = i
    return best


def _axis_size(mesh, axis):
    if isinstance(mesh, int):
        return mesh
    if mesh.mesh_dim_names and axis in mesh.mesh_dim_names:
        return mesh.size(mesh.mesh_dim_names.index(axis))
    return mesh.size()


def _named(params):
    if hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return dict(params)


def fsdp_shardings(params, mesh, axis="data", base=None):
    """Parameter name → ``Shard(dim)`` or ``Replicate()`` over ``axis``, for
    a module's parameters or a dict of tensors; ``mesh`` is a
    ``DeviceMesh`` or the axis size. ``base`` (name → placement, from
    ``tp.encoder_tp_shardings``) marks the axes tensor parallelism took."""
    from torch.distributed.tensor import Replicate, Shard

    size = _axis_size(mesh, axis)
    out = {}
    for name, p in _named(params).items():
        taken = ()
        placement = (base or {}).get(name)
        if isinstance(placement, Shard):
            taken = (placement.dim,)
        dim = _fsdp_dim(tuple(p.shape), size, taken) if p.dim() else None
        out[name] = Replicate() if dim is None else Shard(dim)
    return out


# a transformer layer: ``layers.<i>``, not the conv extractor's (whose
# layers the frontend reads directly, never calling them)
_LAYER = re.compile(r"(^|\.)(?<!feature_extractor\.)layers\.\d+$")


def apply_fsdp(module, mesh, axis="data", base=None, **fsdp_kwargs):
    """``module`` fully sharded in place with FSDP2 over ``axis`` of
    ``mesh`` under ``fsdp_shardings``' rule: each ``layers.<i>`` child
    first, then the root. ``fsdp_kwargs`` go to ``fully_shard`` (a
    ``mp_policy`` for bf16 compute). Returns the module."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    sub = mesh[axis] if (mesh.mesh_dim_names and len(mesh.mesh_dim_names) > 1
                         ) else mesh
    if base is None:            # the axes ``tp.apply_tp`` split, if any
        base = {name: Shard(p._tp_dim)
                for name, p in module.named_parameters()
                if getattr(p, "_tp_dim", None) is not None}
    rule = fsdp_shardings(module, sub, axis, base)
    by_id = {id(p): rule[name] for name, p in module.named_parameters()}

    def placement(param):
        p = by_id.get(id(param))
        return p if isinstance(p, Shard) else Shard(0)

    for name, child in module.named_modules():
        if name and _LAYER.search(name):
            fully_shard(child, mesh=sub, shard_placement_fn=placement,
                        **fsdp_kwargs)
    fully_shard(module, mesh=sub, shard_placement_fn=placement, **fsdp_kwargs)
    return module
