"""Tensor parallelism for the SSL encoders and the seq2seq decoder (port of
``svt_speechbrain_tpu/parallel/tp.py``), Megatron style over a "model"
mesh dim.

The rules of the JAX package (``tp.py:22-76``), per transformer layer:

- ``ffn1``/``fc1`` column parallel (``w`` split by output, ``b`` too),
  ``ffn2``/``fc2`` row parallel (``w`` split by input, ``b`` whole, added
  once after the sum);
- the attention's ``wq``/``wk``/``wv`` (and biases) split by output, i.e.
  by head, and ``wo`` by input (``attn``, ``self_attn``, ``encoder_attn``);
- everything else replicated.

``encoder_tp_shardings`` gives the rule as ``Shard(dim)``/``Replicate()``
by parameter name. ``apply_tp`` applies it through ``parallelize_module``
with the port's own ``ParallelStyle``s (torch's ``ColwiseParallel`` and
``RowwiseParallel`` take ``nn.Linear``, whose weight is (out, in); the
port's ``Linear`` keeps the JAX (in, out) layout). Each rank keeps its own
slice of a split parameter as an ordinary tensor (``_tp_dim`` names the
split axis); a column-parallel input is summed over the ranks in the
backward pass and a row-parallel output in the forward pass, so a step's
numbers are the replicated step's. Dropout inside the attention draws per
local head, so parity holds without attention dropout.

Example
-------
>>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
>>> import torch
>>> layer = torch.nn.ModuleDict({"ffn1": Linear(16, 8), "ffn2": Linear(8, 16)})
>>> layers = torch.nn.ModuleDict({"layers": torch.nn.ModuleList([layer])})
>>> sorted(encoder_tp_shardings(layers).items())[:2]
[('layers.0.ffn1.b', Shard(dim=0)), ('layers.0.ffn1.w', Shard(dim=1))]
"""
from __future__ import annotations

import types

import torch
from torch import nn
from torch.distributed.tensor.parallel import ParallelStyle

_COL = ("ffn1", "fc1")
_ROW = ("ffn2", "fc2")
_ATTN = ("attn", "self_attn", "encoder_attn")


def _dim_for_path(keys):
    """The split axis of a parameter path (the JAX ``_spec_for_path``), or
    None for a replicated one."""
    if "layers" not in keys or len(keys) < 2:
        return None
    parent, leaf = keys[-2], keys[-1]
    if parent in _COL and leaf == "w":
        return 1
    if parent in _COL and leaf == "b":
        return 0
    if parent in _ROW and leaf == "w":
        return 0
    if parent in _ATTN and leaf in ("wq", "wk", "wv"):
        return 1
    if parent in _ATTN and leaf in ("bq", "bk", "bv"):
        return 0
    if parent in _ATTN and leaf == "wo":
        return 0
    return None


def encoder_tp_shardings(module, mesh=None, model_axis="model"):
    """Parameter name → ``Shard(dim)`` or ``Replicate()`` over
    ``model_axis``, for a module or a dict of named tensors."""
    from torch.distributed.tensor import Replicate, Shard

    del mesh, model_axis
    names = (module.named_parameters() if hasattr(module, "named_parameters")
             else module.items())
    out = {}
    for name, _ in names:
        dim = _dim_for_path(name.split("."))
        out[name] = Replicate() if dim is None else Shard(dim)
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the input's gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """The partial outputs summed over the group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _split(module, name, dim, mesh):
    n, r = mesh.size(), mesh.get_local_rank()
    full = getattr(module, name)
    if full.shape[dim] % n:
        raise ValueError(f"{name} {tuple(full.shape)} axis {dim} does not "
                         f"split over {n} ranks")
    part = nn.Parameter(full.detach().chunk(n, dim=dim)[r].clone(),
                        requires_grad=full.requires_grad)
    part._tp_dim = dim
    setattr(module, name, part)


def _row_forward(self, x):
    y = torch.matmul(x, self.w.to(x.dtype))
    y = _ReduceFromModel.apply(y, self._tp_group)
    return y if self.b is None else y + self.b


def _head_mm(self, x, name):
    w = getattr(self, name).to(x.dtype)
    if name == "wo":
        return _ReduceFromModel.apply(torch.matmul(x, w), self._tp_group)
    return torch.matmul(_CopyToModel.apply(x, self._tp_group), w)


class PortColwiseParallel(ParallelStyle):
    """A port ``Linear`` split by output."""

    def _apply(self, module, device_mesh):
        _split(module, "w", 1, device_mesh)
        if module.b is not None:
            _split(module, "b", 0, device_mesh)
        group = device_mesh.get_group()
        module.register_forward_pre_hook(
            lambda m, args: (_CopyToModel.apply(args[0], group),)
            + tuple(args[1:]))
        return module


class PortRowwiseParallel(ParallelStyle):
    """A port ``Linear`` split by input, its bias added after the sum."""

    def _apply(self, module, device_mesh):
        _split(module, "w", 0, device_mesh)
        module._tp_group = device_mesh.get_group()
        module.forward = types.MethodType(_row_forward, module)
        return module


class PortHeadParallel(ParallelStyle):
    """A ``MultiheadAttention`` split by head."""

    def _apply(self, module, device_mesh):
        n = device_mesh.size()
        if module.nhead % n:
            raise ValueError(f"{module.nhead} heads do not split over {n} "
                             f"ranks")
        for name in ("wq", "wk", "wv"):
            _split(module, name, 1, device_mesh)
            _split(module, "b" + name[1], 0, device_mesh)
        _split(module, "wo", 0, device_mesh)
        module.nhead //= n
        module.d_model //= n
        module._tp_group = device_mesh.get_group()
        module._mm = types.MethodType(_head_mm, module)
        return module


def apply_tp(module, mesh, model_axis="model"):
    """``module``'s layers split in place over ``model_axis`` of ``mesh``
    (or a 1-D mesh) by the rules above, through ``parallelize_module``.
    WavLM's gated attention has no rule and raises. Returns the module."""
    from torch.distributed.tensor.parallel import parallelize_module

    from svt_speechbrain_tpu_torch.nnet.attention import MultiheadAttention

    sub = (mesh[model_axis] if mesh.mesh_dim_names
           and len(mesh.mesh_dim_names) > 1 else mesh)
    plan = {}
    for name, child in module.named_modules():
        keys = name.split(".")
        if "layers" not in keys:
            continue
        if keys[-1] in _COL:
            plan[name] = PortColwiseParallel()
        elif keys[-1] in _ROW:
            plan[name] = PortRowwiseParallel()
        elif keys[-1] in _ATTN:
            if not isinstance(child, MultiheadAttention):
                raise NotImplementedError(
                    f"no tensor-parallel rule for {type(child).__name__}")
            plan[name] = PortHeadParallel()
    return parallelize_module(module, sub, plan)
