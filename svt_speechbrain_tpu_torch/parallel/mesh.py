"""Device meshes over processes (port of
``svt_speechbrain_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a mesh of the devices of each
host. PyTorch's idiom is one process per device, so here a mesh is a
``DeviceMesh`` over the ranks of the ``torch.distributed`` process group
(``make_mesh``), each rank holds its own rows of the batch (``shard_batch``)
and a replicated tensor is the same tensor on every rank (``replicate``
broadcasts it from the mesh's first rank).

``use_mesh`` makes a mesh active for the code it runs, as ``with mesh:``
does in JAX; ``sequence_shards`` (the encoder's ``act_sharding``) needs
one. ``SequenceShards`` is sequence parallelism: between the encoder's
layers each rank holds its slice of the frames, and the layer norms, the
feed-forward blocks, the residuals and their dropouts run on that slice;
the attention gathers the whole sequence, runs on it on every rank and
keeps the rank's slice of its output.

Example
-------
>>> import numpy as np
>>> padded, real = pad_batch_to_multiple({"x": np.ones((5, 3))}, 4)
>>> padded["x"].shape, real
((8, 3), 5)
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

_ACTIVE = []


def _dist():
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a device mesh needs an initialised process group "
                           "(parallel.distributed.ddp_init_group)")
    return dist


def _device_type():
    """"cuda" under the NCCL backend, else "cpu"."""
    return "cuda" if _dist().get_backend() == "nccl" else "cpu"


def make_mesh(n_devices=None, axis_names=("data",), shape=None,
              devices=None):
    """A ``DeviceMesh`` over the process group's ranks (``mesh.py:25``):
    1-D over all of them by default, or of ``shape`` with ``axis_names``,
    e.g. ``shape=(2, 2), axis_names=("data", "model")``. ``devices`` is a
    list of ranks, laid out in that order; by default the mesh covers every
    rank, and ``n_devices``, when given, must be the world size."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    world = _dist().get_world_size()
    if devices is None and n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh covers every rank: {n_devices} devices "
                         f"asked, world size {world}")
    count = world if devices is None else len(devices)
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("Provide shape for multi-axis meshes")
        shape = (count,)
    if int(np.prod(shape)) != count:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover the "
                         f"{count} ranks")
    if devices is not None:
        if not set(devices) <= set(range(world)):
            raise ValueError(f"ranks {list(devices)} outside the world "
                             f"size {world}")
        return DeviceMesh(_device_type(),
                          torch.tensor(list(devices)).reshape(tuple(shape)),
                          mesh_dim_names=tuple(axis_names))
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def data_parallel_sharding(mesh, ndim=1, axis="data"):
    """The placements, one per mesh dim, of a batch split on axis 0 over
    ``axis`` and replicated over the other mesh dims."""
    from torch.distributed.tensor import Replicate, Shard

    del ndim                                    # axis 0 is the batch axis
    return tuple(Shard(0) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def replicate(mesh, tree):
    """Every tensor of ``tree`` made equal on all ranks of ``mesh``: broadcast
    in place from the mesh's first rank (the parameters and optimizer state
    of data parallelism)."""
    dist = _dist()
    src = int(mesh.mesh.reshape(-1)[0])
    for leaf in tree_leaves(tree):
        if torch.is_tensor(leaf):
            dist.broadcast(leaf.data if isinstance(leaf, torch.nn.Parameter)
                           else leaf, src=src)
    return tree


def shard_batch(mesh, tree, axis="data", batch_axis=0):
    """This rank's rows of a global host batch: axis ``batch_axis`` cut into
    as many equal parts as ``axis`` has ranks (``mesh.py:71``). Arrays too
    small to carry the batch axis are kept whole. Leaves become tensors on
    the mesh's device."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    index = mesh.get_local_rank(axis)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))

    def put(x):
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if x.dim() <= batch_axis:
            return x.to(device)
        if x.shape[batch_axis] % n:
            raise ValueError(f"batch axis of {x.shape[batch_axis]} rows does "
                             f"not split over {n} ranks; "
                             f"pad_batch_to_multiple first")
        return x.chunk(n, dim=batch_axis)[index].to(device)

    return tree_map(put, tree)


def pad_batch_to_multiple(arrays, multiple):
    """Pad axis 0 of every array with zeros to a multiple of ``multiple``;
    returns (padded tree, real batch size) (``mesh.py:88``)."""

    def pad(x):
        x = np.asarray(x)
        b = x.shape[0]
        target = int(-(-b // multiple) * multiple)
        if target == b:
            return x
        return np.pad(x, [(0, target - b)] + [(0, 0)] * (x.ndim - 1))

    first = tree_leaves(arrays)[0]
    return tree_map(pad, arrays), np.asarray(first).shape[0]


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh inside the block."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    return _ACTIVE[-1] if _ACTIVE else None


def sequence_shards(spec, frames):
    """The ``SequenceShards`` that ``spec`` (an ``act_sharding``: a mesh
    axis name or None for each of the (B, T, D) axes) names on the active
    mesh for ``frames`` frames, or None when it splits no frames. Axis 0 is
    the batch, whose rows are already each rank's own; a split of the
    channels (axis 2) is refused. Without an active mesh it raises, as
    ``jax.lax.with_sharding_constraint`` does."""
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError(f"act_sharding {tuple(spec)!r} needs an active "
                           f"device mesh (parallel.mesh.use_mesh)")
    for name in spec:
        if name is not None and name not in mesh.mesh_dim_names:
            raise ValueError(f"mesh has no axis {name!r} "
                             f"({mesh.mesh_dim_names})")
    if spec[2] is not None:
        raise ValueError(f"act_sharding {tuple(spec)!r}: the port splits "
                         f"the frames (axis 1), not the channels")
    return None if spec[1] is None else SequenceShards(mesh[spec[1]],
                                                       frames)


class SequenceShards:
    """The frames (axis 1) of (B, T, ...) activations cut into equal
    slices, one for each rank of the 1-D mesh ``sub``, T padded with zeros
    to a multiple of them (``size`` frames a rank, from ``start``).

    ``scatter`` takes a tensor every rank holds whole to the rank's slice,
    ``gather`` brings the slices together, and ``local`` is the rank's
    slice of a tensor computed whole on every rank. Their gradients make
    the step that of the whole sequence on one device: the slices'
    gradients are gathered whole for the replicated code before
    ``scatter``; ``gather`` for the attention (``partial``) sums each
    rank's gradient of a slice (only the rank's own output slice reached
    it), while the ``gather`` that ends the region takes the rank's slice of
    a gradient that every rank holds alike. A parameter used on the
    slices goes through ``summed``, which sums its gradient over the ranks.
    ``drop`` is dropout on a slice with the mask of the whole sequence, so
    the draws are those of the unsharded run."""

    def __init__(self, sub, frames):
        self.group = sub.get_group()
        self.ranks = sub.size()
        self.rank = sub.get_local_rank()
        self.frames = frames
        self.size = -(-frames // self.ranks)
        self.start = self.rank * self.size

    def _pad(self, x):
        extra = self.size * self.ranks - x.shape[1]
        if extra == 0:
            return x
        return torch.cat([x, x.new_zeros((x.shape[0], extra)
                                         + tuple(x.shape[2:]))], dim=1)

    def local(self, x):
        return self._pad(x)[:, self.start:self.start + self.size]

    def scatter(self, x):
        return _Scatter.apply(x, self)

    def gather(self, x, partial=True):
        return _Gather.apply(x, self, partial)

    def summed(self, p):
        return _Summed.apply(p, self.group)

    def _all_gather(self, x):
        dist = _dist()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.ranks)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=1)[:, :self.frames]

    def _sum_slices(self, g):
        """The rank's slice of the sum of every rank's ``g`` (whole)."""
        dist = _dist()
        g = self._pad(g)
        if dist.get_backend(self.group) == "nccl":
            whole = g.movedim(1, 0).contiguous()
            out = whole.new_empty((self.size,) + whole.shape[1:])
            dist.reduce_scatter_tensor(out, whole, group=self.group)
            return out.movedim(0, 1)
        g = g.contiguous().clone()
        dist.all_reduce(g, group=self.group)
        return g[:, self.start:self.start + self.size]

    def drop(self, x, rate, rng, train):
        """``nnet.dropout.dropout`` of the slice ``x``, its mask the
        rank's slice of the whole sequence's."""
        if not train or rng is None or rate <= 0.0:
            return x
        keep = 1.0 - rate
        shape = (x.shape[0], self.frames) + tuple(x.shape[2:])
        mask = self.local(torch.rand(shape, generator=rng.device,
                                     device=x.device) < keep)
        return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        return shards.local(x).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.shards._all_gather(g), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shards, partial):
        ctx.shards, ctx.partial = shards, partial
        return shards._all_gather(x)

    @staticmethod
    def backward(ctx, g):
        shards = ctx.shards
        g = shards._sum_slices(g) if ctx.partial else shards.local(g)
        return g.contiguous(), None, None


class _Summed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, group):
        ctx.group = group
        return p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _dist().all_reduce(g, group=ctx.group)
        return g, None
