"""The port's parallel layer held to the JAX package's rules, in process.

The FSDP placement rule (``parallel/fsdp.py:29-46``) over every parameter
shape of wav2vec2-large-lv60 at mesh sizes 2, 4 and 8, alone and on top of
the tensor-parallel rule; the tensor-parallel rule (``parallel/tp.py:22``)
over the encoder's and the seq2seq decoder's parameter paths; the GPipe
schedule's arithmetic and stacking; batch padding; the distributed sampler
wrapper's partitions at ranks 0..3 of 4. All are exact. The mesh helpers
run on a one-rank gloo group made in this process.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from svt_speechbrain_tpu.dataio import sampler as jsampler
from svt_speechbrain_tpu.models import seq2seq_decoder as jdec
from svt_speechbrain_tpu.models import wav2vec2 as jw2v
from svt_speechbrain_tpu.parallel import fsdp as jfsdp
from svt_speechbrain_tpu.parallel import mesh as jmesh
from svt_speechbrain_tpu.parallel import pipeline as jpipe
from svt_speechbrain_tpu.parallel import tp as jtp

from svt_speechbrain_tpu_torch.dataio import sampler
from svt_speechbrain_tpu_torch.parallel import fsdp, mesh, pipeline, tp


def _shapes(module, path_sep="."):
    """{dotted path: (JAX path, shape)} of a JAX module's parameters."""
    tree = jax.eval_shape(module.init, jax.random.PRNGKey(0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {path_sep.join(str(k.key) for k in path): (path, leaf.shape)
            for path, leaf in leaves}


def _placement(spec, axis, ndim):
    """A JAX PartitionSpec's placement over ``axis``, as the port names it."""
    dims = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return ("shard", dims.index(axis)) if axis in dims else ("replicate",)


def _port(placement):
    return ("shard", placement.dim) if hasattr(placement, "dim") else (
        "replicate",)


LV60 = _shapes(jw2v.Wav2Vec2Encoder(jw2v.Wav2Vec2Config.large_lv60()))
DECODER = _shapes(jdec.FairseqTransformerDecoder(jdec.FairseqDecoderConfig(
    vocab_size=27, embed_dim=16, ffn_dim=32, num_layers=2, num_heads=4)))


def _meta(shapes):
    return {name: torch.empty(shape, device="meta")
            for name, (_, shape) in shapes.items()}


@pytest.mark.parametrize("size", [2, 4, 8])
def test_fsdp_rule_matches_jax_over_lv60(size):
    got = fsdp.fsdp_shardings(_meta(LV60), size)
    for name, (_, shape) in LV60.items():
        want = (jfsdp._fsdp_spec(shape, size, "data") if shape
                else P())
        assert _port(got[name]) == _placement(want, "data", len(shape)), name
    # hybrid: the tensor-parallel axes are not FSDP's to take
    base = tp.encoder_tp_shardings(_meta(LV60))
    got = fsdp.fsdp_shardings(_meta(LV60), size, base=base)
    for name, (path, shape) in LV60.items():
        want = jfsdp._fsdp_spec(shape, size, "data",
                                jtp._spec_for_path(path, "model"))
        assert _port(got[name]) == _placement(want, "data", len(shape)), name


@pytest.mark.parametrize("shapes", [LV60, DECODER], ids=["encoder",
                                                          "decoder"])
def test_tp_rule_matches_jax(shapes):
    got = tp.encoder_tp_shardings(_meta(shapes))
    split = 0
    for name, (path, shape) in shapes.items():
        want = _placement(jtp._spec_for_path(path, "model"), "model",
                          len(shape))
        assert _port(got[name]) == want, name
        split += want[0] == "shard"
    assert split > 0


def test_pipeline_schedule_and_stacking_match_jax():
    for m in range(1, 9):
        for s in range(1, 9):
            assert pipeline.bubble_fraction(m, s) == jpipe.bubble_fraction(
                m, s)
            assert pipeline.schedule_ticks(m, s) == jpipe.schedule_ticks(m, s)
    rng = np.random.default_rng(0)
    stages = [{"w": rng.normal(size=(3, 2)).astype(np.float32),
               "inner": {"b": rng.normal(size=(2,)).astype(np.float32)}}
              for _ in range(3)]
    want = jpipe.stack_stage_params(stages)
    got = pipeline.stack_stage_params(
        [jax.tree_util.tree_map(torch.from_numpy, st) for st in stages])
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["inner"]["b"].numpy(),
                                  np.asarray(want["inner"]["b"]))


@pytest.mark.parametrize("rows,multiple", [(5, 4), (8, 4), (3, 8)])
def test_pad_batch_to_multiple_matches_jax(rows, multiple):
    rng = np.random.default_rng(rows)
    tree = {"x": rng.normal(size=(rows, 3)).astype(np.float32),
            "y": {"lens": np.arange(rows, dtype=np.float32)}}
    got, real = mesh.pad_batch_to_multiple(tree, multiple)
    want, jreal = jmesh.pad_batch_to_multiple(tree, multiple)
    assert real == jreal == rows
    np.testing.assert_array_equal(got["x"], np.asarray(want["x"]))
    np.testing.assert_array_equal(got["y"]["lens"],
                                  np.asarray(want["y"]["lens"]))


@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_sampler_wrapper_partitions_match_jax(drop_last):
    inner = sampler.ReproducibleRandomSampler(range(11), seed=3)
    jinner = jsampler.ReproducibleRandomSampler(range(11), seed=3)
    seen = []
    for rank in range(4):
        got = sampler.DistributedSamplerWrapper(inner, rank=rank,
                                                num_replicas=4,
                                                drop_last=drop_last)
        want = jsampler.DistributedSamplerWrapper(jinner, rank=rank,
                                                  num_replicas=4,
                                                  drop_last=drop_last)
        assert list(got) == list(want) and len(got) == len(want)
        got.set_epoch(2)
        want.set_epoch(2)
        assert list(got) == list(want)
        seen += list(got)
    assert (len(seen) == 8) if drop_last else (set(seen) == set(range(11)))


def test_one_rank_mesh_helpers():
    """The helpers on a one-rank gloo group: the mesh, each rank's rows,
    the data-parallel placements, the broadcast, and ``sequence_shards``,
    which raises without an active mesh, splits no frames for a spec that
    names none, refuses a split of the channels, and whose scatter and
    gather are the identity on one rank, gradient included."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="active device mesh"):
        mesh.sequence_shards(("data", "seq", None), 2)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        m = mesh.make_mesh()
        assert m.mesh_dim_names == ("data",) and m.size() == 1
        two = mesh.make_mesh(axis_names=("data", "seq"), shape=(1, 1))
        assert mesh.data_parallel_sharding(two) == (Shard(0), Replicate())
        batch = mesh.shard_batch(m, {"x": np.ones((4, 2)), "n": 3})
        assert batch["x"].shape == (4, 2) and int(batch["n"]) == 3
        t = torch.arange(4.0)
        assert mesh.replicate(m, {"t": t})["t"] is t
        x = torch.randn(2, 5, 3, requires_grad=True)
        with mesh.use_mesh(two):
            assert mesh.active_mesh() is two
            seq = mesh.sequence_shards(("data", "seq", None), 5)
            assert mesh.sequence_shards(("data", None, None), 5) is None
            with pytest.raises(ValueError, match="channels"):
                mesh.sequence_shards(("data", None, "seq"), 5)
            y = seq.gather(seq.scatter(x), partial=False)
        assert mesh.active_mesh() is None
        assert torch.equal(y, x)
        y.sum().backward()
        assert torch.equal(x.grad, torch.ones_like(x))
        with pytest.raises(ValueError, match="cover"):
            mesh.make_mesh(axis_names=("data", "model"), shape=(2, 1))
    finally:
        dist.destroy_process_group()
