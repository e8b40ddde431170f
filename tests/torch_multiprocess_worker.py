"""One rank of ``tests/test_torch_multiprocess.py``'s multi-process run.

Run as ``python tests/torch_multiprocess_worker.py <out_dir> [cpu|cuda]``
under the launcher's environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``), e.g. ``torchrun --nproc_per_node 2``. The
rank sets up its group through the port's ``ddp_init_group`` (gloo on the
CPU, NCCL on the cards), runs every check of ``CHECKS`` in turn on its
device (printing ``CHECK <name>`` before each, so that a run cut off names
the check it stopped in), gathers every rank's results on the CPU and rank
0 writes them to ``<out_dir>/results.pt``. Any number of ranks that divides
the checks' widths (2 or 4) works. It imports torch and the port only, and
no JAX.

The data and the models come from the functions here, so the test can
build the same ones in one process for its references.
"""
import functools
import os
import sys

import numpy as np
import torch
from torch.utils._pytree import tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from svt_speechbrain_tpu_torch.convert_jax import init_modules  # noqa: E402
from svt_speechbrain_tpu_torch.core import Brain, Stage  # noqa: E402
from svt_speechbrain_tpu_torch.dataio.batch import PaddedData  # noqa: E402
from svt_speechbrain_tpu_torch.models import wav2vec2 as w2v  # noqa: E402
from svt_speechbrain_tpu_torch.models.seq2seq_decoder import (  # noqa: E402
    FairseqDecoderConfig, FairseqTransformerDecoder)
from svt_speechbrain_tpu_torch.nnet import losses  # noqa: E402
from svt_speechbrain_tpu_torch.nnet.linear import Linear  # noqa: E402
from svt_speechbrain_tpu_torch.nnet.normalization import (  # noqa: E402
    BatchNorm1d)
from svt_speechbrain_tpu_torch.nnet.schedulers import (  # noqa: E402
    NewBobScheduler)
from svt_speechbrain_tpu_torch.utils.checkpoints import (  # noqa: E402
    Checkpointer)
from svt_speechbrain_tpu_torch.utils.epoch_loop import (  # noqa: E402
    EpochCounter)
from svt_speechbrain_tpu_torch.utils.train_logger import (  # noqa: E402
    FileTrainLogger)

THREADS = 2
QUIET = dict(hidden_dropout=0.0, attention_dropout=0.0,
             activation_dropout=0.0, feat_proj_dropout=0.0)
LR = 1e-3                                  # Adam's, in the checkpoint
DEVICE = torch.device("cpu")               # the rank's, set by ``main``


def rows(n, rank, world):
    """Rank ``rank``'s contiguous part of ``n`` rows (uneven when ``world``
    does not divide ``n``: 7 rows over 2 ranks are 4 and 3)."""
    parts = np.array_split(np.arange(n), world)
    return slice(int(parts[rank][0]), int(parts[rank][-1]) + 1)


def on(x):
    """``x`` (a tensor or a module) on the rank's device."""
    return x.to(DEVICE)


# ------------------------------------------------------------ the models
class TinyBrain(Brain):
    """A linear model beside a frozen one, mean-squared error over lengths,
    SGD (the JAX package's ``tests/test_multiprocess.py:142`` brain)."""

    def compute_forward(self, batch, stage, rng=None):
        x, lens = batch["sig"]
        return self.modules.model(x) + self.modules.frozen(x), lens

    def compute_objectives(self, predictions, batch, stage):
        out, _ = predictions
        target, tlens = batch["anno"]
        return losses.mse_loss(out, target, length=tlens)

    def init_optimizers(self):
        self.add_optimizer("opt", torch.optim.SGD, ["model"], lr=0.1)


def make_brain(device="cpu", **run_opts):
    brain = TinyBrain({"model": Linear(4, 8), "frozen": Linear(4, 8)},
                      hparams={"seed": 7},
                      run_opts=dict(device=str(device), noprogressbar=True,
                                    **run_opts))
    brain.init_optimizers()
    brain.set_frozen_modules(["frozen"])
    return brain


class FitBrain(TinyBrain):
    """``TinyBrain`` with momentum (an optimizer state to checkpoint) and
    the stage end of ``tasks/amt.py``: at each validation a NewBob anneal
    (its threshold makes every epoch after the first anneal), a train-log
    line and a checkpoint by the validation loss."""

    def init_optimizers(self):
        self.add_optimizer("opt", functools.partial(torch.optim.SGD,
                                                    momentum=0.9),
                           ["model"], lr=0.1)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage == Stage.TRAIN:
            self.train_stats = {"loss": stage_loss}
        elif stage == Stage.VALID:
            old, new = self.hparams.scheduler(stage_loss)
            self.set_learning_rate("opt", new)
            self.lrs.append(self.get_learning_rate("opt"))
            self.hparams.train_logger.log_stats(
                {"epoch": epoch, "lr": old}, train_stats=self.train_stats,
                valid_stats={"loss": stage_loss})
            self.checkpointer.save_and_keep_only(meta={"loss": stage_loss},
                                                 min_keys=["loss"])

    def _save_intra_epoch_ckpt(self):
        super()._save_intra_epoch_ckpt()
        self.intra_saves.append(len(self.checkpointer.find_checkpoints(
            ckpt_predicate=lambda c: not c.meta["end-of-epoch"])))


def make_fit_brain(folder, device="cpu", **run_opts):
    """A ``FitBrain`` over two epochs, checkpointing into ``folder`` at
    every step (an intra-epoch checkpoint) and at every validation, and
    logging to ``folder``/log.txt."""
    scheduler, counter = NewBobScheduler(0.1, improvement_threshold=10.0), \
        EpochCounter(2)
    ckpt = Checkpointer(os.path.join(folder, "ckpt"),
                        {"scheduler": scheduler, "counter": counter})
    brain = FitBrain(
        {"model": Linear(4, 8), "frozen": Linear(4, 8)},
        hparams={"seed": 7, "scheduler": scheduler,
                 "train_logger": FileTrainLogger(os.path.join(folder,
                                                              "log.txt"))},
        run_opts=dict(device=str(device), noprogressbar=True,
                      ckpt_interval_minutes=1e-9, **run_opts),
        checkpointer=ckpt)
    brain.set_frozen_modules(["frozen"])
    brain.lrs, brain.intra_saves = [], []
    return brain, counter


def fit_sets():
    """Eight train rows (two steps of four an epoch) and four valid rows."""
    x, y = brain_data(12)
    items = [{"id": str(i), "sig": torch.from_numpy(x[i]),
              "anno": torch.from_numpy(y[i])} for i in range(12)]
    return items[:8], items[8:]


def fit(brain, counter, batch_size=4):
    train, valid = fit_sets()
    brain.fit(counter, train, valid,
              train_loader_kwargs={"batch_size": batch_size},
              valid_loader_kwargs={"batch_size": 2})


def brain_data(rows=7):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(rows, 10, 8)).astype(np.float32),
            rng.normal(size=(rows, 10, 4)).astype(np.float32))


def brain_batch(x, y):
    lens = torch.ones(len(x))
    return {"sig": PaddedData(torch.from_numpy(x), lens),
            "anno": PaddedData(torch.from_numpy(y), lens)}


def tiny_bridge(seed=3, **arch):
    """A TINY wav2vec2 bridge without the batch-wide norms (each rank
    normalizes only its rows) and without dropout."""
    bridge = w2v.HuggingFaceWav2Vec2(
        config=w2v.Wav2Vec2Config(**{**w2v.TINY_ARCH, **QUIET, **arch}),
        output_norm=False, normalize_wav=False)
    init_modules({"bridge": bridge}, seed)
    return bridge


def wavs():
    return torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 3200)).astype(np.float32))


def bridge_steps(bridge, wav, steps=2, adam=False):
    """SGD steps (a step linear in the gradient, so that sums taken in
    another order stay at rounding level) or Adam steps of the mean square
    of the bridge's output; the losses and the optimizer."""
    opt = (torch.optim.Adam(bridge.parameters(), lr=LR) if adam
           else torch.optim.SGD(bridge.parameters(), lr=0.1))
    out = []
    for _ in range(steps):
        opt.zero_grad()
        loss = bridge(wav).square().mean()
        loss.backward()
        opt.step()
        out.append(loss.item())
    return out, opt


def tp_layer(seed=5):
    layer = w2v.TransformerLayer(w2v.Wav2Vec2Config(**dict(w2v.TINY_ARCH,
                                                           **QUIET)))
    holder = torch.nn.ModuleDict({"layers": torch.nn.ModuleList([layer])})
    init_modules({"m": holder}, seed)
    return holder


def layer_input():
    rng = np.random.default_rng(6)
    return (torch.from_numpy(rng.normal(size=(2, 9, 64)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(2, 9, 64)).astype(np.float32)))


def decoder(seed=8):
    dec = FairseqTransformerDecoder(FairseqDecoderConfig(
        vocab_size=27, embed_dim=16, ffn_dim=32, num_layers=2, num_heads=4))
    init_modules({"dec": dec}, seed)
    return dec


def decoder_input():
    rng = np.random.default_rng(9)
    return (torch.from_numpy(rng.normal(size=(2, 5, 16)).astype(np.float32)),
            torch.tensor([[2, 4, 6, 8], [2, 5, 7, 3]]))


def decode(dec, enc, tokens):
    """Teacher-forced logits and three incremental steps' logits."""
    logits, _ = dec(tokens, enc)
    cache = dec.init_cache(enc, max_len=4)
    steps = [dec.step(cache, tokens[:, t], t) for t in range(3)]
    return logits, torch.stack(steps, 1)


def stage_params(stages):
    rng = np.random.default_rng(10)
    return {"w": torch.from_numpy(0.3 * rng.normal(
        size=(stages, 16, 16)).astype(np.float32)),
        "b": torch.from_numpy(0.1 * rng.normal(
            size=(stages, 16)).astype(np.float32))}


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def microbatches(m):
    return torch.from_numpy(np.random.default_rng(11).normal(
        size=(m, 2, 3, 16)).astype(np.float32))


def sequential(params, x):
    for s in range(params["w"].shape[0]):
        x = stage_fn({k: v[s] for k, v in params.items()}, x)
    return x


def bn_data():
    rng = np.random.default_rng(12)
    return (torch.from_numpy(rng.normal(2.0, 3.0, size=(4, 5, 3)).astype(
        np.float32)), torch.from_numpy(rng.normal(size=(4, 5, 3)).astype(
            np.float32)))


# ------------------------------------------------------------ the checks
def _grads(module):
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()
            if p.grad is not None}


def check_ddp_brain(rank, world, out_dir):
    x, y = brain_data()
    brain = make_brain(DEVICE)
    part = rows(7, rank, world)
    losses_ = [brain.fit_batch(brain_batch(x[part], y[part]))
               for _ in range(3)]
    params = {n: p.detach().clone()
              for n, p in brain.modules.named_parameters()}
    bad = x[part].copy()
    if rank == 1:
        bad[0, 0, 0] = np.nan
    skipped = brain.fit_batch(brain_batch(bad, y[part]))
    unchanged = all(torch.equal(p, params[n])
                    for n, p in brain.modules.named_parameters())
    return dict(losses=losses_, params=params, skipped=skipped,
                unchanged=unchanged, nonfinite=brain.nonfinite_count)


def check_ddp_accumulation(rank, world, out_dir):
    """Two micro-batches a step (the first under ``no_sync``), each rank on
    its equal part of 8 rows."""
    x, y = brain_data(8)
    brain = make_brain(DEVICE, grad_accumulation_factor=2)
    part = rows(8, rank, world)
    losses_ = [brain.fit_batch(brain_batch(x[part], y[part]))
               for _ in range(2)]
    return dict(losses=losses_, params={
        n: p.detach().clone() for n, p in brain.modules.named_parameters()})


def check_fsdp_brain(rank, world, out_dir):
    """The ``Brain`` under the ``fsdp`` run option, on the uneven batch."""
    x, y = brain_data()
    brain = make_brain(DEVICE, fsdp=True)
    part = rows(7, rank, world)
    losses_ = [brain.fit_batch(brain_batch(x[part], y[part]))
               for _ in range(3)]
    return dict(losses=losses_, params={
        n: p.full_tensor().detach()
        for n, p in brain.modules.named_parameters()})


def _check_fit(out_dir, tag, **run_opts):
    """Two epochs of ``fit`` on each rank's part of the batches of four,
    then a new brain recovering the newest checkpoint."""
    import torch.distributed as dist

    folder = os.path.join(out_dir, tag)
    brain, counter = make_fit_brain(folder, DEVICE, **run_opts)
    fit(brain, counter, batch_size=4 // dist.get_world_size())

    def whole(b):
        return {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
                .detach().clone() for n, p in b.modules.named_parameters()}

    def momenta(b):
        opt = b.optimizers["opt"]["opt"]
        return [opt.state[p]["momentum_buffer"] for p in
                opt.param_groups[0]["params"]]

    params = whole(brain)
    momentum = [m.full_tensor() if hasattr(m, "full_tensor") else m
                for m in momenta(brain)]
    again, counter = make_fit_brain(folder, DEVICE, **run_opts)
    again.init_optimizers()
    found = again.checkpointer.recover_if_possible()
    recovered = [m.full_tensor() if hasattr(m, "full_tensor") else m
                 for m in momenta(again)]
    return dict(lrs=brain.lrs, train_loss=brain.train_loss, params=params,
                intra_saves=brain.intra_saves,
                momentum=momentum, recovered=whole(again),
                recovered_momentum=recovered, recovered_epoch=counter.current,
                recovered_lr=again.hparams.scheduler.hyperparam_value,
                meta=found.meta, folder=folder,
                optimizer_lr=brain.optimizers["opt"]["opt"].param_groups[0][
                    "lr"])


def check_ddp_fit(rank, world, out_dir):
    return _check_fit(out_dir, "ddp_fit")


def check_fsdp_fit(rank, world, out_dir):
    return _check_fit(out_dir, "fsdp_fit", fsdp=True)


def check_fsdp(rank, world, out_dir):
    from svt_speechbrain_tpu_torch.parallel.fsdp import apply_fsdp
    from svt_speechbrain_tpu_torch.parallel.mesh import make_mesh

    bridge = on(tiny_bridge())
    apply_fsdp(bridge, make_mesh())
    sharded = {n: tuple(p.placements) for n, p in bridge.named_parameters()}
    local, _ = bridge_steps(bridge, on(wavs()[rows(4, rank, world)]))
    return dict(losses=local, placements=sharded, params={
        n: p.full_tensor().detach() for n, p in bridge.named_parameters()})


def _full_tp(module, dims, mesh):
    """Every parameter whole: FSDP's shards gathered, then tensor
    parallelism's slices over the "model" dim."""
    import torch.distributed as dist

    out = {}
    group = mesh.get_group("model")
    for n, p in module.named_parameters():
        t = p.full_tensor() if hasattr(p, "full_tensor") else p
        t = t.detach().contiguous()
        if n in dims:
            parts = [torch.empty_like(t)
                     for _ in range(mesh["model"].size())]
            dist.all_gather(parts, t, group=group)
            t = torch.cat(parts, dim=dims[n])
        out[n] = t
    return out


def check_fsdp_tp(rank, world, out_dir):
    from svt_speechbrain_tpu_torch.parallel.fsdp import apply_fsdp
    from svt_speechbrain_tpu_torch.parallel.mesh import make_mesh
    from svt_speechbrain_tpu_torch.parallel.tp import apply_tp

    mesh = make_mesh(axis_names=("data", "model"), shape=(1, world))
    bridge = on(tiny_bridge())
    apply_tp(bridge, mesh)
    dims = {n: p._tp_dim for n, p in bridge.named_parameters()
            if hasattr(p, "_tp_dim")}
    apply_fsdp(bridge, mesh)
    losses_, _ = bridge_steps(bridge, on(wavs()))
    return dict(losses=losses_, dims=dims,
                params=_full_tp(bridge, dims, mesh))


def check_tp(rank, world, out_dir):
    from svt_speechbrain_tpu_torch.parallel.mesh import make_mesh
    from svt_speechbrain_tpu_torch.parallel.tp import apply_tp

    mesh = make_mesh(axis_names=("model",))
    holder = on(tp_layer())
    apply_tp(holder, mesh)
    x, w = (on(t) for t in layer_input())
    x.requires_grad_(True)
    out = holder["layers"][0](x)
    (out * w).sum().backward()
    dims = {n: p._tp_dim for n, p in holder.named_parameters()
            if hasattr(p, "_tp_dim")}
    dec = on(decoder())
    apply_tp(dec, mesh)
    enc, tokens = (on(t) for t in decoder_input())
    with torch.no_grad():
        logits, steps = decode(dec, enc, tokens)
    return dict(out=out.detach(), x_grad=x.grad, grads=_grads(holder),
                dims=dims, logits=logits, steps=steps)


# ``check_act_sharding``'s bridges: without dropout, then training with
# every dropout at 0.1, post-LN and pre-LN WavLM (a shared position bias)
# under ``remat``
DROPOUT = dict(hidden_dropout=0.1, attention_dropout=0.1,
               activation_dropout=0.1)
ACT_VARIANTS = (("quiet", {}, False), ("dropout", DROPOUT, True),
                ("wavlm_remat", dict(DROPOUT, rel_pos_bias=True, remat=True,
                                     do_stable_layer_norm=True), True))


def check_act_sharding(rank, world, out_dir):
    """Each variant's bridge with ``act_sharding`` over a ("data", "seq")
    mesh and without it, from the same generators: the output, the
    gradients and the frames the first layer was given."""
    from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG
    from svt_speechbrain_tpu_torch.parallel.mesh import make_mesh, use_mesh

    mesh = make_mesh(axis_names=("data", "seq"), shape=(1, world))
    wav = on(wavs())
    lens = on(torch.tensor([1.0, 0.7, 0.5, 1.0]))
    w = on(torch.from_numpy(np.random.default_rng(13).normal(
        size=(4, 9, 64)).astype(np.float32)))
    result = {}
    for variant, arch, train in ACT_VARIANTS:
        result[variant] = {}
        for name, spec in (("sharded", ("data", "seq", None)),
                           ("plain", None)):
            bridge = on(tiny_bridge(act_sharding=spec, **arch))
            bridge.output_norm = True
            frames = []
            bridge.encoder.layers[0].register_forward_pre_hook(
                lambda module, args: frames.append(args[0].shape[1]))
            rng = (StepRNG(torch.Generator(DEVICE).manual_seed(21),
                           torch.Generator().manual_seed(22))
                   if train else None)
            with use_mesh(mesh):
                out = bridge(wav, wav_lens=lens, rng=rng, train=train)
                (out * w).sum().backward()
            result[variant][name] = dict(out=out.detach(),
                                         grads=_grads(bridge),
                                         frames=frames[0])
    return result


def check_pipeline(rank, world, out_dir):
    import torch.distributed as dist

    from svt_speechbrain_tpu_torch.parallel.mesh import make_mesh
    from svt_speechbrain_tpu_torch.parallel.pipeline import (
        pipeline_transformer_layers, spmd_pipeline, stack_stage_params)

    mesh = make_mesh(axis_names=("pipe",))
    result = {}
    for m in (1, 4):                       # fewer micro-batches than stages
        params = {k: on(v).requires_grad_(True)
                  for k, v in stage_params(world).items()}
        y = spmd_pipeline(stage_fn, params, on(microbatches(m)), mesh)
        y.square().mean().backward()
        grads = {k: v.grad.clone() for k, v in params.items()}
        for g in grads.values():
            dist.all_reduce(g)             # each rank holds its stage's
        result[m] = dict(out=y.detach(), grads=grads)
    layers = [on(tp_layer(14 + i)["layers"][0]) for i in range(world)]
    stacked = stack_stage_params([dict(l.named_parameters()) for l in layers])
    x = on(layer_input()[0])
    with torch.no_grad():
        result["layers"] = pipeline_transformer_layers(
            layers[0], {k: v.detach() for k, v in stacked.items()},
            torch.stack([x, 2 * x]), mesh)
    return result


def check_syncbn(rank, world, out_dir):
    x, w = bn_data()
    part = rows(4, rank, world)
    bn = BatchNorm1d(3)
    init_modules({"bn": bn}, 16)
    bn = on(bn)
    xs = on(x[part]).requires_grad_(True)
    out = bn(xs, train=True, axis_name="data")
    (out * on(w[part])).sum().backward()
    grads = _grads(bn)
    import torch.distributed as dist
    for g in grads.values():
        dist.all_reduce(g)                 # the rows' parts of the sums
    return dict(out=out.detach(), x_grad=xs.grad, grads=grads,
                mean=bn.mean.clone(), var=bn.var.clone())


def check_checkpoint(rank, world, out_dir):
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_optimizer_state_dict)

    from svt_speechbrain_tpu_torch.parallel.fsdp import apply_fsdp
    from svt_speechbrain_tpu_torch.parallel.mesh import make_mesh
    from svt_speechbrain_tpu_torch.utils.orbax_checkpoints import (
        OrbaxCheckpointer)

    bridge = on(tiny_bridge())
    apply_fsdp(bridge, make_mesh())
    _, opt = bridge_steps(bridge, on(wavs()[rows(4, rank, world)]), steps=1,
                          adam=True)
    ck = OrbaxCheckpointer(os.path.join(out_dir, "ckpt"), {"model": bridge})
    ck.add_recoverable("opt", opt, module=bridge)
    step = ck.save_checkpoint(meta={"ranks": world})
    full_opt = get_optimizer_state_dict(
        bridge, opt, options=StateDictOptions(full_state_dict=True,
                                              cpu_offload=True))
    return dict(step=step, opt=full_opt, params={
        n: p.full_tensor().detach() for n, p in bridge.named_parameters()})


CHECKS = (("ddp_brain", check_ddp_brain),
          ("ddp_accumulation", check_ddp_accumulation),
          ("fsdp_brain", check_fsdp_brain), ("ddp_fit", check_ddp_fit),
          ("fsdp_fit", check_fsdp_fit), ("fsdp", check_fsdp),
          ("fsdp_tp", check_fsdp_tp), ("tp", check_tp),
          ("act_sharding", check_act_sharding), ("pipeline", check_pipeline),
          ("syncbn", check_syncbn), ("checkpoint", check_checkpoint))


def _cpu(tree):
    return tree_map(lambda t: t.detach().cpu() if torch.is_tensor(t) else t,
                    tree)


def main(out_dir, device="cpu"):
    import torch.distributed as dist

    from svt_speechbrain_tpu_torch.parallel.distributed import ddp_init_group

    global DEVICE
    torch.set_num_threads(THREADS)
    run_opts = {"distributed_launch": True, "device": device,
                "distributed_timeout": 60}
    ddp_init_group(run_opts)
    DEVICE = torch.device(run_opts["device"])
    # f32 products as the CPU references compute them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = dist.get_rank(), dist.get_world_size()
    results = {}
    for name, check in CHECKS:
        print(f"CHECK {name}", flush=True)
        mine = _cpu(check(rank, world, out_dir))
        both = [None] * world
        dist.all_gather_object(both, mine)
        results[name] = both
    if rank == 0:
        torch.save(results, os.path.join(out_dir, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()
    print("DONE", flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
