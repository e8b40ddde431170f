"""The port's multi-device layer across two gloo ranks on the CPU.

A module-scoped fixture launches ``tests/torch_multiprocess_worker.py`` on
two processes once for the file, under its own timeout: a run that does not
finish fails, naming the check it stopped in, and never hangs the suite.
On a machine with cards the same file runs the ranks on NCCL, one card
each: ``SVT_MP_RANKS=4 SVT_MP_DEVICE=cuda python -m pytest --noconftest
tests/test_torch_multiprocess.py`` (the references stay on the CPU).
Each test takes its check's results from both ranks and holds them against
the same computation in this one process (the single-process port, which
the other port tests hold against the JAX package): DDP through the
``Brain`` (single steps, and ``fit`` with validation, annealing and
checkpoints), FSDP2, FSDP with tensor parallelism, tensor-parallel encoder
and decoder layers, ``act_sharding``, the GPipe schedule, SyncBN and a
checkpoint saved at two ranks and restored at one.

Tolerances: sums of the same f32 terms in another order (two halves of a
batch, or two slices of a product, added up) differ in their last bits,
so outputs, gradients and parameters are held to atol 1e-5 / rtol 1e-4
(``tests/test_parallel.py:380-384``) unless a check is exact by
construction (the checkpoint: bit for bit).
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from svt_speechbrain_tpu_torch.parallel.fsdp import fsdp_shardings
from svt_speechbrain_tpu_torch.utils.orbax_checkpoints import (
    OrbaxCheckpointer)


def _load_worker():
    """The worker module, loaded from its file (another ``tests`` package
    may come first on the path of a machine with cards)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_multiprocess_worker.py")
    spec = importlib.util.spec_from_file_location(
        "torch_multiprocess_worker", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


worker = _load_worker()

TIMEOUT = 180
ATOL, RTOL = 1e-5, 1e-4
RANKS = int(os.environ.get("SVT_MP_RANKS", "2"))
DEVICE = os.environ.get("SVT_MP_DEVICE", "cpu")


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of every check, from one launch."""
    out = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(RANKS))
    logs = [open(out / f"rank{r}.log", "w") for r in range(RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(out), DEVICE],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(RANKS)]
    deadline = time.monotonic() + TIMEOUT
    while (any(p.poll() is None for p in procs)
           and time.monotonic() < deadline):
        time.sleep(0.2)
    hung = [p for p in procs if p.poll() is None]
    for p in hung:
        p.kill()
        p.wait()
    for log in logs:
        log.close()
    texts = [(out / f"rank{r}.log").read_text() for r in range(RANKS)]
    checks = [line.split()[1] for t in texts for line in t.splitlines()
              if line.startswith("CHECK ")]
    last = checks[-1] if checks else "(set-up)"
    if hung:
        pytest.fail(f"the ranks did not finish within {TIMEOUT} s; they "
                    f"stopped in check {last}:\n" + texts[0][-3000:])
    if any(p.returncode for p in procs):
        pytest.fail(f"a rank failed in check {last}:\n"
                    + "\n".join(t[-3000:] for t in texts))
    return dict(torch.load(out / "results.pt", weights_only=False),
                out_dir=str(out))


def _close(got, want, what="", atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(),
                               torch.as_tensor(want).numpy(), atol=atol,
                               rtol=rtol, err_msg=what)


def test_ddp_brain_step_equals_the_full_batch_step(ranks):
    """Three SGD steps of the ``Brain`` over an uneven batch (7 rows: 4 and
    3 on two ranks) equal three steps on the whole batch in one process; the frozen module
    stays out; a NaN on one rank skips the step on both."""
    x, y = worker.brain_data()
    brain = worker.make_brain()
    frozen = {n: p.detach().clone()
              for n, p in brain.modules.frozen.named_parameters()}
    want = [brain.fit_batch(worker.brain_batch(x, y)) for _ in range(3)]
    params = dict(brain.modules.named_parameters())
    for r, got in enumerate(ranks["ddp_brain"]):
        _close(got["losses"], want, f"rank {r} losses", atol=0, rtol=1e-6)
        for name, value in got["params"].items():
            _close(value, params[name].detach(), f"rank {r} {name}")
        for name, value in frozen.items():
            assert torch.equal(got["params"]["frozen." + name], value)
        assert np.isnan(got["skipped"]) and got["unchanged"]
        assert got["nonfinite"] == 1
    a, b = (ranks["ddp_brain"][r]["params"] for r in (0, -1))
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_ddp_accumulated_step_equals_the_full_batch_step(ranks):
    """``grad_accumulation_factor`` 2 under DDP (the first micro-batch under
    ``no_sync``), 8 rows shared equally, equals the factor-2 step on all 8
    rows."""
    x, y = worker.brain_data(8)
    brain = worker.make_brain(grad_accumulation_factor=2)
    want = [brain.fit_batch(worker.brain_batch(x, y)) for _ in range(2)]
    params = dict(brain.modules.named_parameters())
    for r, got in enumerate(ranks["ddp_accumulation"]):
        _close(got["losses"], want, f"rank {r} losses", atol=0, rtol=1e-6)
        for name, value in got["params"].items():
            _close(value, params[name].detach(), f"rank {r} {name}")


def test_fsdp_brain_step_equals_the_full_batch_step(ranks):
    """The ``Brain`` with the ``fsdp`` run option (FSDP2 over every rank)
    on the uneven batch: the whole batch's steps; the frozen module stays
    as it was."""
    x, y = worker.brain_data()
    brain = worker.make_brain()
    frozen = {n: p.detach().clone()
              for n, p in brain.modules.frozen.named_parameters()}
    want = [brain.fit_batch(worker.brain_batch(x, y)) for _ in range(3)]
    params = dict(brain.modules.named_parameters())
    for r, got in enumerate(ranks["fsdp_brain"]):
        _close(got["losses"], want, f"rank {r} losses", atol=0, rtol=1e-6)
        for name, value in got["params"].items():
            _close(value, params[name].detach(), f"rank {r} {name}")
        for name, value in frozen.items():
            assert torch.equal(got["params"]["frozen." + name], value)


@pytest.mark.parametrize("check", ["ddp_fit", "fsdp_fit"])
def test_fit_anneals_and_checkpoints_alike_on_every_rank(ranks, tmp_path,
                                                         check):
    """Two epochs of ``fit`` with validation under DDP and under the
    ``fsdp`` run option equal the same fit in one process: the NewBob
    anneal after epoch 2 sets every rank's learning rate, the parameters
    and the train log are the whole batch's, an intra-epoch checkpoint is
    written at every step. A new brain on every rank recovers the newest
    checkpoint bit for bit (parameters, momentum, epoch, schedule), and so
    does one process from the ranks' files (on the ranks' kind of device:
    the files hold its generators' states)."""
    brain, counter = worker.make_fit_brain(str(tmp_path))
    worker.fit(brain, counter)
    want = dict(brain.modules.named_parameters())
    for r, got in enumerate(ranks[check]):
        assert got["lrs"] == brain.lrs == [0.1, 0.05], f"rank {r}"
        assert got["optimizer_lr"] == 0.05, f"rank {r}"
        _close(got["train_loss"], brain.train_loss, f"rank {r} train loss",
               atol=0, rtol=1e-6)
        for name, value in got["params"].items():
            _close(value, want[name].detach(), f"rank {r} {name}")
        assert got["intra_saves"] == [1, 1, 1, 1], f"rank {r}"
        assert got["meta"]["end-of-epoch"] and got["recovered_epoch"] == 2
        assert got["recovered_lr"] == 0.05
        for name, value in got["params"].items():
            assert torch.equal(got["recovered"][name], value), (r, name)
        for a, b in zip(got["momentum"], got["recovered_momentum"]):
            assert torch.equal(a, b), f"rank {r} momentum"
    folder = ranks[check][0]["folder"]
    with open(os.path.join(folder, "log.txt")) as f, \
            open(tmp_path / "log.txt") as g:
        assert f.read() == g.read()
    here, counter = worker.make_fit_brain(folder, DEVICE)
    here.init_optimizers()
    here.checkpointer.recover_if_possible()
    assert counter.current == 2
    for name, p in here.modules.named_parameters():
        assert torch.equal(p.detach().cpu(), ranks[check][0]["params"][name]), \
            name


def test_fsdp_training_equals_replicated_training(ranks):
    """Two SGD steps under FSDP2, each rank on its half of the batch, equal
    the steps on the whole batch; every parameter is placed by the JAX
    rule (a replicated one split along axis 0 instead)."""
    bridge = worker.tiny_bridge()
    rule = fsdp_shardings(bridge, RANKS)
    want, _ = worker.bridge_steps(bridge, worker.wavs())
    params = dict(bridge.named_parameters())
    for r, got in enumerate(ranks["fsdp"]):
        for step, loss in enumerate(want):
            mean = np.mean([ranks["fsdp"][i]["losses"][step]
                            for i in range(RANKS)])
            _close(mean, loss, f"step {step}", atol=0, rtol=1e-6)
        for name, value in got["params"].items():
            _close(value, params[name].detach(), f"rank {r} {name}")
        for name, placements in got["placements"].items():
            dim = getattr(rule[name], "dim", 0)
            assert [p.dim for p in placements] == [dim], name


def test_fsdp_with_tensor_parallelism_equals_replicated(ranks):
    """FSDP2 over "data" composed with tensor parallelism over "model" (a
    (1, ranks) mesh) trains as the replicated model does; the split axes
    are the TP rule's."""
    bridge = worker.tiny_bridge()
    want, _ = worker.bridge_steps(bridge, worker.wavs())
    params = dict(bridge.named_parameters())
    for r, got in enumerate(ranks["fsdp_tp"]):
        _close(got["losses"], want, f"rank {r} losses")
        assert got["dims"]["encoder.layers.0.ffn1.w"] == 1
        assert got["dims"]["encoder.layers.0.ffn2.w"] == 0
        assert got["dims"]["encoder.layers.0.attn.wo"] == 0
        for name, value in got["params"].items():
            _close(value, params[name].detach(), f"rank {r} {name}")


def test_tensor_parallel_encoder_layer_and_decoder_step(ranks):
    holder = worker.tp_layer()
    x, w = worker.layer_input()
    x.requires_grad_(True)
    out = holder["layers"][0](x)
    (out * w).sum().backward()
    grads = dict(holder.named_parameters())
    dec = worker.decoder()
    enc, tokens = worker.decoder_input()
    with torch.no_grad():
        logits, steps = worker.decode(dec, enc, tokens)
    for r, got in enumerate(ranks["tp"]):
        _close(got["out"], out.detach(), f"rank {r} out")
        _close(got["x_grad"], x.grad, f"rank {r} input gradient")
        assert set(got["grads"]) == set(grads)
        for name, g in got["grads"].items():
            full = grads[name].grad
            if name in got["dims"]:
                full = full.chunk(RANKS, dim=got["dims"][name])[r]
            _close(g, full, f"rank {r} {name}")
        _close(got["logits"], logits, f"rank {r} decoder logits")
        _close(got["steps"], steps, f"rank {r} decoder steps")


def test_act_sharding_equals_replicated(ranks):
    """The bridge with ``act_sharding=("data", "seq", None)`` on a
    ("data", "seq") mesh gives the output and gradients of the same bridge
    without it on the rank's device (``tests/test_parallel.py:239``), in
    eval and in training with every dropout (the same draws), post-LN and
    pre-LN WavLM under ``remat``; between layers each rank holds
    ceil(9 / ranks) of the 9 frames. Without dropout those are this
    process's numbers within 1e-4 of each leaf's peak, and ATOL (on cards,
    the f32 convs of another device)."""
    bridge = worker.tiny_bridge()
    bridge.output_norm = True
    w = torch.from_numpy(np.random.default_rng(13).normal(
        size=(4, 9, 64)).astype(np.float32))
    out = bridge(worker.wavs(), wav_lens=torch.tensor([1.0, 0.7, 0.5, 1.0]))
    (out * w).sum().backward()
    for r, got in enumerate(ranks["act_sharding"]):
        for variant, _, _ in worker.ACT_VARIANTS:
            sharded, plain = got[variant]["sharded"], got[variant]["plain"]
            what = f"rank {r} {variant}"
            assert plain["frames"] == 9, what
            assert sharded["frames"] == -(-9 // RANKS), what
            _close(sharded["out"], plain["out"], f"{what} out")
            assert set(sharded["grads"]) == set(plain["grads"]), what
            for name, g in plain["grads"].items():
                _close(sharded["grads"][name], g, f"{what} {name}")
        plain = got["quiet"]["plain"]
        _close(plain["out"], out.detach(), f"rank {r} out against here",
               atol=max(ATOL, 1e-4 * out.abs().max().item()))
        for name, p in bridge.named_parameters():
            _close(plain["grads"][name], p.grad, f"rank {r} {name} here",
                   atol=max(ATOL, 1e-4 * p.grad.abs().max().item()))


def test_gpipe_forward_and_gradients_equal_sequential(ranks):
    """A stage a rank, one micro-batch (fewer than the stages) and four:
    outputs and gradients of the sequential stack; a pipeline of a
    transformer layer a rank equals the layers in turn."""
    for m in (1, 4):
        params = {k: v.clone().requires_grad_(True)
                  for k, v in worker.stage_params(RANKS).items()}
        y = worker.sequential(params, worker.microbatches(m))
        y.square().mean().backward()
        for r, got in enumerate(ranks["pipeline"]):
            _close(got[m]["out"], y.detach(), f"rank {r} M={m} out")
            for k, p in params.items():
                _close(got[m]["grads"][k], p.grad, f"rank {r} M={m} {k}")
    layers = [worker.tp_layer(14 + i)["layers"][0] for i in range(RANKS)]
    x, _ = worker.layer_input()

    def stack(v):
        for layer in layers:
            v = layer(v)
        return v

    with torch.no_grad():
        want = torch.stack([stack(v) for v in (x, 2 * x)])
    for r, got in enumerate(ranks["pipeline"]):
        _close(got["layers"], want, f"rank {r} layers")


def test_syncbn_equals_full_batch_batchnorm(ranks):
    """Cross-replica statistics over the ranks' equal parts of four rows:
    the outputs, the input and parameter gradients and the running
    statistics of one BatchNorm over all four rows."""
    from svt_speechbrain_tpu_torch.convert_jax import init_modules
    from svt_speechbrain_tpu_torch.nnet.normalization import BatchNorm1d

    x, w = worker.bn_data()
    bn = BatchNorm1d(3)
    init_modules({"bn": bn}, 16)
    xs = x.clone().requires_grad_(True)
    out = bn(xs, train=True)
    (out * w).sum().backward()
    for r, got in enumerate(ranks["syncbn"]):
        rows = worker.rows(4, r, RANKS)
        _close(got["out"], out[rows].detach(), f"rank {r} out")
        _close(got["x_grad"], xs.grad[rows], f"rank {r} input gradient")
        for name, p in bn.named_parameters():
            _close(got["grads"][name], p.grad, f"rank {r} {name}")
        _close(got["mean"], bn.mean, f"rank {r} mean")
        _close(got["var"], bn.var, f"rank {r} var")


def test_checkpoint_saved_at_two_ranks_restores_at_one(ranks):
    """An FSDP2 model and its Adam, saved sharded over the ranks through
    ``OrbaxCheckpointer``, restore bit for bit into one unsharded model
    and optimizer here."""
    from torch.distributed.checkpoint.state_dict import (
        get_optimizer_state_dict)

    saved = ranks["checkpoint"][0]
    bridge = worker.tiny_bridge(seed=99)
    opt = torch.optim.Adam(bridge.parameters(), lr=worker.LR)
    ck = OrbaxCheckpointer(os.path.join(ranks["out_dir"], "ckpt"),
                           {"model": bridge})
    ck.add_recoverable("opt", opt, module=bridge)
    assert ck.recover_if_possible() == saved["step"] == 0
    with open(os.path.join(ranks["out_dir"], "ckpt", "0", "meta.json")) as f:
        assert json.load(f) == {"ranks": RANKS}
    for name, p in bridge.named_parameters():
        assert torch.equal(p.detach(), saved["params"][name]), name
    state = get_optimizer_state_dict(bridge, opt)["state"]
    assert set(state) == set(saved["opt"]["state"])
    for name, entries in saved["opt"]["state"].items():
        for key, value in entries.items():
            assert torch.equal(torch.as_tensor(state[name][key]),
                               torch.as_tensor(value)), (name, key)
