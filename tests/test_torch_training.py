"""Port parity, training: the TINY ``AudioAMT`` in both packages from one
numpy weight tree, on the same numpy batches, f32 on the CPU. One
linear-probe step (epoch 1), two full-finetune steps (epoch 3) with the
task's optimizers, then one full-finetune step with plain SGD in both
engines. After each step the loss and the global gradient norm must agree,
and so must every parameter's update (after minus before): this holds
``torch.optim.Adam``/``Adadelta`` to ``optax.adam``/``adadelta``, and, on
the SGD step, whose update is the clipped gradient times the learning
rate, the per-parameter gradients and the clip factor.

Dropout is off in both (the two packages draw different random masks);
the in-kernel dropout hash is compared bit for bit at kernel level in
``test_torch_flash_training.py``."""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from svt_speechbrain_tpu.core import Stage as JStage
from svt_speechbrain_tpu.dataio.batch import PaddedData as JPaddedData
from svt_speechbrain_tpu.models.wav2vec2 import (
    HuggingFaceWav2Vec2 as JBridge, Wav2Vec2Config as JConfig)
from svt_speechbrain_tpu.nnet import losses as jlosses
from svt_speechbrain_tpu.nnet.activations import Softmax as JSoftmax
from svt_speechbrain_tpu.nnet.linear import Linear as JLinear
from svt_speechbrain_tpu.tasks.amt import AudioAMT as JAudioAMT

from svt_speechbrain_tpu_torch.convert_jax import (export_jax_params,
                                                   init_params,
                                                   load_jax_params)
from svt_speechbrain_tpu_torch.core import Brain, Stage
from svt_speechbrain_tpu_torch.dataio.batch import PaddedData
from svt_speechbrain_tpu_torch.models.wav2vec2 import (
    HuggingFaceWav2Vec2, TINY_ARCH, Wav2Vec2Config)
from svt_speechbrain_tpu_torch.nnet import losses
from svt_speechbrain_tpu_torch.nnet.activations import Softmax
from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG, dropout
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.tasks.amt import AudioAMT

NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0,
                  activation_dropout=0.0, feat_proj_dropout=0.0)
ARCH = dict(TINY_ARCH, **NO_DROPOUT)
SAMPLES = 8000
# low enough that the clip fires on the SGD step (the recipe's is 5.0)
MAX_GRAD_NORM = 1.0
# the last step's optimizer in both engines: its update is -lr * clip * g
SGD_LR = 0.1
# f32 on both sides: summation order only
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4
# each parameter's update, |du_torch - du_jax| / |du_jax| over the leaf:
# at most 9.0e-4 over the four steps (Adam's first step on the positional
# conv's v, whose smallest gradients sit near Adam's eps), 6.6e-5 on the
# SGD step; a missing or sign-flipped update gives 1 or 2, a clip factor
# off by more than 0.5% fails the SGD step
UPDATE_RTOL = 5e-3
# a leaf whose reference gradient is under this share of the global norm
# is 0 in exact arithmetic (the attention's key bias: softmax ignores a
# per-query constant) and float noise on both sides, at 3e-10 to 1.2e-9 of
# the norm; Adam turns that noise into +-lr steps of either sign, so its
# update is not compared. The next smallest share is 8.8e-4 (a query bias)
ZERO_GRAD_SHARE = 1e-6


def _hparams(loss_mod, softmax):
    crit = dict(reduction="mean", allowed_len_diff=60, label_smoothing=0.0)
    return dict(
        seed=1986, pitch_octave_num=4, onset_positive_weight=15.0,
        offset_positive_weight=1.0, lr=3e-4, lr_wav2vec=5e-5,
        linear_prob_epochs=2, max_grad_norm=MAX_GRAD_NORM,
        onset_criterion=functools.partial(loss_mod.bce_loss, **crit),
        offset_criterion=functools.partial(loss_mod.bce_loss, **crit),
        octave_criterion=functools.partial(loss_mod.nll_loss, **crit),
        pitch_criterion=functools.partial(loss_mod.nll_loss, **crit),
        log_softmax=softmax(apply_log=True))


def _batches(cfg, n, seed):
    """n batches of 2 rows: the second row's annotation is 3/4 valid."""
    rng = np.random.default_rng(seed)
    frames = cfg.output_length(SAMPLES)
    out = []
    for _ in range(n):
        wav = rng.normal(size=(2, SAMPLES)).astype(np.float32)
        anno = np.stack([rng.random((2, frames)) > 0.8,
                         rng.random((2, frames)) > 0.8,
                         rng.integers(0, 5, (2, frames)),
                         rng.integers(0, 13, (2, frames))],
                        axis=-1).astype(np.float32)
        out.append((wav, np.ones(2, np.float32), anno,
                    np.asarray([1.0, 0.75], np.float32)))
    return out


def _flat(tree, prefix=""):
    """A nested dict of arrays → {"a/b/c": f32 numpy copy}."""
    flat = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            flat.update(_flat(val, f"{prefix}{key}/"))
        else:
            flat[f"{prefix}{key}"] = np.array(val, np.float32)
    return flat


def _run_steps():
    """The four steps in both engines; returns ([step record], start)."""
    cfg = Wav2Vec2Config(**ARCH)
    tree = init_params(cfg, torch.Generator().manual_seed(0))

    jmodules = {"wav2vec2": JBridge(config=JConfig(**ARCH), output_norm=True,
                                    normalize_wav=True),
                "model": JLinear(20, cfg.hidden_size)}
    for name, module in jmodules.items():
        # the JAX engine initialises each module's params itself: hand it
        # the shared tree (and skip its random init, slow op by op on CPU)
        module.init = functools.partial(
            lambda sub, rng: jax.tree_util.tree_map(jnp.asarray, sub),
            tree[name])
    jbrain = JAudioAMT(modules=jmodules, hparams=_hparams(jlosses, JSoftmax),
                       run_opts={"noprogressbar": True,
                                 "data_parallel_count": 1})
    jbrain.init_optimizers()

    bridge = HuggingFaceWav2Vec2(config=cfg, output_norm=True,
                                 normalize_wav=True)
    head = Linear(20, cfg.hidden_size)
    load_jax_params(tree, bridge, head)
    brain = AudioAMT(modules={"wav2vec2": bridge, "model": head},
                     hparams=_hparams(losses, Softmax),
                     run_opts={"device": "cpu"})
    brain.init_optimizers()

    def j_loss(params, arrays):
        preds = jbrain.compute_forward(params, arrays, JStage.TRAIN,
                                       jax.random.PRNGKey(0))
        return jbrain.compute_objectives(preds, arrays, JStage.TRAIN)

    j_grad = jax.jit(jax.grad(j_loss))
    steps = []
    for kind, epoch, (wav, wlens, anno, alens) in zip(
            ("probe", "finetune", "finetune", "sgd"), (1, 3, 3, 3),
            _batches(cfg, 4, 1)):
        if kind == "sgd":
            both = ["wav2vec2", "model"]
            jbrain.optimizers, jbrain.opt_states = {}, {}
            jbrain.add_optimizer("sgd", functools.partial(optax.sgd), both,
                                 lr=SGD_LR)
            brain.optimizers = {}
            brain.add_optimizer("sgd", torch.optim.SGD, both, lr=SGD_LR)
        jbrain.configure_freezing(epoch)
        brain.on_stage_start(Stage.TRAIN, epoch)
        jbatch = {"sig": JPaddedData(wav, wlens),
                  "anno": JPaddedData(anno, alens)}
        grads = j_grad(jbrain.params, jbrain._batch_arrays(jbatch))
        if epoch <= 2:
            grads = {"model": grads["model"]}
        j_before = _flat(jax.device_get(jbrain.params))
        before = _flat(export_jax_params(bridge, head))
        j_loss_val = jbrain.fit_batch(jbatch)
        loss = brain.fit_batch({"sig": PaddedData(wav, wlens),
                                "anno": PaddedData(anno, alens)})
        steps.append(dict(
            kind=kind, epoch=epoch, j_loss=j_loss_val, loss=loss,
            j_gnorm=float(optax.global_norm(grads)),
            gnorm=brain.last_grad_norm, j_grads=_flat(jax.device_get(grads)),
            j_before=j_before, j_params=_flat(jax.device_get(jbrain.params)),
            before=before, params=_flat(export_jax_params(bridge, head))))
    return steps, _flat(tree)


@pytest.fixture(scope="module")
def trajectories():
    return _run_steps()


def _update_errors(step):
    """{leaf: |du - du_jax| / |du_jax|} over the leaves with a gradient
    above ``ZERO_GRAD_SHARE`` of the norm; frozen leaves must not move on
    either side."""
    errs = {}
    for name, want_after in step["j_params"].items():
        want = want_after - step["j_before"][name]
        got = step["params"][name] - step["before"][name]
        if name not in step["j_grads"]:
            assert not want.any() and not got.any(), name
            continue
        if (np.linalg.norm(step["j_grads"][name])
                <= ZERO_GRAD_SHARE * step["j_gnorm"]):
            continue
        errs[name] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    return errs


def test_losses_and_gradient_norms_match_jax(trajectories):
    steps, _ = trajectories
    for s in steps:
        np.testing.assert_allclose(s["loss"], s["j_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(s["gnorm"], s["j_gnorm"], rtol=GNORM_RTOL)
    # on the SGD step a clip factor other than JAX's moves every update
    assert steps[-1]["kind"] == "sgd" and steps[-1]["j_gnorm"] > MAX_GRAD_NORM


def test_parameters_after_each_step_match_jax(trajectories):
    """Every parameter's update on each step, held at ``UPDATE_RTOL`` of
    the update's own size; only leaves whose reference gradient is zero to
    rounding are exempt, and only the attention's key biases are."""
    steps, _ = trajectories
    for s in steps:
        assert s["params"].keys() == s["j_params"].keys()
        errs = _update_errors(s)
        exempt = {n for n in s["j_grads"] if n not in errs}
        assert all(n.endswith("attn/bk") for n in exempt), exempt
        worst = max(errs, key=errs.get)
        assert errs[worst] <= UPDATE_RTOL, \
            f"{s['kind']} step (epoch {s['epoch']}): {worst} {errs[worst]:.3e}"


def test_probe_step_moves_only_the_head(trajectories):
    steps, start = trajectories
    probe = steps[0]["params"]
    for name, value in probe.items():
        moved = not np.array_equal(value, start[name])
        assert moved == name.startswith("model/"), name
    finetune = steps[1]["params"]
    assert any(not np.array_equal(finetune[n], probe[n])
               for n in probe if n.startswith("wav2vec2/"))


def test_export_inverts_load():
    cfg = Wav2Vec2Config(**ARCH)
    tree = init_params(cfg, torch.Generator().manual_seed(2))
    bridge = HuggingFaceWav2Vec2(config=cfg)
    head = Linear(20, cfg.hidden_size)
    load_jax_params(tree, bridge, head)
    got, want = _flat(export_jax_params(bridge, head)), _flat(tree)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_dropout_keeps_and_scales():
    x = torch.ones(64, 64)
    assert dropout(x, 0.3, torch.Generator().manual_seed(0)) is x  # eval
    y = dropout(x, 0.25, torch.Generator().manual_seed(0), train=True)
    assert set(y.unique().tolist()) == {0.0, float(np.float32(4.0 / 3.0))}
    assert abs((y == 0).float().mean().item() - 0.25) < 0.03
    seeds = {StepRNG(torch.Generator(), torch.Generator().manual_seed(s))
             .attention_seed() for s in range(4)}
    assert len(seeds) == 4 and all(0 <= s < 2 ** 31 - 1 for s in seeds)


def test_bf16_precision_casts_parameters_and_keeps_f32_masters():
    """``precision="bf16"``: the forward sees bf16 parameters; the masters
    and their gradients stay f32, and the step is finite."""
    seen = []

    class Probe(Brain):
        def compute_forward(self, batch, stage, rng=None):
            seen.append(self.modules.model.w.dtype)
            return self.modules.model(batch["x"].float())

        def compute_objectives(self, predictions, batch, stage):
            return predictions.square().mean()

    head = Linear(4, 8)
    torch.nn.init.normal_(head.w)
    brain = Probe({"model": head}, run_opts={"device": "cpu",
                                             "precision": "bf16"})
    brain.add_optimizer("opt", torch.optim.SGD, ["model"], lr=0.1)
    loss = brain.fit_batch({"x": np.ones((2, 8), np.float32)})
    assert seen == [torch.bfloat16] and np.isfinite(loss)
    assert head.w.dtype == torch.float32 and head.w.grad.dtype == torch.float32
    assert brain.optimizer_step == 1


@pytest.mark.parametrize("where,factor", [("run_opts", 1),
                                          ("run_opts", 2), ("hparams", 2)])
def test_grad_accumulation_is_refused_until_ported(where, factor):
    """``grad_accumulation_factor`` is taken from run_opts or hparams, as
    the JAX Brain takes it (it was refused before accumulation was
    ported). At factor 2 a batch of 4 rows runs as two micro-batches of 2
    whose gradients are summed and divided by 2: with a loss that sums its
    rows, the update is half that of one unaccumulated step on the 4 rows
    (the parity with the JAX step is held in
    ``test_torch_grad_accumulation.py``)."""
    opts = {"grad_accumulation_factor": factor}
    kwargs = {"run_opts": {"device": "cpu", **opts}} if where == "run_opts" \
        else {"run_opts": {"device": "cpu"}, "hparams": {"seed": 0, **opts}}

    class Mean(Brain):
        def compute_forward(self, batch, stage, rng=None):
            return self.modules.model(batch["x"])

        def compute_objectives(self, predictions, batch, stage):
            return (predictions.square().sum(-1)
                    * batch["valid_rows"]).sum() / 2.0

    x = np.arange(8, dtype=np.float32).reshape(4, 2) / 8
    updates = []
    for accum_kwargs in (kwargs, {"run_opts": {"device": "cpu"}}):
        head = Linear(2, 2)
        with torch.no_grad():
            head.w.copy_(torch.tensor([[0.5, -0.25], [0.125, 1.0]]))
            head.b.zero_()
        brain = Mean({"model": head}, **accum_kwargs)
        brain.add_optimizer("sgd", torch.optim.SGD, ["model"], lr=0.1)
        before = head.w.detach().clone()
        brain.fit_batch({"x": x[:factor * 2] if factor > 1 else x[:2]})
        updates.append(head.w.detach() - before)
    assert brain.grad_accumulation_factor == 1
    assert Mean({"model": Linear(2, 2)}, **kwargs).grad_accumulation_factor \
        == factor
    if factor == 1:
        return
    # two micro-batches of 2 rows: (g1 + g2) / 2 is the mean over 4 rows of
    # a loss that sums 2 rows, half the unaccumulated step's sum over 4
    torch.testing.assert_close(updates[0], updates[1] / 2)


def test_nonfinite_steps_are_skipped_then_raise():
    class Nan(Brain):
        def compute_forward(self, batch, stage, rng=None):
            return self.modules.model(batch["x"])

        def compute_objectives(self, predictions, batch, stage):
            return predictions.sum() * float("nan")

    head = Linear(2, 2)
    brain = Nan({"model": head}, run_opts={"device": "cpu",
                                           "nonfinite_patience": 1})
    brain.add_optimizer("opt", torch.optim.SGD, ["model"], lr=0.1)
    before = head.w.detach().clone()
    batch = {"x": torch.ones(1, 2)}
    assert np.isnan(brain.fit_batch(batch))
    assert torch.equal(head.w.detach(), before) and brain.optimizer_step == 0
    with pytest.raises(ValueError):
        brain.fit_batch(batch)


def test_bridge_freezing_options():
    """``freeze_feature_extractor``: the extractor takes no gradient, the
    rest does; ``freeze``: no gradient anywhere and no dropout, so the
    train-mode output equals the eval output."""
    cfg = Wav2Vec2Config(**TINY_ARCH)     # dropouts 0.1
    tree = init_params(cfg, torch.Generator().manual_seed(4))
    wav = torch.from_numpy(_batches(cfg, 1, 5)[0][0])
    rng = StepRNG(torch.Generator().manual_seed(0),
                  torch.Generator().manual_seed(1))
    bridge = HuggingFaceWav2Vec2(config=cfg, freeze_feature_extractor=True)
    load_jax_params(tree, bridge)
    bridge(wav, rng=rng, train=True).sum().backward()
    ext = bridge.encoder.feature_extractor
    assert all(p.grad is None for p in ext.parameters())
    assert all(p.grad is not None for n, p in bridge.named_parameters()
               if not n.startswith("encoder.feature_extractor."))
    frozen = HuggingFaceWav2Vec2(config=cfg, freeze=True)
    load_jax_params(tree, frozen)
    out = frozen(wav, rng=rng, train=True)
    assert not out.requires_grad
    with torch.no_grad():
        assert torch.equal(out, frozen(wav))
