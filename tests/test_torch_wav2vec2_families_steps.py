"""Port parity, training steps of the SSL families: one full-finetune
``AudioAMT`` step's loss and every gradient against ``jax.grad`` (base,
data2vec under ``remat``, WavLM-large), and ``remat``/``remat_frontend``
steps bit for bit against steps without remat, dropouts 0.1 (the families'
forwards: ``test_torch_wav2vec2_families.py``)."""
import functools

import numpy as np
import pytest

import jax
import torch

from svt_speechbrain_tpu.core import Stage as JStage
from svt_speechbrain_tpu.dataio.batch import PaddedData as JPaddedData
from svt_speechbrain_tpu.nnet import losses as jlosses
from svt_speechbrain_tpu.nnet.activations import Softmax as JSoftmax
from svt_speechbrain_tpu.nnet.linear import Linear as JLinear
from svt_speechbrain_tpu.tasks.amt import AudioAMT as JAudioAMT

from svt_speechbrain_tpu_torch.convert_jax import (
    _flatten, export_jax_params, init_wav2vec2, load_module_tree,
    module_state)
from svt_speechbrain_tpu_torch.core import Stage
from svt_speechbrain_tpu_torch.dataio.batch import PaddedData
from svt_speechbrain_tpu_torch.models import wav2vec2 as w2v
from svt_speechbrain_tpu_torch.nnet import losses
from svt_speechbrain_tpu_torch.nnet.activations import Softmax
from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.tasks.amt import AudioAMT
from tests.torch_threads import two_torch_threads  # noqa: F401
from tests.test_torch_wav2vec2_families import (  # noqa: F401
    DROPOUT, GRAD_RTOL, LOSS_RTOL, SAMPLES, ZERO_GRAD_SHARE, _bridges, _configs, _wavs)


# -------------------------------------------------------------- training
def _amt_hparams(loss_mod, softmax):
    crit = dict(reduction="mean", allowed_len_diff=60, label_smoothing=0.0)
    return dict(
        seed=1986, pitch_octave_num=4, onset_positive_weight=15.0,
        offset_positive_weight=1.0, lr=3e-4, lr_wav2vec=5e-5,
        linear_prob_epochs=0, max_grad_norm=5.0,
        onset_criterion=functools.partial(loss_mod.bce_loss, **crit),
        offset_criterion=functools.partial(loss_mod.bce_loss, **crit),
        octave_criterion=functools.partial(loss_mod.nll_loss, **crit),
        pitch_criterion=functools.partial(loss_mod.nll_loss, **crit),
        log_softmax=softmax(apply_log=True))


def _amt_batch(frames, seed):
    rng = np.random.default_rng(seed)
    wav = rng.normal(size=(2, SAMPLES)).astype(np.float32)
    anno = np.stack([rng.random((2, frames)) > 0.8,
                     rng.random((2, frames)) > 0.8,
                     rng.integers(0, 5, (2, frames)),
                     rng.integers(0, 13, (2, frames))],
                    axis=-1).astype(np.float32)
    return (wav, np.ones(2, np.float32), anno,
            np.asarray([1.0, 0.75], np.float32))


@pytest.mark.parametrize("family,remat", [
    ("base", False), ("data2vec", True), ("wavlm_large", False)],
    ids=["base", "data2vec_remat", "wavlm_large"])
def test_amt_step_loss_and_gradients_match_jax_grad(family, remat):
    """One full-finetune ``AudioAMT`` step's loss and every parameter's
    gradient, dropouts 0; "data2vec_remat" runs ``remat`` and
    ``remat_frontend`` in both packages."""
    extra = dict(remat=remat, remat_frontend=remat)
    jb, params, tb = _bridges(family, **extra)
    head_tree = JLinear(20, 64).init(jax.random.PRNGKey(1))
    tree = {"wav2vec2": params, "model": head_tree}
    jmodules = {"wav2vec2": jb, "model": JLinear(20, 64)}
    for name, module in jmodules.items():
        module.init = functools.partial(lambda sub, rng: sub, tree[name])
    jbrain = JAudioAMT(modules=jmodules,
                       hparams=_amt_hparams(jlosses, JSoftmax),
                       run_opts={"noprogressbar": True,
                                 "data_parallel_count": 1})
    head = Linear(20, 64)
    load_module_tree(head, jax.tree_util.tree_map(np.asarray, head_tree))
    brain = AudioAMT(modules={"wav2vec2": tb.train(), "model": head},
                     hparams=_amt_hparams(losses, Softmax),
                     run_opts={"device": "cpu"})
    wav, wlens, anno, alens = _amt_batch(tb.config.output_length(SAMPLES), 2)

    def j_loss(p, arrays):
        preds = jbrain.compute_forward(p, arrays, JStage.TRAIN,
                                       jax.random.PRNGKey(0))
        return jbrain.compute_objectives(preds, arrays, JStage.TRAIN)

    arrays = jbrain._batch_arrays({"sig": JPaddedData(wav, wlens),
                                   "anno": JPaddedData(anno, alens)})
    want_loss, jgrads = jax.jit(jax.value_and_grad(j_loss))(
        jbrain.params, arrays)
    batch = brain._batch_to_device({"sig": PaddedData(wav, wlens),
                                    "anno": PaddedData(anno, alens)})
    loss = brain.compute_objectives(
        brain.compute_forward(batch, Stage.TRAIN, StepRNG(
            torch.Generator(), torch.Generator())), batch, Stage.TRAIN)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    gnorm = np.sqrt(sum(np.square(g).sum()
                        for g in jax.tree_util.tree_leaves(jgrads)))
    checked = 0
    for name, module in brain.modules.items():
        want = module_state(module, jgrads[name])
        got = {n: p.grad for n, p in module.named_parameters()}
        assert sorted(got) == sorted(want), name
        for n, g in got.items():
            ref = want[n].numpy()
            if np.linalg.norm(ref) <= ZERO_GRAD_SHARE * gnorm:
                assert n.endswith("attn.bk"), n
                continue
            err = np.linalg.norm(g.numpy() - ref) / np.linalg.norm(ref)
            assert err <= GRAD_RTOL, f"{name}.{n}: {err:.2e}"
            checked += 1
    assert checked > 40


def _seeded_amt(family, precision="fp32", **extra):
    """``AudioAMT`` over a family's TINY bridge (dropouts 0.1) and a head,
    both seeded, with its optimizers, in a full-finetune epoch."""
    _, cfg = _configs(family, **DROPOUT, **extra)
    bridge = w2v.HuggingFaceWav2Vec2(config=cfg, normalize_wav=True)
    head = Linear(20, 64)
    gen = torch.Generator().manual_seed(0)
    load_module_tree(bridge, init_wav2vec2(cfg, gen))
    load_module_tree(head, {"w": torch.randn(64, 20, generator=gen).numpy(),
                            "b": np.zeros(20, np.float32)})
    brain = AudioAMT(modules={"wav2vec2": bridge, "model": head},
                     hparams=_amt_hparams(losses, Softmax),
                     run_opts={"device": "cpu", "precision": precision})
    brain.init_optimizers()
    brain.on_stage_start(Stage.TRAIN, 1)
    return brain


def _remat_step(brain, rows, samples):
    """One ``fit_batch`` on a fixed batch: the loss, every parameter before
    and after the step, and the step's generators after it."""
    modules = (brain.modules["wav2vec2"], brain.modules["model"])
    before = _flatten(export_jax_params(*modules))
    wav = _wavs(rows, samples, 4)
    frames = brain.modules["wav2vec2"].config.output_length(samples)
    anno = np.zeros((rows, frames, 4), np.float32)
    anno[:, ::7, 0] = 1.0
    ones = np.ones(rows, np.float32)
    loss = brain.fit_batch({"sig": PaddedData(wav, ones),
                            "anno": PaddedData(anno, ones)})
    return (loss, before, _flatten(export_jax_params(*modules)),
            brain.generator.get_state(), brain.host_generator.get_state())


@pytest.mark.parametrize("family,rows,samples,precision", [
    ("base", 2, SAMPLES, "fp32"), ("data2vec", 2, SAMPLES, "bf16"),
    ("wavlm_large", 2, SAMPLES, "fp32"), ("data2vec", 1, 1030 * 320, "fp32")],
    ids=["base", "data2vec_bf16", "wavlm_large", "data2vec_streaming"])
def test_remat_step_is_bit_equal_with_dropout(family, rows, samples,
                                              precision):
    """``remat`` and ``remat`` + ``remat_frontend`` against the step
    without remat: the same loss and every parameter bit for bit after an
    Adam step with every dropout at 0.1, and the generators left in the
    same state. "data2vec_streaming" has 1029 frames, so the attention
    takes the streaming kernel's path with its hash dropout seeded from the
    host generator; "data2vec_bf16" runs the step at ``precision="bf16"``,
    whose recomputation must see the same bf16 parameter copies."""
    want = _remat_step(_seeded_amt(family, precision), rows, samples)
    assert any(not np.array_equal(want[1][k], want[2][k]) for k in want[1]
               if k.startswith("wav2vec2/encoder/layers/"))
    for remat_frontend in (False, True):
        got = _remat_step(_seeded_amt(family, precision, remat=True,
                                      remat_frontend=remat_frontend),
                          rows, samples)
        assert got[0] == want[0]
        assert sorted(got[2]) == sorted(want[2])
        for key, value in want[2].items():
            np.testing.assert_array_equal(got[2][key], value, err_msg=key)
        assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
