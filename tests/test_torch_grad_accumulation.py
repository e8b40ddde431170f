"""Port parity, gradient accumulation: one ``fit_batch`` with
``grad_accumulation_factor`` 2, 3 and 4 on ragged batches of 4 and 5 rows,
TINY ``AudioAMT`` from one weight tree in both engines, dropouts 0, f32 on
the CPU, full finetune with plain SGD over both modules and no clip, so
that each update is the rate times the accumulated gradient (the
optimizers' own steps are the unaccumulated engine's, held in
``test_torch_training.py``). ``VideoAMT``, whose padded rows
reach the BatchNorm statistics, is held in
``test_torch_grad_accumulation_video.py``.

The JAX step pads the batch with zero rows to a multiple of the factor
(relative length 0, ``valid_rows`` 0), splits it into contiguous
micro-batches, sums their gradients and divides by the factor. Held against
it: the loss, the global gradient norm (the JAX one from its update),
every parameter's update (as ``test_torch_training.py`` holds them), and
the finite flag (optimizer steps taken and skipped). A micro-batch of padding rows only (batch 4 at factor 3, batch
5 at factor 4) adds 0 to the loss in both engines, but its wav2vec2 input
norm divides by a zero row count, so the gradient is NaN in both: the step
is skipped and the parameters stay."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

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
from svt_speechbrain_tpu_torch.core import Brain
from svt_speechbrain_tpu_torch.dataio.batch import PaddedData
from svt_speechbrain_tpu_torch.models.wav2vec2 import (HuggingFaceWav2Vec2,
                                                       Wav2Vec2Config)
from svt_speechbrain_tpu_torch.nnet import losses
from svt_speechbrain_tpu_torch.nnet.activations import Softmax
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.tasks import amt
from tests.test_torch_training import (ARCH, GNORM_RTOL, LOSS_RTOL,
                                       SGD_LR, UPDATE_RTOL, _flat, _hparams,
                                       _update_errors)

SAMPLES = 6400
NO_CLIP = 1e9


def _audio_batch(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    frames = cfg.output_length(SAMPLES)
    wav = rng.normal(size=(rows, SAMPLES)).astype(np.float32)
    anno = np.stack([rng.random((rows, frames)) > 0.8,
                     rng.random((rows, frames)) > 0.8,
                     rng.integers(0, 5, (rows, frames)),
                     rng.integers(0, 13, (rows, frames))],
                    axis=-1).astype(np.float32)
    wlens = np.asarray([1.0, 0.9, 0.8, 1.0, 0.7][:rows], np.float32)
    alens = np.asarray([1.0, 0.75, 0.9, 0.6, 1.0][:rows], np.float32)
    return wav, wlens, anno, alens


def _audio_step(accum, rows):
    cfg = Wav2Vec2Config(**ARCH)
    tree = init_params(cfg, torch.Generator().manual_seed(0))
    jmodules = {"wav2vec2": JBridge(config=JConfig(**ARCH), output_norm=True,
                                    normalize_wav=True),
                "model": JLinear(20, cfg.hidden_size)}
    for name, module in jmodules.items():
        module.init = functools.partial(
            lambda sub, rng: jax.tree_util.tree_map(jnp.asarray, sub),
            tree[name])
    jbrain = JAudioAMT(modules=jmodules,
                       hparams=dict(_hparams(jlosses, JSoftmax),
                                    max_grad_norm=NO_CLIP),
                       run_opts={"noprogressbar": True,
                                 "data_parallel_count": 1,
                                 "grad_accumulation_factor": accum})
    bridge = HuggingFaceWav2Vec2(config=cfg, output_norm=True,
                                 normalize_wav=True)
    head = Linear(20, cfg.hidden_size)
    load_jax_params(tree, bridge, head)
    brain = amt.AudioAMT(modules={"wav2vec2": bridge, "model": head},
                         hparams=dict(_hparams(losses, Softmax),
                                      max_grad_norm=NO_CLIP),
                         run_opts={"device": "cpu",
                                   "grad_accumulation_factor": accum})
    both = ["wav2vec2", "model"]
    jbrain.add_optimizer("sgd", functools.partial(optax.sgd), both,
                         lr=SGD_LR)
    brain.add_optimizer("sgd", torch.optim.SGD, both, lr=SGD_LR)
    for b in (jbrain, brain):
        b.configure_freezing(3)
    wav, wlens, anno, alens = _audio_batch(cfg, rows, seed=rows + 10 * accum)
    jbatch = {"sig": JPaddedData(wav, wlens),
              "anno": JPaddedData(anno, alens)}
    j_before = _flat(jax.device_get(jbrain.params))
    before = _flat(export_jax_params(bridge, head))
    j_loss_val = jbrain.fit_batch(jbatch)
    loss = brain.fit_batch({"sig": PaddedData(wav, wlens),
                            "anno": PaddedData(anno, alens)})
    j_params = _flat(jax.device_get(jbrain.params))
    # no clip: the JAX step's gradient is its update over -lr
    j_grads = {k: (j_before[k] - v) / SGD_LR for k, v in j_params.items()}
    return dict(j_loss=j_loss_val, loss=loss,
                j_gnorm=float(np.sqrt(sum(np.square(g).sum()
                                          for g in j_grads.values()))),
                gnorm=brain.last_grad_norm, j_grads=j_grads,
                j_before=j_before, j_params=j_params, before=before,
                params=_flat(export_jax_params(bridge, head)),
                j_flags=(jbrain.optimizer_step, jbrain.nonfinite_count),
                flags=(brain.optimizer_step, brain.nonfinite_count))


@pytest.mark.parametrize("accum,rows,finite", [
    (2, 5, True), (3, 5, True), (3, 4, False), (4, 5, False)])
def test_audio_amt_accumulated_step_matches_jax(accum, rows, finite):
    s = _audio_step(accum, rows)
    assert s["flags"] == s["j_flags"] == ((1, 0) if finite else (0, 1))
    np.testing.assert_allclose(s["loss"], s["j_loss"], rtol=LOSS_RTOL)
    if not finite:
        # a micro-batch of padding rows: its loss is 0 (the masked means
        # drop every term), but its whole-batch statistics divide by zero
        # and NaN reaches the gradient in both engines; the step is skipped
        assert np.isfinite(s["loss"])
        assert np.isnan(s["gnorm"])
        for name, value in s["params"].items():
            assert np.array_equal(value, s["before"][name]), name
            assert np.array_equal(s["j_params"][name],
                                  s["j_before"][name]), name
        return
    np.testing.assert_allclose(s["gnorm"], s["j_gnorm"], rtol=GNORM_RTOL)
    errs = _update_errors(s)
    exempt = {n for n in s["j_grads"] if n not in errs}
    assert all(n.endswith("attn/bk") for n in exempt), exempt
    worst = max(errs, key=errs.get)
    assert errs[worst] <= UPDATE_RTOL, f"{worst} {errs[worst]:.3e}"


def test_factor_below_one_is_one_and_batches_pad():
    """``max(int(factor), 1)``, as the JAX step; a padded batch carries 0
    in ``valid_rows`` and relative length 0 on its padding rows."""
    for factor, want in ((0, 1), ("3", 3), (2.7, 2)):
        brain = Brain({"model": Linear(2, 2)}, run_opts={
            "device": "cpu", "grad_accumulation_factor": factor})
        assert brain.grad_accumulation_factor == want
    batch = brain._batch_to_device(
        {"x": PaddedData(np.ones((3, 4), np.float32),
                         np.asarray([1.0, 0.5, 1.0], np.float32)),
         "n": np.arange(3)}, accum=2)
    assert batch["valid_rows"].tolist() == [1.0, 1.0, 1.0, 0.0]
    assert batch["x"].lengths.tolist() == [1.0, 0.5, 1.0, 0.0]
    assert batch["x"].data[3].abs().sum() == 0 and batch["n"].tolist() == [
        0, 1, 2, 0]
