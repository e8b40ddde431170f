"""Port parity, gradient accumulation in ``VideoAMT``: a tiny AV-HuBERT
(``tests/test_torch_video_models.py``'s TINY, 32x32 frames) and head in
both engines, one ``fit_batch`` at ``grad_accumulation_factor`` 2 on a
batch of 3, f32 on the CPU, dropouts 0, plain SGD over both modules (its
update is the clipped gradient times the rate, so the accumulated
gradients are held). The batch pads to 4 with a zero row, and the second
micro-batch (row 2 and the padding row) passes through the BatchNorms:
both engines count the padding row in the statistics, and the statistics
of the first micro-batch reach the second. Held: the loss, the step's
flags, every running statistic, and every parameter's update."""
import functools

import jax
import numpy as np
import optax
import torch

from svt_speechbrain_tpu.dataio.batch import PaddedData as JPaddedData
from svt_speechbrain_tpu.models import avhubert as javhubert
from svt_speechbrain_tpu.nnet import activations as jact
from svt_speechbrain_tpu.nnet import losses as jlosses
from svt_speechbrain_tpu.nnet.linear import Linear as JLinear
from svt_speechbrain_tpu.tasks import amt as jamt

from svt_speechbrain_tpu_torch.convert_jax import (_flatten,
                                                   load_module_tree,
                                                   module_tree)
from svt_speechbrain_tpu_torch.dataio.batch import PaddedData
from svt_speechbrain_tpu_torch.models import avhubert
from svt_speechbrain_tpu_torch.nnet import losses
from svt_speechbrain_tpu_torch.nnet.activations import Softmax
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.tasks import amt
from tests.test_torch_training import LOSS_RTOL, SGD_LR, UPDATE_RTOL
from tests.test_torch_video_models import TINY as TINY_AVHUBERT

STATS_ATOL = 1e-5


def _video_hparams(pkg_losses, softmax):
    crit = dict(reduction="mean", allowed_len_diff=60, label_smoothing=0.0)
    return dict(
        seed=1986, pitch_octave_num=4, onset_positive_weight=15.0,
        offset_positive_weight=1.0, lr=3e-4, lr_encoder=5e-5,
        linear_prob_epochs=1, max_grad_norm=5.0,
        onset_criterion=functools.partial(pkg_losses.bce_loss, **crit),
        offset_criterion=functools.partial(pkg_losses.bce_loss, **crit),
        octave_criterion=functools.partial(pkg_losses.nll_loss, **crit),
        pitch_criterion=functools.partial(pkg_losses.nll_loss, **crit),
        log_softmax=softmax(apply_log=True))


def test_video_amt_accumulated_step_matches_jax():
    accum = 2
    cfg = javhubert.AVHubertConfig(**TINY_AVHUBERT, modality_fuse="concat")
    jenc = javhubert.FairseqAVHubert(cfg, output_norm=True)
    jhead = JLinear(20, 16)
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    params = {"encoder": jenc.init(k1), "head": jhead.init(k2)}
    state = jax.tree_util.tree_map(lambda s: s * 1.5 + 0.1,
                                   jenc.init_state())
    np_params = jax.tree_util.tree_map(np.asarray, params)
    np_state = jax.tree_util.tree_map(np.asarray, state)
    jenc.init = lambda rng: params["encoder"]
    jenc.init_state = lambda: state
    jhead.init = lambda rng: params["head"]
    jbrain = jamt.VideoAMT(
        modules={"encoder": jenc, "head": jhead},
        hparams=_video_hparams(jlosses, jact.Softmax),
        run_opts={"noprogressbar": True, "data_parallel_count": 1,
                  "grad_accumulation_factor": accum})
    both = ["encoder", "head"]
    jbrain.add_optimizer("sgd", functools.partial(optax.sgd), both,
                         lr=SGD_LR)
    enc = avhubert.FairseqAVHubert(arch_overrides=dict(
        TINY_AVHUBERT, modality_fuse="concat"), output_norm=True)
    head = Linear(20, 16)
    load_module_tree(enc, np_params["encoder"], np_state)
    load_module_tree(head, np_params["head"])
    brain = amt.VideoAMT(modules={"encoder": enc, "head": head},
                         hparams=_video_hparams(losses, Softmax),
                         run_opts={"device": "cpu",
                                   "grad_accumulation_factor": accum})
    brain.add_optimizer("sgd", torch.optim.SGD, both, lr=SGD_LR)
    for b in (jbrain, brain):
        b.configure_freezing(2)
    rng = np.random.default_rng(3)
    video = rng.standard_normal((3, 4, 32, 32, 1)).astype(np.float32)
    anno = np.stack([rng.integers(0, 2, (3, 4)), rng.integers(0, 2, (3, 4)),
                     rng.integers(0, 5, (3, 4)), rng.integers(0, 13, (3, 4))],
                    -1).astype(np.float32)
    lens = np.asarray([1.0, 0.75, 1.0], np.float32)
    before = {**_flatten(module_tree(enc), "encoder/"),
              **_flatten(module_tree(head), "head/")}
    j_loss = jbrain.fit_batch({"sig": JPaddedData(video, lens),
                               "anno": JPaddedData(anno, lens)})
    loss = brain.fit_batch({"sig": PaddedData(video, lens),
                            "anno": PaddedData(anno, lens)})
    np.testing.assert_allclose(loss, j_loss, rtol=LOSS_RTOL)
    assert (brain.optimizer_step, brain.nonfinite_count) == \
        (jbrain.optimizer_step, jbrain.nonfinite_count) == (1, 0)
    got = _flatten(module_tree(enc, running_stats=True))
    want = _flatten(jax.tree_util.tree_map(np.asarray, jbrain.states[
        "encoder"]))
    assert sorted(got) == sorted(want) and len(want) > 10
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=STATS_ATOL,
                                   err_msg=key)
    # the statistics moved from where both started
    assert any(not np.allclose(value, _flatten(np_state)[key])
               for key, value in want.items())
    # every parameter moved by -lr * clip * (the accumulated gradient),
    # alike in both
    j_after = _flatten(jax.tree_util.tree_map(np.asarray, jbrain.params))
    j_before = _flatten(np_params)
    after = {**_flatten(module_tree(enc), "encoder/"),
             **_flatten(module_tree(head), "head/")}
    assert sorted(after) == sorted(j_after)
    moved = 0
    for key, value in j_after.items():
        want_du = value - j_before[key]
        got_du = after[key] - before[key]
        if np.linalg.norm(want_du) > 0:
            err = np.linalg.norm(got_du - want_du) / np.linalg.norm(want_du)
            assert err <= UPDATE_RTOL or key.endswith("bk"), (key, err)
            moved += 1
    assert moved > 20
