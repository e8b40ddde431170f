"""Port parity, the RNN-T slice as a whole: TINY wav2vec2 + prediction
network + joint + fused loss, its loss and every gradient against
``jax.grad``, and greedy and beam search through the ported modules,
against the JAX package on the CPU, same numpy weights and inputs, f32."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.decoders.transducer import (
    TransducerBeamSearcher as JSearcher)
from svt_speechbrain_tpu.models.wav2vec2 import (
    HuggingFaceWav2Vec2 as JBridge, Wav2Vec2Config as JConfig)
from svt_speechbrain_tpu.nnet import rnn as jrnn
from svt_speechbrain_tpu.nnet.embedding import Embedding as JEmbedding
from svt_speechbrain_tpu.nnet.linear import Linear as JLinear
from svt_speechbrain_tpu.nnet.loss.transducer_loss import (
    TransducerLoss as JTransducerLoss)
from svt_speechbrain_tpu.nnet.transducer_joint import (
    Transducer_joint as JJoint)

from svt_speechbrain_tpu_torch.convert_jax import (
    _unconvert, init_embedding, init_linear, init_rnn, init_wav2vec2,
    load_module_tree)
from svt_speechbrain_tpu_torch.decoders import TransducerBeamSearcher
from svt_speechbrain_tpu_torch.models.wav2vec2 import (
    HuggingFaceWav2Vec2, TINY_ARCH, Wav2Vec2Config)
from svt_speechbrain_tpu_torch.nnet import rnn as trnn
from svt_speechbrain_tpu_torch.nnet.embedding import Embedding
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.loss.transducer_loss import TransducerLoss
from svt_speechbrain_tpu_torch.nnet.transducer_joint import Transducer_joint
from tests.test_torch_transducer import (  # noqa: F401
    BLANK, _flat, _gen, _jtree)
from tests.torch_threads import two_torch_threads  # noqa: F401


# ------------------------------------------------------- the slice as a whole
ARCH = dict(TINY_ARCH, hidden_dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0, feat_proj_dropout=0.0)
VOCAB, EMB, JOINT, SAMPLES, LABELS = 11, 6, 16, 6000, 4
BLANK_BIAS = 0.3


def _slice_tree(blank_bias=0.0):
    cfg = Wav2Vec2Config(**ARCH)
    gen = _gen(10)
    tree = {"wav2vec2": init_wav2vec2(cfg, gen),
            "enc_lin": init_linear(gen, cfg.hidden_size, JOINT),
            "emb": init_embedding(gen, VOCAB, EMB),
            "dec": init_rnn(gen, 3, EMB, JOINT),
            "dec_lin": init_linear(gen, JOINT, JOINT),
            "out": init_linear(gen, JOINT, VOCAB)}
    # a blank the untrained joint often prefers: greedy emits on some frames
    # only, and the beam search's expansion loop ends
    tree["out"]["b"][BLANK] += blank_bias
    return cfg, tree


def _slice_batch():
    rng = np.random.default_rng(11)
    wav = rng.normal(size=(3, SAMPLES)).astype(np.float32)
    targets = rng.integers(1, VOCAB, size=(3, LABELS)).astype(np.int32)
    return (wav, targets, np.asarray([1.0, 0.8, 0.6], np.float32),
            np.asarray([1.0, 0.5, 0.0], np.float32))


def _torch_modules(cfg, tree, cell=False):
    mods = {"wav2vec2": HuggingFaceWav2Vec2(config=cfg),
            "enc_lin": Linear(JOINT, cfg.hidden_size),
            "emb": Embedding(VOCAB, EMB, blank_id=BLANK),
            "dec": (trnn.GRUCell(JOINT, EMB) if cell
                    else trnn.GRU(JOINT, input_size=EMB)),
            "dec_lin": Linear(JOINT, JOINT), "out": Linear(VOCAB, JOINT)}
    for name, mod in mods.items():
        load_module_tree(mod, tree[name])
    return mods


def _jax_modules(cfg_kwargs, cell=False):
    return {"wav2vec2": JBridge(config=JConfig(**cfg_kwargs)),
            "enc_lin": JLinear(JOINT, cfg_kwargs["hidden_size"]),
            "emb": JEmbedding(VOCAB, EMB, blank_id=BLANK),
            "dec": (jrnn.GRUCell(JOINT, EMB) if cell
                    else jrnn.GRU(JOINT, input_size=EMB)),
            "dec_lin": JLinear(JOINT, JOINT), "out": JLinear(VOCAB, JOINT)}


def test_training_forward_and_every_gradient_match_jax():
    """TINY wav2vec2 (train mode, dropouts 0) → enc_lin; blank-prefixed
    targets → Embedding → GRU → dec_lin; sum joint with leaky_relu; output
    Linear; ``TransducerLoss(fused=True)``. The loss to rtol 1e-5 and the
    gradient of every parameter against ``jax.grad`` of the same assembly,
    |g_torch - g_jax| / |g_jax| per leaf under 1e-3 (f32 summation order
    through the encoder; a missing or flipped gradient gives 1 or 2). The
    attention's key biases are 0 in exact arithmetic and exempt."""
    cfg, tree = _slice_tree()
    wav, targets, wav_lens, target_lens = _slice_batch()
    bos = np.concatenate([np.full((3, 1), BLANK, np.int32), targets], axis=1)

    jmods = _jax_modules(ARCH)
    jjoint = JJoint(joint="sum", nonlinearity="leaky_relu")
    jloss = JTransducerLoss(blank_index=BLANK, fused=True)

    def j_forward(params):
        feats = jmods["wav2vec2"](params["wav2vec2"], jnp.asarray(wav),
                                  rng=jax.random.PRNGKey(0), train=True,
                                  row_mask=jnp.ones(3))
        tn = jmods["enc_lin"](params["enc_lin"], feats)
        pn, _ = jmods["dec"](params["dec"],
                             jmods["emb"](params["emb"], jnp.asarray(bos)))
        pn = jmods["dec_lin"](params["dec_lin"], pn)
        logits = jmods["out"](params["out"],
                              jjoint({}, tn[:, :, None], pn[:, None]))
        return jloss(logits, jnp.asarray(targets), jnp.asarray(wav_lens),
                     jnp.asarray(target_lens))

    # jitted: op by op the JAX side took most of this test's time
    want, want_grads = jax.jit(jax.value_and_grad(j_forward))(_jtree(tree))

    mods = _torch_modules(cfg, tree)
    joint = Transducer_joint(joint="sum", nonlinearity="leaky_relu")
    feats = mods["wav2vec2"](torch.from_numpy(wav), train=True,
                             row_mask=torch.ones(3))
    tn = mods["enc_lin"](feats)
    pn, _ = mods["dec"](mods["emb"](torch.from_numpy(bos)))
    pn = mods["dec_lin"](pn)
    logits = mods["out"](joint(tn[:, :, None], pn[:, None]))
    assert logits.shape == (3, cfg.output_length(SAMPLES), LABELS + 1, VOCAB)
    loss = TransducerLoss(blank_index=BLANK, fused=True)(
        logits, torch.from_numpy(targets), torch.from_numpy(wav_lens),
        torch.from_numpy(target_lens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)

    want_flat = _flat(jax.tree_util.tree_map(np.asarray, want_grads))
    got_flat = {}
    for name, mod in mods.items():
        for pname, p in mod.named_parameters():
            assert p.grad is not None, f"{name}.{pname} got no gradient"
            # the export's layout conversions, applied to the gradient
            path, value = _unconvert(pname, p.grad)
            got_flat[f"{name}/{path}"] = value
    assert sorted(got_flat) == sorted(want_flat)
    norm = np.sqrt(sum(np.square(g).sum() for g in want_flat.values()))
    worst = 0.0
    for key, ref in want_flat.items():
        size = np.linalg.norm(ref)
        if size <= 1e-6 * norm:
            assert key.endswith("attn/bk"), key
            continue
        rel = np.linalg.norm(got_flat[key] - ref) / size
        worst = max(worst, rel)
        assert rel < 1e-3, (key, rel)
    assert worst > 0


@pytest.mark.parametrize("beam", [1, 4])
def test_search_through_the_ported_modules_matches_jax(beam):
    """Greedy and beam 4 with the real prediction network (Embedding →
    GRUCell → Linear) and joint of both packages on TINY encoder output:
    the same hypotheses, scores to rtol 1e-4."""
    cfg, tree = _slice_tree(blank_bias=BLANK_BIAS)
    wav = _slice_batch()[0]
    mods = _torch_modules(cfg, tree, cell=True)
    jmods = _jax_modules(ARCH, cell=True)
    joint = Transducer_joint(joint="sum", nonlinearity="leaky_relu")
    jjoint = JJoint(joint="sum", nonlinearity="leaky_relu")
    params = _jtree(tree)
    with torch.no_grad():
        tn = mods["enc_lin"](mods["wav2vec2"](torch.from_numpy(wav)))
    jtn = jmods["enc_lin"](params["enc_lin"], jmods["wav2vec2"](
        params["wav2vec2"], jnp.asarray(wav)))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jtn), atol=1e-4)

    def decode_fn(tokens, state):
        out, state = mods["dec"](mods["emb"](tokens), state)
        return mods["dec_lin"](out), state

    def joint_fn(enc_frame, dec_out):
        return mods["out"](joint(enc_frame, dec_out))

    def j_decode_fn(tokens, state):
        out, state = jmods["dec"](params["dec"],
                                  jmods["emb"](params["emb"], tokens), state)
        return jmods["dec_lin"](params["dec_lin"], out), state

    def j_joint_fn(enc_frame, dec_out):
        return jmods["out"](params["out"], jjoint({}, enc_frame, dec_out))

    got = TransducerBeamSearcher(decode_fn, joint_fn, BLANK, beam_size=beam,
                                 nbest=2)(tn)
    # the JAX searcher on the port's encoder output: both searches then see
    # the same frames, and only the prediction network and joint differ
    want = JSearcher(j_decode_fn, j_joint_fn, BLANK, beam_size=beam,
                     nbest=2)(jnp.asarray(tn.numpy()))
    assert got[0] == want[0]
    assert any(got[0])
    assert np.isclose(got[1], want[1], rtol=1e-4)
    if beam > 1:
        assert got[2] == want[2]
        for g, w in zip(got[3], want[3]):
            np.testing.assert_allclose(g, w, rtol=1e-4)
