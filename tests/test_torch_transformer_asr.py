"""Port parity, the transformer and conformer ASR models: the encoder and
decoder layers and stacks (pre- and post-LN, masks, the head-averaged
weights), ``NormalizedEmbedding``, the convolution module and conformer
layers in training (their BatchNorm statistics) and in eval,
``ConformerDecoder``, ``ConvolutionFrontEnd``, ``TransformerASR`` with
either encoder, ``TransformerLM`` and ``RNNLM``, against the JAX package on
the CPU with the same numpy weights and inputs, f32; and a TINY ``Brain``
step of ``chip_smoke.py``'s phase-23 assembly (filterbank, input
normalization, the frontend, a conformer ``TransformerASR``, CTC and
sequence heads, 0.3 CTC + 0.7 label-smoothed NLL) against the jitted JAX
step: the loss and every parameter's gradient."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke as cs
from svt_speechbrain_tpu.models import conformer as jconf
from svt_speechbrain_tpu.models import convolution as jconv
from svt_speechbrain_tpu.models import features as jlobes
from svt_speechbrain_tpu.models import rnnlm as jrnnlm
from svt_speechbrain_tpu.models import transformer as jtr
from svt_speechbrain_tpu.models import transformer_asr as jasr
from svt_speechbrain_tpu.nnet import losses as jlosses
from svt_speechbrain_tpu.nnet.linear import Linear as JLinear
from svt_speechbrain_tpu.processing import features as jfeat

from svt_speechbrain_tpu_torch.convert_jax import (load_module_tree,
                                                   module_tree, seeded_tree)
from svt_speechbrain_tpu_torch.core import Stage
from svt_speechbrain_tpu_torch.models import conformer as tconf
from svt_speechbrain_tpu_torch.models import convolution as tconv
from svt_speechbrain_tpu_torch.models import rnnlm as trnnlm
from svt_speechbrain_tpu_torch.models import transformer as ttr
from svt_speechbrain_tpu_torch.models import transformer_asr as tasr
from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG
from tests.torch_threads import two_torch_threads  # noqa: F401

# f32 on both sides, outputs of order 1: the summation order only. The
# BatchNorm statistics are means over B·T of order-1 values: 1e-5 too.
ATOL = 1e-5
D, H, FFN, B, T = 8, 2, 16, 2, 7


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _pair(jmod, tmod, seed=0):
    """The port's seeded tree of ``tmod`` (checked against the JAX
    ``init``'s shapes, traced without running it), loaded into ``tmod``
    and returned as ``jmod``'s params."""
    tree = seeded_tree(tmod, torch.Generator().manual_seed(seed))
    want = jax.eval_shape(jmod.init, jax.random.PRNGKey(0))
    assert [(k, v.shape) for k, v in
            jax.tree_util.tree_leaves_with_path(want)] == [
        (k, v.shape) for k, v in jax.tree_util.tree_leaves_with_path(tree)]
    load_module_tree(tmod, tree)
    return _as_params(want, tree)


def _as_params(want, tree):
    if isinstance(want, dict):
        return {k: _as_params(v, (tree or {}).get(k)) for k, v in
                want.items()}
    return jnp.asarray(tree)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _kpm():
    kpm = np.zeros((B, T), bool)
    kpm[1, 5:] = True
    return kpm


@pytest.mark.parametrize("pre", [False, True])
def test_encoder_layer_and_stack(pre):
    jl = jtr.TransformerEncoderLayer(FFN, H, D, normalize_before=pre)
    tl = ttr.TransformerEncoderLayer(FFN, H, D, normalize_before=pre)
    params = _pair(jl, tl)
    x, kpm = _x((B, T, D)), _kpm()
    causal = np.triu(np.ones((T, T), bool), 1)
    want, wattn = jl(params, jnp.asarray(x), jnp.asarray(causal),
                     jnp.asarray(kpm))
    with torch.no_grad():
        got, gattn = tl(torch.from_numpy(x), torch.from_numpy(causal),
                        torch.from_numpy(kpm))
    _close(got, want)
    _close(gattn, wattn)

    je = jtr.TransformerEncoder(2, H, FFN, d_model=D, normalize_before=pre)
    te = ttr.TransformerEncoder(2, H, FFN, d_model=D, normalize_before=pre)
    params = _pair(je, te, seed=1)
    want, wattns = je(params, jnp.asarray(x),
                      src_key_padding_mask=jnp.asarray(kpm))
    with torch.no_grad():
        got, gattns = te(torch.from_numpy(x),
                         src_key_padding_mask=torch.from_numpy(kpm))
    _close(got, want)
    assert len(gattns) == 2
    _close(gattns[1], wattns[1])


@pytest.mark.parametrize("pre", [False, True])
def test_decoder_layer_and_stack(pre):
    jd = jtr.TransformerDecoder(2, H, FFN, D, normalize_before=pre)
    td = ttr.TransformerDecoder(2, H, FFN, D, normalize_before=pre)
    params = _pair(jd, td)
    tgt, mem, kpm = _x((B, 5, D)), _x((B, T, D), 1), _kpm()
    causal = np.triu(np.ones((5, 5), bool), 1)
    want, wsa, wca = jd(params, jnp.asarray(tgt), jnp.asarray(mem),
                        tgt_mask=jnp.asarray(causal),
                        memory_key_padding_mask=jnp.asarray(kpm))
    with torch.no_grad():
        got, gsa, gca = td(torch.from_numpy(tgt), torch.from_numpy(mem),
                           tgt_mask=torch.from_numpy(causal),
                           memory_key_padding_mask=torch.from_numpy(kpm))
    _close(got, want)
    for g, w in zip(gsa + gca, wsa + wca):
        _close(g, w)
    # padded memory frames take no cross-attention weight
    assert float(gca[0][1, :, 5:].abs().max()) == 0.0


def test_normalized_embedding_scales_by_sqrt_d():
    jm = jtr.NormalizedEmbedding(D, 11)
    tm = ttr.NormalizedEmbedding(D, 11)
    params = _pair(jm, tm)
    tokens = np.array([[1, 4, 10], [0, 2, 3]])
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    _close(got, jm(params, jnp.asarray(tokens)))
    _close(got / np.sqrt(D), np.asarray(params["table"])[tokens])


def test_transformer_interface_children():
    for module in ("transformer", "conformer"):
        jm = jtr.TransformerInterface(D, H, 1, 1, FFN, encoder_module=module,
                                      kernel_size=3)
        tm = ttr.TransformerInterface(D, H, 1, 1, FFN, encoder_module=module,
                                      kernel_size=3)
        _pair(jm, tm)
    tm = ttr.TransformerInterface(D, H, 1, 0, FFN)
    assert tm.decoder is None


def _conv_state(state):
    return jax.tree_util.tree_map(np.asarray, state)


@pytest.mark.parametrize("causal", [False, True])
def test_convolution_module_train_and_eval(causal):
    jm = jconf.ConvolutionModule(D, kernel_size=5, causal=causal)
    tm = tconf.ConvolutionModule(D, kernel_size=5, causal=causal)
    params = _pair(jm, tm)
    x = _x((B, T, D))
    state = {"mean": jnp.asarray(_x((D,), 3, 0.1)),
             "var": jnp.asarray(1 + np.abs(_x((D,), 4, 0.1)))}
    load_module_tree(tm, module_tree(tm), _conv_state(state))
    want, _ = jm(params, jnp.asarray(x), state=state, train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, want)
    want, new_state = jm(params, jnp.asarray(x), state=state, train=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=True)
    _close(got, want)
    got_state = module_tree(tm, running_stats=True)
    for key in ("mean", "var"):
        _close(got_state[key], new_state[key])


@pytest.mark.parametrize("attention", ["RelPosMHAXL", "regularMHA"])
def test_conformer_encoder_train_and_eval(attention):
    je = jconf.ConformerEncoder(2, D, FFN, H, kernel_size=3,
                                attention_type=attention)
    te = tconf.ConformerEncoder(2, D, FFN, H, kernel_size=3,
                                attention_type=attention)
    params = _pair(je, te)
    x, kpm = _x((B, T, D)), _kpm()
    state = je.init_state()
    want, new_state = je(params, jnp.asarray(x),
                         src_key_padding_mask=jnp.asarray(kpm),
                         state=state, train=True)
    with torch.no_grad():
        got = te(torch.from_numpy(x),
                 src_key_padding_mask=torch.from_numpy(kpm), train=True)
    _close(got, want)
    got_state = module_tree(te, running_stats=True)
    want_state = _conv_state(new_state)
    assert jax.tree_util.tree_structure(got_state) == \
        jax.tree_util.tree_structure(want_state)
    for g, w in zip(jax.tree_util.tree_leaves(got_state),
                    jax.tree_util.tree_leaves(want_state)):
        _close(g, w)
    # eval on the moved statistics
    want, _ = je(params, jnp.asarray(x),
                 src_key_padding_mask=jnp.asarray(kpm), state=new_state)
    with torch.no_grad():
        got = te(torch.from_numpy(x),
                 src_key_padding_mask=torch.from_numpy(kpm))
    _close(got, want)


def test_conformer_decoder():
    jd = jconf.ConformerDecoder(2, H, FFN, D, kernel_size=3)
    td = tconf.ConformerDecoder(2, H, FFN, D, kernel_size=3)
    params = _pair(jd, td)
    tgt, mem, kpm = _x((B, 5, D)), _x((B, T, D), 1), _kpm()
    for mask in (None, kpm):
        want = jd(params, jnp.asarray(tgt), jnp.asarray(mem),
                  memory_key_padding_mask=None if mask is None
                  else jnp.asarray(mask))
        with torch.no_grad():
            got = td(torch.from_numpy(tgt), torch.from_numpy(mem),
                     memory_key_padding_mask=None if mask is None
                     else torch.from_numpy(mask))
        _close(got, want)


def test_convolution_frontend():
    kw = dict(input_size=12, num_blocks=2, num_layers_per_block=2,
              out_channels=(3, 4), kernel_sizes=(3, 3), strides=(2, 2))
    jm = jconv.ConvolutionFrontEnd(**kw)
    tm = tconv.ConvolutionFrontEnd(**kw)
    params = _pair(jm, tm)
    x = _x((B, 9, 12))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want = jm(params, jnp.asarray(x))
    assert tuple(got.shape) == want.shape == (B, 3, tm.output_dim())
    assert tm.output_dim() == jm.output_dim() == 12
    _close(got, want)


@pytest.mark.parametrize("module", ["transformer", "conformer"])
def test_transformer_asr(module):
    kw = dict(tgt_vocab=13, input_size=6, d_model=D, nhead=H,
              num_encoder_layers=2, num_decoder_layers=2, d_ffn=FFN,
              dropout=0.0, encoder_module=module, kernel_size=3)
    jm, tm = jasr.TransformerASR(**kw), tasr.TransformerASR(**kw)
    params = _pair(jm, tm)
    src = _x((B, 8, 6))
    tgt = np.random.default_rng(1).integers(0, 13, (B, 5))
    # 0.5625 · 8 = 4.5 rounds half to even: 4 frames
    wav_len = np.array([1.0, 0.5625], np.float32)
    want_enc, want_dec = jm(params, jnp.asarray(src), jnp.asarray(tgt),
                            jnp.asarray(wav_len))
    with torch.no_grad():
        got_enc, got_dec = tm(torch.from_numpy(src), torch.from_numpy(tgt),
                              torch.from_numpy(wav_len))
        _, kpm = tm.encode(torch.from_numpy(src), torch.from_numpy(wav_len))
    _close(got_enc, want_enc)
    _close(got_dec, want_dec)
    assert kpm[1].tolist() == [False] * 4 + [True] * 4
    wrapper = tasr.EncoderWrapper(tm)
    with torch.no_grad():
        _close(wrapper(torch.from_numpy(src), torch.from_numpy(wav_len)),
               want_enc)


def test_transformer_lm_scales_its_embedding():
    kw = dict(vocab=13, d_model=D, nhead=H, num_encoder_layers=2, d_ffn=FFN,
              dropout=0.0)
    jm, tm = jasr.TransformerLM(**kw), tasr.TransformerLM(**kw)
    params = _pair(jm, tm)
    x = np.random.default_rng(2).integers(0, 13, (B, 6))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, jm(params, jnp.asarray(x)))
    # causal: a later token leaves earlier logits alone
    y = x.copy()
    y[:, -1] = (y[:, -1] + 1) % 13
    with torch.no_grad():
        other = tm(torch.from_numpy(y))
    _close(other[:, :-1], got[:, :-1].numpy())


@pytest.mark.parametrize("rnn_class,blocks", [("lstm", 1), ("gru", 2)])
def test_rnnlm(rnn_class, blocks):
    kw = dict(output_neurons=13, embedding_dim=6, rnn_class=rnn_class,
              rnn_layers=2, rnn_neurons=10, dnn_blocks=blocks, dnn_neurons=7,
              dropout=0.0)
    jm, tm = jrnnlm.RNNLM(**kw), trnnlm.RNNLM(**kw)
    params = _pair(jm, tm)
    x = np.random.default_rng(3).integers(0, 13, (B, 6))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, jm(params, jnp.asarray(x)))


def test_layers_take_dropout_from_the_step_generator():
    tm = tasr.TransformerASR(13, 6, d_model=D, nhead=H, num_encoder_layers=1,
                             num_decoder_layers=1, d_ffn=FFN, dropout=0.5,
                             encoder_module="conformer", kernel_size=3)
    load_module_tree(tm, seeded_tree(tm, torch.Generator().manual_seed(0)))
    src = torch.from_numpy(_x((B, 8, 6)))
    tgt = torch.ones(B, 4, dtype=torch.long)

    def run(seed, train):
        rng = StepRNG(torch.Generator().manual_seed(seed),
                      torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return tm(src, tgt, rng=rng, train=train)[1]

    assert torch.equal(run(0, True), run(0, True))
    assert not torch.equal(run(0, True), run(1, True))
    assert torch.equal(run(0, False), run(1, False))


# ------------------------------------------------ the phase-23 assembly
ARCH = dict(cs.CONFORMER_ARCH, d_model=D, nhead=H, num_encoder_layers=2,
            num_decoder_layers=1, d_ffn=FFN, kernel_size=3, dropout=0.0)
FRONT = dict(cs.CONFORMER_FRONT, out_channels=(2, 3))
N_MELS, VOCAB = 12, 11
SECONDS = (0.3, 0.25)
# f32 on both sides: the loss within 1e-5 of itself; gradients within 3e-4
# of each leaf's norm (the JAX step is jitted: XLA's fused reductions and
# torch's sum in other orders; a bias gradient sums ~10^2-10^3 terms of
# both signs over frames and channels, as in the CRDNN slice)
LOSS_RTOL, GRAD_RTOL = 1e-5, 3e-4
ZERO_SHARE = 1e-6


class JaxConformer:
    """The JAX side of the assembly, as functions of (params, state); the
    augmentation is off (the step is compared at dropout 0 without it)."""

    names = ("front", "asr", "ctc_lin", "seq_lin")

    def __init__(self):
        self.fbank = jlobes.Fbank(n_mels=N_MELS, n_fft=cs.CONFORMER_N_FFT)
        self.norm = jfeat.InputNormalization(norm_type="global")
        self.front = jconv.ConvolutionFrontEnd(input_size=N_MELS, **FRONT)
        self.asr = jasr.TransformerASR(VOCAB, self.front.output_dim(),
                                       **ARCH)
        self.ctc_lin = JLinear(VOCAB, D)
        self.seq_lin = JLinear(VOCAB, D)

    def loss(self, params, state, b):
        wav_lens = b["sig"].lengths
        feats, _ = self.norm(None, state, self.fbank(None, b["sig"].data),
                             wav_lens, epoch=1, train=True)
        src = self.front(params["front"], feats)
        enc, dec = self.asr(params["asr"], src, b["tokens_bos"].data,
                            wav_lens, train=True)
        p_ctc = jax.nn.log_softmax(self.ctc_lin(params["ctc_lin"], enc))
        p_seq = jax.nn.log_softmax(self.seq_lin(params["seq_lin"], dec))
        ctc = jlosses.ctc_loss(p_ctc, b["tokens"].data, wav_lens,
                               b["tokens"].lengths, cs.CONFORMER_BLANK)
        nll = jlosses.nll_loss(p_seq, b["tokens_eos"].data,
                               length=b["tokens_eos"].lengths,
                               label_smoothing=cs.CONFORMER_SMOOTHING)
        w = cs.CONFORMER_CTC_WEIGHT
        return w * ctc + (1 - w) * nll


def _grad_tree(module):
    clone = copy.deepcopy(module)
    with torch.no_grad():
        for (_, p), (_, q) in zip(module.named_parameters(),
                                  clone.named_parameters()):
            q.copy_(p.grad)
    return module_tree(clone)


def test_conformer_slice_matches_the_jax_step():
    modules = cs.conformer_modules(ARCH, FRONT, N_MELS, VOCAB,
                                   augment=False)
    brain = cs.conformer_brain(modules, "cpu", 0)
    jm = JaxConformer()
    params = {n: jax.tree_util.tree_map(jnp.asarray,
                                        module_tree(modules[n]))
              for n in jm.names}
    for n in jm.names:                    # the port's trees, JAX-shaped
        want = jax.eval_shape(getattr(jm, n).init, jax.random.PRNGKey(0))
        assert jax.tree_util.tree_structure(want) == \
            jax.tree_util.tree_structure(params[n]), n
    batch = cs.conformer_batch(np.random.default_rng(0), SECONDS, VOCAB)
    jb = {k: cs.PaddedData(jnp.asarray(np.asarray(v.data)),
                           jnp.asarray(np.asarray(v.lengths)))
          for k, v in batch.items()}
    arrays = brain._batch_to_device(batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        params, jm.norm.init_state(), jb)
    loss = brain.compute_objectives(
        brain.compute_forward(arrays, Stage.TRAIN), arrays, Stage.TRAIN)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    pairs = {}
    for name in jm.names:
        want = jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jgrads[name]))
        got = dict(jax.tree_util.tree_leaves_with_path(
            _grad_tree(modules[name])))
        assert len(got) == len(want), name
        for path, w in want:
            pairs[name + jax.tree_util.keystr(path)] = (got[path], w)
    total = np.sqrt(sum(np.sum(np.square(w)) for _, w in pairs.values()))
    for key, (g, w) in pairs.items():
        if np.linalg.norm(w) <= ZERO_SHARE * total:
            assert np.linalg.norm(g) <= ZERO_SHARE * total, key
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, (key, err)
