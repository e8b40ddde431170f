"""Port parity, the CRDNN ASR slice as a whole at TINY widths: waveform →
``Fbank`` → global ``InputNormalization`` → ``CRDNN`` (2 CNN blocks, time
pooling, 2 bidirectional batch-normed LiGRU layers, 2 DNN blocks) → CTC
head, and bos-prefixed tokens → ``Embedding`` → location-aware GRU
``AttentionalRNNDecoder`` → sequence head; loss 0.2 CTC + 0.8 NLL. JAX
parameters and state are carried into the port by ``convert_jax``; the
loss, every parameter's gradient, the eval log-probabilities and the new
running state are held against the JAX step on the CPU, f32, and the trees
go back both ways. The assembly and its ``Brain`` are ``chip_smoke.py``'s
phase 22 (``crdnn_modules``, ``CRDNNBrain``)."""
import copy

import numpy as np

import jax
import jax.numpy as jnp
import torch

import chip_smoke as cs
from svt_speechbrain_tpu.models import crdnn as jcrdnn
from svt_speechbrain_tpu.models import features as jlobes
from svt_speechbrain_tpu.nnet import losses as jlosses
from svt_speechbrain_tpu.nnet import rnn as jrnn
from svt_speechbrain_tpu.nnet.embedding import Embedding as JEmbedding
from svt_speechbrain_tpu.nnet.linear import Linear as JLinear
from svt_speechbrain_tpu.processing import features as jfeat

from svt_speechbrain_tpu_torch.convert_jax import (is_unseeded,
                                                   load_module_tree,
                                                   module_tree)
from svt_speechbrain_tpu_torch.core import Stage
from tests.torch_threads import two_torch_threads  # noqa: F401

ARCH = dict(input_size=16, cnn_blocks=2, cnn_channels=(4, 6),
            cnn_kernelsize=(3, 3), time_pooling=True, time_pooling_size=2,
            freq_pooling_size=2, rnn_class="ligru", rnn_layers=2,
            rnn_neurons=8, rnn_bidirectional=True, dnn_blocks=2,
            dnn_neurons=10, dropout=0.0)
DEC = dict(hidden_size=9, attn_dim=7, num_layers=1, channels=3,
           kernel_size=4, dropout=0.0)
VOCAB, EMB = 11, 6
SECONDS = (0.3, 0.25, 0.2)
# f32 on both sides: the loss within 1e-5 of itself; log-probabilities of
# order 1-3 within 1e-5; running statistics within 1e-5. Gradients within
# 3e-4 of each leaf's norm, wider than 1e-4: the JAX step runs jitted (one
# compile, not thousands of eager dispatches), so XLA's fused reductions
# and torch's sum in other orders, and a bias or norm-scale gradient sums
# ~10^3 terms of both signs over frames and frequency bins (the worst
# leaves, the first CNN block's norm scales and the attention's biases,
# sit at 0.9-1.5e-4)
LOSS_RTOL, ATOL, GRAD_RTOL = 1e-5, 1e-5, 3e-4
ZERO_SHARE = 1e-6


class JaxCRDNN:
    """The JAX package's side of the assembly, as functions of (params,
    state)."""

    def __init__(self):
        self.fbank = jlobes.Fbank(n_mels=ARCH["input_size"])
        self.norm = jfeat.InputNormalization(norm_type="global")
        self.enc = jcrdnn.CRDNN(**ARCH)
        self.ctc_lin = JLinear(VOCAB, ARCH["dnn_neurons"])
        self.emb = JEmbedding(VOCAB, EMB)
        self.dec = jrnn.AttentionalRNNDecoder(
            "gru", "location", enc_dim=ARCH["dnn_neurons"], input_size=EMB,
            **DEC)
        self.seq_lin = JLinear(VOCAB, DEC["hidden_size"])
        self.names = ("enc", "ctc_lin", "emb", "dec", "seq_lin")

    def init(self, seed):
        keys = jax.random.split(jax.random.PRNGKey(seed), len(self.names))

        @jax.jit
        def draw(keys):
            return {n: getattr(self, n).init(k)
                    for n, k in zip(self.names, keys)}

        params = draw(keys)
        return params, {"normalize": self.norm.init_state(),
                        "enc": self.enc.init_state()}

    def forward(self, params, state, b, train):
        wav_lens = b["sig"].lengths
        feats, norm_state = self.norm(None, state["normalize"],
                                      self.fbank(None, b["sig"].data),
                                      wav_lens, epoch=1, train=train)
        x, enc_state = self.enc(params["enc"], feats, train=train,
                                state=state["enc"])
        p_ctc = jax.nn.log_softmax(self.ctc_lin(params["ctc_lin"], x))
        h, _ = self.dec(params["dec"],
                        self.emb(params["emb"], b["tokens_bos"].data), x,
                        wav_lens)
        p_seq = jax.nn.log_softmax(self.seq_lin(params["seq_lin"], h))
        return (p_ctc, p_seq), {"normalize": norm_state, "enc": enc_state}

    def loss(self, params, state, b):
        (p_ctc, p_seq), new_state = self.forward(params, state, b, True)
        ctc = jlosses.ctc_loss(p_ctc, b["tokens"].data, b["sig"].lengths,
                               b["tokens"].lengths, cs.CRDNN_BLANK)
        nll = jlosses.nll_loss(p_seq, b["tokens_eos"].data,
                               length=b["tokens_eos"].lengths)
        w = cs.CRDNN_CTC_WEIGHT
        return w * ctc + (1 - w) * nll, new_state


def _jax_batch(batch):
    return {k: cs.PaddedData(jnp.asarray(np.asarray(v.data)),
                             jnp.asarray(np.asarray(v.lengths)))
            for k, v in batch.items()}


def _port(params, state):
    modules = cs.crdnn_modules(ARCH, DEC, VOCAB, EMB)
    for name in ("enc", "ctc_lin", "emb", "dec", "seq_lin"):
        load_module_tree(modules[name], jax.tree_util.tree_map(
            np.asarray, params[name]),
            jax.tree_util.tree_map(np.asarray, state.get(name)))
    load_module_tree(modules["normalize"], {}, jax.tree_util.tree_map(
        np.asarray, {k: v for k, v in state["normalize"].items()
                     if not k.startswith("spk_")}))
    return modules


def _brain(modules):
    brain = cs.CRDNNBrain(modules, hparams={"seed": 0, "lr": 1e-3},
                          run_opts={"device": "cpu"})
    brain.epoch = 1
    return brain


def _grad_tree(module):
    clone = copy.deepcopy(module)
    with torch.no_grad():
        for (_, p), (_, q) in zip(module.named_parameters(),
                                  clone.named_parameters()):
            q.copy_(p.grad)
    return module_tree(clone)


def test_crdnn_slice_matches_the_jax_step():
    jm = JaxCRDNN()
    params, state = jm.init(0)
    batch = cs.crdnn_batch(np.random.default_rng(0), SECONDS, VOCAB)
    jb = _jax_batch(batch)
    modules = _port(params, state)
    brain = _brain(modules)
    arrays = brain._batch_to_device(batch)

    # eval: the untrained running state on both sides (the JAX side
    # jitted: one compile instead of thousands of eager dispatches)
    (j_ctc, j_seq), _ = jax.jit(jm.forward, static_argnums=3)(
        params, state, jb, False)
    with torch.inference_mode():
        t_ctc, t_seq = brain.compute_forward(arrays, Stage.VALID)
    np.testing.assert_allclose(t_ctc.numpy(), np.asarray(j_ctc), atol=ATOL)
    np.testing.assert_allclose(t_seq.numpy(), np.asarray(j_seq), atol=ATOL)

    # one training step's loss, gradients and new state
    (jloss, new_state), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(params, state, jb)
    loss = brain.compute_objectives(
        brain.compute_forward(arrays, Stage.TRAIN), arrays, Stage.TRAIN)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    flat_want = {}
    for name in jm.names:
        want = jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jgrads[name]))
        got = dict(jax.tree_util.tree_leaves_with_path(
            _grad_tree(modules[name])))
        assert len(got) == len(want), name
        for path, w in want:
            flat_want[name + jax.tree_util.keystr(path)] = (got[path], w)
    total = np.sqrt(sum(np.sum(np.square(w)) for _, w in flat_want.values()))
    for key, (g, w) in flat_want.items():
        if np.linalg.norm(w) <= ZERO_SHARE * total:
            assert np.linalg.norm(g) <= ZERO_SHARE * total, key
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, (key, err)
    enc_state = module_tree(modules["enc"], running_stats=True)
    want_state = jax.tree_util.tree_map(np.asarray, new_state["enc"])
    assert jax.tree_util.tree_structure(enc_state) == \
        jax.tree_util.tree_structure(want_state)
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(enc_state),
            jax.tree_util.tree_leaves_with_path(want_state)):
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=str(path))
    norm_state = module_tree(modules["normalize"], running_stats=True)
    for key in ("glob_mean", "glob_std", "count"):
        np.testing.assert_allclose(norm_state[key],
                                   np.asarray(new_state["normalize"][key]),
                                   atol=1e-4, err_msg=key)

    # the trees back: the JAX parameters bit for bit, and a fresh port
    # loaded from the exported trees computes the same eval outputs
    for name in jm.names:
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(module_tree(
                    modules[name])),
                jax.tree_util.tree_leaves_with_path(params[name])):
            np.testing.assert_array_equal(g, np.asarray(w), str(path))
    exported = {name: (module_tree(m), module_tree(m, running_stats=True))
                for name, m in modules.items()}
    fresh = cs.crdnn_modules(ARCH, DEC, VOCAB, EMB)
    for name, (p, st) in exported.items():
        load_module_tree(fresh[name], p, st)
    with torch.inference_mode():
        again = _brain(fresh).compute_forward(arrays, Stage.VALID)
        ref = brain.compute_forward(arrays, Stage.VALID)
    for a, b in zip(again, ref):
        assert torch.equal(a, b)


def test_crdnn_brain_seeds_and_trains_every_part():
    """The assembly's ``Brain`` over unseeded modules, as phase 22 builds
    it on the card: the modules come out seeded, two Adam steps with the
    recipe's dropouts move every running statistic and the normalization's
    state, and leave no parameter at zero."""
    modules = cs.crdnn_modules(dict(ARCH, dropout=0.15),
                               dict(DEC, dropout=0.5), VOCAB, EMB)
    assert all(is_unseeded(m) for name, m in modules.items()
               if next(m.parameters(), None) is not None)
    brain = cs.crdnn_brain(modules, "cpu", 3)
    assert not any(is_unseeded(m) for m in brain.modules.values())
    batch = cs.crdnn_batch(np.random.default_rng(1), SECONDS, VOCAB)
    before = cs.crdnn_state(brain)
    brain.on_stage_start(Stage.TRAIN, 1)
    losses = [brain.fit_batch(batch) for _ in range(2)]
    after = cs.crdnn_state(brain)
    assert all(np.isfinite(v) for v in losses)
    assert [n for n in before if torch.equal(before[n], after[n])] == []
    assert float(after["normalize.count"]) == 2.0
    assert all(bool(p.detach().any()) for p in brain.modules.parameters())
    t = int(SECONDS[0] * 100) + 1
    with torch.inference_mode():
        p_ctc, p_seq = brain.compute_forward(brain._batch_to_device(batch),
                                             Stage.VALID)
    assert p_ctc.shape == (3, t // 2, VOCAB)
    assert p_seq.shape == (3, batch["tokens_bos"].data.shape[1], VOCAB)
