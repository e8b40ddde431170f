"""The port's seeded initialisation: ``seeded_tree`` composes the leaf
classes' initialisers over any module, ``init_modules`` fills modules from
one seed, a module with parameters of its own and no initialiser raises
naming its class (``any(module.parameters())`` no longer decides, so one
single-0.0 parameter is not skipped), and a ``Brain`` built over modules
that no one loaded or seeded draws them from its seed, as the JAX ``Brain``
draws every module from its ``init``, while weights loaded before it is
built are kept bit for bit."""
import math

import numpy as np
import pytest

import jax
import torch

from svt_speechbrain_tpu.models import crdnn as jcrdnn
from svt_speechbrain_tpu.nnet import rnn as jrnn

from svt_speechbrain_tpu_torch.convert_jax import (init_modules, is_unseeded,
                                                   module_tree, seeded_tree)
from svt_speechbrain_tpu_torch.core import Brain
from svt_speechbrain_tpu_torch.models.crdnn import CRDNN
from svt_speechbrain_tpu_torch.nnet.cnn import Conv1d
from svt_speechbrain_tpu_torch.nnet.containers import Sequential
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import LayerNorm
from svt_speechbrain_tpu_torch.nnet.rnn import AttentionalRNNDecoder
from svt_speechbrain_tpu_torch.utils.epoch_loop import EpochCounter


class _Scalar(torch.nn.Module):
    """A module whose only parameter is a single 0.0, and no initialiser."""

    def __init__(self):
        super().__init__()
        self.p = torch.nn.Parameter(torch.zeros(()))


def test_leaves_with_initialisers_are_seeded():
    """``LayerNorm(4)`` and ``Conv1d(4, 3, 2)`` have initialisers now: the
    norm comes out as the JAX init's ones and zeros, the conv
    kaiming-uniform within sqrt(1/fan_in) and its bias within
    1/sqrt(fan_in)."""
    ln, conv = LayerNorm(4), Conv1d(4, 3, 2)
    init_modules({"ln": ln, "conv": conv}, 0)
    assert torch.equal(ln.scale, torch.ones(4))
    assert torch.equal(ln.bias, torch.zeros(4))
    fan_in = 2 * 3
    assert conv.weight.shape == (4, 2, 3)
    assert 0 < conv.weight.abs().max() <= math.sqrt(1 / fan_in)
    assert 0 < conv.bias.abs().max() <= 1 / math.sqrt(fan_in)
    assert len(torch.unique(conv.weight)) == conv.weight.numel()


def test_single_zero_parameter_module_is_seeded_or_named():
    """A lone 0.0 is seeded where the class has an initialiser (a
    bias-free ``Linear(1, 1)``) and raises naming the class where it has
    none: neither is skipped as parameter-free."""
    lin = Linear(1, 1, bias=False)
    init_modules({"lin": lin}, 0)
    assert float(lin.w.detach()) != 0.0
    with pytest.raises(NotImplementedError, match="_Scalar"):
        init_modules({"scalar": _Scalar()}, 0)
    with pytest.raises(NotImplementedError, match="_Scalar"):
        seeded_tree(Sequential(Linear(2, 2), _Scalar()),
                    torch.Generator().manual_seed(0))


@pytest.mark.parametrize("which", ["crdnn", "decoder"])
def test_composed_trees_have_the_jax_shapes(which):
    """Modules built from the port's leaves are seeded with no entry of
    their own: the composed tree has the JAX ``init``'s keys and shapes
    (traced, not run)."""
    if which == "crdnn":
        kw = dict(input_size=16, cnn_channels=(4, 6), rnn_class="ligru",
                  rnn_layers=2, rnn_neurons=8, dnn_neurons=10,
                  time_pooling=True)
        port, jax_mod = CRDNN(**kw), jcrdnn.CRDNN(**kw)
    else:
        kw = dict(rnn_type="lstm", attn_type="location", hidden_size=7,
                  attn_dim=6, num_layers=2, enc_dim=10, input_size=5,
                  channels=3, kernel_size=2)
        port, jax_mod = (AttentionalRNNDecoder(**kw),
                         jrnn.AttentionalRNNDecoder(**kw))
    tree = seeded_tree(port, torch.Generator().manual_seed(0))
    want = jax.eval_shape(jax_mod.init, jax.random.PRNGKey(0))
    assert [(k, v.shape) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)] == [
        (k, v.shape) for k, v in jax.tree_util.tree_leaves_with_path(want)]
    assert is_unseeded(port)
    init_modules({"m": port}, 1)
    assert not is_unseeded(port)
    np.testing.assert_array_equal(
        jax.tree_util.tree_leaves(module_tree(port))[0],
        jax.tree_util.tree_leaves(seeded_tree(
            type(port)(**kw), torch.Generator().manual_seed(1)))[0])


class _Fit(Brain):
    def compute_forward(self, batch, stage, rng=None):
        return self.modules.model(batch["x"].data)

    def compute_objectives(self, predictions, batch, stage):
        return (predictions - batch["y"].data).square().mean()


def test_brain_seeds_two_stacked_linears_and_both_move():
    """The ROADMAP's test of the fault: two stacked ``Linear``s that no one
    seeded, under ``Brain.fit`` (SGD, lr 0.1, 3 epochs). At zeros the first
    weight took no gradient through the second; seeded, both move."""
    model = Sequential(Linear(3, 4), Linear(2, 3))
    gen = torch.Generator().manual_seed(0)
    data = []
    for i in range(8):
        x = torch.randn(5, 4, generator=gen)
        data.append({"id": str(i), "x": x, "y": x[:, :2] - x[:, 2:]})
    brain = _Fit({"model": model}, opt_class=lambda p, lr=0.1:
                 torch.optim.SGD(p, lr=lr), hparams={"seed": 4},
                 run_opts={"device": "cpu", "noprogressbar": True})
    w0, w1 = model[0].w.detach().clone(), model[1].w.detach().clone()
    assert w0.abs().sum() > 0 and w1.abs().sum() > 0
    brain.fit(EpochCounter(3), data, train_loader_kwargs={"batch_size": 4})
    assert not torch.equal(model[0].w, w0)
    assert not torch.equal(model[1].w, w1)
    # the draws are init_modules' from the Brain's seed
    again = Sequential(Linear(3, 4), Linear(2, 3))
    init_modules({"model": again}, 4)
    assert torch.equal(again[0].w, w0) and torch.equal(again[1].w, w1)


def test_brain_keeps_loaded_weights_bit_for_bit():
    """Weights loaded or seeded before the ``Brain`` is built are kept:
    seeded from another seed, a norm-only module with trained values, and
    a torch module with its own initialisation."""
    crdnn = CRDNN(input_size=16, cnn_channels=(4, 6), rnn_class="ligru",
                  rnn_layers=1, rnn_neurons=8, dnn_neurons=10)
    head = Linear(5, 10)
    init_modules({"crdnn": crdnn, "head": head}, 9)
    norm = LayerNorm(3)
    with torch.no_grad():
        norm.scale.copy_(torch.tensor([0.5, 2.0, 1.5]))
    plain = torch.nn.Linear(2, 2)
    modules = {"crdnn": crdnn, "head": head, "norm": norm, "plain": plain}
    before = {name: {k: v.clone() for k, v in m.state_dict().items()}
              for name, m in modules.items()}
    Brain(modules, hparams={"seed": 0}, run_opts={"device": "cpu"})
    for name, m in modules.items():
        for k, v in m.state_dict().items():
            assert torch.equal(v, before[name][k]), (name, k)
