"""A JAX training run resumed in the port: the TINY MIR-ST500 recipe of the
JAX package runs one epoch (the linear probe) and leaves its checkpoint
directory (``CKPT.yaml``, msgpack parameter and optax trees, YAML state
dicts). Copies of that output folder are resumed for the second epoch (the
first finetune epoch) by the JAX recipe and by the port's recipe, whose
``Checkpointer`` reads the JAX directory.

Held: what the port recovered (every parameter, both optimizers' moments,
step counts and learning rates, the epoch counter and the NewBob
schedulers) against the JAX trees; then the second epoch's train and valid
losses (rtol 2e-4, as the losses after the first Adam step in
``tests/test_torch_recipe_n20emv2_video.py``), the NewBob values exactly
and the learning rates as float32. A JAX run resumed in the port draws its
own dropout masks (the JAX PRNG key has no ``torch.Generator`` state), so
dropouts are 0 here. Then the JAX Brain's ``model_states`` file filling a
``VideoAMT``'s BatchNorm statistics, and the refusal of an optimizer other
than Adam or Adadelta."""
import functools
import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from svt_speechbrain_tpu.config import load_hyperyaml as jax_load_hyperyaml

from svt_speechbrain_tpu_torch import convert_jax
from svt_speechbrain_tpu_torch.convert_jax import init_params
from svt_speechbrain_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from svt_speechbrain_tpu_torch.utils import checkpoints
from tests.test_torch_recipe_mir_st500 import (  # noqa: F401 (fixture)
    ARCH, JAX_YAML, NO_DROPOUT, _load_jax_recipe, _overrides, _port_hparams,
    _recording, _run, songs)
from tests.torch_threads import two_torch_threads  # noqa: F401

import tests.test_torch_recipe_mir_st500 as mir
from svt_speechbrain_tpu_torch.recipes.MIR_ST500 import \
    train_audio_ssl as recipe

AFTER_ADAM_RTOL = 2e-4


def _jax_brain(root, out, tree, epochs):
    jrecipe = _load_jax_recipe()
    with open(JAX_YAML) as f:
        hp = jax_load_hyperyaml(f, _overrides(
            root, out, "svt_speechbrain_tpu", dict(ARCH, **NO_DROPOUT),
            epochs=epochs))
    for name in ("wav2vec2", "model"):
        hp["modules"][name].init = functools.partial(
            lambda sub, rng: jax.tree_util.tree_map(jnp.asarray, sub),
            tree[name])
    hp["_data"] = jrecipe.dataio_prepare(hp)
    brain = _recording(jrecipe.AMT)(
        modules=hp["modules"], hparams=hp,
        run_opts={"noprogressbar": True, "data_parallel_count": 1},
        checkpointer=hp["checkpointer"])
    return brain, hp


def _port_brain(root, out, tree):
    hp = _port_hparams(root, out, dict(ARCH, **NO_DROPOUT), tree, epochs=2)
    brain = _recording(recipe.AMT)(
        modules=hp["modules"], hparams=hp,
        run_opts={"device": "cpu", "noprogressbar": True},
        checkpointer=hp["checkpointer"])
    return brain, hp


@pytest.fixture(scope="module")
def resumed(songs, tmp_path_factory):  # noqa: F811
    tree = init_params(Wav2Vec2Config(**dict(ARCH, conv_dim=(16,) * 7)),
                       torch.Generator().manual_seed(0))
    base = tmp_path_factory.mktemp("jax_ckpt")
    brain, hp = _jax_brain(songs, base / "first", tree, epochs=1)
    _run(brain, hp, evaluate=False)
    ckpt = glob.glob(str(base / "first" / "save" / "CKPT+*"))
    assert len(ckpt) == 1 and os.path.exists(
        os.path.join(ckpt[0], "CKPT.yaml"))
    for side in ("jax", "port"):
        shutil.copytree(base / "first", base / side)

    jbrain, jhp = _jax_brain(songs, base / "jax", tree, epochs=2)
    jax_run = _run(jbrain, jhp, evaluate=False)

    pbrain, php = _port_brain(songs, base / "port", tree)
    # what the port recovers, before it trains
    pbrain.init_optimizers()
    found = php["checkpointer"].recover_if_possible()
    recovered = dict(
        path=found.path, counter=php["epoch_counter"].current,
        scheds=[php["lr_annealing_wav2vec"].state_dict(),
                php["lr_annealing_model"].state_dict()],
        params={k: v.clone() for k, v in pbrain.modules.state_dict().items()},
        opts={n: cfg["opt"] for n, cfg in pbrain.optimizers.items()},
        steps=(pbrain.step, pbrain.optimizer_step))
    recovered["opt_state"] = {
        n: {id(p): {k: (v.clone() if torch.is_tensor(v) else v)
                    for k, v in opt.state[p].items()}
            for g in opt.param_groups for p in g["params"]}
        for n, opt in recovered["opts"].items()}
    pbrain.optimizers = {}
    port_run = _run(pbrain, php, evaluate=False)
    return dict(jax=jax_run, port=port_run, recovered=recovered,
                ckpt=ckpt[0], modules=pbrain.modules)


def _read(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def test_the_port_recovers_every_jax_recoverable(resumed):
    rec, ckpt = resumed["recovered"], resumed["ckpt"]
    assert os.path.basename(rec["path"]) == os.path.basename(ckpt)
    assert rec["counter"] == 1
    assert rec["steps"][1] == 3       # the probe epoch's three steps
    for name in ("wav2vec2", "model"):
        want = convert_jax.module_state(resumed["modules"][name],
                                        _read(f"{ckpt}/{name}.ckpt"))
        for key, value in want.items():
            assert torch.equal(rec["params"][f"{name}.{key}"], value), key
    for got, name in zip(rec["scheds"], ("scheduler_wav2vec",
                                         "scheduler_model")):
        assert got == checkpoints._read_yaml_file(f"{ckpt}/{name}.ckpt")


@pytest.mark.parametrize("opt,keys,count", [
    ("wav2vec", ("exp_avg", "exp_avg_sq"), 0),
    ("model", ("square_avg", "acc_delta"), 3)])
def test_optax_states_become_torch_optim_states(resumed, opt, keys, count):
    rec, ckpt = resumed["recovered"], resumed["ckpt"]
    tree = _read(f"{ckpt}/{opt}_opt.ckpt")
    torch_opt = rec["opts"][opt]
    assert torch_opt.param_groups[0]["lr"] == float(
        tree["hyperparams"]["learning_rate"])
    module_name = "wav2vec2" if opt == "wav2vec" else "model"
    module = resumed["modules"][module_name]
    inner = [v for v in tree["inner_state"].values() if isinstance(v, dict)
             and len(v) >= 2][0]
    jax_keys = [k for k in inner if k != "count"]
    names = dict(module.named_parameters())
    states = rec["opt_state"][opt]
    n = 0
    for jkey, tkey in zip(jax_keys, keys):
        want = convert_jax.module_state(module, inner[jkey][module_name])
        for pname, value in want.items():
            state = states[id(names[pname])]
            assert float(state["step"]) == count
            assert torch.equal(state[tkey], value)
            n += 1
    assert n == 2 * len(names)


def test_resumed_epoch_matches_the_jax_resume(resumed):
    want = resumed["jax"]["brain"].stage_ends
    got = resumed["port"]["brain"].stage_ends
    assert [(e["stage"], e["epoch"]) for e in got] == \
        [(e["stage"], e["epoch"]) for e in want] == \
        [("TRAIN", 2), ("VALID", 2)]
    np.testing.assert_allclose([e["loss"] for e in got],
                               [e["loss"] for e in want],
                               rtol=AFTER_ADAM_RTOL)
    for w, g in zip(want, got):
        assert g["scheds"] == w["scheds"]
        assert {k: np.float32(v) for k, v in g["lrs"].items()} == \
            {k: np.float32(v) for k, v in w["lrs"].items()}
    assert resumed["port"]["log"] == resumed["jax"]["log"]
    assert len(resumed["port"]["log"]) == 2


def test_model_states_fill_batchnorm_statistics(tmp_path):
    """A JAX checkpoint with a ``model_states`` file (the JAX Brain's
    BatchNorm statistics, apart from the parameters) fills the port's
    BatchNorm buffers; the parameters come from the module's own file."""
    from svt_speechbrain_tpu.nnet.normalization import \
        BatchNorm1d as JBatchNorm1d
    from svt_speechbrain_tpu_torch.nnet.normalization import BatchNorm1d

    jbn = JBatchNorm1d(input_size=6)
    rng = np.random.default_rng(0)
    params = {"scale": rng.standard_normal(6).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    state = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": rng.random(6).astype(np.float32) + 0.5}
    assert set(jbn.init_state()) == set(state)
    ckpt = tmp_path / "CKPT+2026-01-01+00-00-00+00"
    ckpt.mkdir()
    (ckpt / "CKPT.yaml").write_text("# yamllint disable\nend-of-epoch: "
                                    "true\nunixtime: 1.5\n")
    (ckpt / "bn.ckpt").write_bytes(serialization.to_bytes(params))
    (ckpt / "model_states.ckpt").write_bytes(
        serialization.to_bytes({"bn": state}))
    bn = BatchNorm1d(input_size=6)
    ckptr = checkpoints.Checkpointer(tmp_path, {"bn": bn})
    assert ckptr.recover_if_possible().meta == {"end-of-epoch": True,
                                                "unixtime": 1.5}
    for key, value in {**params, **state}.items():
        assert torch.equal(getattr(bn, key), torch.from_numpy(value)), key


def test_other_optimizers_raise_by_name(tmp_path):
    from svt_speechbrain_tpu_torch.nnet.linear import Linear

    head = Linear(3, 2)
    opt = torch.optim.SGD(head.parameters(), lr=0.1)
    path = tmp_path / "opt.ckpt"
    path.write_bytes(serialization.to_bytes({"count": np.int32(1)}))
    with pytest.raises(TypeError, match="not SGD"):
        checkpoints._load_obj(opt, str(path), True, {"model": head})


def test_file_formats_by_first_bytes(tmp_path):
    torch.save({"a": 1}, tmp_path / "t.ckpt")
    (tmp_path / "m.ckpt").write_bytes(serialization.to_bytes({"a": 1}))
    (tmp_path / "y.ckpt").write_text("current: 1\n")
    assert [checkpoints._file_format(tmp_path / f) for f in
            ("t.ckpt", "m.ckpt", "y.ckpt")] == ["torch", "msgpack", "yaml"]
    assert mir.LOSS_RTOL < AFTER_ADAM_RTOL
