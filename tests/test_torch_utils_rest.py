"""Port parity of the last utility modules and of the names and parameters
the ported modules lacked, each against its JAX twin on the same inputs:
``accuracy``, ``bleu``, ``der``, ``hpopt``, ``flops`` (lv60's analytic
counts) and ``profiling``; the ``dataio``, ``batch``, ``data_utils``,
``epoch_loop``, ``logger``, ``checkpoints`` and ``core`` names; the
parameters ``layer_norm(axis)``, ``fetch(use_auth_token)``,
``make_mesh(devices)``, ``int8_matmul(out_dtype)``,
``format_order_of_magnitude(abbreviate)`` and ``average_checkpoints
(parameter_loader, averager)``. Exact equality unless a test says
otherwise."""
import inspect
import io
import json
import logging
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svt_speechbrain_tpu import core as jcore
from svt_speechbrain_tpu.dataio import batch as jbatch
from svt_speechbrain_tpu.dataio import dataio as jdataio
from svt_speechbrain_tpu.models import wav2vec2 as jwav2vec2
from svt_speechbrain_tpu.nnet import normalization as jnorm
from svt_speechbrain_tpu.ops import quant as jquant
from svt_speechbrain_tpu.pretrained import fetching as jfetching
from svt_speechbrain_tpu.utils import accuracy as jaccuracy
from svt_speechbrain_tpu.utils import bleu as jbleu
from svt_speechbrain_tpu.utils import checkpoints as jcheckpoints
from svt_speechbrain_tpu.utils import data_utils as jdata_utils
from svt_speechbrain_tpu.utils import der as jder
from svt_speechbrain_tpu.utils import epoch_loop as jepoch_loop
from svt_speechbrain_tpu.utils import flops as jflops
from svt_speechbrain_tpu.utils import hpopt as jhpopt
from svt_speechbrain_tpu.utils import logger as jlogger
from svt_speechbrain_tpu.utils import profiling as jprofiling

from svt_speechbrain_tpu_torch import core
from svt_speechbrain_tpu_torch.dataio import batch, dataio
from svt_speechbrain_tpu_torch.models import wav2vec2
from svt_speechbrain_tpu_torch.nnet import normalization
from svt_speechbrain_tpu_torch.ops import quant
from svt_speechbrain_tpu_torch.pretrained import fetching
from svt_speechbrain_tpu_torch.utils import (accuracy, bleu, checkpoints,
                                             data_utils, der, epoch_loop,
                                             flops, hpopt, logger, profiling)


# ------------------------------------------------------------- accuracy
@pytest.mark.parametrize("shape", [(3, 7), (2, 5, 3)])
@pytest.mark.parametrize("with_length", [True, False])
def test_accuracy_matches_jax(shape, with_length):
    rng = np.random.default_rng(sum(shape))
    logp = np.log(rng.dirichlet(np.ones(4), size=shape)).astype(np.float32)
    targets = rng.integers(0, 4, shape)
    length = (np.asarray([1.0, 0.6, 0.3][:shape[0]], np.float32)
              if with_length else None)
    got = accuracy.Accuracy(torch.from_numpy(logp),
                            torch.from_numpy(targets),
                            None if length is None
                            else torch.from_numpy(length))
    want = jaccuracy.Accuracy(logp, targets, length)
    assert got == want
    ours, theirs = accuracy.AccuracyStats(), jaccuracy.AccuracyStats()
    for _ in range(2):
        ours.append(torch.from_numpy(logp), torch.from_numpy(targets),
                    None if length is None else torch.from_numpy(length))
        theirs.append(logp, targets, length)
    assert ours.summarize() == theirs.summarize()


# ----------------------------------------------------------- bleu, der
def test_bleu_matches_jax():
    hyps = [["the", "cat", "sat", "on", "the", "mat"],
            ["a", "dog", "ran", "home"], ["it", "was", "late"]]
    refs = [[["the", "cat", "sat", "on", "a", "mat"],
             ["a", "dog", "ran", "to", "the", "house"],
             ["it", "was", "very", "late"]]]
    assert bleu.merge_words(hyps) == jbleu.merge_words(hyps)
    assert bleu.corpus_bleu(bleu.merge_words(hyps),
                            [bleu.merge_words(r) for r in refs]) == \
        jbleu.corpus_bleu(jbleu.merge_words(hyps),
                          [jbleu.merge_words(r) for r in refs])
    got, want = bleu.BLEUStats(), jbleu.BLEUStats()
    for stats in (got, want):
        stats.append(["u1", "u2", "u3"], hyps, refs)
    assert got.summarize() == want.summarize()
    out, jout = io.StringIO(), io.StringIO()
    got.write_stats(out)
    want.write_stats(jout)
    assert out.getvalue() == jout.getvalue()


def test_der_and_rectify_match_jax():
    rng = np.random.default_rng(3)
    ref, sys_ = [], []
    for segs, spk in ((ref, "ABC"), (sys_, "xyz")):
        t = 0.0
        for _ in range(12):
            d = float(rng.uniform(0.3, 2.0))
            segs.append((round(t, 2), round(t + d, 2), spk[rng.integers(3)]))
            t += d + float(rng.uniform(-0.2, 0.5))
    for collar in (0.0, 0.25):
        assert der.DER(ref, sys_, collar=collar) == jder.DER(
            ref, sys_, collar=collar)
    arr = [0.5, np.nan, np.inf, 0.0]
    assert np.array_equal(der.rectify(arr), jder.rectify(arr))


# --------------------------------------------------------------- hpopt
def test_hpopt_reporter_output_matches_jax(tmp_path, monkeypatch):
    yaml = tmp_path / "p.yaml"
    yaml.write_text("lr: 0.1\n")
    outputs = []
    for mod in (hpopt, jhpopt):
        buf = io.StringIO()
        rep = mod.get_reporter("generic", output=buf)
        rep.report_objective({"objective": 0.25, "epoch": 3})
        ctx = mod.hyperparameter_optimization(objective_key="error",
                                              output=buf)
        with ctx as c:
            param, _, overrides = c.parse_arguments(
                [str(yaml), "--hpopt", "true", "--hpopt_mode", "generic",
                 "--lr=0.5"])
            mod.report_result({"error": 0.125, "epoch": 2})
        mod.report_result({"ignored": 1})      # no context: dropped
        outputs.append((buf.getvalue(), param, overrides, c.enabled,
                        type(c.reporter).__name__,
                        type(mod.get_reporter("orion.x")).__name__,
                        mod.get_trial_id()))
        cls = mod.hpopt_mode("custom")(type("R", (), {}))
        assert mod._hpopt_modes["custom"] is cls
    assert outputs[0] == outputs[1]
    monkeypatch.setenv("ORION_TRIAL_ID", "t7")
    assert hpopt.get_trial_id() == jhpopt.get_trial_id() == "t7"
    with pytest.raises(ImportError):
        hpopt.OrionHyperparameterOptimizationReporter()


# --------------------------------------------------------------- flops
@pytest.mark.parametrize("arch", ["lv60", "tiny"])
@pytest.mark.parametrize("seconds", [5.0, 21.0, 30.0])
def test_flop_counts_match_jax(arch, seconds):
    kw = {} if arch == "lv60" else dict(wav2vec2.TINY_ARCH)
    ours, theirs = wav2vec2.Wav2Vec2Config(**kw), jwav2vec2.Wav2Vec2Config(
        **kw)
    n = int(seconds * 16000)
    t = ours.output_length(n)
    assert t == theirs.output_length(n)
    assert flops.conv_frontend_flops(ours, n) == jflops.conv_frontend_flops(
        theirs, n)
    assert flops.encoder_flops(ours, t) == jflops.encoder_flops(theirs, t)
    assert flops.amt_forward_flops(ours, n) == jflops.amt_forward_flops(
        theirs, n)
    for remat in (False, True):
        assert flops.amt_train_flops(ours, n, remat=remat) == \
            jflops.amt_train_flops(theirs, n, remat=remat)


def test_peaks_are_the_h100_s_and_the_override_is_renamed(monkeypatch):
    assert flops.peak_flops_per_sec() == 989e12
    assert flops.peak_flops_per_sec("f32") == 67e12
    assert flops.peak_flops_per_sec("tf32") == 495e12
    assert flops.peak_flops_per_sec("int8") == 1979e12
    assert flops.PEAK_BYTES == 3.35e12
    monkeypatch.setenv("SVT_PEAK_TFLOPS", "100")
    monkeypatch.setenv("TPU_PEAK_TFLOPS", "100")
    assert flops.mfu(1e12, 50.0) == jflops.mfu(1e12, 50.0) == 0.5
    assert flops.mfu(1e12, 50.0, dtype="f32") == 0.5
    monkeypatch.delenv("SVT_PEAK_TFLOPS")
    assert flops.mfu(67e12, 0.5, dtype="f32") == 0.5      # TPU_ has no say


# ----------------------------------------------------------- profiling
def test_step_timer_matches_jax_and_profile_writes_a_trace(tmp_path):
    summaries = []
    for mod in (profiling, jprofiling):
        timer = mod.StepTimer("t")
        for _ in range(4):
            with timer.measure():
                pass
        summaries.append((sorted(timer.summary()), timer.summary()["steps"],
                          timer.name))
        with mod.annotate("region"):
            pass
    assert summaries[0] == summaries[1]
    timer = profiling.StepTimer()
    with timer.measure(device="cpu"):      # no card: nothing synchronized
        pass
    assert timer.first_time is not None and timer.times == []
    logdir = str(tmp_path / "prof")
    with profiling.profile(logdir, timeout_s=60.0) as got:
        with profiling.annotate("fit_batch"):
            torch.ones(8).sum()
    assert got == logdir
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        trace = json.load(f)
    assert any(ev.get("name") == "fit_batch"
               for ev in trace["traceEvents"])


# ------------------------------------------------------------- 21c names
def test_dataio_names_match_jax(tmp_path, capsys):
    out, jout = io.StringIO(), io.StringIO()
    for mod, stream in ((dataio, out), (jdataio, jout)):
        w = mod.IterativeCSVWriter(stream, ["wav", "spk"],
                                   defaults={"spk": "s0"})
        w.write(ID="u1", wav="a.wav")
        w.write("u2", "b.wav", "s3")
        w.set_default("spk", "s9")
        w.write_batch(ID=["u3", "u4"], wav=["c.wav", "d.wav"])
        w.write_batch(["u5"], ["e.wav"], ["s1"])
        with pytest.raises(ValueError):
            w.set_default("nope", 1)
    assert out.getvalue() == jout.getvalue()
    label = np.asarray([[5, 6, 7], [8, 9, 0]], np.int64)
    assert np.array_equal(
        dataio.prepend_bos_token(torch.from_numpy(label), 1).numpy(),
        np.asarray(jdataio.prepend_bos_token(jnp.asarray(label), 1)))
    assert np.array_equal(
        dataio.append_eos_token(torch.from_numpy(label), [3, 1], 2).numpy(),
        np.asarray(jdataio.append_eos_token(jnp.asarray(label), [3, 1], 2)))
    assert dataio.convert_index_to_lab(label, {i: str(i) for i in range(10)}) \
        == jdataio.convert_index_to_lab(label, {i: str(i) for i in range(10)})
    lens = np.asarray([3, 1, 4.5])
    assert np.array_equal(dataio.length_to_mask(lens),
                          jdataio.length_to_mask(lens))
    assert np.array_equal(dataio.length_to_mask(lens, 6, np.int32),
                          jdataio.length_to_mask(lens, 6, np.int32))
    wav = np.zeros((3, 16000))
    assert np.array_equal(
        dataio.relative_time_to_absolute(wav, [1.0, 0.5, 0.33], 16000),
        jdataio.relative_time_to_absolute(wav, [1.0, 0.5, 0.33], 16000))
    obj = {"a": [1, 2], "b": np.arange(3)}
    dataio.save_pkl(obj, str(tmp_path / "p.pkl"))
    loaded = jdataio.load_pkl(str(tmp_path / "p.pkl"))
    assert loaded["a"] == [1, 2] and np.array_equal(loaded["b"], obj["b"])
    assert dataio.load_pickle is dataio.load_pkl
    files = [str(tmp_path / "p.pkl")]
    assert dataio.get_md5(files[0]) == jdataio.get_md5(files[0])
    dataio.save_md5(files, str(tmp_path / "m.pkl"))
    jdataio.save_md5(files, str(tmp_path / "jm.pkl"))
    assert dataio.load_pkl(str(tmp_path / "m.pkl")) == jdataio.load_pkl(
        str(tmp_path / "jm.pkl"))
    dataio.write_txt_file(["x", 2], str(tmp_path / "d" / "t.txt"))
    jdataio.write_txt_file(["x", 2], str(tmp_path / "d" / "jt.txt"))
    assert (tmp_path / "d" / "t.txt").read_text() == (
        tmp_path / "d" / "jt.txt").read_text()
    dataio.write_stdout(["l1", "l2"])
    ours = capsys.readouterr().out
    jdataio.write_stdout(["l1", "l2"])
    assert ours == capsys.readouterr().out == "l1\nl2\n"
    for mod in (dataio, jdataio):
        with pytest.raises(ImportError):
            mod.read_kaldi_lab("ali", "ali-to-pdf")


def test_batchsize_guesser_matches_jax():
    ours, theirs = batch.BatchsizeGuesser(), jbatch.BatchsizeGuesser()
    arr = np.zeros((4, 2))
    cases = [(torch.zeros(3, 5), np.zeros((3, 5))),
             ({"x": [torch.zeros(4, 2)]}, {"x": [arr]}),
             ([1, 2, 3], [1, 2, 3]), ([[torch.zeros(2)]], [[np.zeros(2)]]),
             (7, 7), ({}, {}), (types.SimpleNamespace(batchsize=9),
                                types.SimpleNamespace(batchsize=9))]
    for mine, jaxs in cases:
        assert ours(mine) == theirs(jaxs)


def test_data_utils_names_match_jax(tmp_path):
    for rel in ("a/x.wav", "a/b/y.wav", "a/b/z.txt", "c.wav"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text("")
    for kw in ({}, dict(match_and=[".wav"]), dict(match_or=["x", "z"]),
               dict(exclude_and=["b", "y"]), dict(exclude_or=["c.wav"])):
        assert data_utils.get_all_files(str(tmp_path), **kw) == \
            jdata_utils.get_all_files(str(tmp_path), **kw)
    for n in (1, 2, 3, 7):
        assert data_utils.split_list(range(10), n) == \
            jdata_utils.split_list(range(10), n)
    nested = {"a": 1, "b": {"c": 2, "d": {"e": 3}}, "f": 4}
    assert list(data_utils.recursive_items(nested)) == list(
        jdata_utils.recursive_items(nested))
    for must_match in (False, True):
        mine, theirs = json.loads(json.dumps(nested)), json.loads(
            json.dumps(nested))
        data_utils.recursive_update(mine, {"b": {"c": 9}, "g": 1})
        jdata_utils.recursive_update(theirs, {"b": {"c": 9}, "g": 1})
        assert mine == theirs
        if must_match:
            for fn in (data_utils.recursive_update,
                       jdata_utils.recursive_update):
                with pytest.raises(KeyError):
                    fn({}, {"x": 1}, must_match=True)
    tree = {"a": [np.arange(3.0), "s"], "b": (np.ones(2), 4)}
    got = data_utils.recursive_to(tree, lambda x: x * 2)
    want = jdata_utils.recursive_to(tree, lambda x: x * 2)
    assert np.array_equal(got["a"][0], want["a"][0]) and got["a"][1] == "s"
    assert np.array_equal(got["b"][0], want["b"][0]) and got["b"][1] == 4
    moved = data_utils.recursive_to({"t": [torch.ones(2), np.zeros(2)]},
                                    torch.device("cpu"))
    assert all(isinstance(v, torch.Tensor) for v in moved["t"])
    for batch_values in ([np.ones(2), np.zeros(2)], [1.5, 2.5], [True, False],
                         [1, 2], ["a", "b"], [np.ones(2), np.ones(3)]):
        got, want = (data_utils.mod_default_collate(batch_values),
                     jdata_utils.mod_default_collate(batch_values))
        assert type(got) is type(want)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        else:                                  # handed back unchanged
            assert got is batch_values
    stacked = data_utils.mod_default_collate([torch.ones(2), torch.zeros(2)])
    assert torch.equal(stacked, torch.tensor([[1.0, 1.0], [0.0, 0.0]]))
    assert data_utils.split_by_whitespace(" a b\tc ") == \
        jdata_utils.split_by_whitespace(" a b\tc ")
    for path in ("a/b/c.ckpt", "c.ckpt", "http://x/y"):
        assert data_utils.split_path(path) == jdata_utils.split_path(path)


def test_epoch_counter_with_stopper_matches_jax():
    metrics = [5.0, 4.0, 4.0, 4.0, 3.0, 3.5, 2.0, 2.0, 2.0, 2.0]
    for direction, sign in (("min", 1), ("max", -1)):
        runs = []
        for mod in (epoch_loop, jepoch_loop):
            counter = mod.EpochCounterWithStopper(
                limit=10, limit_to_stop=2, limit_warmup=1,
                direction=direction)
            seen = []
            for epoch in counter:
                counter.update_metric(sign * metrics[epoch - 1])
                seen.append((epoch, counter.state_dict()))
            runs.append(seen)
        assert runs[0] == runs[1]
    for mod in (epoch_loop, jepoch_loop):
        with pytest.raises(ValueError):
            mod.EpochCounterWithStopper(3, 1, 0, "sideways")
    restored = epoch_loop.EpochCounterWithStopper(10, 2, 1, "min")
    restored.load_state_dict({"current": 4, "best_limit": 2, "th": 4.0},
                             end_of_epoch=False)
    assert (restored.current, restored.best_limit, restored.th) == (3, 2,
                                                                    4.0)


def test_logger_checkpoint_and_core_names_match_jax():
    for n in (0, 950, 3_500_000, 2.5e-4, -7e9):
        for abbreviate in (True, False):
            assert logger.format_order_of_magnitude(n, abbreviate) == \
                jlogger.format_order_of_magnitude(n, abbreviate)
    texts = []
    for mod in (logger, jlogger):
        stream = io.StringIO()
        handler = mod.TqdmCompatibleStreamHandler(stream)
        handler.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
        handler.emit(logging.LogRecord("n", logging.INFO, __file__, 1,
                                       "hello %s", ("world",), None))
        texts.append(stream.getvalue())
    assert texts[0] == texts[1] == "INFO hello world\n"
    hooks = {int: "int", object: "object"}
    for obj in (True, 3, "s", 2.0):
        assert checkpoints.get_default_hook(obj, hooks) == \
            jcheckpoints.get_default_hook(obj, hooks)
    assert checkpoints.get_default_hook(1.0, {str: 1}) is None
    assert core.DEFAULT_LOG_CONFIG == jcore.DEFAULT_LOG_CONFIG
    params = inspect.signature(core.create_experiment_directory).parameters
    assert list(params) == list(inspect.signature(
        jcore.create_experiment_directory).parameters)


def test_create_experiment_directory_takes_log_config(tmp_path):
    import sys

    root = logging.getLogger()
    handlers, level, hook = list(root.handlers), root.level, sys.excepthook
    try:
        core.create_experiment_directory(str(tmp_path / "exp"),
                                         log_config="unused.yaml",
                                         save_env_desc=False)
        assert (tmp_path / "exp" / "log.txt").exists()
    finally:                       # the logging set-up is the process's
        for h in list(root.handlers):
            root.removeHandler(h)
            if h not in handlers:
                h.close()
        for h in handlers:
            root.addHandler(h)
        root.setLevel(level)
        sys.excepthook = hook


# ------------------------------------------------------- 21d parameters
def test_layer_norm_takes_axis_as_jax():
    x = np.random.default_rng(0).normal(size=(2, 5, 3)).astype(np.float32)
    scale = np.linspace(0.5, 1.5, 5).astype(np.float32)[:, None]
    for axis in (-1, 1):
        s = scale if axis == 1 else None
        got = normalization.layer_norm(
            torch.from_numpy(x), None if s is None else torch.from_numpy(s),
            eps=1e-5, axis=axis)
        want = jnorm.layer_norm(jnp.asarray(x), s, eps=1e-5, axis=axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-6)


def test_fetch_takes_use_auth_token(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "w.ckpt").write_text("x")
    got = fetching.fetch("w.ckpt", str(src), savedir=str(tmp_path / "a"),
                         use_auth_token=True)
    want = jfetching.fetch("w.ckpt", str(src), savedir=str(tmp_path / "b"),
                           use_auth_token=True)
    assert got.name == want.name and got.read_text() == want.read_text()


def test_make_mesh_takes_a_list_of_ranks():
    import torch.distributed as dist

    from svt_speechbrain_tpu.parallel import mesh as jmesh
    from svt_speechbrain_tpu_torch.parallel import mesh

    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        got = mesh.make_mesh(devices=[0])
        import jax
        want = jmesh.make_mesh(devices=jax.devices()[:1])
        assert got.mesh_dim_names == want.axis_names == ("data",)
        assert tuple(got.mesh.shape) == want.devices.shape == (1,)
        assert got.mesh.tolist() == [0]
        with pytest.raises(ValueError):
            mesh.make_mesh(devices=[0, 1])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_out_dtype_matches_jax(dtype):
    """The CPU path casts the plain version's f32 result once: bf16 in, f32
    out is the f32 epilogue's value (not a bf16 result widened), within
    the f32 tolerance of the JAX XLA path run op by op."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(6, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 128)) * 0.3).astype(np.float32)
    tx = torch.from_numpy(x).to(dtype)
    w8, ws = quant.quantize_weight(torch.from_numpy(w))
    jw8, jws = jquant.quantize_weight(jnp.asarray(w))
    got = quant.int8_matmul(tx, w8, ws, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert torch.equal(got, quant.int8_matmul_plain(
        tx, w8, ws, out_dtype=torch.float32))
    jx = jnp.asarray(tx.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = jquant.int8_matmul(jx, jw8, jws, out_dtype=jnp.float32)
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0.0)
    if dtype == torch.bfloat16:
        widened = quant.int8_matmul(tx, w8, ws).float()
        assert not torch.equal(got, widened)
    low = quant.int8_matmul(tx, w8, ws, out_dtype=torch.bfloat16)
    assert low.dtype == torch.bfloat16 and torch.equal(low, got.to(
        torch.bfloat16))


def test_average_checkpoints_takes_a_loader_and_an_averager(tmp_path):
    from flax import serialization

    trees = [{"w": np.full((2, 2), v, np.float32), "b": np.arange(3.0) * v}
             for v in (1.0, 2.0, 4.0)]
    ours, theirs = [], []
    for i, tree in enumerate(trees):
        path = str(tmp_path / f"m{i}.ckpt")
        torch.save({k: torch.from_numpy(v) for k, v in tree.items()}, path)
        ours.append(types.SimpleNamespace(paramfiles={"model": path}))
        jpath = str(tmp_path / f"j{i}.msgpack")
        with open(jpath, "wb") as f:
            f.write(serialization.msgpack_serialize(tree))
        theirs.append(types.SimpleNamespace(paramfiles={"model": jpath}))
    got = checkpoints.average_checkpoints(ours, "model")
    want = jcheckpoints.average_checkpoints(theirs, "model")
    for k in ("w", "b"):
        np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=1e-7)
    seen = []

    def loader(path):
        seen.append(os.path.basename(path))
        return torch.load(path, weights_only=True)

    def first(state_dicts):
        return next(iter(state_dicts))

    picked = checkpoints.average_checkpoints(ours, "model",
                                             parameter_loader=loader,
                                             averager=first)
    assert seen == ["m0.ckpt"] and torch.equal(picked["w"],
                                               torch.ones(2, 2))
    assert "parameter_loader" in inspect.signature(
        jcheckpoints.average_checkpoints).parameters
