"""Port parity, the dataio and utils modules no recipe of the port uses yet,
each against the JAX package's module on the same inputs: the weighted,
concat and dynamic samplers' orders for several seeds and epochs; the
encoders' codes, tensors and saved files (each package loads the other's);
the dynamic bucketing iterators' batches; ``wer`` and ``edit_distance``'s
text and numbers; the binary, EER, minDCF and error-rate metrics; the
tensorboard and wandb loggers' import refusals; ``AudioNormalizer``; the
legacy CSV dataset; ``LengthsCapableChain`` as a module; ``superpowers``."""
import io
import os
import random

import numpy as np
import pytest
import torch

from svt_speechbrain_tpu.dataio import encoder as jencoder
from svt_speechbrain_tpu.dataio import iterators as jiterators
from svt_speechbrain_tpu.dataio import legacy as jlegacy
from svt_speechbrain_tpu.dataio import preprocess as jpreprocess
from svt_speechbrain_tpu.dataio import sampler as jsampler
from svt_speechbrain_tpu.dataio import wer as jwer
from svt_speechbrain_tpu.utils import callchains as jcallchains
from svt_speechbrain_tpu.utils import edit_distance as jedit
from svt_speechbrain_tpu.utils import metric_stats as jmetric_stats
from svt_speechbrain_tpu.utils import superpowers as jsuperpowers

from svt_speechbrain_tpu_torch.dataio import (encoder, iterators, legacy,
                                              preprocess, sampler, wer)
from svt_speechbrain_tpu_torch.utils import (callchains, edit_distance,
                                             metric_stats, superpowers,
                                             train_logger)


# ------------------------------------------------------------- samplers
@pytest.mark.parametrize("seed,epoch", [(0, 0), (7, 3), (129491412, 1)])
def test_weighted_sampler_orders_match_jax(seed, epoch):
    weights = np.random.default_rng(seed).random(17)
    for replacement, n in ((True, 40), (False, 9)):
        ours = sampler.ReproducibleWeightedRandomSampler(
            weights, n, replacement=replacement, seed=seed)
        theirs = jsampler.ReproducibleWeightedRandomSampler(
            weights, n, replacement=replacement, seed=seed)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert list(ours) == list(theirs) and len(ours) == len(theirs) == n
    with pytest.raises(ValueError):
        sampler.ReproducibleWeightedRandomSampler(weights, 3, seed=True)


@pytest.mark.parametrize("epoch", [0, 2])
def test_concat_batch_sampler_matches_jax(epoch):
    def samplers(mod):
        return [mod.ReproducibleRandomSampler(range(n), seed=s)
                for n, s in ((11, 1), (7, 2), (5, 3))]

    ours = sampler.ConcatDatasetBatchSampler(samplers(sampler), [3, 2, 1],
                                             epoch=epoch)
    theirs = jsampler.ConcatDatasetBatchSampler(samplers(jsampler),
                                                [3, 2, 1], epoch=epoch)
    assert list(ours) == list(theirs) and len(ours) == len(theirs) == 3
    ours.set_epoch(epoch + 1)
    theirs.set_epoch(epoch + 1)
    assert list(ours) == list(theirs)
    with pytest.raises(ValueError):
        sampler.ConcatDatasetBatchSampler(samplers(sampler), [1, 2])


@pytest.mark.parametrize("kw", [
    dict(num_buckets=3, shuffle=True, batch_ordering="random"),
    dict(bucket_boundaries=[1.0, 2.5], shuffle=False,
         batch_ordering="ascending"),
    dict(bucket_boundaries=[2.0], shuffle=True, batch_ordering="descending",
         max_batch_ex=3, drop_last=True)])
def test_dynamic_batch_sampler_matches_jax(kw):
    lengths = np.random.default_rng(4).uniform(0.5, 4.0, 41).round(3).tolist()
    ours = sampler.DynamicBatchSampler(None, 6.0, lengths_list=lengths,
                                       seed=11, **kw)
    theirs = jsampler.DynamicBatchSampler(None, 6.0, lengths_list=lengths,
                                          seed=11, **kw)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert list(ours) == list(theirs)
        assert list(ours) == list(theirs)        # the re-draw after a pass
        assert len(ours) == len(theirs)
    batch = list(ours)[0]
    assert ours.get_durations(batch) == theirs.get_durations(batch)


def test_dynamic_batch_sampler_over_a_dataset_matches_jax(tmp_path):
    from svt_speechbrain_tpu.dataio.dataset import \
        DynamicItemDataset as JDataset
    from svt_speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset

    data = {f"u{i}": {"duration": float(d)} for i, d in
            enumerate(np.random.default_rng(5).uniform(1, 9, 23).round(2))}
    ours = sampler.DynamicBatchSampler(DynamicItemDataset(data), 20.0,
                                       num_buckets=4)
    theirs = jsampler.DynamicBatchSampler(JDataset(data), 20.0,
                                          num_buckets=4)
    assert list(ours) == list(theirs)


# ------------------------------------------------------------- encoders
def _fill(mod):
    enc = mod.CategoricalEncoder(starting_index=2)
    enc.update_from_iterable(["b", "a", "c", "a"])
    enc.add_unk()
    text = mod.TextEncoder()
    text.update_from_iterable([list("hello"), list("world")],
                              sequence_input=True)
    text.insert_bos_eos(bos_label="<s>", eos_label="</s>")
    ctc = mod.CTCTextEncoder()
    ctc.update_from_iterable(["abca", "bb"], sequence_input=True)
    ctc.insert_blank(index=0)
    ctc.add_unk()
    return enc, text, ctc


def test_encoders_match_jax_and_return_tensors(tmp_path):
    ours, theirs = _fill(encoder), _fill(jencoder)
    for o, t in zip(ours, theirs):
        assert o.lab2ind == t.lab2ind and o.ind2lab == t.ind2lab
    enc, text, ctc = ours
    jenc, jtext, jctc = theirs
    got = enc.encode_sequence_torch(["a", "z", "c"])
    want = jenc.encode_sequence_torch(["a", "z", "c"])
    assert got.dtype == torch.int64 and got.tolist() == want.tolist()
    assert enc.encode_label_torch("b").tolist() == \
        jenc.encode_label_torch("b").tolist()
    assert enc.decode_torch(got) == jenc.decode_torch(want)
    assert enc.decode_ndim(torch.tensor([[2, 3], [4, 2]])) == \
        jenc.decode_ndim(np.asarray([[2, 3], [4, 2]]))
    assert text.encode_sequence(list("hold"), allow_unk=False) == \
        jtext.encode_sequence(list("hold"), allow_unk=False)
    assert text.prepend_bos_index([5, 6]) == jtext.prepend_bos_index([5, 6])
    assert text.append_eos_label(["h"]) == jtext.append_eos_label(["h"])
    raw = [0, 1, 1, 0, 2, 2, 0, 0, 3]
    assert ctc.collapse_indices_ndim([raw, raw[:4]]) == \
        jctc.collapse_indices_ndim([raw, raw[:4]])
    assert ctc.collapse_labels(list("aa_b")) == \
        jctc.collapse_labels(list("aa_b"))
    with pytest.raises(KeyError):
        text.encode_label("?")


@pytest.mark.parametrize("which", [0, 1, 2])
def test_encoder_files_load_across_packages(tmp_path, which):
    ours, theirs = _fill(encoder)[which], _fill(jencoder)[which]
    ours.save(tmp_path / "ours.txt")
    theirs.save(tmp_path / "theirs.txt")
    assert (tmp_path / "ours.txt").read_text() == \
        (tmp_path / "theirs.txt").read_text()
    back = type(ours).from_saved(tmp_path / "theirs.txt")
    assert back.lab2ind == theirs.lab2ind
    jback = type(theirs).from_saved(tmp_path / "ours.txt")
    assert jback.lab2ind == ours.lab2ind


def test_encoder_load_or_create_on_one_process(tmp_path):
    path = tmp_path / "enc.txt"
    made = encoder.CategoricalEncoder().load_or_create(
        path, from_iterables=[["x", "y"]])
    again = encoder.CategoricalEncoder().load_or_create(
        path, from_iterables=[["z"]])
    assert made.lab2ind == again.lab2ind == {"x": 0, "y": 1}


# ------------------------------------------------------------ iterators
def test_dynamic_bucketed_batch_matches_jax():
    rng = np.random.default_rng(6)
    data = [{"id": f"u{i}", "len": int(n)}
            for i, n in enumerate(rng.integers(10, 300, 97))]
    kwargs = dict(len_key="len", buffersize=20, sampler_kwargs=dict(
        target_batch_numel=600, max_batch_size=8, max_padding_ratio=0.4))
    random.seed(3)
    want = [[d["id"] for d in b]
            for b in jiterators.dynamic_bucketed_batch(iter(data), **kwargs)]
    random.seed(3)
    got = [[d["id"] for d in b]
           for b in iterators.dynamic_bucketed_batch(iter(data), **kwargs)]
    assert got == want and sum(map(len, got)) == len(data)
    assert iterators.padding_ratio([4, 4, 8]) == \
        jiterators.padding_ratio([4, 4, 8])
    buf = [iterators.LengthItem(n, str(n)) for n in (2, 3, 4, 8, 9)]
    jbuf = [jiterators.LengthItem(n, str(n)) for n in (2, 3, 4, 8, 9)]
    for pivot in range(5):
        assert iterators.indices_around_random_pivot(
            buf, 12, max_batch_numel=20,
            randint_generator=lambda a, b: pivot) == \
            jiterators.indices_around_random_pivot(
                jbuf, 12, max_batch_numel=20,
                randint_generator=lambda a, b: pivot)
    assert sorted([iterators.RatioIndex(1, 0.5), iterators.RatioIndex(0, 0.1)
                   ])[0].index == 0


# ------------------------------------------------------- WER and edits
def _utterances():
    refs = {"a": "the cat sat on the mat".split(), "b": "hello world".split(),
            "c": ["quiet"], "d": "one two three".split()}
    hyps = {"a": "the cat sit on mat".split(), "b": "hello big world".split(),
            "c": [], "d": "one two three".split()}
    return refs, hyps


def test_edit_distance_and_wer_text_match_jax():
    refs, hyps = _utterances()
    outs = []
    for ed, w in ((edit_distance, wer), (jedit, jwer)):
        details = ed.wer_details_by_utterance(refs, hyps,
                                              compute_alignments=True)
        summary = ed.wer_summary(details)
        speakers = ed.wer_details_by_speaker(
            details, {"a": "s1", "b": "s1", "c": "s2", "d": "s2"})
        top = ed.top_wer_utts(details, top_k=3)
        top_spk = ed.top_wer_spks(speakers, top_k=2)
        text = io.StringIO()
        w.print_wer_summary(summary, file=text)
        w.print_alignments(details, file=text)
        w._print_top_wer_utts(*top, file=text)
        w._print_top_wer_spks(top_spk, file=text)
        stats = ed.accumulatable_wer_stats(list(refs.values()),
                                           list(hyps.values()))
        table = ed.op_table(refs["a"], hyps["a"])
        outs.append((text.getvalue(), summary, details, speakers, stats,
                     [list(r) for r in table], ed.alignment(table),
                     ed.count_ops(table)))
    assert outs[0] == outs[1]
    assert "%WER" in outs[0][0]


def test_error_rate_stats_match_jax():
    pred = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0]])
    tgt = np.asarray([[1, 3, 3, 9], [4, 5, 6, 0]])
    lens = np.asarray([1.0, 0.75])
    results = []
    for mod, conv in ((metric_stats, torch.as_tensor), (jmetric_stats,
                                                          np.asarray)):
        stats = mod.ErrorRateStats()
        stats.append(["x", "y"], conv(pred), conv(tgt), conv(lens),
                     conv(lens))
        text = io.StringIO()
        stats.write_stats(text)
        results.append((stats.summarize(), text.getvalue()))
        chars = mod.ErrorRateStats(split_tokens=True)
        chars.append(["x"], [["ab", "c"]], [["abd"]])
        results.append(chars.summarize("error_rate"))
    assert results[:2] == results[2:]


# ---------------------------------------------------------------- metrics
@pytest.mark.parametrize("seed", [0, 1])
def test_binary_metrics_eer_and_min_dcf_match_jax(seed):
    rng = np.random.default_rng(seed)
    pos = rng.normal(1.0, 1.0, 60).astype(np.float32)
    neg = rng.normal(-0.5, 1.0, 90).astype(np.float32)
    assert metric_stats.eer_threshold(pos, neg) == \
        jmetric_stats.eer_threshold(pos, neg)
    assert metric_stats.EER(torch.from_numpy(pos), torch.from_numpy(neg)) == \
        jmetric_stats.EER(pos, neg)
    assert metric_stats.minDCF(pos, neg, p_target=0.05) == \
        jmetric_stats.minDCF(pos, neg, p_target=0.05)
    scores = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones(60), np.zeros(90)])
    for kw in ({}, {"threshold": 0.2}, {"max_samples": 20}):
        ours = metric_stats.BinaryMetricStats()
        theirs = jmetric_stats.BinaryMetricStats()
        ours.append([f"i{k}" for k in range(150)], torch.from_numpy(scores),
                    torch.from_numpy(labels))
        theirs.append([f"i{k}" for k in range(150)], scores, labels)
        assert ours.summarize(**kw) == theirs.summarize(**kw)


def test_sequence_and_multiprocess_evaluation_match_jax():
    pred = [np.arange(5.0), np.ones(5), np.zeros(5)]
    tgt = [np.zeros(5), np.ones(5), np.arange(5.0)]

    def metric(p, t, scale=1.0):
        return scale * float(np.abs(p - t).sum())

    for jobs in (1, 3):
        assert metric_stats.multiprocess_evaluation(
            metric, pred, tgt, n_jobs=jobs, scale=2.0) == \
            jmetric_stats.multiprocess_evaluation(
                metric, pred, tgt, n_jobs=jobs, scale=2.0)
    assert metric_stats.sequence_evaluation(metric, pred, tgt) == \
        jmetric_stats.sequence_evaluation(metric, pred, tgt)


# ---------------------------------------------------------------- loggers
def test_loggers_name_a_missing_package(monkeypatch, tmp_path):
    import builtins

    real = builtins.__import__

    def refuse(name, *args, **kwargs):
        if name in ("wandb", "torch.utils.tensorboard"):
            raise ImportError(f"no {name}")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", refuse)
    with pytest.raises(ImportError, match="wandb"):
        train_logger.WandBLogger()
    with pytest.raises(ImportError, match="tensorboard"):
        train_logger.TensorboardLogger(str(tmp_path))


def test_wandb_logger_logs_through_its_run():
    logged = []

    class Run:
        def log(self, data, step=None):
            logged.append((data, step))

    import sys
    import types

    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: Run()
    sys.modules["wandb"] = fake
    try:
        log = train_logger.WandBLogger(project="p")
    finally:
        del sys.modules["wandb"]
    log.log_stats({"epoch": 2, "lr": 0.1}, train_stats={"loss": 1.5})
    assert logged == [({"train": {"loss": 1.5}, "epoch": 2, "lr": 0.1}, 2)]


def test_tensorboard_logger_writes_events(tmp_path):
    pytest.importorskip("tensorboard")
    log = train_logger.TensorboardLogger(str(tmp_path))
    log.log_stats({"epoch": 1}, train_stats={"loss": [1.0, 0.5]},
                  valid_stats={"loss": 0.7})
    log.writer.flush()
    assert log.global_step == {"train": {"loss": 2}, "valid": {"loss": 1},
                               "test": {}, "meta": 1}
    assert any(f.startswith("events.") for f in os.listdir(tmp_path))


# --------------------------------------------------- audio and legacy CSV
@pytest.mark.parametrize("rate,channels,mix", [
    (16000, 1, "avg-to-mono"), (8000, 2, "avg-to-mono"), (44100, 2, "keep"),
    (22050, 1, "keep")])
def test_audio_normalizer_matches_jax(rate, channels, mix):
    rng = np.random.default_rng(rate)
    shape = (rate // 10,) if channels == 1 else (rate // 10, channels)
    audio = rng.standard_normal(shape).astype(np.float32)
    got = preprocess.AudioNormalizer(16000, mix)(torch.from_numpy(audio),
                                                  rate)
    want = jpreprocess.AudioNormalizer(16000, mix)(audio, rate)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        preprocess.AudioNormalizer(mix="sum")


def test_extended_csv_dataset_matches_jax(tmp_path):
    from svt_speechbrain_tpu.dataio.dataio import write_audio

    rng = np.random.default_rng(8)
    rows = ["ID, duration, wav, wav_format, wav_opts, text, text_format, "
            "text_opts"]
    for i, dur in enumerate((1.0, 0.25, 0.5, 2.0)):
        path = tmp_path / f"u{i}.wav"
        write_audio(str(path), (0.1 * rng.standard_normal(int(dur * 16000)))
                    .astype(np.float32), 16000)
        rows.append(f"u{i}, {dur}, $root/u{i}.wav, wav, , word{i}, string, ")
    csv_path = tmp_path / "data.csv"
    csv_path.write_text("\n".join(rows) + "\n")
    for sorting in ("original", "ascending", "descending"):
        kw = dict(replacements={"root": str(tmp_path)}, sorting=sorting,
                  max_duration=1.5)
        ours = legacy.ExtendedCSVDataset(str(csv_path), **kw)
        theirs = jlegacy.ExtendedCSVDataset(str(csv_path), **kw)
        assert len(ours) == len(theirs) == 3
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert a["text_data"] == b["text_data"]
            np.testing.assert_array_equal(np.asarray(a["wav_data"]),
                                          np.asarray(b["wav_data"]))


# ------------------------------------------------ callchains, superpowers
def test_lengths_capable_chain_is_a_module():
    from svt_speechbrain_tpu_torch.nnet.linear import Linear

    head = Linear(input_size=4, n_neurons=3)
    chain = callchains.LengthsCapableChain(head, lambda x, lengths: x * lengths)
    assert isinstance(chain, torch.nn.Module)
    assert [n for n, _ in chain.named_parameters()] == ["mods.0.w",
                                                        "mods.0.b"]
    assert chain.takes_lengths == [False, True]
    x = torch.ones(2, 4)
    assert torch.equal(chain(x, lengths=2.0), head(x) * 2.0)
    jchain = jcallchains.LengthsCapableChain(lambda x: x + 1,
                                             lambda x, lengths: x * lengths)
    pchain = callchains.LengthsCapableChain(lambda x: x + 1,
                                            lambda x, lengths: x * lengths)
    assert pchain(2, lengths=10) == jchain(2, lengths=10) == 30
    assert callchains.LengthsCapableChain()(1) is None


def test_superpowers_match_jax(tmp_path):
    path = tmp_path / "mod.py"
    path.write_text("VALUE = 7\n")
    assert superpowers.import_from_path(str(path)).VALUE == \
        jsuperpowers.import_from_path(str(path)).VALUE == 7
    assert superpowers.run_shell("echo hi; exit 3") == \
        jsuperpowers.run_shell("echo hi; exit 3")
