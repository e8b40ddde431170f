"""Port parity, tokenizers and n-gram language models: ``spm_lite`` (unigram,
BPE, char and word models trained on one corpus in both packages: the same
pieces, scores, ids and model bytes), ``spm_proto``'s read and write, the
``SentencePiece`` wrapper trained from a CSV and a JSON manifest through
its four tasks (tensors in the port where the JAX wrapper takes numpy),
``CharTokenizer``/``WordTokenizer``, and ``lm/{arpa,counting,ngram}.py``.
The port's copies are held bit for bit: equal values, equal bytes."""
import collections
import csv
import io
import json

import numpy as np
import pytest
import torch

from svt_speechbrain_tpu.lm import arpa as jarpa
from svt_speechbrain_tpu.lm import counting as jcount
from svt_speechbrain_tpu.lm import ngram as jngram
from svt_speechbrain_tpu.tokenizers import sentence_piece as jsp
from svt_speechbrain_tpu.tokenizers import spm_lite as jlite
from svt_speechbrain_tpu.tokenizers import spm_proto as jproto

from svt_speechbrain_tpu_torch.lm import arpa as tarpa
from svt_speechbrain_tpu_torch.lm import counting as tcount
from svt_speechbrain_tpu_torch.lm import ngram as tngram
from svt_speechbrain_tpu_torch.tokenizers import sentence_piece as tsp
from svt_speechbrain_tpu_torch.tokenizers import spm_lite as tlite
from svt_speechbrain_tpu_torch.tokenizers import spm_proto as tproto

CORPUS = ["the cat sat on the mat", "the cat ate the rat",
          "a rat sat on a mat", "the mat sat on the cat"] * 3
QUERIES = ["the cat sat", "a mat ate the rat", "taste the mate",
           "zebra on the cat"]


def _files(prefix):
    return {ext: open(prefix + ext, "rb").read() for ext in (".model",
                                                            ".vocab")}


@pytest.mark.parametrize("model_type,vocab_size,kw", [
    ("unigram", 28, {}),
    ("unigram", 32, dict(bos_id=1, eos_id=2,
                         user_defined_symbols="<sep>,<cls>")),
    ("bpe", 29, {}),
    ("char", 64, dict(unk_id=60, pad_id=63)),
    ("word", 20, {}),
    ("unigram", 30, dict(model_format="json"))])
def test_spm_lite_trains_the_same_model(tmp_path, model_type, vocab_size,
                                        kw):
    txt = str(tmp_path / "corpus.txt")
    jlite._write_lines(CORPUS, txt)
    out = {}
    for name, lite in (("jax", jlite), ("port", tlite)):
        prefix = str(tmp_path / f"{name}_{model_type}")
        lite.SentencePieceTrainer.train(
            input=txt, model_prefix=prefix, vocab_size=vocab_size,
            model_type=model_type, **kw)
        sp = lite.SentencePieceProcessor()
        sp.load(prefix + ".model")
        out[name] = (sp, _files(prefix))
    (jsp_, jfiles), (tsp_, tfiles) = out["jax"], out["port"]
    assert tfiles == jfiles
    assert tsp_.pieces == jsp_.pieces and tsp_.scores == jsp_.scores
    assert tsp_.vocab_size() == jsp_.vocab_size()
    for q in QUERIES:
        assert tsp_.encode_as_pieces(q) == jsp_.encode_as_pieces(q)
        ids = tsp_.encode_as_ids(q)
        assert ids == jsp_.encode_as_ids(q)
        assert tsp_.decode_ids(ids) == jsp_.decode_ids(ids)


def test_spm_lite_query_string_form(tmp_path):
    txt = str(tmp_path / "corpus.txt")
    tlite._write_lines(CORPUS, txt)
    files = []
    for name, lite in (("jax", jlite), ("port", tlite)):
        prefix = str(tmp_path / name)
        lite.SentencePieceTrainer.train(
            f"--input={txt} --model_prefix={prefix} --model_type=bpe"
            f" --bos_id=-1 --eos_id=-1 --pad_id=-1 --unk_id=0"
            f" --max_sentencepiece_length=10 --character_coverage=1.0"
            f" --add_dummy_prefix=True --vocab_size=26")
        files.append(_files(prefix))
    assert files[0] == files[1]


def test_spm_proto_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)] + [
        (f"▁p{i}", float(np.float32(-rng.uniform(1, 12))), 1)
        for i in range(40)] + [("<sep>", 0.0, 4)]
    for kw in (dict(model_type="unigram", unk_id=0, bos_id=1, eos_id=2,
                    vocab_size=len(pieces)),
               dict(model_type="bpe", add_dummy_prefix=False,
                    split_by_whitespace=False, max_sentencepiece_length=8)):
        raw = tproto.write_model(pieces, **kw)
        assert raw == jproto.write_model(pieces, **kw)
        assert tproto.read_model(raw) == jproto.read_model(raw)
        assert tproto.read_model(raw)["pieces"] == pieces
        assert tproto.looks_like_model_proto(raw)
        assert not tproto.looks_like_model_proto(b"{")
    # a processor loads what the writer wrote, in both packages alike
    path_ids = []
    for name, lite, proto in (("jax", jlite, jproto),
                              ("port", tlite, tproto)):
        path = tmp_path / f"{name}.model"
        path.write_bytes(proto.write_model(
            pieces[:3] + [("▁the", -1.0, 1), ("▁cat", -1.5, 1)]
            + [(c, -5.0, 1) for c in "thecat▁"], unk_id=0))
        sp = lite.SentencePieceProcessor()
        sp.load(str(path))
        path_ids.append(sp.encode_as_ids("the cat tac"))
    assert path_ids[0] == path_ids[1] and len(path_ids[0]) == 6


def _manifest(tmp_path, fmt):
    rows = [{"ID": str(i), "wrd": s} for i, s in enumerate(CORPUS)]
    if fmt == "csv":
        path = tmp_path / "train.csv"
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["ID", "wrd"])
            w.writeheader()
            w.writerows(rows)
    else:
        path = tmp_path / "train.json"
        path.write_text(json.dumps({r["ID"]: {"wrd": r["wrd"]}
                                    for r in rows}))
    return str(path)


@pytest.mark.parametrize("fmt,model_type", [("csv", "unigram"),
                                            ("json", "bpe")])
def test_sentence_piece_wrapper(tmp_path, fmt, model_type):
    path = _manifest(tmp_path, fmt)
    kw = dict(annotation_train=path, annotation_read="wrd",
              model_type=model_type, annotation_format=fmt,
              annotation_list_to_check=[path])
    jtok = jsp.SentencePiece(str(tmp_path / "jax"), 27, **kw)
    ttok = tsp.SentencePiece(str(tmp_path / "port"), 27, **kw)
    assert (_files(ttok.prefix_model_file)
            == _files(jtok.prefix_model_file))
    # encode: (B, L) label indices with relative lengths and an ind2lab
    words = sorted({w for s in CORPUS for w in s.split()})
    ind2lab = dict(enumerate(words))
    lab2ind = {w: i for i, w in ind2lab.items()}
    batch = np.zeros((3, 6), np.int64)
    sents = [CORPUS[0].split(), CORPUS[1].split()[:3], ["rat"]]
    for i, s in enumerate(sents):
        batch[i, :len(s)] = [lab2ind[w] for w in s]
    lens = np.asarray([len(s) / 6 for s in sents], np.float32)
    ids, id_lens = ttok(torch.from_numpy(batch), torch.from_numpy(lens),
                        ind2lab, task="encode")
    jids, jid_lens = jtok(batch, lens, ind2lab, task="encode")
    assert ids.dtype == torch.float32 and ids.device.type == "cpu"
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(id_lens.numpy(), jid_lens)
    # decode back to words, from tensors and from lists
    assert ttok(ids, id_lens, task="decode") == jtok(jids, jid_lens,
                                                     task="decode")
    assert ttok(ids, id_lens, task="decode") == [s for s in sents]
    lists = [[int(t) for t in row[:round(float(n) * ids.shape[1])]]
             for row, n in zip(ids, id_lens)]
    assert (ttok(lists, task="decode_from_list")
            == jtok(lists, task="decode_from_list"))
    fl, fl_lens = ttok(sents, task="encode_from_list")
    jfl, jfl_lens = jtok(sents, task="encode_from_list")
    np.testing.assert_array_equal(fl.numpy(), jfl)
    np.testing.assert_array_equal(fl_lens.numpy(), jfl_lens)
    with pytest.raises(ValueError):
        ttok(ids, id_lens, task="encode")


def test_sentence_piece_char_format_and_reuse(tmp_path):
    path = _manifest(tmp_path, "csv")
    rows = [r for r in csv.DictReader(open(path))]
    with open(path, "w", newline="") as f:     # char-format labels
        w = csv.DictWriter(f, fieldnames=["ID", "wrd"])
        w.writeheader()
        w.writerows([{"ID": r["ID"], "wrd": " ".join(
            r["wrd"].replace(" ", "_"))} for r in rows])
    kw = dict(annotation_train=path, annotation_read="wrd",
              model_type="unigram", char_format_input=True,
              num_sequences=5)
    jtok = jsp.SentencePiece(str(tmp_path / "jax"), 24, **kw)
    ttok = tsp.SentencePiece(str(tmp_path / "port"), 24, **kw)
    assert open(ttok.prefix_model_file + ".txt").read() == open(
        jtok.prefix_model_file + ".txt").read()
    assert (_files(ttok.prefix_model_file)
            == _files(jtok.prefix_model_file))
    chars = [list("the_cat"), list("a_mat")]
    np.testing.assert_array_equal(
        ttok(chars, task="encode_from_list")[0].numpy(),
        jtok(chars, task="encode_from_list")[0])
    again = tsp.SentencePiece(str(tmp_path / "port"), 24)   # no training
    assert again.sp.pieces == ttok.sp.pieces


def test_char_and_word_tokenizers():
    for fit in (["hello", "world"], ["abc", "cab"]):
        tc, jc = tsp.CharTokenizer(vocab=fit), jsp.CharTokenizer(vocab=fit)
        for text in ("hello", "cab", "zz"):
            assert tc.encode(text) == jc.encode(text)
            assert tc.decode(tc.encode(text)) == jc.decode(jc.encode(text))
        assert tc.vocab_size == jc.vocab_size
        assert tc(["ab", "c"]) == jc(["ab", "c"])
        assert tc([[1, 2]], task="decode") == jc([[1, 2]], task="decode")
    tw = tsp.WordTokenizer().fit(["the quick fox", "lazy dog"])
    jw = jsp.WordTokenizer().fit(["the quick fox", "lazy dog"])
    for text in ("quick dog", "the cat"):
        assert tw.encode(text) == jw.encode(text)
        assert tw.decode(tw.encode(text)) == jw.decode(jw.encode(text))


ARPA = """\\data\\
ngram 1=5
ngram 2=4
ngram 3=2

\\1-grams:
-1.0 <s>
-1.3 hello -0.5
-1.3 world -0.4
-1.2 </s>
-1.9 again -0.2

\\2-grams:
-0.3 <s> hello -0.1
-0.5 hello world -0.3
-0.4 world </s>
-0.6 world again

\\3-grams:
-0.2 <s> hello world
-0.1 hello world again

\\end\\
"""


def test_arpa_counting_and_backoff_lm():
    tnum, tgrams, tback = tarpa.read_arpa(io.StringIO(ARPA))
    assert (tnum, tgrams, tback) == jarpa.read_arpa(io.StringIO(ARPA))
    tlm = tngram.BackoffNgramLM(tgrams, tback)
    jlm = jngram.BackoffNgramLM(tgrams, tback)
    assert tlm.top_order == jlm.top_order == 3
    sents = [["hello", "world", "again"], ["world", "hello"], ["again"]]
    for seq in sents:
        padded = list(tcount.pad_ends(seq))
        assert padded == list(jcount.pad_ends(seq))
        assert (list(tcount.pad_ends(seq, pad_left=False))
                == list(jcount.pad_ends(seq, pad_left=False)))
        for n in (1, 2, 3):
            assert list(tcount.ngrams(padded, n)) == list(
                jcount.ngrams(padded, n))
        for first in (True, False):
            assert list(tcount.ngrams_for_evaluation(padded, 3, first)) \
                == list(jcount.ngrams_for_evaluation(padded, 3, first))
    with pytest.raises(ValueError):
        list(tcount.ngrams([], 0))
    for token, context in [("world", ("<s>", "hello")), ("</s>", ("hello",)),
                           ("again", ("hello", "world")), ("world", ()),
                           ("world", ("zzz", "yyy")), ("hello", ("again",))]:
        assert tlm.logprob(token, context) == jlm.logprob(token, context)
    data = [list(tcount.ngrams_for_evaluation(list(tcount.pad_ends(s)), 3,
                                              True)) for s in sents]
    details = tngram.ngram_evaluation_details(data, tlm)
    assert details == jngram.ngram_evaluation_details(data, jlm)
    assert all(isinstance(d, collections.Counter) for d in details)
    assert (tngram.ngram_perplexity(details)
            == jngram.ngram_perplexity(details))
    assert (tngram.ngram_perplexity(details, logbase=2.0)
            == jngram.ngram_perplexity(details, logbase=2.0))
    tc, jc = tngram.CountNgramCounter(3), jngram.CountNgramCounter(3)
    for s in sents + [CORPUS[0].split()]:
        tc.add_sentence(s)
        jc.add_sentence(s)
    assert tc.counts == jc.counts


def test_copied_modules_import_nothing_of_jax():
    import ast
    import pathlib

    root = pathlib.Path(tsp.__file__).resolve().parents[1]
    for rel in ("tokenizers/spm_lite.py", "tokenizers/spm_proto.py",
                "tokenizers/sentence_piece.py", "lm/arpa.py",
                "lm/counting.py", "lm/ngram.py"):
        for node in ast.walk(ast.parse((root / rel).read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                for name in names:
                    assert not (name or "").startswith("jax"), (rel, name)
                    assert not (name or "").startswith(
                        "svt_speechbrain_tpu."), (rel, name)
