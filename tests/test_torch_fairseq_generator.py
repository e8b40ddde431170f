"""Port parity, the fairseq beam generator (``decoders/fairseq_generator.py``)
against the JAX package on the CPU: a TINY decoder drawn by JAX and loaded
into the port, the same seeded encoder features, and every route of both
packages (``generate`` on its fast path and on its host path,
``generate_on_device``), with beam 1, 2 and 4 and the generator's options,
prefix forcing, LM shallow fusion and a 2-member ensemble; refusals; and a
stub decoder whose logits tie exactly, which pins the tie order.

Tolerances: tokens exact; ``score`` and ``positional_scores`` within ATOL
(f32 log-probabilities of decoders whose logits agree within 1e-5). Where
two finalized hypotheses of a sentence lie within ATOL of each other their
order is not held: the test says so, holds that rank's score, and holds its
tokens to those of one of the tied ranks.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svt_speechbrain_tpu.decoders import fairseq_generator as jgen
from svt_speechbrain_tpu.models import seq2seq_decoder as jdec

from svt_speechbrain_tpu_torch.convert_jax import load_module_tree
from svt_speechbrain_tpu_torch.decoders import fairseq_generator as tgen
from svt_speechbrain_tpu_torch.models import seq2seq_decoder as tdec

from tests.torch_threads import two_torch_threads  # noqa: F401

ATOL = 1e-5
D, V, S, B, EOS = 16, 16, 6, 3, 2


def _cfg(pkg):
    return pkg.FairseqDecoderConfig(
        vocab_size=V, embed_dim=D, ffn_dim=32, num_layers=2, num_heads=2,
        normalize_before=False, no_scale_embedding=True,
        max_target_positions=32)


def _decoders(seed):
    """A JAX decoder's params and the port's decoder loaded from them; the
    EOS row of the output embedding is scaled so that hypotheses end at
    several lengths."""
    jd = jdec.FairseqTransformerDecoder(_cfg(jdec))
    params = jax.tree_util.tree_map(np.asarray,
                                    jd.init(jax.random.PRNGKey(seed)))
    params["embed_out"] = params["embed_out"].copy()
    params["embed_out"][EOS] *= 3.0
    td = tdec.FairseqTransformerDecoder(_cfg(tdec))
    load_module_tree(td, params)
    return jd, params, td.eval()


@pytest.fixture(scope="module")
def pair():
    return _decoders(0)


@pytest.fixture(scope="module")
def enc():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    mask = np.zeros((B, S), bool)
    mask[1, S - 2:] = True
    return x, mask


def _same(want, got, what):
    """Hypothesis lists equal: tokens exact, scores within ATOL; a rank
    whose JAX score lies within ATOL of another's is held by its score and
    to the tokens of one of those ranks, and said."""
    assert len(want) == len(got), what
    for sent, (w, g) in enumerate(zip(want, got)):
        assert len(w) == len(g), (what, sent)
        ws = [h["score"] for h in w]
        for r, (hw, hg) in enumerate(zip(w, g)):
            group = [q for q in range(len(ws)) if abs(ws[r] - ws[q]) <= ATOL]
            assert abs(hw["score"] - hg["score"]) <= ATOL, (what, sent, r)
            if len(group) > 1:
                print(f"{what}: sentence {sent} rank {r} lies within {ATOL} "
                      f"of ranks {group}; its score is held, and its tokens "
                      f"are one of theirs")
                assert np.asarray(hg["tokens"]).tolist() in [
                    np.asarray(w[q]["tokens"]).tolist() for q in group]
                continue
            np.testing.assert_array_equal(np.asarray(hg["tokens"]),
                                          np.asarray(hw["tokens"]),
                                          err_msg=f"{what} {sent} {r}")
            np.testing.assert_allclose(np.asarray(hg["positional_scores"]),
                                       np.asarray(hw["positional_scores"]),
                                       rtol=0, atol=ATOL)


def _zero_lm(tokens):
    return torch.zeros(tokens.shape[0], V, device=tokens.device)


OPTIONS = {
    "beam1": dict(beam_size=1, max_len_b=8),
    "beam2_lenpen_unk_minlen": dict(beam_size=2, max_len_b=8,
                                    len_penalty=0.5, unk_penalty=0.7,
                                    min_len=3),
    "beam4_temp_lena_unnormalized": dict(beam_size=4, max_len_a=0.5,
                                         max_len_b=4, temperature=1.3,
                                         normalize_scores=False),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_generate_matches_jax_on_every_route(pair, enc, name):
    """JAX ``generate`` (its fast path) against the port's fast path, its
    host path (forced by an LM of zeros) and ``generate_on_device``."""
    jd, params, td = pair
    x, mask = enc
    kw = OPTIONS[name]
    want = jgen.FairseqSequenceGenerator(jd, **kw).generate(
        params, jnp.asarray(x), jnp.asarray(mask))
    fast = tgen.FairseqSequenceGenerator(td, **kw)
    got = fast.generate(torch.from_numpy(x), torch.from_numpy(mask))
    _same(want, got, f"{name} fast path")
    assert fast.stats["host_reads"] == fast.stats["steps"]
    host = tgen.FairseqSequenceGenerator(td, lm=_zero_lm, **kw)
    _same(want, host.generate(torch.from_numpy(x), torch.from_numpy(mask)),
          f"{name} host path")
    dev = fast.generate_on_device(torch.from_numpy(x), torch.from_numpy(mask))
    _same(want, dev, f"{name} device search")
    assert fast.stats["host_reads"] <= fast.stats["steps"] + 5


def test_some_hypotheses_end_early(pair, enc):
    """The scaled EOS row lets hypotheses end before ``max_len``, so the
    comparisons above cover finalization mid-search."""
    _, _, td = pair
    x, mask = enc
    out = tgen.FairseqSequenceGenerator(td, beam_size=2, max_len_b=8).generate(
        torch.from_numpy(x), torch.from_numpy(mask))
    lengths = {len(h["tokens"]) for hyps in out for h in hyps}
    assert min(lengths) < 9 and len(lengths) > 1, lengths


def test_device_search_matches_jax_device_search(pair, enc):
    jd, params, td = pair
    x, mask = enc
    kw = dict(beam_size=3, max_len_b=7, len_penalty=1.5)
    want = jgen.FairseqSequenceGenerator(jd, **kw).generate_on_device(
        params, jnp.asarray(x), jnp.asarray(mask), bos_token=0)
    got = tgen.FairseqSequenceGenerator(td, **kw).generate_on_device(
        torch.from_numpy(x), torch.from_numpy(mask), bos_token=0)
    _same(want, got, "device search, bos 0")


def test_prefix_forcing_matches_jax(pair, enc):
    """Forced tokens, pad (no constraint) in the prefix, and an EOS in the
    prefix, which replicates beam 0 across the sentence's beams."""
    jd, params, td = pair
    x, mask = enc
    prefix = np.array([[5, 7, 1], [1, 9, 4], [6, EOS, 1]], np.int64)
    kw = dict(beam_size=3, max_len_b=6)
    want = jgen.FairseqSequenceGenerator(jd, **kw).generate(
        params, jnp.asarray(x), jnp.asarray(mask), prefix_tokens=prefix)
    got = tgen.FairseqSequenceGenerator(td, **kw).generate(
        torch.from_numpy(x), torch.from_numpy(mask),
        prefix_tokens=torch.from_numpy(prefix))
    _same(want, got, "prefix")
    assert all(int(h["tokens"][0]) == 5 for h in got[0])


def _table_lm(seed):
    table = np.asarray(jax.nn.log_softmax(
        np.random.default_rng(seed).standard_normal((V, V)) * 2.0,
        axis=-1), np.float32)

    def lm(tokens):
        last = np.asarray(tokens.cpu() if torch.is_tensor(tokens)
                          else tokens)[:, -1]
        return table[last]

    return lm


def test_lm_fusion_matches_jax(pair, enc):
    jd, params, td = pair
    x, mask = enc
    kw = dict(beam_size=2, max_len_b=6, lm=_table_lm(2), lm_weight=0.4)
    want = jgen.FairseqSequenceGenerator(jd, **kw).generate(
        params, jnp.asarray(x), jnp.asarray(mask))
    got = tgen.FairseqSequenceGenerator(td, **kw).generate(
        torch.from_numpy(x), torch.from_numpy(mask))
    _same(want, got, "LM fusion")


def test_ensemble_matches_jax(pair, enc):
    jd, params, td = pair
    _, params2, td2 = _decoders(7)
    x, mask = enc
    kw = dict(beam_size=2, max_len_b=6)
    want = jgen.FairseqSequenceGenerator(jd, **kw).generate(
        [params, params2], jnp.asarray(x), jnp.asarray(mask))
    gen = tgen.FairseqSequenceGenerator([td, td2], **kw)
    _same(want, gen.generate(torch.from_numpy(x), torch.from_numpy(mask)),
          "ensemble")
    assert gen.stats["host_reads"] == 2 * gen.stats["steps"]


def test_device_search_refuses_what_jax_refuses(pair):
    jd, params, td = pair
    x = torch.zeros(1, S, D)
    with pytest.raises(ValueError, match="LM fusion"):
        tgen.FairseqSequenceGenerator(td, lm=_zero_lm).generate_on_device(x)
    with pytest.raises(ValueError, match="LM fusion"):
        jgen.FairseqSequenceGenerator(jd, lm=_zero_lm).generate_on_device(
            params, jnp.zeros((1, S, D)))
    with pytest.raises(ValueError, match="vocab-2"):
        tgen.FairseqSequenceGenerator(td, beam_size=8).generate_on_device(x)
    with pytest.raises(ValueError, match="vocab-2"):
        jgen.FairseqSequenceGenerator(jd, beam_size=8).generate_on_device(
            params, jnp.zeros((1, S, D)))
    with pytest.raises(ValueError, match="ensembles"):
        tgen.FairseqSequenceGenerator([td, td]).generate_on_device(x)


# ------------------------------------------------------------- exact ties

class _JaxStub:
    """A JAX decoder whose step logits are ``params["table"][t]``."""

    def __init__(self, cfg):
        self.cfg = cfg

    def init_cache(self, params, enc, max_len, encoder_padding_mask=None):
        return {"rows": jnp.zeros((enc.shape[0],))}

    def reorder_cache(self, cache, order):
        return {"rows": cache["rows"][order]}

    def step(self, params, cache, tokens_t, t):
        return jnp.broadcast_to(params["table"][t],
                                (tokens_t.shape[0], self.cfg.vocab_size)), \
            cache


class _TorchStub(torch.nn.Module):
    def __init__(self, cfg, table):
        super().__init__()
        self.cfg = cfg
        self.table = torch.from_numpy(table)

    def init_cache(self, enc, max_len, encoder_padding_mask=None, beam=1):
        return {"rows": enc.shape[0] * beam}

    @staticmethod
    def reorder_cache(cache, order):
        return cache

    def step(self, cache, tokens_t, t):
        return self.table[t].expand(tokens_t.shape[0], -1)


def test_exact_ties_keep_the_lower_index_first():
    """Logits that tie exactly at every step (two levels, repeated): every
    route of both packages ranks equal candidates by ascending flat index
    (beam-major), so all give the same hypotheses bit for bit."""
    cfg = _cfg(jdec)
    table = np.zeros((40, V), np.float32)
    table[:, 4:8] = 1.0                 # four tied leaders a step
    table[3::4, EOS] = 1.0              # and EOS among them every 4th step
    want = jgen.FairseqSequenceGenerator(
        _JaxStub(cfg), beam_size=3, max_len_b=9).generate(
            {"table": jnp.asarray(table)}, jnp.zeros((2, S, D)))
    jdev = jgen.FairseqSequenceGenerator(
        _JaxStub(cfg), beam_size=3, max_len_b=9).generate_on_device(
            {"table": jnp.asarray(table)}, jnp.zeros((2, S, D)))
    stub = _TorchStub(_cfg(tdec), table)
    routes = {
        "fast": tgen.FairseqSequenceGenerator(stub, beam_size=3, max_len_b=9)
        .generate(torch.zeros(2, S, D)),
        "host": tgen.FairseqSequenceGenerator(stub, beam_size=3, max_len_b=9,
                                              lm=_zero_lm)
        .generate(torch.zeros(2, S, D)),
        "device": tgen.FairseqSequenceGenerator(stub, beam_size=3,
                                                max_len_b=9)
        .generate_on_device(torch.zeros(2, S, D)),
    }
    for ref in (want, jdev):
        for route, got in routes.items():
            assert len(got) == len(ref)
            for w, g in zip(ref, got):
                assert [h["tokens"].tolist() for h in g] == \
                    [np.asarray(h["tokens"]).tolist() for h in w], route
                assert [h["score"] for h in g] == [h["score"] for h in w]
    # the lowest index wins each tie: the best hypothesis takes token 4
    assert routes["fast"][0][0]["tokens"][0] == 4
