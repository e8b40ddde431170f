"""Back-off n-gram LM (analogue of reference ``speechbrain/lm/ngram.py``).

Reference-exact (golden-tested in ``tests/test_lm_golden.py``): the Katz
back-off recursion, the evaluation-details contract (sentences of
``(token, context)`` pairs → ``collections.Counter`` per sentence), and the
perplexity aggregation. ``CountNgramCounter`` is a TPU-side counting
utility addition.

The port's copy of ``svt_speechbrain_tpu/lm/ngram.py`` (pure Python), kept
identical.
"""
from __future__ import annotations

import collections

NEGINFINITY = float("-inf")


class BackoffNgramLM:
    """Query interface over ARPA-style ngrams/backoffs
    (reference ``ngram.py:12``): ``logprob(token, context)`` applies the
    standard Katz back-off recursion. ``ngrams[order][context][token]`` and
    ``backoffs[order][context]`` hold log-probabilities / back-off weights;
    the backoff dict must cover order N or N-1 like the reference.

    Example
    -------
    >>> ngrams = {1: {(): {"a": -0.5, "b": -1.0}},
    ...           2: {("a",): {"b": -0.2}}}
    >>> backoffs = {1: {("a",): -0.3}}
    >>> lm = BackoffNgramLM(ngrams, backoffs)
    >>> lm.logprob("b", context=("a",))      # bigram hit
    -0.2
    >>> round(lm.logprob("a", context=("a",)), 1)   # backoff + unigram
    -0.8
    """

    def __init__(self, ngrams, backoffs):
        order = len(ngrams)
        if not (len(backoffs) == order or len(backoffs) == order - 1):
            raise ValueError("Backoffs dict needs to be of order N or N-1")
        self.ngrams = ngrams
        self.backoffs = backoffs
        self.top_order = order

    def logprob(self, token, context=tuple()):
        context = tuple(context)
        query_order = len(context) + 1
        if query_order > self.top_order:
            return self.logprob(token, context[1:])
        table = self.ngrams[query_order]
        if context in table and token in table[context]:
            return table[context][token]
        if query_order == 1:
            return NEGINFINITY
        backoff_log_weight = self.backoffs[query_order - 1].get(context, 0.0)
        return self.logprob(token, context[1:]) + backoff_log_weight


def ngram_evaluation_details(data, LM):
    """Per-sentence evaluation (reference ``ngram.py:108``): ``data`` is an
    iterator over sentences of ``(token, context)`` pairs (the output of
    ``counting.ngrams_for_evaluation``); returns one
    ``collections.Counter({"num_tokens", "neglogprob"})`` per sentence.

    Example
    -------
    >>> class MockLM:
    ...     top_order = 2
    ...     def logprob(self, token, context):
    ...         return -1.0
    >>> details = ngram_evaluation_details(
    ...     [[("a", ("<s>",)), ("b", ("a",))]], MockLM())
    >>> details[0]["num_tokens"], details[0]["neglogprob"]
    (2, 2.0)
    """
    details = []
    for sentence in data:
        counter = collections.Counter()
        for token, context in sentence:
            counter["num_tokens"] += 1
            counter["neglogprob"] += -LM.logprob(token, context)
        details.append(counter)
    return details


def ngram_perplexity(eval_details, logbase=10.0):
    """Aggregate perplexity over sentence Counters (reference ``ngram.py:170``).

    Example
    -------
    >>> import collections
    >>> ngram_perplexity([
    ...     collections.Counter(neglogprob=5, num_tokens=5),
    ...     collections.Counter(neglogprob=15, num_tokens=15)])
    10.0
    """
    counter = sum(eval_details, collections.Counter())
    exponent = counter["neglogprob"] / counter["num_tokens"]
    return logbase ** exponent


class CountNgramCounter:
    """Simple n-gram counting helper for training small LMs (TPU-side
    utility; the reference counts via ``counting.ngrams`` in recipes)."""

    def __init__(self, order):
        self.order = order
        self.counts = [collections.Counter() for _ in range(order)]

    def add_sentence(self, tokens):
        for n in range(1, self.order + 1):
            for i in range(len(tokens) - n + 1):
                self.counts[n - 1][tuple(tokens[i:i + n])] += 1
