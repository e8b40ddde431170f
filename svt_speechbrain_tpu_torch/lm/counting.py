"""N-gram counting utilities (reference ``speechbrain/lm/counting.py``).

The port's copy of ``svt_speechbrain_tpu/lm/counting.py`` (pure Python), kept
identical.
"""
from __future__ import annotations

import itertools


def pad_ends(sequence, pad_left=True, left_pad_symbol="<s>",
             right_pad_symbol="</s>"):
    """Pad sentence-boundary symbols around a token sequence
    (reference ``counting.py:16``). Returns a lazy chain like the reference.

    Example
    -------
    >>> list(pad_ends(["hello", "world"]))
    ['<s>', 'hello', 'world', '</s>']
    """
    if pad_left:
        return itertools.chain((left_pad_symbol,), tuple(sequence),
                               (right_pad_symbol,))
    return itertools.chain(tuple(sequence), (right_pad_symbol,))


def ngrams(sequence, n):
    """Yield each n-gram (as a tuple) of the sequence
    (reference ``counting.py:62``, itertools window); ``n <= 0`` raises.

    Example
    -------
    >>> list(ngrams(["a", "b", "c", "d"], 2))
    [('a', 'b'), ('b', 'c'), ('c', 'd')]
    """
    if n <= 0:
        raise ValueError("N must be >=1")
    iters = itertools.tee(sequence, n)
    for i, it in enumerate(iters):
        for _ in range(i):
            next(it, None)
    return (tuple(win) for win in zip(*iters))


def ngrams_for_evaluation(sequence, max_n, predict_first=False):
    """Yield ``(token, context-tuple)`` pairs with growing context up to
    ``max_n - 1`` (reference ``counting.py:111``): for LM evaluation where
    the first tokens only have short histories.

    Example
    -------
    >>> list(ngrams_for_evaluation(["a", "b", "c"], max_n=2))
    [('b', ('a',)), ('c', ('b',))]
    """
    if max_n <= 0:
        raise ValueError("Max N must be >=1")
    sequence = list(sequence)
    for i in range(not predict_first, len(sequence)):
        context_start = max(0, i - max_n + 1)
        yield sequence[i], tuple(sequence[context_start:i])
