"""ARPA LM file reading (analogue of reference ``speechbrain/lm/arpa.py``).

The port's copy of ``svt_speechbrain_tpu/lm/arpa.py`` (pure Python), kept
identical.
"""
from __future__ import annotations


def read_arpa(fstream):
    """Read an ARPA file → (num_grams_by_order, ngrams, backoffs)
    (reference ``arpa.py:68``).

    ``ngrams[order][context][token] = logprob``;
    ``backoffs[order][context_tuple] = backoff_logprob``.

    Example
    -------
    >>> import io
    >>> arpa = io.StringIO('''
    ... \\\\data\\\\
    ... ngram 1=2
    ...
    ... \\\\1-grams:
    ... -0.5\\ta
    ... -1.0\\tb\\t-0.30103
    ...
    ... \\\\end\\\\
    ... ''')
    >>> counts, ngrams, backoffs = read_arpa(arpa)
    >>> counts[1], ngrams[1][()]["a"], backoffs[1][("b",)]
    (2, -0.5, -0.30103)
    """
    num_ngrams = {}
    ngrams_by_order = {}
    backoffs_by_order = {}
    lines = iter(fstream)
    for line in lines:
        if line.strip() == "\\data\\":
            break
    else:
        raise ValueError("Not a properly formatted ARPA file (no \\data\\)")
    for line in lines:
        line = line.strip()
        if not line:
            break
        if line.startswith("ngram"):
            head, count = line.split("=")
            order = int(head.split()[1].split("=")[0])
            num_ngrams[order] = int(count)
    # n-gram sections
    cur_order = None
    for line in lines:
        line = line.strip()
        if line == "\\end\\":
            break
        if not line:
            continue
        if line.startswith("\\") and line.endswith("-grams:"):
            cur_order = int(line[1:].split("-")[0])
            ngrams_by_order[cur_order] = {}
            backoffs_by_order[cur_order] = {}
            continue
        if cur_order is None:
            continue
        parts = line.split("\t")
        if len(parts) < 2:
            parts = line.split()
            prob = float(parts[0])
            tokens = tuple(parts[1:1 + cur_order])
            backoff = float(parts[1 + cur_order]) if len(parts) > 1 + cur_order else None
        else:
            prob = float(parts[0])
            tokens = tuple(parts[1].split())
            backoff = float(parts[2]) if len(parts) > 2 else None
        context = tokens[:-1]
        token = tokens[-1]
        ngrams_by_order[cur_order].setdefault(context, {})[token] = prob
        if backoff is not None:
            backoffs_by_order[cur_order][tokens] = backoff
    return num_ngrams, ngrams_by_order, backoffs_by_order
