"""Padded batch data (port of ``svt_speechbrain_tpu/dataio/batch.py:20``).

``PaddedData(data, lengths)`` pairs a right-padded array with its rows'
*relative* lengths (length / padded length), the convention the
length-masked losses depend on. The collating ``PaddedBatch`` and the
loaders wait for a later slice; the engine takes dicts of these pairs.
"""
from __future__ import annotations

import collections

PaddedData = collections.namedtuple("PaddedData", ["data", "lengths"])
