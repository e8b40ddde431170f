"""Webdataset-compatible dynamic bucketing iterators (a copy of
``svt_speechbrain_tpu/dataio/iterators.py``): batch a length-keyed sample
stream so padding waste stays bounded, without knowing the dataset length
upfront."""
from __future__ import annotations

import bisect
import random
from dataclasses import dataclass, field
from typing import Any


@dataclass(order=True)
class LengthItem:
    length: int
    data: Any = field(compare=False)


def total_length_with_padding(lengths):
    return len(lengths) * max(lengths)


def padding_ratio(lengths):
    """Wasted fraction when padding to the max length.

    Example
    -------
    >>> total_length_with_padding([4, 4, 8])
    24
    >>> round(padding_ratio([4, 4, 8]), 3)     # 8 of 24 slots are padding
    0.333
    """
    return 1.0 - sum(lengths) / total_length_with_padding(lengths)


def indices_around_random_pivot(databuffer, target_batch_numel,
                                max_batch_size=None, max_batch_numel=None,
                                max_padding_ratio=None, randint_generator=None):
    """Pick a random pivot in the sorted buffer and grow the batch outward
    toward the target element count (reference ``iterators.py:44``).

    Example
    -------
    >>> buf = [LengthItem(l, f"utt{l}") for l in (2, 3, 4, 8, 9)]
    >>> indices_around_random_pivot(buf, target_batch_numel=12,
    ...                             randint_generator=lambda a, b: 1)
    [0, 1, 2]
    """
    randint_generator = randint_generator or random.randint
    pivot = randint_generator(0, len(databuffer) - 1)
    lo = hi = pivot
    lengths = [databuffer[pivot].length]
    while True:
        if max_batch_size is not None and len(lengths) >= max_batch_size:
            break
        if total_length_with_padding(lengths) >= target_batch_numel:
            break
        left = databuffer[lo - 1].length if lo > 0 else None
        right = databuffer[hi + 1].length if hi + 1 < len(databuffer) else None
        if left is None and right is None:
            break
        take_left = right is None or (
            left is not None and (lengths[0] - left) <= (right - lengths[-1]))
        if take_left:
            lo -= 1
            lengths.insert(0, left)
        else:
            hi += 1
            lengths.append(right)
        if max_batch_numel is not None and \
                total_length_with_padding(lengths) > max_batch_numel:
            if take_left:
                lo += 1
                lengths.pop(0)
            else:
                hi -= 1
                lengths.pop()
            break
        if max_padding_ratio is not None and len(lengths) > 1 and \
                padding_ratio(lengths) > max_padding_ratio:
            if take_left:
                lo += 1
                lengths.pop(0)
            else:
                hi -= 1
                lengths.pop()
            break
    return list(range(lo, hi + 1))


def dynamic_bucketed_batch(data, len_key=None, sampler_kwargs=None,
                           min_sample_len=None, max_sample_len=None,
                           buffersize=1024, collate_fn=None, drop_end=False):
    """Stream → dynamically bucketed batches (reference ``iterators.py:109``).

    ``data`` yields dicts; ``len_key`` selects the length field. Batches come
    from ``indices_around_random_pivot`` over a sorted reservoir.
    """
    sampler_kwargs = sampler_kwargs or {"target_batch_numel": 32000}
    databuffer = []
    for sample in data:
        length = sample[len_key] if len_key is not None else len(sample)
        if min_sample_len is not None and length < min_sample_len:
            continue
        if max_sample_len is not None and length > max_sample_len:
            continue
        item = LengthItem(length, sample)
        bisect.insort(databuffer, item)
        if len(databuffer) >= buffersize:
            indices = indices_around_random_pivot(databuffer, **sampler_kwargs)
            batch = [databuffer[i].data for i in indices]
            for i in reversed(indices):
                del databuffer[i]
            yield collate_fn(batch) if collate_fn is not None else batch
    while databuffer and not drop_end:
        indices = indices_around_random_pivot(databuffer, **sampler_kwargs)
        batch = [databuffer[i].data for i in indices]
        for i in reversed(indices):
            del databuffer[i]
        yield collate_fn(batch) if collate_fn is not None else batch


class RatioIndex:
    """(index, ratio) pair ordered by ratio (reference
    ``iterators.py:RatioIndex``) — used when picking the worst-padding
    element to evict from the bucket buffer."""

    def __init__(self, index, ratio):
        self.index = index
        self.ratio = ratio

    def __lt__(self, other):
        return self.ratio < other.ratio
