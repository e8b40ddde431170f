"""Padding helpers of the data loaders (port of the part of
``svt_speechbrain_tpu/utils/data_utils.py`` that ``PaddedBatch`` and
``ErrorRateStats`` need).

They work on numpy arrays, in the loader's worker processes; ``PaddedBatch``
turns their results into tensors. ``download_file`` is not ported: nothing
is downloaded.
"""
from __future__ import annotations

import numpy as np


def undo_padding(batch, lengths):
    """Strip padding from a padded batch (an array or tensor) → list of
    lists (``data_utils.py:11``).

    Example
    -------
    >>> undo_padding([[1, 2, 0, 0], [3, 4, 5, 6]], [0.5, 1.0])
    [[1, 2], [3, 4, 5, 6]]
    """
    batch = np.asarray(batch)
    batch_max_len = batch.shape[1]
    as_list = []
    for seq, seq_length in zip(batch, lengths):
        actual_size = int(round(float(seq_length) * batch_max_len))
        as_list.append(seq[:actual_size].tolist())
    return as_list


def pad_right_to(array, target_shape, mode="constant", value=0):
    """Pad ``array`` up to ``target_shape`` on the right of every axis
    (``data_utils.py:29``). Returns (padded, valid) where valid is the list
    of original/target fractions per axis."""
    array = np.asarray(array)
    assert len(target_shape) == array.ndim
    pads, valid = [], []
    for i, target in enumerate(target_shape):
        assert target >= array.shape[i], "Target shape must be >= original shape"
        pads.append((0, target - array.shape[i]))
        valid.append(array.shape[i] / target)
    return np.pad(array, pads, mode=mode, constant_values=value), valid


def batch_pad_right(arrays, mode="constant", value=0, target_len=None):
    """Pad a list of arrays to a common shape and stack (``data_utils.py:46``);
    the first axis is padded to at least ``target_len``. The relative lengths
    (first axis) come back as float32, the dtype the losses' masks see.

    Example
    -------
    >>> import numpy as np
    >>> stacked, valid = batch_pad_right(
    ...     [np.asarray([1.0, 2.0, 3.0]), np.asarray([4.0])], target_len=4)
    >>> stacked.shape
    (2, 4)
    >>> [round(float(v), 2) for v in valid]
    [0.75, 0.25]
    """
    assert len(arrays), "input should be a non-empty list"
    if not any(arrays[0].ndim == x.ndim for x in arrays[1:]) and len(arrays) > 1:
        raise IndexError("All arrays must have same number of dimensions")
    for dim in range(1, arrays[0].ndim):
        if not all(x.shape[dim] == arrays[0].shape[dim] for x in arrays[1:]):
            raise IndexError("arrays should have matching shapes on all axes "
                             "but the first")
    max_shape = []
    for dim in range(arrays[0].ndim):
        m = max(x.shape[dim] for x in arrays)
        if dim == 0 and target_len is not None:
            m = max(m, int(target_len))
        max_shape.append(m)
    padded, valid = [], []
    for x in arrays:
        p, v = pad_right_to(x, max_shape, mode=mode, value=value)
        padded.append(p)
        valid.append(v[0])
    return np.stack(padded), np.array(valid, dtype=np.float32)


def round_up(x, multiple):
    """Smallest multiple of ``multiple`` ≥ x (``pad_multiples`` bucketing)."""
    return int(-(-x // multiple) * multiple)
