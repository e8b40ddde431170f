"""Data helpers (port of ``svt_speechbrain_tpu/utils/data_utils.py``):
padding for the loaders, file listing, list splitting, nested-dict walks,
``recursive_to`` over tensors and a tolerant collate.

The padding helpers work on numpy arrays, in the loader's worker
processes; ``PaddedBatch`` turns their results into tensors.
``download_file`` is not ported: nothing is downloaded
(``docs/PORT_MAP.md``).
"""
from __future__ import annotations

import collections.abc
import os

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


def recursive_to(data, fn):
    """Every tensor or numpy array of a nested structure through ``fn``
    (``data_utils.py:86``): a callable, or a ``torch.device`` (or its name)
    that the leaves are moved to, numpy arrays as tensors.

    Example
    -------
    >>> import torch
    >>> out = recursive_to({"a": [torch.ones(2)], "b": "x"}, "cpu")
    >>> out["a"][0].device.type, out["b"]
    ('cpu', 'x')
    """
    import torch

    if isinstance(data, (torch.Tensor, np.ndarray)):
        if callable(fn):
            return fn(data)
        return torch.as_tensor(data).to(fn)
    if isinstance(data, collections.abc.Mapping):
        return {k: recursive_to(v, fn) for k, v in data.items()}
    if isinstance(data, tuple) and hasattr(data, "_fields"):  # namedtuple
        return type(data)(*(recursive_to(v, fn) for v in data))
    if isinstance(data, collections.abc.Sequence) and not isinstance(
            data, str):
        return [recursive_to(v, fn) for v in data]
    return data


def recursive_update(d, u, must_match=False):
    """Update the nested dict ``d`` with ``u`` (``data_utils.py:100``);
    with ``must_match`` a key of ``u`` that ``d`` lacks raises."""
    for k, v in u.items():
        if isinstance(v, collections.abc.Mapping) and k in d:
            recursive_update(d.get(k, {}), v, must_match=must_match)
        elif must_match and k not in d:
            raise KeyError(f"Override '{k}' not found in: "
                           f"{[key for key in d.keys()]}")
        else:
            d[k] = v


def split_path(path):
    """[folder or source, file name] (``data_utils.py:130``).

    Example
    -------
    >>> split_path("a/b/c.ckpt"), split_path("c.ckpt")
    (['a/b', 'c.ckpt'], ('./', 'c.ckpt'))
    """
    if "/" in path:
        return path.rsplit("/", maxsplit=1)
    return "./", path


def get_all_files(dirName, match_and=None, match_or=None, exclude_and=None,
                  exclude_or=None):
    """The files under ``dirName``, recursively, filtered by substrings
    (``data_utils.py:138``)."""
    allFiles = []
    for entry in os.listdir(dirName):
        fullPath = os.path.join(dirName, entry)
        if os.path.isdir(fullPath):
            allFiles += get_all_files(fullPath, match_and, match_or,
                                      exclude_and, exclude_or)
        else:
            if match_and and not all(s in fullPath for s in match_and):
                continue
            if match_or and not any(s in fullPath for s in match_or):
                continue
            if exclude_and and all(s in fullPath for s in exclude_and):
                continue
            if exclude_or and any(s in fullPath for s in exclude_or):
                continue
            allFiles.append(fullPath)
    return allFiles


def mod_default_collate(batch):
    """Stack a list of batch values where it can, never raising
    (``data_utils.py:159``): equal-shape tensors into a tensor, equal-shape
    arrays into a numpy array, Python numbers into a numpy array; anything
    else comes back unchanged."""
    import torch

    elem = batch[0]
    if isinstance(elem, torch.Tensor):
        try:
            return torch.stack(batch, 0)
        except Exception:
            return batch
    if isinstance(elem, np.ndarray) or hasattr(elem, "__array__"):
        try:
            arrs = [np.asarray(b) for b in batch]
            if (len({a.shape for a in arrs}) == 1
                    and arrs[0].dtype.kind not in "OUS"):
                return np.stack(arrs, 0)
        except Exception:
            pass
        return batch
    if isinstance(elem, float):
        return np.asarray(batch, dtype=np.float64)
    if isinstance(elem, bool):
        return np.asarray(batch, dtype=bool)
    if isinstance(elem, int):
        return np.asarray(batch)
    return batch


def split_by_whitespace(text):
    """``text.split()`` as a pipeline function (``data_utils.py:183``)."""
    return text.split()


def split_list(seq, num):
    """``seq`` in ``num`` nearly equal chunks (``data_utils.py:189``).

    Example
    -------
    >>> split_list(range(5), 2)
    [[0, 1], [2, 3, 4]]
    """
    seq = list(seq)
    avg = len(seq) / float(num)
    out, last = [], 0.0
    while last < len(seq):
        out.append(seq[int(last):int(last + avg)])
        last += avg
    return out


def recursive_items(dictionary):
    """(key, value) of every leaf of a nested dict, depth first
    (``data_utils.py:201``)."""
    for key, value in dictionary.items():
        if isinstance(value, dict):
            yield from recursive_items(value)
        else:
            yield (key, value)
