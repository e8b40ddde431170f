"""Padded batch collation (port of ``svt_speechbrain_tpu/dataio/batch.py``).

``PaddedData(data, lengths)`` pairs a right-padded tensor with its rows'
*relative* lengths (length / padded length, float32), the convention the
length-masked losses depend on. ``PaddedBatch`` is the loaders' collate
function: it pads array-valued keys (each key's first axis up to a multiple
of ``pad_multiples[key]``, as the JAX loader buckets shapes), stacks
numbers into tensors and keeps everything else as lists. It runs in the
loader's worker processes; ``pin_memory`` lets the loader pin it for
asynchronous copies to the card.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from svt_speechbrain_tpu_torch.utils.data_utils import batch_pad_right, round_up

PaddedData = collections.namedtuple("PaddedData", ["data", "lengths"])


def _is_array_like(x):
    return isinstance(x, (np.ndarray, torch.Tensor)) or (
        hasattr(x, "__array__") and not isinstance(x, (str, bytes)))


class PaddedBatch:
    """Collate a list of example dicts (``batch.py:29``).

    - array-valued keys (unless in ``non_padded_keys``) are padded right and
      stored as ``PaddedData(stacked tensor, relative lengths)``;
    - numbers are stacked into a tensor; anything else is kept as a list.

    Keys read as attributes (``batch.sig.data``) or items (``batch["sig"]``).

    Example
    -------
    >>> import numpy as np
    >>> batch = PaddedBatch([
    ...     {"id": "ex1", "sig": np.asarray([1.0, 2.0, 3.0, 4.0])},
    ...     {"id": "ex2", "sig": np.asarray([5.0, 6.0])},
    ... ], pad_multiples={"sig": 3})
    >>> batch.id
    ['ex1', 'ex2']
    >>> data, lengths = batch.sig        # unpackable PaddedData
    >>> tuple(data.shape), lengths.dtype, [round(v, 4) for v in lengths.tolist()]
    ((2, 6), torch.float32, [0.6667, 0.3333])
    >>> sorted(batch.tensors())
    ['sig']
    """

    def __init__(self, examples, padded_keys=None, non_padded_keys=(),
                 pad_multiples=None, padding_kwargs=None):
        padding_kwargs = padding_kwargs or {}
        pad_multiples = pad_multiples or {}
        self.__length = len(examples)
        self.__keys = list(examples[0].keys())
        self.__padded_keys = []
        for key in self.__keys:
            values = [ex[key] for ex in examples]
            if (key not in non_padded_keys
                    and (padded_keys is None or key in padded_keys)
                    and _is_array_like(values[0])):
                arrays = [np.asarray(v) for v in values]
                target = None
                if key in pad_multiples:
                    target = round_up(max(a.shape[0] for a in arrays),
                                      pad_multiples[key])
                data, lengths = batch_pad_right(arrays, target_len=target,
                                                **padding_kwargs)
                setattr(self, key, PaddedData(torch.from_numpy(data),
                                              torch.from_numpy(lengths)))
                self.__padded_keys.append(key)
            else:
                if isinstance(values[0], (int, float, np.integer,
                                          np.floating)):
                    values = torch.as_tensor(np.asarray(values))
                setattr(self, key, values)

    def __len__(self):
        return self.__length

    def __getitem__(self, key):
        if key in self.__keys:
            return getattr(self, key)
        raise KeyError(f"Batch doesn't have key: {key}")

    def at_position(self, pos):
        """The item at position ``pos`` of the batch's keys
        (``batch.py:94``)."""
        return getattr(self, self.__keys[pos])

    @property
    def keys(self):
        return list(self.__keys)

    @property
    def padded_keys(self):
        return list(self.__padded_keys)

    def tensors(self, keys=None):
        """The device-bound part: {key: PaddedData} for the padded keys and
        {key: tensor} for stacked numbers; strings and lists stay on the
        host (the JAX batch's ``numpy_arrays``)."""
        return {key: getattr(self, key) for key in (keys or self.__keys)
                if isinstance(getattr(self, key), (PaddedData, torch.Tensor))}

    def pin_memory(self):
        """Pin every tensor (the DataLoader's ``pin_memory`` calls this)."""
        for key, val in self.tensors().items():
            if isinstance(val, PaddedData):
                val = PaddedData(val.data.pin_memory(),
                                 val.lengths.pin_memory())
            else:
                val = val.pin_memory()
            setattr(self, key, val)
        return self


class BatchsizeGuesser:
    """The batch size of any batch object, never raising
    (``batch.py:127``): ``batchsize``, a leading dimension, the first value
    of a dict or the first item of a sequence; 1 when none applies.

    Example
    -------
    >>> import torch
    >>> guess = BatchsizeGuesser()
    >>> guess(torch.zeros(3, 5)), guess({"x": [torch.zeros(4, 2)]}), guess(7)
    (3, 4, 1)
    """

    def guess(self, batch):
        try:
            if hasattr(batch, "batchsize"):
                return batch.batchsize
            if hasattr(batch, "shape"):
                return batch.shape[0]
            if isinstance(batch, dict) and batch:
                return self.guess(next(iter(batch.values())))
            if isinstance(batch, (list, tuple)) and batch:
                first = batch[0]
                if hasattr(first, "shape"):
                    return first.shape[0]
                if isinstance(first, (int, float, str)):
                    return len(batch)
                return self.guess(first)
        except Exception:
            pass
        return 1

    def __call__(self, batch):
        return self.guess(batch)
