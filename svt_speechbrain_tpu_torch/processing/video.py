"""Video utilities: lip-ROI transforms, loading, span masking (a copy of
``svt_speechbrain_tpu/processing/video.py``, which is numpy only).

The transforms run on the host, in the loader's workers; a transform given
a numpy ``rng`` draws from it in call order, so a recipe that shares one
generator between its transforms draws the same crops and flips as the
JAX package's (each forked loader worker copies the generator, in both
packages). ``compute_mask_indices`` is fairseq's span masking of AV-HuBERT
pretraining.
"""
from __future__ import annotations

import numpy as np


def load_video(path):
    """Read a grayscale video into (T, H, W) uint8 (reference ``utils.py:22``).
    Accepts a ``.npy`` dump or a video file via OpenCV."""
    if path.endswith(".npy"):
        return np.load(path)
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
    cap.release()
    return np.stack(frames)


class Compose:
    """Compose several video transforms (reference ``utils.py:43``)."""

    def __init__(self, preprocess):
        self.preprocess = preprocess

    def __call__(self, sample):
        for t in self.preprocess:
            sample = t(sample)
        return sample


class Normalize:
    """(x - mean) / std (reference ``utils.py:110``)."""

    def __init__(self, mean, std):
        self.mean = mean
        self.std = std

    def __call__(self, frames):
        return (frames - self.mean) / self.std


class CenterCrop:
    """Center spatial crop (reference ``utils.py:60``)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, frames):
        t, h, w = frames.shape
        th, tw = self.size
        delta_w = int(round((w - tw) / 2.0))
        delta_h = int(round((h - th) / 2.0))
        return frames[:, delta_h:delta_h + th, delta_w:delta_w + tw]


class RandomCrop:
    """Random spatial crop (reference ``utils.py:79``)."""

    def __init__(self, size, rng=None):
        self.size = size
        self.rng = rng or np.random.default_rng()

    def __call__(self, frames):
        t, h, w = frames.shape
        th, tw = self.size
        delta_w = int(self.rng.integers(0, max(w - tw, 0) + 1))
        delta_h = int(self.rng.integers(0, max(h - th, 0) + 1))
        return frames[:, delta_h:delta_h + th, delta_w:delta_w + tw]


class HorizontalFlip:
    """Random horizontal flip of all frames (reference ``utils.py:95``)."""

    def __init__(self, flip_ratio, rng=None):
        self.flip_ratio = flip_ratio
        self.rng = rng or np.random.default_rng()

    def __call__(self, frames):
        if self.rng.random() < self.flip_ratio:
            return np.ascontiguousarray(frames[:, :, ::-1])
        return frames


def find_runs(x):
    """Run-length encode: (values, starts, lengths) (reference ``utils.py:261``).

    Example
    -------
    >>> values, starts, lengths = find_runs([1, 1, 0, 0, 0, 1])
    >>> values.tolist(), starts.tolist(), lengths.tolist()
    ([1, 0, 1], [0, 2, 5], [2, 3, 1])
    """
    x = np.asarray(x)
    if x.ndim != 1:
        raise ValueError("only 1D arrays supported")
    n = x.shape[0]
    if n == 0:
        return np.array([]), np.array([]), np.array([])
    loc_run_start = np.empty(n, dtype=bool)
    loc_run_start[0] = True
    np.not_equal(x[:-1], x[1:], out=loc_run_start[1:])
    run_starts = np.nonzero(loc_run_start)[0]
    run_values = x[run_starts]
    run_lengths = np.diff(np.append(run_starts, n))
    return run_values, run_starts, run_lengths


def compute_mask_indices(shape, padding_mask, mask_prob, mask_length,
                         mask_type="static", mask_other=0.0, min_masks=0,
                         no_overlap=False, min_space=0, rng=None):
    """fairseq-style span masking (reference ``utils.py:131-260``).

    Returns (mask (B, T) bool, starts, ends, batch_indexes) describing the
    sampled spans, like the reference's extended variant.
    """
    rng = rng or np.random.default_rng()
    bsz, all_sz = shape
    mask = np.full((bsz, all_sz), False)

    all_num_mask = int(mask_prob * all_sz / float(mask_length) + rng.random())
    all_num_mask = max(min_masks, all_num_mask)
    mask_idcs = []
    for i in range(bsz):
        if padding_mask is not None:
            sz = all_sz - int(padding_mask[i].sum())
            num_mask = int(mask_prob * sz / float(mask_length) + rng.random())
            num_mask = max(min_masks, num_mask)
        else:
            sz = all_sz
            num_mask = all_num_mask

        if mask_type == "static":
            lengths = np.full(num_mask, mask_length)
        elif mask_type == "uniform":
            lengths = rng.integers(mask_other, mask_length * 2 + 1, size=num_mask)
        elif mask_type == "normal":
            lengths = rng.normal(mask_length, mask_other, size=num_mask)
            lengths = [max(1, int(round(x))) for x in lengths]
        elif mask_type == "poisson":
            lengths = rng.poisson(mask_length, size=num_mask)
            lengths = [int(round(x)) for x in lengths]
        else:
            raise Exception("unknown mask selection " + mask_type)

        if sum(lengths) == 0:
            lengths = [min(mask_length, sz - 1)]

        if no_overlap:
            mask_idc = []

            def arrange(s, e, length, keep_length):
                span_start = rng.integers(s, e - length)
                mask_idc.extend(span_start + i for i in range(length))
                new_parts = []
                if span_start - s - min_space >= keep_length:
                    new_parts.append((s, span_start - min_space + 1))
                if e - span_start - length - min_space > keep_length:
                    new_parts.append((span_start + length + min_space, e))
                return new_parts

            parts = [(0, sz)]
            min_length = min(lengths)
            for length in sorted(lengths, reverse=True):
                lens = np.fromiter(
                    (e - s if e - s >= length + min_space else 0 for s, e in parts),
                    np.int32)
                l_sum = np.sum(lens)
                if l_sum == 0:
                    break
                probs = lens / np.sum(lens)
                c = rng.choice(len(parts), p=probs)
                s, e = parts.pop(c)
                parts.extend(arrange(s, e, length, min_length))
            mask_idc = np.asarray(mask_idc)
        else:
            min_len = min(lengths)
            if sz - min_len <= num_mask:
                min_len = sz - num_mask - 1
            mask_idc = rng.choice(sz - min_len, num_mask, replace=False)
            mask_idc = np.asarray(
                [mask_idc[j] + offset for j in range(len(mask_idc))
                 for offset in range(lengths[j])])
        mask_idcs.append(np.unique(mask_idc[mask_idc < sz]))

    min_len = min([len(m) for m in mask_idcs])
    batch_indexes, starts, ends = [], [], []
    for i, mask_idc in enumerate(mask_idcs):
        if len(mask_idc) > min_len:
            mask_idc = rng.choice(mask_idc, min_len, replace=False)
        mask[i, mask_idc] = True
        vals, run_starts, run_lengths = find_runs(mask[i])
        start_indices = run_starts[vals == True]  # noqa: E712
        lengths_ = run_lengths[vals == True]  # noqa: E712
        starts.append(start_indices)
        ends.append(start_indices + lengths_)
        batch_indexes.append(np.zeros_like(start_indices) + i)
    return (mask, np.concatenate(starts).astype(np.int64),
            np.concatenate(ends).astype(np.int64),
            np.concatenate(batch_indexes).astype(np.int64))
