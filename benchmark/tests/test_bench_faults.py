"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a chip skipped, the rest of a run driven on the CPU at
test size, once for each fault the cell can have, and once unbroken."""
from __future__ import annotations

import pytest
import torch

from benchmark.drivers import serve_songs, train_wav
from benchmark.tests import tiny


class AlteredAnswer(serve_songs.Cell):
    """Each frame's pitch class moved up by one where it is produced."""

    def __init__(self, *args):
        super().__init__(*args)
        forward = self.transcriber._forward

        def altered(wavs, wav_lens):
            out = forward(wavs, wav_lens).clone()
            out[..., 3] = (out[..., 3] + 1) % 13
            return out

        self.transcriber._forward = altered


class HalfBatch(serve_songs.Cell):
    """The encoder runs the first half of each batch; the rest of the rows
    take its answers."""

    def __init__(self, *args):
        super().__init__(*args)
        forward = self.transcriber._forward

        def half(wavs, wav_lens):
            h = wavs.shape[0] // 2
            out = forward(wavs[:h], wav_lens[:h])
            return torch.cat([out, out[:wavs.shape[0] - h]])

        self.transcriber._forward = half


class AlteredNotes(serve_songs.Cell):
    """The decode drops each song's last note."""

    def __init__(self, *args):
        super().__init__(*args)
        transcribe = self.transcriber.transcribe

        def fewer(songs, fast=True):
            return {k: v[:-1] for k, v in transcribe(songs, fast).items()}

        self.transcriber.transcribe = fewer


class UnchangedState(train_wav.Cell):
    """Every optimizer step returns the state unchanged."""

    def _brain(self):
        brain = super()._brain()
        for entry in brain.optimizers.values():
            entry["opt"].step = lambda *a, **k: None
        return brain


class HalfRows(train_wav.Cell):
    """Each step trains on the first half of its rows, the loss the mean
    over those."""

    def _step(self, batch):
        from svt_speechbrain_tpu_torch.dataio.batch import PaddedData

        h = batch["sig"].data.shape[0] // 2
        half = {k: PaddedData(batch[k].data[:h], batch[k].lengths[:h])
                for k in ("sig", "anno")}
        return super()._step(half)


class SwappedLabels(train_wav.Cell):
    """The loader hands each row the annotations of the next row's song."""

    def _next_batch(self):
        from svt_speechbrain_tpu_torch.dataio.batch import PaddedData

        batch = super()._next_batch()
        anno = batch["anno"]
        batch.anno = PaddedData(anno.data.roll(1, 0), anno.lengths.roll(1, 0))
        return batch


class ShortRow(train_wav.Cell):
    """The loader's reader drops the last tenth of the first row's song."""

    def _next_batch(self):
        batch = super()._next_batch()
        sig = batch["sig"].data
        sig[0, int(0.9 * batch["sig"].lengths[0] * sig.shape[1]):] = 0.0
        return batch


@pytest.mark.parametrize("cell_class", [AlteredAnswer, HalfBatch,
                                        AlteredNotes])
def test_serving_faults(cell_class):
    result, _, _ = tiny.run_tiny("lv60-serve-songs", cell_class=cell_class)
    assert result["correct"] is False


@pytest.mark.parametrize("cell_class", [UnchangedState, HalfRows])
@pytest.mark.parametrize("traffic", [None, tiny.TRAIN], ids=["5s", "buckets"])
def test_training_faults(cell_class, traffic):
    result, _, _ = tiny.run_tiny("lv60-train-5s", traffic=traffic,
                                 cell_class=cell_class)
    assert result["correct"] is False


@pytest.mark.parametrize("cell_class", [SwappedLabels, ShortRow])
def test_loader_faults(cell_class):
    result, checks, _ = tiny.run_tiny("lv60-train-5s", cell_class=cell_class)
    assert result["correct"] is False
    assert dict((n, v) for n, v, _ in checks)["loader_rows_other"] > 0


@pytest.mark.parametrize("cell", ["lv60-serve-songs", "d2v-serve-songs",
                                  "lv60-train-5s"])
def test_unbroken_runs_are_correct(cell):
    result, checks, _ = tiny.run_tiny(cell)
    assert result["correct"] is True, checks
