"""Training traffic: the full-finetune stage of ``AudioAMT`` (Adam on the
encoder, Adadelta on the head, dropouts as the configuration states them,
f32 with TF32 off) on songs read from 16-bit WAV files by the port's
loader.

Set-up writes ``song_count`` songs of lengths spread evenly over
``song_seconds`` into a folder under ``TMPDIR`` (content and order from the
seed, so that every seed trains on the same lengths), builds the brain on
the benchmark's weights and a loader through ``Brain.make_dataloader``:
a ``DynamicBatchSampler`` in length buckets, or a fixed ``batch_size`` with
the brain's seeded shuffle, and ``num_workers`` forked workers. It warms the
largest batch shape with a forward and backward that draws from
generators of its own and leaves no gradient, then runs the first
``checked_steps`` steps of the epoch through ``fit_batch``, as the window
does, and reads from them what the check compares: each step's loss, the
first step's gradient by leaf from the optimizers' state, and the change
of every leaf over those steps. The window goes on with the same brain and
loader.

The check, once the program is freed: each checked batch is made again
from the seed by the song ids the loader gave (the songs as a 16-bit
reader reads them back, the annotations, both padded to the batch's
longest) and held exactly against what the loader delivered; the
reference trains the same weights on the batches so made for the same
steps, replaying the dropout from the brain's seed, and each number is
held against its limit: the rows the loader delivered otherwise (or twice,
or missing from a fixed batch), the worst step's loss, and the worst
leaf's gradient and change norms, each as a gap of norms over the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median
leaf's (a key bias under softmax) move by round-off alone and are left out
of the change.
"""
from __future__ import annotations

import functools
import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import program, songs, weights
from benchmark.trace import note
from benchmark.reference import train as ref_train

ROUND_OFF_LEAF = 1e-3


def draw_lengths(traffic, seed):
    """The songs' lengths in seconds: spread evenly over ``song_seconds``,
    in an order drawn from the seed."""
    lo, hi = traffic["song_seconds"]
    lengths = np.round(np.linspace(lo, hi, traffic["song_count"]), 2)
    rng = np.random.default_rng(songs.derive(seed, 4))
    return rng.permutation(lengths).tolist()


def _labels(seed, index, duration):
    return songs.annotation(seed, index, duration)


def padded(rows):
    """Rows (each (n, ...) float32) as a batch: zeros to the longest, and
    the relative lengths in float32, as the loader's collate pads them."""
    longest = max(len(r) for r in rows)
    data = np.zeros((len(rows), longest) + rows[0].shape[1:], np.float32)
    for k, r in enumerate(rows):
        data[k, :len(r)] = r
    rel = np.array([len(r) / longest for r in rows], np.float32)
    return torch.from_numpy(data), torch.from_numpy(rel)


def rows_other(got, want):
    """The rows of a delivered batch (tensors) that differ from ``want``."""
    if any(g.shape != w.shape for g, w in zip(got, want)):
        return max(len(got[0]), len(want[0]))
    other = torch.zeros(len(want[0]), dtype=torch.bool)
    for g, w in zip(got, want):
        other |= (g != w).reshape(len(w), -1).any(1)
    return int(other.sum())


class Cell:
    def __init__(self, cfg, traffic, seed, device, limits):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.limits = limits
        self.device = torch.device(device)
        self.failed = 0
        torch.backends.cuda.matmul.allow_tf32 = cfg["train_tf32"]
        torch.backends.cudnn.allow_tf32 = cfg["train_tf32"]
        t = traffic
        clock = time.perf_counter()
        self.lengths = lengths = draw_lengths(t, self.seed)
        self.folder = tempfile.mkdtemp(prefix="bench-songs-")
        self.data = songs.write_song_files(self.folder, lengths,
                                           songs.derive(self.seed, 5), device)
        clock = note("set-up: WAV files", clock)
        self.brain = self._brain()
        clock = note("set-up: weights and brain", clock)
        self.loader = self._loader()
        self.epoch = 1
        self.batches = iter(self.loader)
        clock = note("set-up: loader", clock)
        self._warm_up(max(lengths))
        clock = note("set-up: warm-up at the largest batch", clock)
        self.step_rows = []           # (rows, padded samples, true samples)
        self.checked_batches, self.losses = [], []
        for step in range(t["checked_steps"]):
            batch = self._next_batch()
            self.checked_batches.append(self._host_copy(batch))
            self.losses.append(self._step(batch))
            if step == 0:
                self.first_grads = self._grads_from_state()
        self.change = self._change()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        note(f"set-up: {t['checked_steps']} checked steps", clock)

    def _brain(self):
        clock = time.perf_counter()
        from svt_speechbrain_tpu_torch.nnet import losses
        from svt_speechbrain_tpu_torch.nnet.activations import Softmax
        from svt_speechbrain_tpu_torch.tasks.amt import AudioAMT

        clock = note("set-up: brain imports", clock)
        bridge, head = program.build_modules(
            self.cfg, weights.make_weights(self.cfg, self.seed, self.device),
            self.device)
        clock = note("set-up: weights and modules", clock)
        crit = dict(reduction="mean", allowed_len_diff=60, label_smoothing=0.0)
        t = self.traffic
        hparams = dict(
            seed=self.seed, pitch_octave_num=self.cfg["pitch_octave_num"],
            onset_positive_weight=ref_train.ONSET_POS_WEIGHT,
            offset_positive_weight=1.0, lr=t["lr"],
            lr_wav2vec=t["lr_wav2vec"], linear_prob_epochs=0,
            onset_criterion=functools.partial(losses.bce_loss, **crit),
            offset_criterion=functools.partial(losses.bce_loss, **crit),
            octave_criterion=functools.partial(losses.nll_loss, **crit),
            pitch_criterion=functools.partial(losses.nll_loss, **crit),
            log_softmax=Softmax(apply_log=True))
        brain = AudioAMT({"wav2vec2": bridge, "model": head}, hparams=hparams,
                         run_opts={"device": str(self.device),
                                   "precision": "fp32",
                                   "max_grad_norm": ref_train.MAX_GRAD_NORM,
                                   "noprogressbar": True})
        clock = note("set-up: AudioAMT", clock)
        brain.init_optimizers()
        note("set-up: optimizers", clock)
        return brain

    def _loader(self):
        from svt_speechbrain_tpu_torch.core import Stage
        from svt_speechbrain_tpu_torch.dataio.dataio import read_audio
        from svt_speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
        from svt_speechbrain_tpu_torch.dataio.sampler import DynamicBatchSampler

        ds = DynamicItemDataset(self.data)
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        ds.add_dynamic_item(functools.partial(_labels, self.seed),
                            takes=["index", "duration"], provides="anno")
        ds.set_output_keys(["id", "sig", "anno"])
        t = self.traffic
        kwargs = dict(num_workers=t["num_workers"])
        if "max_batch_seconds" in t:
            kwargs["batch_sampler"] = DynamicBatchSampler(
                None, t["max_batch_seconds"], num_buckets=t["num_buckets"],
                lengths_list=[d["duration"] for d in self.data.values()],
                max_batch_ex=t["max_batch_songs"], shuffle=True,
                seed=self.seed)
        else:
            kwargs.update(batch_size=t["batch_size"], shuffle=True)
        loader = self.brain.make_dataloader(ds, Stage.TRAIN, **kwargs)
        self.brain.on_stage_start(Stage.TRAIN, 1)
        if self.brain.train_sampler is not None:
            self.brain.train_sampler.set_epoch(1)
        return loader

    def _warm_up(self, seconds):
        """A forward and backward at the largest batch the traffic makes,
        from generators of its own; the brain's state is left as it was."""
        from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG

        t = self.traffic
        rows = t.get("max_batch_songs", t.get("batch_size"))
        n = int(round(seconds * songs.SR))
        gens = StepRNG(torch.Generator(self.device).manual_seed(0),
                       torch.Generator().manual_seed(0))
        wav = torch.zeros((rows, n), device=self.device)
        mods = self.brain.modules
        out = mods.model(mods.wav2vec2(wav, rng=gens, train=True))
        out.float().square().mean().backward()
        for p in mods.parameters():
            p.grad = None

    def _next_batch(self):
        """The loader's next batch; at an epoch's end, the next epoch's
        first (the traffic sizes an epoch to outlast the window)."""
        try:
            return next(self.batches)
        except StopIteration:
            self.epoch += 1
            self.brain.train_sampler.set_epoch(self.epoch)
            self.batches = iter(self.loader)
            return next(self.batches)

    @staticmethod
    def _host_copy(batch):
        """(song ids, wav, wav lengths, annotations, their lengths) of a
        batch, on the host."""
        sig, anno = batch["sig"], batch["anno"]
        return (list(batch["id"]), *(x.detach().cpu().clone() for x in (
            sig.data, sig.lengths, anno.data, anno.lengths)))

    def _step(self, batch):
        sig = batch["sig"]
        rows, samples = sig.data.shape
        true = (sig.lengths.double() * samples).round().long().tolist()
        self.step_rows.append((rows, samples, true))
        self.brain.step += 1
        loss = self.brain.fit_batch(batch)
        if not np.isfinite(loss):
            self.failed += 1
        return loss

    def _grads_from_state(self):
        """The first step's clipped gradient by leaf, from the optimizers'
        state after it: Adam's first moment over (1 - beta1), Adadelta's
        square average over (1 - rho), square-rooted."""
        out = {}
        for entry in self.brain.optimizers.values():
            opt, (module_name,) = entry["opt"], entry["modules"]
            prefix = module_name + "."
            for name, p in self.brain.modules[module_name].named_parameters():
                state = opt.state.get(p, {})
                if "exp_avg" in state:
                    b1 = opt.param_groups[0]["betas"][0]
                    norm = state["exp_avg"].norm() / (1 - b1)
                elif "square_avg" in state:
                    rho = opt.param_groups[0]["rho"]
                    norm = (state["square_avg"].sum() / (1 - rho)).sqrt()
                else:                   # the optimizer never stepped
                    norm = torch.zeros((), device=self.device)
                out[prefix + name] = norm
        names = list(out)
        return dict(zip(names, torch.stack([out[n] for n in names]).tolist()))

    def _change(self):
        start = weights.make_weights(self.cfg, self.seed, self.device)
        now = {f"wav2vec2.{n}": p for n, p in
               self.brain.modules.wav2vec2.named_parameters()}
        now.update({f"model.{n}": p for n, p in
                    self.brain.modules.model.named_parameters()})
        with torch.no_grad():
            return ref_train.leaf_norms({n: now[n] - start[n] for n in start})

    # ------------------------------------------------------------- window
    def run(self, win):
        self.window_rows = []
        while win.more():
            with win.item():
                with win.span("bench.loader_next"):
                    batch = self._next_batch()
                with win.span("bench.fit_batch"):
                    self._step(batch)
                self.window_rows.append(self.step_rows[-1])
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        win.close()
        true = sum(sum(r[2]) for r in self.window_rows)
        out = {self.traffic["rate_metric"]: true / songs.SR / win.wall}
        if self.device.type == "cuda":
            out["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out

    def attempted(self):
        return len(self.window_rows)

    def work(self, items):
        return [{"rows": self.window_rows[i]} for i in items]

    def release(self):
        self.batches = None
        self.loader = None
        del self.brain
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.folder, ignore_errors=True)

    # -------------------------------------------------------------- check
    def rebuild(self, ids):
        """(wav, wav lengths, annotations, their lengths) of the songs
        ``ids`` made again from the seed, padded as a batch."""
        index = [int(i[len("song"):]) for i in ids]
        wavs = songs.read_back(self.lengths, songs.derive(self.seed, 5),
                               index, self.device)
        labels = [songs.annotation(self.seed, i, self.lengths[i])
                  for i in index]
        return (*padded([wavs[i] for i in index]), *padded(labels))

    def check(self):
        t = self.traffic
        batches, other, ids = [], 0, []
        for got in self.checked_batches:
            want = self.rebuild(got[0])
            other += rows_other(got[1:], want)
            if "max_batch_seconds" not in t:
                other += abs(len(got[0]) - t["batch_size"])
            ids += got[0]
            wav, _, anno, anno_rel = want
            batches.append((wav.to(self.device), anno.to(self.device),
                            anno_rel.to(self.device)))
        other += len(ids) - len(set(ids))
        params = weights.make_weights(self.cfg, self.seed, self.device)
        losses, grads, change = ref_train.train_steps(
            self.cfg, params, batches, self.seed, t["lr_wav2vec"], t["lr"])
        self.reference = (losses, grads, change)
        return [("loader_rows_other", float(other),
                 self.limits["loader_rows_other"])] + self.compare(
            losses, grads, change)

    def compare(self, losses, grads, change):
        """[(name, value, limit)] of the program's readings against the
        reference's ``losses``, ``grads`` and ``change``."""
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(self.losses, losses))
        median_g = float(np.median(list(grads.values())))
        grad_gap = max(abs(self.first_grads[n] - g) / max(g, median_g)
                       for n, g in grads.items())
        moved = {n: c for n, c in change.items()
                 if grads[n] >= ROUND_OFF_LEAF * median_g}
        median_c = float(np.median(list(moved.values())))
        change_gap = max(abs(self.change[n] - c) / max(c, median_c)
                         for n, c in moved.items())
        self.left_out = sorted(set(change) - set(moved))
        lim = self.limits
        return [("loss_gap", loss_gap, lim["loss_gap"]),
                ("first_grad_leaf_gap", grad_gap, lim["first_grad_leaf_gap"]),
                ("change_leaf_gap", change_gap, lim["change_leaf_gap"])]
