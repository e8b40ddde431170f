"""Whole-song transcription traffic: a closed loop with one client, each
request ``SingingTranscriber.transcribe_batch`` on a few whole songs.

Set-up makes a pool of songs of fixed lengths (``pool_seconds``) whose
content comes from the seed, builds the interface on the benchmark's
weights and serves one request to build its transcriber and warm its one
shape (``batch_size`` rows of ``chunk_seconds``). The window sends the
requests of ``pairs`` (indices into the pool), a seeded order of them each
round, so that every seed sends the same sizes in another order.

The check, once the window has closed and the program is freed: a sample
of the requests of the first ``checked_rounds`` rounds (each of which
sends every pair once), drawn from the seed and holding the longest, is
run through the f32 reference chunk by chunk, as the traffic chunks it
(zero-padded windows, each row normalised over its own samples). Each
song's served frames are compared with it: the onset and offset
probabilities by their largest distance, the octave and pitch-class
decisions by the widest gap by which the served class's reference logit
lies below the reference's best. The served notes must be those the
reference decode gives for the served frames.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark import program, songs, weights
from benchmark.trace import note
from benchmark.reference import decode, model

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def draw(traffic, seed, device):
    """(pool of songs, order of requests as pool indices) for ``seed``."""
    pool = songs.make_songs(traffic["pool_seconds"], songs.derive(seed, 1),
                            device)
    rng = np.random.default_rng(songs.derive(seed, 2))
    pairs = traffic["pairs"]
    rounds = -(-traffic["max_requests"] // len(pairs))
    order = [pairs[j] for _ in range(rounds)
             for j in rng.permutation(len(pairs))]
    return pool, order


class Cell:
    def __init__(self, cfg, traffic, seed, device, limits):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.limits = limits
        self.device = torch.device(device)
        t = traffic
        clock = time.perf_counter()
        self.pool, self.order = draw(t, self.seed, device)
        clock = note("set-up: songs", clock)
        from svt_speechbrain_tpu_torch.pretrained.interfaces import (
            SingingTranscriber)

        params = weights.make_weights(cfg, self.seed, device)
        self.head_bias = self.calibrate(params)
        params["model.b"][:2] = self.head_bias
        clock = note("set-up: weights and head calibration", clock)
        bridge, head = program.build_modules(cfg, params, device)
        self.iface = SingingTranscriber(
            modules={"wav2vec2": bridge, "model": head},
            hparams={"frame_rate": t["frame_rate"],
                     "onset_threshold": t["onset_threshold"],
                     "offset_threshold": t["offset_threshold"]},
            batch_size=t["batch_size"], chunk_seconds=t["chunk_seconds"],
            chunking="ceil", quantize=t.get("quantize"), device=device,
            compute_dtype=DTYPES[t["compute_dtype"]])
        clock = note("set-up: interface", clock)
        self.served = []            # (pair, frames, notes) a request
        self.latencies, self.predict_s = [], []
        self.audio_s = 0.0
        self.failed = 0
        self.iface.transcribe_batch(self._request(self.order[-1]))
        self.transcriber = self.iface._transcriber
        predict = self.transcriber.predict_frames

        def predict_and_keep(songs_, depth=2):
            t0 = time.perf_counter()
            self._frames = predict(songs_, depth)
            self._predict_s = time.perf_counter() - t0
            return self._frames

        self.transcriber.predict_frames = predict_and_keep
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        note("set-up: first request (transcriber, warm-up)", clock)

    def calibrate(self, params):
        """The onset and offset biases of the head that put the share of
        frames at or above the decode thresholds at ``onset_share`` and
        ``offset_share``, read from the f32 reference on the first chunk
        of every song of the pool. Random weights otherwise leave the
        onset probability above or below its threshold almost everywhere
        (9 to 14,369 notes a request by seed), and the host's decode, and
        with it the work of a request, would change with the seed."""
        t = self.traffic
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cs = int(round(t["chunk_seconds"] * songs.SR))
        x = torch.from_numpy(np.stack([w[:cs] for w in self.pool]))
        with torch.no_grad():
            logits = model.forward(self.cfg, params, x.to(self.device),
                                   samples=torch.full((len(self.pool),), cs,
                                                      device=self.device))
        bias = params["model.b"][:2]
        z = (logits[..., :2] - bias).reshape(-1, 2).double().cpu().numpy()
        out = []
        for j, (share, thres) in enumerate(
                ((t["onset_share"], t["onset_threshold"]),
                 (t["offset_share"], t["offset_threshold"]))):
            out.append(np.log(thres / (1 - thres))
                       - np.quantile(z[:, j], 1 - share))
        return torch.tensor(out, dtype=torch.float32, device=self.device)

    def _request(self, pair):
        return {f"song{j}": self.pool[j] for j in pair}

    # ------------------------------------------------------------- window
    def chunk_rows(self, pair):
        """The batches the request needs: [(true samples of each row)],
        rows of 0 samples for batch padding."""
        cs = int(round(self.traffic["chunk_seconds"] * songs.SR))
        rows = []
        for j in pair:
            n = len(self.pool[j])
            rows += [min(cs, n - i * cs) for i in range(max(1, -(-n // cs)))]
        b = self.traffic["batch_size"]
        return [rows[i:i + b] + [0] * (b - len(rows[i:i + b]))
                for i in range(0, len(rows), b)]

    def trace_hooks(self):
        """Forward hooks that open and close ``bench.posconv`` around the
        transcriber's own positional-embedding module."""
        ranges = []

        def pre(module, args):
            rf = torch.profiler.record_function("bench.posconv")
            rf.__enter__()
            ranges.append(rf)

        def post(module, args, out):
            ranges.pop().__exit__(None, None, None)

        pos = self.transcriber.bridge.encoder.pos_conv
        return [pos.register_forward_pre_hook(pre),
                pos.register_forward_hook(post)]

    def run(self, win):
        hooks = self.trace_hooks() if win.trace else []
        while win.more():
            with win.item() as i:
                pair = self.order[i % len(self.order)]
                t0 = time.perf_counter()
                try:
                    with win.span("bench.request"):
                        notes = self.iface.transcribe_batch(self._request(pair))
                except RuntimeError:
                    self.failed += 1
                    raise
                self.latencies.append(time.perf_counter() - t0)
                self.predict_s.append(self._predict_s)
            # the check reads requests of the first rounds only: keeping
            # every request's notes would grow the collector's work
            self.served.append((pair, self._frames, notes)
                               if i < len(self.traffic["pairs"])
                               * self.traffic["checked_rounds"] else (pair,))
            self.audio_s += sum(len(self.pool[j]) for j in pair) / songs.SR
        win.close()
        for h in hooks:
            h.remove()
        lat = np.asarray(self.latencies) * 1e3
        self.latency_ms = lat
        q = np.percentile(lat, [25, 50, 75, 95, 100])
        frames_ms = 1e3 * float(np.mean(self.predict_s))
        notes = np.mean([sum(map(len, e[2].values())) for e in self.served
                         if len(e) == 3])
        print(f"[bench] {len(lat)} requests, ms quartiles {q[0]:.1f} "
              f"{q[1]:.1f} {q[2]:.1f}, p95 {q[3]:.1f}, max {q[4]:.1f}; "
              f"frames {frames_ms:.1f} ms and decode "
              f"{float(np.mean(lat)) - frames_ms:.1f} ms a request, "
              f"{notes:.0f} notes a request", file=sys.stderr, flush=True)
        return {"serve_rtfx": self.audio_s / win.wall}

    def attempted(self):
        return len(self.latencies) + self.failed

    def work(self, items):
        """The items' batches and latencies, as the per-layer readers take
        them."""
        return [{"rows": self.chunk_rows(self.served[i][0]),
                 "latency_ms": float(self.latency_ms[i])} for i in items]

    def release(self):
        del self.iface, self.transcriber
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- check
    def sample(self):
        """Indices of the served requests the check reads: of those of the
        first ``checked_rounds`` rounds (every pair once a round), the
        longest and ``check_requests`` - 1 more drawn from the seed."""
        kept = [i for i, entry in enumerate(self.served) if len(entry) == 3]
        sizes = [sum(len(self.pool[j]) for j in self.served[i][0])
                 for i in kept]
        longest = kept[int(np.argmax(sizes))]
        rest = [i for i in kept if i != longest]
        rng = np.random.default_rng(songs.derive(self.seed, 3))
        k = min(self.traffic["check_requests"] - 1, len(rest))
        return [longest] + sorted(rng.choice(rest, size=k, replace=False)
                                  .tolist())

    def reference_logits(self, params, wav, cast=None):
        """(frames, outputs) f32 logits of one song, chunked as served;
        ``cast`` rounds the reference's products (the control)."""
        cs = int(round(self.traffic["chunk_seconds"] * songs.SR))
        n = len(wav)
        starts = list(range(0, max(n, 1), cs))
        out = []
        for lo in range(0, len(starts), self.traffic["batch_size"]):
            block = starts[lo:lo + self.traffic["batch_size"]]
            x = np.zeros((len(block), cs), np.float32)
            true = []
            for r, s in enumerate(block):
                part = wav[s:s + cs]
                x[r, :len(part)] = part
                true.append(len(part))
            samples = torch.tensor(true, device=self.device)
            logits = model.forward(self.cfg, params,
                                   torch.from_numpy(x).to(self.device),
                                   samples=samples, cast=cast)
            frames = model.frames_of(self.cfg, samples).tolist()
            out += [logits[r, :f] for r, f in enumerate(frames)]
        return torch.cat(out).double().cpu().numpy()

    def weights(self):
        """The run's weights again, the head's calibrated biases in."""
        params = weights.make_weights(self.cfg, self.seed, self.device)
        params["model.b"][:2] = self.head_bias
        return params

    def use_control(self):
        """Put the control in the program's place for the requests the
        check reads: the reference with its products in float8 e4m3
        (``model.fp8``), its frames and the notes they decode to."""
        params = self.weights()
        n_oct, t = self.cfg["pitch_octave_num"], self.traffic
        with torch.no_grad():
            for i in self.sample():
                pair, frames, notes = self.served[i]
                frames, notes = dict(frames), dict(notes)
                for j in pair:
                    logits = self.reference_logits(params, self.pool[j],
                                                   cast=model.fp8)
                    got = np.stack([1 / (1 + np.exp(-logits[:, 0])),
                                    1 / (1 + np.exp(-logits[:, 1])),
                                    logits[:, 2:3 + n_oct].argmax(1),
                                    logits[:, 3 + n_oct:].argmax(1)],
                                   axis=-1).astype(np.float32)
                    frames[f"song{j}"] = got
                    notes[f"song{j}"] = decode.frame2note(
                        got, t["onset_threshold"], t["offset_threshold"],
                        1 / t["frame_rate"])
                self.served[i] = (pair, frames, notes)

    def check(self):
        """[(name, value, limit)] of the numbers compared."""
        # the reference in f32: no TF32 in products or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        params = self.weights()
        n_oct = self.cfg["pitch_octave_num"]
        t = self.traffic
        prob = octave = pitch = 0.0
        mismatched = compared = frames_compared = 0
        with torch.no_grad():
            for i in self.sample():
                pair, frames, notes = self.served[i]
                for j in pair:
                    name = f"song{j}"
                    ref = self.reference_logits(params, self.pool[j])
                    got = np.asarray(frames[name], np.float64)
                    if got.shape[0] != ref.shape[0]:
                        raise AssertionError(
                            f"{name}: {got.shape[0]} served frames, the "
                            f"reference has {ref.shape[0]}")
                    p_ref = 1.0 / (1.0 + np.exp(-ref[:, :2]))
                    prob = max(prob, float(np.abs(got[:, :2] - p_ref).max()))
                    oct_logits = ref[:, 2:3 + n_oct]
                    cls_logits = ref[:, 3 + n_oct:]
                    rows = np.arange(len(got))
                    octave = max(octave, float(
                        (oct_logits.max(1)
                         - oct_logits[rows, got[:, 2].astype(int)]).max()))
                    pitch = max(pitch, float(
                        (cls_logits.max(1)
                         - cls_logits[rows, got[:, 3].astype(int)]).max()))
                    want = decode.frame2note(
                        frames[name], t["onset_threshold"],
                        t["offset_threshold"], 1 / t["frame_rate"])
                    mismatched += want != [list(x) for x in notes[name]]
                    compared += 1
                    frames_compared += len(got)
        self.compared = (compared, frames_compared)
        limits = self.limits
        return [("onset_offset_prob_gap", prob, limits["onset_offset_prob_gap"]),
                ("octave_logit_gap", octave, limits["octave_logit_gap"]),
                ("pitch_class_logit_gap", pitch,
                 limits["pitch_class_logit_gap"]),
                ("songs_with_other_notes", float(mismatched),
                 limits["songs_with_other_notes"])]
