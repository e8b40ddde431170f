"""Batched long-form and streaming AMT inference (port of
``svt_speechbrain_tpu/inference.py``: ``BatchedAMTTranscriber``,
``StreamSession``, ``StreamingServer``, ``StreamingAMTTranscriber``).

Songs are cut host-side into fixed windows, chunks of all songs are batched
together, and each batch runs encoder → head → sigmoid/argmax compaction on
the device into one (B, F, 4) array, copied back once per batch and
stitched per song. The host pipeline uses pinned host buffers and the
current CUDA stream: uploads and the copy back are asynchronous, and up to
``depth`` batches stay in flight before the oldest is stitched.

The streaming classes run the same batch program whenever a window of
samples is full: ``StreamingAMTTranscriber`` one stream at batch 1,
``StreamingServer`` many sessions multiplexed into shared batches. Both
decode incrementally and emit exactly the offline transcriber's notes. A
bridge quantized by ``models.quantize.quantize_wav2vec2`` serves through
every class here like a float one.
"""
from __future__ import annotations

import copy
from collections import deque

import numpy as np
import torch

from svt_speechbrain_tpu_torch import resolve_device
from svt_speechbrain_tpu_torch.utils.amt import (IncrementalFrame2Note,
                                                 frame2note, frame2note_fast)


class BatchedAMTTranscriber:
    """Chunk-batched singing transcription on one device.

    Arguments
    ---------
    bridge : models.wav2vec2.HuggingFaceWav2Vec2
    head : nnet.linear.Linear
        Frame head: 2 + (octaves+1) + (classes+1) logits.
    chunk_seconds, batch_size, sample_rate, frame_rate, pitch_octave_num,
    pitch_class_num, onset_threshold, offset_threshold :
        As in the JAX transcriber.
    compute_dtype : torch dtype
        bf16 by default: every floating parameter and buffer is cast to it
        (on copies; the caller's modules are left as they are). Of an int8
        bridge that rounds ``w_scale`` to bf16 and leaves ``w_q8`` as it is,
        as the JAX transcriber's cast of every f32 leaf does.
    chunking : "ceil" | "reference" | "song"
        Equal zero-padded windows; the reference's utterance split with the
        last chunk padded to 1 s buckets; or one window per song padded to
        ``song_bucket_seconds``.
    compact : "f32" | "u16"
        Exact float32 probabilities, or probabilities quantized to 1/65535
        (half the bytes back per batch).
    device :
        CUDA unless the caller names another device (``device="cpu"`` runs
        the plain versions of the kernels).
    """

    def __init__(self, bridge, head, chunk_seconds=5.0, batch_size=32,
                 sample_rate=16000, frame_rate=49.8, pitch_octave_num=4,
                 pitch_class_num=12, onset_threshold=0.4,
                 offset_threshold=0.5, compute_dtype=torch.bfloat16,
                 chunking="ceil", compact="f32", song_bucket_seconds=30.0,
                 device=None):
        if chunking not in ("ceil", "reference", "song"):
            raise ValueError(chunking)
        if compact not in ("f32", "u16"):
            raise ValueError(compact)
        self.device = resolve_device(device)
        self.config = bridge.config
        self.chunk_samples = int(round(chunk_seconds * sample_rate))
        self.batch_size = batch_size
        self.sample_rate = sample_rate
        self.frame_rate = frame_rate
        self.pitch_octave_num = pitch_octave_num
        self.pitch_class_num = pitch_class_num
        self.onset_threshold = onset_threshold
        self.offset_threshold = offset_threshold
        self.compute_dtype = compute_dtype
        self.chunking = chunking
        self.compact = compact
        self.chunk_frames = self.config.output_length(self.chunk_samples)
        self.pad_bucket = sample_rate
        self.song_bucket = int(round(song_bucket_seconds * sample_rate))
        self.bridge = copy.deepcopy(bridge).to(self.device,
                                               compute_dtype).eval()
        self.head = copy.deepcopy(head).to(self.device, compute_dtype).eval()

    @torch.inference_mode()
    def _forward(self, wavs, wav_lens):
        """(B, T) wavs (int16 or float) and (B,) relative lengths on the
        device → packed (B, F, 4) ``[onset_p, offset_p, octave, class]``
        (int16 codes offset by 32768 in "u16" mode)."""
        if wavs.dtype == torch.int16:
            # int16 PCM feed, scaled on the device: half the upload bytes
            wavs = wavs.to(self.compute_dtype) * (1.0 / 32768.0)
        wavs = wavs.to(self.compute_dtype)
        feats = self.bridge(wavs, wav_lens=wav_lens)
        logits = self.head(feats).float()
        n_oct = self.pitch_octave_num
        onset = torch.sigmoid(logits[:, :, 0])
        offset = torch.sigmoid(logits[:, :, 1])
        octave = torch.argmax(logits[:, :, 2:3 + n_oct], dim=-1).float()
        pitch = torch.argmax(logits[:, :, 3 + n_oct:], dim=-1).float()
        if self.compact == "u16":
            packed = torch.stack([torch.round(onset * 65535.0),
                                  torch.round(offset * 65535.0), octave,
                                  pitch], dim=-1)
            return (packed - 32768.0).to(torch.int16)
        return torch.stack([onset, offset, octave, pitch], dim=-1)

    def _chunk_song(self, wav):
        """One waveform → (chunks, true frames, widths, true lengths)."""
        n = len(wav)
        cs = self.chunk_samples
        dtype = np.int16 if wav.dtype == np.int16 else np.float32
        if self.chunking == "song":
            width = int(max(1, -(-n // self.song_bucket)) * self.song_bucket)
            buf = np.zeros(width, dtype=dtype)
            buf[:n] = wav
            return [buf], [self.config.output_length(n)], [width], [n]
        if self.chunking == "reference":
            n_chunks = max(1, round(n / cs))
        else:
            n_chunks = max(1, -(-n // cs))
        chunks, frames, widths, true_lens = [], [], [], []
        for i in range(n_chunks):
            if i == n_chunks - 1 and self.chunking == "reference":
                part = wav[i * cs:]
            else:
                part = wav[i * cs:(i + 1) * cs]
            if len(part) == cs or self.chunking != "reference":
                width = cs
            else:
                width = int(-(-len(part) // self.pad_bucket) * self.pad_bucket)
            buf = np.zeros(width, dtype=dtype)
            buf[:len(part)] = part
            chunks.append(buf)
            frames.append(self.config.output_length(len(part)))
            widths.append(width)
            true_lens.append(len(part))
        return chunks, frames, widths, true_lens

    def _jobs(self, songs):
        by_width = {}  # width → (order list, chunk list, rel-length list)
        for name, wav in songs.items():
            wav = np.asarray(wav)
            if wav.dtype != np.int16:
                wav = wav.astype(np.float32)
            chunks, frames, widths, true_lens = self._chunk_song(wav)
            for i in range(len(chunks)):
                order, chunk_list, len_list = by_width.setdefault(
                    widths[i], ([], [], []))
                order.append((name, i, frames[i]))
                chunk_list.append(chunks[i])
                len_list.append(true_lens[i] / widths[i])
        b = self.batch_size
        jobs = []
        for width, (order, chunk_list, len_list) in sorted(
                by_width.items(), key=lambda kv: -len(kv[1][1])):
            for bi in range(-(-len(chunk_list) // b)):
                batch = chunk_list[bi * b:(bi + 1) * b]
                lens = len_list[bi * b:(bi + 1) * b]
                real = len(batch)
                if real < b:   # batch-padding rows: zeros, length 0
                    batch = batch + [np.zeros(width, batch[0].dtype)] * (b - real)
                    lens = lens + [0.0] * (b - real)
                jobs.append((np.stack(batch), np.asarray(lens, np.float32),
                             order[bi * b:bi * b + real]))
        return jobs

    def predict_frames(self, songs, depth=2):
        """songs: name → 16 kHz waveform (float, or int16 PCM). Returns
        name → (frames, 4) float32 ``[onset_p, offset_p, octave, class]``,
        stitched in chunk order with padding frames trimmed."""
        cuda = self.device.type == "cuda"
        results = {name: {} for name in songs}
        pending = deque()
        for wavs, lens, order in self._jobs(songs):
            wavs_t, lens_t = torch.from_numpy(wavs), torch.from_numpy(lens)
            if cuda:
                wavs_t, lens_t = wavs_t.pin_memory(), lens_t.pin_memory()
            out = self._forward(wavs_t.to(self.device, non_blocking=True),
                                lens_t.to(self.device, non_blocking=True))
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=cuda)
            host.copy_(out, non_blocking=cuda)
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            pending.append((host, done, order))
            while len(pending) > depth:
                self._stitch(*pending.popleft(), results)
        while pending:
            self._stitch(*pending.popleft(), results)
        return {name: np.concatenate([per_chunk[i]
                                      for i in range(len(per_chunk))], axis=0)
                for name, per_chunk in results.items()}

    @staticmethod
    def _unpack(packed):
        """The device's packed output as float32 rows ("u16" codes back to
        probabilities)."""
        if packed.dtype == np.int16:
            stacked = packed.astype(np.float32) + 32768.0
            stacked[:, :, :2] *= 1.0 / 65535.0
            return stacked
        return packed

    def run_batch(self, wavs, lens):
        """One batch, synchronously: (B, T) numpy wavs (int16 or float32)
        and (B,) relative lengths → (B, F, 4) float32 rows on the host. The
        streaming classes run their windows through this."""
        out = self._forward(
            torch.from_numpy(np.ascontiguousarray(wavs)).to(self.device),
            torch.from_numpy(np.asarray(lens, np.float32)).to(self.device))
        return self._unpack(out.cpu().numpy())

    def _stitch(self, host, done, order, results):
        if done is not None:
            done.synchronize()
        stacked = self._unpack(host.numpy())
        for j, (name, chunk_idx, frames) in enumerate(order):
            results[name][chunk_idx] = stacked[j, :frames]

    def transcribe(self, songs, fast=True):
        """name → waveform ⇒ name → [[onset_s, offset_s, midi], ...].
        ``fast`` picks the vectorized decoder; both give the same notes.

        Example
        -------
        >>> import numpy as np, torch
        >>> from svt_speechbrain_tpu_torch.flagship import build_flagship
        >>> model = build_flagship(tiny=True, device="cpu")
        >>> tr = BatchedAMTTranscriber(model.bridge, model.head,
        ...                            chunk_seconds=1.0, batch_size=2,
        ...                            compute_dtype=torch.float32,
        ...                            device="cpu")
        >>> notes = tr.transcribe({"song1": np.zeros(24000, np.float32)})
        >>> sorted(notes), all(len(ev) == 3 for ev in notes["song1"])
        (['song1'], True)
        """
        decode = frame2note_fast if fast else frame2note
        frames = self.predict_frames(songs)
        return {name: decode(fi, onset_thres=self.onset_threshold,
                             offset_thres=self.offset_threshold,
                             frame_size=1 / self.frame_rate)
                for name, fi in frames.items()}


def _append_pcm(buffer, samples):
    """Append a 1-D PCM piece to a (possibly empty) buffered partial window.

    Rejects a dtype switch mid-window: concatenating int16 PCM into a float
    window (or the reverse) would promote silently and skip the device's
    1/32768 scaling, making the int16 samples about 32768 times too loud.
    """
    samples = np.asarray(samples)
    if samples.ndim != 1:
        raise ValueError("feed() takes a 1-D sample array")
    if not len(samples):
        # an empty feed is a no-op: concatenating an empty float array
        # would promote a buffered int16 window
        return samples if buffer is None else buffer
    if buffer is None or not len(buffer):
        return samples
    if samples.dtype != buffer.dtype:
        raise ValueError(f"dtype switch mid-window: buffered "
                         f"{buffer.dtype}, fed {samples.dtype}")
    return np.concatenate([buffer, samples])


class StreamSession:
    """One live stream inside a ``StreamingServer`` (made by
    ``server.open()``, never directly). ``feed()`` PCM as it arrives; notes
    are final whenever the server runs a batch and are handed back, exactly
    once, through this session's ``feed()``/``poll()``/``flush()``.

    Example
    -------
    >>> import numpy as np, torch
    >>> from svt_speechbrain_tpu_torch.flagship import build_flagship
    >>> model = build_flagship(tiny=True, device="cpu")
    >>> server = StreamingServer(model.bridge, model.head, batch_size=2,
    ...                          chunk_seconds=0.5,
    ...                          compute_dtype=torch.float32, device="cpu")
    >>> a, b = server.open("alice"), server.open("bob")
    >>> _ = a.feed(np.zeros(12000, np.float32))   # buffers and auto-pumps
    >>> _ = b.feed(np.zeros(5000, np.float32))
    >>> notes_a, notes_b = a.flush(), b.flush()   # forces a final pump
    >>> all(len(ev) == 3 for ev in notes_a + notes_b)
    True
    """

    def __init__(self, server, name, decoder):
        self._server = server
        self.name = name
        self._decoder = decoder
        self._buffer = None
        self._done = False
        self._notes = []  # final, not yet handed to the caller

    def _take(self):
        out, self._notes = self._notes, []
        return out

    def feed(self, samples):
        """Append PCM samples (float32 or int16, (T,)). Full windows queue
        up on the server, which runs a batch whenever one is full. Returns
        the notes final for THIS session so far."""
        if self._done:
            raise RuntimeError("stream already flushed")
        self._buffer = _append_pcm(self._buffer, samples)
        cs = self._server._tr.chunk_samples
        while len(self._buffer) >= cs:
            self._server._enqueue(self, self._buffer[:cs], cs)
            self._buffer = self._buffer[cs:]
        self._server._auto_pump()
        return self._take()

    def poll(self):
        """Notes final for this session since the last hand-over (by another
        session's auto-pump, or an explicit ``server.pump()``)."""
        return self._take()

    def flush(self):
        """End this stream: queue the last partial window (zero-padded, with
        exact-lengths masking), force a server pump, and close any open
        note. Idempotent; returns the remaining notes."""
        if self._done:
            return []
        self._done = True
        if self._buffer is not None and len(self._buffer):
            tail = np.zeros(self._server._tr.chunk_samples,
                            self._buffer.dtype)
            tail[:len(self._buffer)] = self._buffer
            self._server._enqueue(self, tail, len(self._buffer))
        self._buffer = None
        self._server.pump()
        self._server._n_open -= 1
        return self._take() + self._decoder.flush()


class StreamingServer:
    """Multiplexed low-latency serving: N concurrent PCM streams share one
    batched chunk program (``inference.py:458``).

    - each ``open()`` returns a ``StreamSession`` with its own buffer and
      ``IncrementalFrame2Note`` decoder;
    - full windows of all sessions queue up first in, first out; as soon as
      ``batch_size`` of them are ready the server runs one batch (rows it
      cannot fill are rows of length 0, masked like the offline path's
      batch padding, so short batches stay exact);
    - ``pump()`` forces the queue through, a partial last batch included:
      call it on a latency deadline; ``flush()`` of any session calls it.

    Per session the notes are exactly what a dedicated
    ``StreamingAMTTranscriber`` emits for the same audio: rows of a batch
    do not depend on each other. Drive one server from one thread: sessions
    share its queue, so concurrent ``feed()`` calls need a lock outside.
    Extra keyword arguments (``compute_dtype``, ``compact``, ``device``)
    go to the ``BatchedAMTTranscriber`` inside.
    """

    def __init__(self, bridge, head, batch_size=8, chunk_seconds=5.0,
                 sample_rate=16000, frame_rate=49.8, onset_threshold=0.4,
                 offset_threshold=0.5, **kwargs):
        self._tr = BatchedAMTTranscriber(
            bridge, head, chunk_seconds=chunk_seconds,
            batch_size=batch_size, sample_rate=sample_rate,
            frame_rate=frame_rate, onset_threshold=onset_threshold,
            offset_threshold=offset_threshold, chunking="ceil", **kwargs)
        self._decoder_args = (onset_threshold, offset_threshold,
                              1.0 / frame_rate)
        self._queue = []  # FIFO of (session, (cs,) window, true samples)
        self._n_open = 0
        self._n_sessions = 0

    @property
    def pending(self):
        """Windows queued but not yet run."""
        return len(self._queue)

    @property
    def open_sessions(self):
        """Sessions opened and not yet flushed."""
        return self._n_open

    def open(self, name=None):
        """Start a new stream; ``name`` defaults to ``"stream<N>"``."""
        on, off, fs = self._decoder_args
        if name is None:
            name = f"stream{self._n_sessions}"
        self._n_sessions += 1
        self._n_open += 1
        return StreamSession(self, name,
                             IncrementalFrame2Note(on, off, frame_size=fs))

    def _enqueue(self, session, window, true_samples):
        self._queue.append((session, window, true_samples))

    def _auto_pump(self):
        b = self._tr.batch_size
        while len(self._queue) >= b:
            self._run_batch(self._queue[:b])
            del self._queue[:b]

    def pump(self):
        """Run every queued window now (the last batch may be partial).
        Returns the number of windows run; final notes land in their
        sessions (``poll()`` them)."""
        n = len(self._queue)
        b = self._tr.batch_size
        while self._queue:
            take = self._queue[:b]
            del self._queue[:len(take)]
            self._run_batch(take)
        return n

    def _run_batch(self, entries):
        tr = self._tr
        cs = tr.chunk_samples
        rows, lens = [], []
        # int16 rows go up as int16 only when the whole batch is int16 (the
        # device scales by 1/32768 on dtype); a mixed batch converts its
        # int16 rows to float32 on the host, which loses nothing
        all_i16 = all(e[1].dtype == np.int16 for e in entries)
        for _, window, true_samples in entries:
            if not all_i16 and window.dtype == np.int16:
                window = window.astype(np.float32) * (1.0 / 32768.0)
            rows.append(window.astype(np.int16 if all_i16 else np.float32,
                                      copy=False))
            lens.append(true_samples / cs)
        pad_dtype = np.int16 if all_i16 else np.float32
        while len(rows) < tr.batch_size:
            rows.append(np.zeros(cs, pad_dtype))
            lens.append(0.0)
        out = tr.run_batch(np.stack(rows), lens)
        for j, (session, _, true_samples) in enumerate(entries):
            f = tr.config.output_length(true_samples)
            session._notes += session._decoder.feed(out[j, :f])


class StreamingAMTTranscriber:
    """Low-latency streaming transcription (``inference.py:575``):
    ``feed()`` PCM as it arrives and receive note events as soon as they
    are final; ``flush()`` at the end of the stream.

    The same batch program as ``BatchedAMTTranscriber`` runs (at batch 1)
    every time a full window of samples has arrived, and an
    ``IncrementalFrame2Note`` decoder emits notes with bounded lookahead.
    The whole emitted stream is exactly what the offline transcriber's
    exact decode gives for the same audio. Latency is one chunk (5 s by
    default) plus the decoder's 4-frame peak lookahead.

    Example
    -------
    >>> import numpy as np, torch
    >>> from svt_speechbrain_tpu_torch.flagship import build_flagship
    >>> model = build_flagship(tiny=True, device="cpu")
    >>> st = StreamingAMTTranscriber(model.bridge, model.head,
    ...                              chunk_seconds=0.5,
    ...                              compute_dtype=torch.float32,
    ...                              device="cpu")
    >>> notes = st.feed(np.zeros(12000, np.float32)) + st.flush()
    >>> all(len(ev) == 3 for ev in notes), st.flush()
    (True, [])
    """

    def __init__(self, bridge, head, chunk_seconds=5.0, sample_rate=16000,
                 frame_rate=49.8, onset_threshold=0.4, offset_threshold=0.5,
                 **kwargs):
        self._tr = BatchedAMTTranscriber(
            bridge, head, chunk_seconds=chunk_seconds, batch_size=1,
            sample_rate=sample_rate, frame_rate=frame_rate,
            onset_threshold=onset_threshold,
            offset_threshold=offset_threshold, chunking="ceil", **kwargs)
        self._decoder = IncrementalFrame2Note(
            onset_threshold, offset_threshold, frame_size=1.0 / frame_rate)
        self._buffer = None
        self._done = False

    def _run_chunk(self, chunk, true_samples):
        tr = self._tr
        if chunk.dtype != np.int16:
            chunk = chunk.astype(np.float32, copy=False)
        rows = tr.run_batch(chunk[None], [true_samples / len(chunk)])
        return self._decoder.feed(
            rows[0, :tr.config.output_length(true_samples)])

    def feed(self, samples):
        """Append PCM samples (float32 or int16, (T,)); returns the notes
        made final by this piece as ``[[onset_s, offset_s, midi], ...]``."""
        if self._done:
            raise RuntimeError("stream already flushed")
        self._buffer = _append_pcm(self._buffer, samples)
        notes = []
        cs = self._tr.chunk_samples
        while len(self._buffer) >= cs:
            notes += self._run_chunk(self._buffer[:cs], cs)
            self._buffer = self._buffer[cs:]
        return notes

    def flush(self):
        """End the stream: decode the last partial window (zero-padded, with
        exact-lengths masking, like the offline ceil chunker) and close any
        open note."""
        if self._done:
            return []
        self._done = True
        notes = []
        if self._buffer is not None and len(self._buffer):
            tail = np.zeros(self._tr.chunk_samples, self._buffer.dtype)
            tail[:len(self._buffer)] = self._buffer
            notes += self._run_chunk(tail, len(self._buffer))
        self._buffer = None
        return notes + self._decoder.flush()
