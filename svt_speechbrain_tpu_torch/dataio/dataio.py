"""Data I/O: CSV/JSON manifests, WAV files, label and token helpers,
pickles, checksums and an incremental CSV writer (port of
``svt_speechbrain_tpu/dataio/dataio.py``).

Reads return float32 samples in [-1, 1] through the native C++ decoder
(``svt_speechbrain_tpu_torch.native``), sliced without reading the whole
file, or through scipy when no compiler is available or ``SVT_NATIVE=0``
(16-bit PCM / 32768), as the JAX package reads them.
"""
from __future__ import annotations

import csv
import json
import os
import re

import numpy as np


def load_data_csv(csv_path, replacements={}):
    """CSV manifest → dict of dicts (``dataio.py:19``): the mandatory ``ID``
    column is the key, ``duration`` is cast to float and ``$var`` substrings
    are replaced from ``replacements``.

    Example
    -------
    >>> import os, tempfile
    >>> path = os.path.join(tempfile.mkdtemp(), "m.csv")
    >>> _ = open(path, "w").write("ID,duration,wav\\nu1,1.5,$root/a.wav\\n")
    >>> load_data_csv(path, {"root": "/data"})
    {'u1': {'duration': 1.5, 'wav': '/data/a.wav'}}
    """
    with open(csv_path, newline="") as csvfile:
        result = {}
        reader = csv.DictReader(csvfile, skipinitialspace=True)
        variable_finder = re.compile(r"\$([\w.]+)")
        for row in reader:
            try:
                data_id = row["ID"]
                del row["ID"]
            except KeyError:
                raise KeyError("CSV has to have an 'ID' field, with unique "
                               "ids for all data points")
            if data_id in result:
                raise ValueError(f"Duplicate id: {data_id}")
            for key, value in row.items():
                try:
                    row[key] = variable_finder.sub(
                        lambda match: str(replacements[match[1]]), value)
                except KeyError:
                    raise KeyError(f"The item {value} requires replacements "
                                   f"which were not supplied.")
            if "duration" in row:
                row["duration"] = float(row["duration"])
            result[data_id] = row
    return result


def load_data_json(json_path, replacements={}):
    """JSON manifest → dict of dicts (``dataio.py:49``); ``{var}`` in string
    values is replaced from ``replacements``."""
    with open(json_path) as f:
        out_json = json.load(f)
    pattern = re.compile(r"\{(\w*)\}")
    for data_id in out_json:
        for key, value in out_json[data_id].items():
            if isinstance(value, str):
                out_json[data_id][key] = pattern.sub(
                    lambda match: str(replacements.get(match[1], match[0])),
                    value)
    return out_json


def read_audio(waveforms_obj):
    """A path, or ``{"file": ..., "start": ..., "stop": ...}`` → float32
    samples, (T,) for mono, (T, C) otherwise (``dataio.py:62``)."""
    if isinstance(waveforms_obj, str):
        audio, _sr = _read_wav(waveforms_obj)
    else:
        audio, _sr = _read_wav(
            waveforms_obj["file"], start=int(waveforms_obj.get("start", 0)),
            stop=int(waveforms_obj.get("stop", 0)) or None)
    return audio.squeeze(-1) if audio.shape[-1] == 1 else audio


def read_audio_info(path):
    """(num_frames, sample_rate, num_channels) without reading samples."""
    import wave

    with wave.open(path, "rb") as w:
        return w.getnframes(), w.getframerate(), w.getnchannels()


def _read_wav(path, start=0, stop=None):
    """A WAV file → (float32 array (T, C), sample rate) (``dataio.py:84``):
    the native decoder when it builds, sliced reads never materialising a
    whole song in a loader worker; ``SVT_NATIVE=0`` forces scipy."""
    if os.environ.get("SVT_NATIVE", "1") != "0":
        from svt_speechbrain_tpu_torch import native

        result = native.wav_read(path, start=start, stop=stop)
        if result is not None:
            return result
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if start or stop is not None:
        data = data[start:stop]
    if data.ndim == 1:
        data = data[:, None]
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, sr


def write_audio(filepath, audio, samplerate):
    """Float audio in [-1, 1] → 16-bit PCM WAV (``dataio.py:114``); (C, T)
    input is taken as (T, C).

    Example
    -------
    >>> import os, tempfile
    >>> import numpy as np
    >>> path = os.path.join(tempfile.mkdtemp(), "a.wav")
    >>> write_audio(path, np.asarray([0.0, 0.5, -1.0]), 16000)
    >>> read_audio(path).tolist()
    [0.0, 0.499969482421875, -0.999969482421875]
    """
    from scipy.io import wavfile

    audio = np.asarray(audio)
    if audio.ndim == 2 and audio.shape[0] < audio.shape[1]:
        audio = audio.T
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    wavfile.write(filepath, samplerate, pcm)


def merge_csvs(data_folder, csv_lst, merged_csv):
    """Concatenate CSV manifests with identical headers (``dataio.py:126``);
    an existing ``merged_csv`` is left as it is."""
    write_path = os.path.join(data_folder, merged_csv)
    if os.path.isfile(write_path):
        return
    with open(os.path.join(data_folder, csv_lst[0])) as f:
        header = f.readline()
    lines = []
    for csv_file in csv_lst:
        with open(os.path.join(data_folder, csv_file)) as f:
            for i, line in enumerate(f):
                if i == 0:
                    if line != header:
                        raise ValueError("Different header for " + csv_file)
                    continue
                lines.append(line)
    with open(write_path, "w") as f:
        f.write(header)
        f.writelines(lines)


def merge_char(sequences, space="_"):
    """Char sequences → word sequences, split at ``space``
    (``dataio.py:217``).

    Example
    -------
    >>> merge_char([["a", "b", "_", "c", "d"]])
    [['ab', 'cd']]
    """
    return [[word for word in "".join(seq).split(space) if word]
            for seq in sequences]


def split_word(sequences, space="_"):
    """Word sequences → char sequences with ``space`` between the words
    (``dataio.py:229``).

    Example
    -------
    >>> split_word([["ab", "c"]])
    [['a', 'b', '_', 'c']]
    """
    return [list(space.join(seq)) for seq in sequences]


def length_to_mask(length, max_len=None, dtype=np.float32):
    """Binary numpy mask from absolute lengths (``dataio.py:150``); the
    tensor version is ``nnet.losses.length_to_mask``.

    Example
    -------
    >>> length_to_mask([1, 3]).tolist()
    [[1.0, 0.0, 0.0], [1.0, 1.0, 1.0]]
    """
    length = np.asarray(length)
    if max_len is None:
        max_len = int(length.max())
    return (np.arange(max_len)[None, :] < length[:, None]).astype(dtype)


def prepend_bos_token(label, bos_index):
    """``bos_index`` before each row of a (B, L) label tensor
    (``dataio.py:159``).

    Example
    -------
    >>> import torch
    >>> prepend_bos_token(torch.tensor([[5, 6], [7, 8]]), bos_index=1).tolist()
    [[1, 5, 6], [1, 7, 8]]
    """
    import torch

    label = torch.as_tensor(label)
    bos = torch.full((label.shape[0], 1), bos_index, dtype=label.dtype,
                     device=label.device)
    return torch.cat([bos, label], dim=1)


def append_eos_token(label, length, eos_index):
    """A column of zeros after a (B, L) label tensor, with ``eos_index`` at
    each row's absolute ``length`` (``dataio.py:174``).

    Example
    -------
    >>> import torch
    >>> append_eos_token(torch.tensor([[5, 6], [7, 0]]), [2, 1], 9).tolist()
    [[5, 6, 9], [7, 9, 0]]
    """
    import torch

    label = torch.as_tensor(label)
    b = label.shape[0]
    out = torch.cat([label, label.new_zeros((b, 1))], dim=1)
    pos = torch.as_tensor(length, device=label.device).to(torch.int64)
    out[torch.arange(b, device=label.device), pos] = eos_index
    return out


def read_audio_multichannel(waveforms_obj):
    """One or several files, their channels stacked to (T, C) and cut to
    the shortest; a path or ``{"files": [...], "start": s, "stop": e}``
    (``dataio.py:185``)."""
    if isinstance(waveforms_obj, str):
        files, start, stop = [waveforms_obj], 0, None
    else:
        files = waveforms_obj.get("files", waveforms_obj.get("file"))
        if isinstance(files, str):
            files = [files]
        start = waveforms_obj.get("start", 0)
        stop = waveforms_obj.get("stop", None)
    chans = []
    for f in files:
        wav, _sr = _read_wav(f, start=start, stop=stop)
        chans.append(wav[:, None] if wav.ndim == 1 else wav)
    n = min(c.shape[0] for c in chans)
    return np.concatenate([c[:n] for c in chans], axis=-1)


def relative_time_to_absolute(batch, relative_lens, rate):
    """Relative lengths → seconds, rounded to 8 decimals
    (``dataio.py:205``)."""
    max_len = batch.shape[1]
    return np.round(np.asarray(relative_lens) * max_len / rate, decimals=8)


def convert_index_to_lab(batch, ind2lab):
    """Index sequences → label lists (``dataio.py:212``).

    Example
    -------
    >>> convert_index_to_lab([[1, 0]], {0: "a", 1: "b"})
    [['b', 'a']]
    """
    return [[ind2lab[int(i)] for i in seq] for seq in batch]


def save_pkl(obj, file):
    """Pickle ``obj`` to ``file`` (``dataio.py:235``)."""
    import pickle

    with open(file, "wb") as f:
        pickle.dump(obj, f)


def load_pkl(file):
    """Unpickle ``file`` (``dataio.py:243``)."""
    import pickle

    with open(file, "rb") as f:
        return pickle.load(f)


load_pickle = load_pkl


def write_txt_file(data, filename, sampling_rate=None):
    """One line a item of ``data`` (``dataio.py:254``)."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as f:
        for line in data:
            f.write(str(line) + "\n")


def get_md5(file):
    """The MD5 checksum of a file (``dataio.py:264``)."""
    import hashlib

    hash_md5 = hashlib.md5()
    with open(file, "rb") as f:
        for chunk in iter(lambda: f.read(65536), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def save_md5(files, out_file):
    """{file: md5} pickled to ``out_file`` (``dataio.py:275``)."""
    save_pkl({f: get_md5(f) for f in files}, out_file)


def write_stdout(data, filename=None):
    """Print each line of ``data`` (``dataio.py:281``)."""
    for line in data:
        print(line)


class IterativeCSVWriter:
    """A CSV written row by row, by position or by keyword with defaults
    (``dataio.py:287``).

    Example
    -------
    >>> import io
    >>> out = io.StringIO()
    >>> w = IterativeCSVWriter(out, ["wav", "spk"], defaults={"spk": "s0"})
    >>> w.write(ID="u1", wav="a.wav")
    >>> w.write_batch(ID=["u2", "u3"], wav=["b.wav", "c.wav"], spk=["s1", "s2"])
    >>> out.getvalue().splitlines()
    ['ID,wav,spk', 'u1,a.wav,s0', 'u2,b.wav,s1', 'u3,c.wav,s2']
    """

    def __init__(self, outstream, data_fields, defaults={}):
        self._outstream = outstream
        self.fields = ["ID"] + data_fields
        self.defaults = defaults
        self._outstream.write(",".join(self.fields))

    def set_default(self, field, value):
        if field not in self.fields:
            raise ValueError(f"{field} is not a field in this CSV")
        self.defaults[field] = value

    def write(self, *args, **kwargs):
        if args and kwargs:
            raise ValueError("Use either positional fields or keyword "
                             "fields")
        if args:
            if len(args) != len(self.fields):
                raise ValueError("Need consistent fields")
            to_write = [str(arg) for arg in args]
        else:
            full = dict(self.defaults, **kwargs)
            to_write = [str(full.get(field, "")) for field in self.fields]
        self._outstream.write("\n" + ",".join(to_write))

    def write_batch(self, *args, **kwargs):
        if args and kwargs:
            raise ValueError("Use either positional fields or keyword "
                             "fields")
        if args:
            if len(args) != len(self.fields):
                raise ValueError("Need consistent fields")
            for arg_row in zip(*args):
                self.write(*arg_row)
        else:
            for row in zip(*kwargs.values()):
                self.write(**dict(zip(kwargs.keys(), row)))


def read_kaldi_lab(kaldi_ali, kaldi_lab_opts):
    """Kaldi alignment labels (``dataio.py:327``); needs the optional
    ``kaldi_io`` package and Kaldi's binaries on the path."""
    try:
        import kaldi_io
    except ImportError as e:
        raise ImportError(
            "read_kaldi_lab needs the optional kaldi_io package") from e
    return dict(kaldi_io.read_vec_int_ark(
        f"gunzip -c {kaldi_ali}/ali*.gz | "
        f"{kaldi_lab_opts} {kaldi_ali}/final.mdl ark:- ark:-|"))
