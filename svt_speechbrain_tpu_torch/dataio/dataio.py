"""Data I/O: CSV/JSON manifests, WAV files and the char/word helpers of
the tokenizers (port of ``svt_speechbrain_tpu/dataio/dataio.py:19-144``,
``:217-233``).

Reads return float32 samples in [-1, 1] through scipy, as the JAX package's
scipy path does (16-bit PCM / 32768). The native C++ decoder is not ported
(ROADMAP.md queue 1 item 21).
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
    """A WAV file → (float32 array (T, C), sample rate), the JAX package's
    scipy path (``dataio.py:84-111``)."""
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
