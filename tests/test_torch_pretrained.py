"""Port parity, the deployment entry point: ``fetch`` and ``Pretrainer``
against the JAX ones on the same directories, then
``SingingTranscriber.from_hparams`` on ``tests/fixtures/
singing_transcriber_hyperparams.yaml`` (TINY through overrides) with a
``torch.save`` export and with a JAX msgpack export, and ``transcribe_file``
on seeded WAVs against the JAX ``SingingTranscriber.transcribe_file`` with
the same weights, float and int8, in f32: notes exactly, frame
probabilities within 2e-5 (int8: ``test_torch_quant.py``'s bar). A frame
whose two probabilities fall on either side of a threshold (within 2e-5 of
it in float) decides differently on the two packages, so notes are held
whenever no frame does; the count of such frames is reported."""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svt_speechbrain_tpu import inference as jinf
from svt_speechbrain_tpu.dataio.dataio import read_audio as jread_audio
from svt_speechbrain_tpu.dataio.dataio import write_audio
from svt_speechbrain_tpu.pretrained import fetching as jfetching
from svt_speechbrain_tpu.pretrained.interfaces import (
    SingingTranscriber as JSingingTranscriber)
from svt_speechbrain_tpu.tasks.amt import save_msgpack
from svt_speechbrain_tpu.utils import parameter_transfer as jtransfer
from svt_speechbrain_tpu.utils.checkpoints import PytreeHandle

from svt_speechbrain_tpu_torch import inference as tinf
from svt_speechbrain_tpu_torch.dataio.dataio import read_audio
from svt_speechbrain_tpu_torch.models.wav2vec2 import TINY_ARCH
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.pretrained import fetching
from svt_speechbrain_tpu_torch.pretrained.interfaces import (
    SingingTranscriber)
from svt_speechbrain_tpu_torch.tasks.amt import save_state_dict
from svt_speechbrain_tpu_torch.utils import parameter_transfer
from tests.conftest import REPO_ROOT
from tests.test_torch_serving import HP, tiny  # noqa: F401 (fixture)

YAML = os.path.join(REPO_ROOT, "tests", "fixtures",
                    "singing_transcriber_hyperparams.yaml")
SR = 16000
PROB_ATOL = 2e-5
TINY_OVERRIDES = (
    "wav2vec2: !new:svt_speechbrain_tpu_torch.models.wav2vec2."
    "HuggingFaceWav2Vec2 {source: facebook/wav2vec2-large-lv60, "
    f"output_norm: True, arch_overrides: {json.dumps(dict(TINY_ARCH))}}}\n"
    "feat_dim: 64\n")


# --------------------------------------------------------------- fetching
def _tree(root):
    return sorted((os.path.relpath(os.path.join(d, f), root),
                   os.path.realpath(os.path.join(d, f)))
                  for d, _, files in os.walk(root) for f in files)


def test_fetch_behaves_as_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.ckpt").write_text("one")
    (src / "b.ckpt").write_text("two")
    for mod, side in ((jfetching, "jax"), (fetching, "port")):
        dst = tmp_path / side
        mod.fetch("a.ckpt", str(src), savedir=dst)
        mod.fetch("b.ckpt", str(src), savedir=dst, save_filename="c.ckpt")
        # an existing destination is reused unless overwrite
        mod.fetch("b.ckpt", str(src), savedir=dst, save_filename="a.ckpt")
        assert (dst / "a.ckpt").read_text() == "one"
        mod.fetch("b.ckpt", str(src), savedir=dst, save_filename="a.ckpt",
                  overwrite=True)
        assert (dst / "a.ckpt").read_text() == "two"
        assert (dst / "a.ckpt").is_symlink()
        with pytest.raises(FileNotFoundError):
            mod.fetch("missing.ckpt", str(src), savedir=dst)
    assert [(n, p) for n, p in _tree(tmp_path / "jax")] == \
        [(n, p) for n, p in _tree(tmp_path / "port")]


@pytest.mark.parametrize("source", [
    "https://example.org/models", "http://host/x", "speechbrain/asr-model",
    "wav2vec2-large-lv60"])
def test_fetch_refuses_remote_sources(tmp_path, source):
    with pytest.raises(ValueError, match="no network"):
        fetching.fetch("hyperparams.yaml", source, savedir=tmp_path)


def test_fetch_of_a_missing_directory(tmp_path):
    with pytest.raises(FileNotFoundError):
        fetching.fetch("x.yaml", str(tmp_path / "missing" / "dir"),
                       savedir=tmp_path / "s")


def test_pretrainer_behaves_as_jax(tmp_path):
    """The same loadables, paths and default source collect the same links
    in both packages and load the same values."""
    src, other = tmp_path / "src", tmp_path / "other"
    src.mkdir()
    other.mkdir()
    rng = np.random.default_rng(0)
    w = {n: rng.standard_normal((3, 2)).astype(np.float32)
         for n in ("head", "extra")}
    for n, folder in (("head", other), ("extra", src)):
        donor = Linear(input_size=3, n_neurons=2)
        with torch.no_grad():
            donor.w.copy_(torch.from_numpy(w[n]))
        torch.save(donor.state_dict(), folder / f"{n}.ckpt")
    ours = {n: Linear(input_size=3, n_neurons=2) for n in w}
    pre = parameter_transfer.Pretrainer(
        collect_in=tmp_path / "port", loadables=ours,
        paths={"head": f"{other}/head.ckpt"})
    got = pre.collect_files(default_source=str(src))
    pre.load_collected()
    for n in w:
        assert np.array_equal(ours[n].w.detach().numpy(), w[n])
    store = {}
    theirs = {n: PytreeHandle(lambda n=n: store.get(n),
                              lambda t, n=n: store.__setitem__(n, t))
              for n in w}
    jpre = jtransfer.Pretrainer(collect_in=tmp_path / "jax",
                                loadables=theirs,
                                paths={"head": f"{other}/head.ckpt"})
    want = jpre.collect_files(default_source=str(src))
    assert {n: (p.name, os.path.realpath(p)) for n, p in got.items()} == \
        {n: (p.name, os.path.realpath(p)) for n, p in want.items()}
    assert parameter_transfer.Pretrainer.split_path("a/b/c.pt") == \
        jtransfer.Pretrainer.split_path("a/b/c.pt") == ["a/b", "c.pt"]
    assert parameter_transfer.Pretrainer.split_path("c.pt") == \
        jtransfer.Pretrainer.split_path("c.pt")
    calls = []
    hooked = parameter_transfer.Pretrainer(
        collect_in=tmp_path / "hooked", loadables={"head": ours["head"]},
        paths={"head": f"{other}/head.ckpt"},
        custom_hooks={"head": lambda obj, path: calls.append(path)})
    hooked.collect_files()
    hooked.load_collected()
    assert calls == [str(tmp_path / "hooked" / "head.ckpt")]


# ------------------------------------------------------------ from_hparams
def _export(tiny, folder, fmt):
    """An export folder: the inference yaml beside the weights, as the
    port's recipes (``.pt``) or the JAX ones (``.msgpack``) write them."""
    _, _, params, bridge, head = tiny
    os.makedirs(folder, exist_ok=True)
    shutil.copy(YAML, os.path.join(folder, "hyperparams.yaml"))
    if fmt == "pt":
        save_state_dict(bridge, os.path.join(folder, "wav2vec2.pt"))
        save_state_dict(head, os.path.join(folder, "model.pt"))
        return TINY_OVERRIDES
    save_msgpack(params["wav2vec2"], os.path.join(folder, "wav2vec2.msgpack"))
    save_msgpack(params["model"], os.path.join(folder, "model.msgpack"))
    return TINY_OVERRIDES + ("wav2vec2_file: wav2vec2.msgpack\n"
                             "model_file: model.msgpack\n")


def _wavs(folder, n=3, seed=5):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        wav = 0.3 * rng.standard_normal(int(rng.uniform(0.8, 2.6) * SR))
        path = os.path.join(folder, f"song{i}.wav")
        write_audio(path, wav.astype(np.float32), SR)
        paths.append(path)
    return paths


def _jax_interface(tiny, mode, chunk_seconds, batch_size):
    jb, jh, params, _, _ = tiny
    ji = JSingingTranscriber(modules={"wav2vec2": jb, "model": jh},
                             hparams=HP, quantize=mode,
                             batch_size=batch_size,
                             chunk_seconds=chunk_seconds)
    ji.params = params
    ji._transcriber = jinf.BatchedAMTTranscriber(
        jb, jh, ji._serving_params(), chunk_seconds=chunk_seconds,
        batch_size=batch_size, compute_dtype=jnp.float32)
    return ji


@pytest.mark.parametrize("fmt,mode", [("pt", None), ("pt", "int8"),
                                      ("msgpack", None)])
def test_from_hparams_transcribe_file_matches_jax(tiny, tmp_path, fmt,
                                                  mode):
    folder = str(tmp_path / "export")
    overrides = _export(tiny, folder, fmt)
    ti = SingingTranscriber.from_hparams(
        folder, savedir=str(tmp_path / "saved"), overrides=overrides,
        device="cpu", batch_size=2, chunk_seconds=1.0, quantize=mode,
        compute_dtype=torch.float32)
    assert sorted(os.listdir(tmp_path / "saved")) == \
        ["hyperparams.yaml", "model.ckpt", "wav2vec2.ckpt"]
    _, _, _, bridge, head = tiny
    for name, want in (("wav2vec2", bridge), ("model", head)):
        got = getattr(ti.mods, name).state_dict()
        assert sorted(got) == sorted(want.state_dict())
        for key, value in want.state_dict().items():
            assert torch.equal(got[key], value), key
    ji = _jax_interface(tiny, mode, 1.0, 2)
    paths = _wavs(tmp_path)
    songs = {os.path.basename(p): jread_audio(p) for p in paths}
    want_frames = ji._transcriber.predict_frames(songs)
    got_frames = ti._get_transcriber().predict_frames(songs)
    straddle = 0
    for name in songs:
        w, g = np.asarray(want_frames[name]), np.asarray(got_frames[name])
        if mode is None:
            np.testing.assert_allclose(g, w, atol=PROB_ATOL, rtol=0)
        else:
            # test_torch_quant.py's bar: a rare activation on a rounding
            # boundary lands on the other integer in one package
            diff = np.abs(g - w)
            assert np.median(diff) < 1e-5 and diff.max() < 5e-2
        for col, thres in ((0, HP["onset_threshold"]),
                           (1, HP["offset_threshold"])):
            straddle += int(((w[:, col] > thres) != (g[:, col] > thres))
                            .sum())
    notes = 0
    for path in paths:
        want = ji.transcribe_file(path)
        got = ti.transcribe_file(path)
        notes += len(want)
        if straddle == 0:
            assert got == want
    print(f"frames decided on other sides of a threshold: {straddle}")
    assert notes > 5
    assert isinstance(ti._get_transcriber(), tinf.BatchedAMTTranscriber)


def test_from_hparams_refusals_and_defaults(tiny, tmp_path):
    """A missing source raises ``FileNotFoundError``; a URL or hub id the
    no-network error; ``transcribe_file`` keys by the file's basename."""
    with pytest.raises(FileNotFoundError):
        SingingTranscriber.from_hparams(str(tmp_path / "nothing"),
                                        savedir=str(tmp_path / "s"),
                                        device="cpu")
    with pytest.raises(ValueError, match="no network"):
        SingingTranscriber.from_hparams("https://example.org/x",
                                        savedir=str(tmp_path / "s"),
                                        device="cpu")
    folder = str(tmp_path / "export")
    overrides = _export(tiny, folder, "pt")
    ti = SingingTranscriber.from_hparams(
        folder, savedir=str(tmp_path / "s2"), overrides=overrides,
        device="cpu", batch_size=2, chunk_seconds=1.0)
    assert ti.compute_dtype == torch.bfloat16
    assert ti.hparams.frame_rate == 49.8
    path = _wavs(tmp_path, n=1)[0]
    notes = ti.transcribe_file(path)
    assert notes == ti.transcribe_batch({"x": read_audio(path)})["x"]
