"""Port parity, the serving surface: ``SingingTranscriber`` (float and
int8), ``StreamingAMTTranscriber``, ``StreamingServer`` and their guards,
``IncrementalFrame2Note``, ``transcription_eval`` and ``convert_hf`` against
the JAX package on the CPU at TINY_ARCH in f32: same weights, same audio."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu import inference as jinf
from svt_speechbrain_tpu.models import convert_hf as jconvert_hf
from svt_speechbrain_tpu.models import quantize as jquantize
from svt_speechbrain_tpu.models.wav2vec2 import (
    HuggingFaceWav2Vec2 as JBridge, TINY_ARCH as J_TINY_ARCH,
    Wav2Vec2Config as JConfig)
from svt_speechbrain_tpu.nnet.linear import Linear as JLinear
from svt_speechbrain_tpu.pretrained.interfaces import (
    SingingTranscriber as JSingingTranscriber)
from svt_speechbrain_tpu.utils import amt as jamt
from svt_speechbrain_tpu.utils import transcription_eval as jeval

from svt_speechbrain_tpu_torch import inference as tinf
from svt_speechbrain_tpu_torch.convert_jax import (load_jax_params,
                                                   module_tree)
from svt_speechbrain_tpu_torch.flagship import build_modules
from svt_speechbrain_tpu_torch.models import convert_hf
from svt_speechbrain_tpu_torch.models.quantize import quantize_wav2vec2
from svt_speechbrain_tpu_torch.models.wav2vec2 import (Wav2Vec2Config,
                                                       Wav2Vec2Encoder)
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.pretrained.interfaces import (
    Pretrained, SingingTranscriber)
from svt_speechbrain_tpu_torch.utils import amt as tamt
from svt_speechbrain_tpu_torch.utils import transcription_eval as teval
from tests.torch_threads import two_torch_threads  # noqa: F401

HP = {"frame_rate": 49.8, "onset_threshold": 0.4, "offset_threshold": 0.5}
SR = 16000
F32 = dict(compute_dtype=torch.float32, device="cpu")
MODES = [None, "int8"]


@pytest.fixture(scope="module")
def tiny():
    """JAX-initialised TINY flagship weights, in both packages."""
    jb = JBridge(source="facebook/wav2vec2-large-lv60", output_norm=True,
                 arch_overrides=dict(J_TINY_ARCH))
    jh = JLinear(input_size=64, n_neurons=20)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = jax.jit(lambda a, b: {"wav2vec2": jb.init(a),
                                   "model": jh.init(b)})(k1, k2)
    bridge, head = build_modules(tiny=True)
    load_jax_params(jax.tree_util.tree_map(np.asarray, params), bridge, head)
    return jb, jh, params, bridge, head


def _jax_params(params, mode):
    if mode is None:
        return params
    return {"wav2vec2": jquantize.quantize_wav2vec2(params["wav2vec2"]),
            "model": params["model"]}


def _port_bridge(bridge, mode):
    return bridge if mode is None else quantize_wav2vec2(bridge)


def _songs(seed, n, min_s=0.7, max_s=3.1):
    rng = np.random.default_rng(seed)
    return {f"s{i}": rng.normal(size=int(rng.uniform(min_s, max_s) * SR))
            .astype(np.float32) for i in range(n)}


def _interfaces(tiny, mode, **kw):
    """The two packages' interfaces on the same weights."""
    jb, jh, params, bridge, head = tiny
    ji = JSingingTranscriber(modules={"wav2vec2": jb, "model": jh},
                             hparams=HP, quantize=mode, **kw)
    ji.params = params
    ti = SingingTranscriber(modules={"wav2vec2": bridge, "model": head},
                            hparams=HP, quantize=mode, device="cpu", **kw)
    return ji, ti


# ------------------------------------------------------------ the interface
@pytest.mark.parametrize("mode", MODES)
def test_singing_transcriber_matches_jax(tiny, mode):
    """``transcribe_batch`` in f32 on both sides: the interfaces build bf16
    transcribers, whose roundings differ between the frameworks, so the test
    installs an f32 transcriber over each interface's own serving weights."""
    ji, ti = _interfaces(tiny, mode, batch_size=2, chunk_seconds=1.0)
    jb, jh, _, _, head = tiny
    ji._transcriber = jinf.BatchedAMTTranscriber(
        jb, jh, ji._serving_params(), chunk_seconds=1.0, batch_size=2,
        compute_dtype=jnp.float32)
    ti._transcriber = tinf.BatchedAMTTranscriber(
        ti._serving_bridge(), head, chunk_seconds=1.0, batch_size=2, **F32)
    songs = _songs(3, 3)
    want = ji.transcribe_batch(songs)
    got = ti.transcribe_batch(songs)
    assert sum(len(v) for v in want.values()) > 10        # not vacuous
    assert got == want
    quantized = any(n.endswith("w_q8")
                    for n, _ in ti._transcriber.bridge.named_buffers())
    assert quantized == (mode == "int8")


def test_int8_interface_keeps_to_the_float_notes(tiny):
    """The JAX package's own bar for int8 against float on random weights
    (``tests/test_quant.py``): equal note times, and the pitch (an argmax
    over near-uniform logits) agreeing on more than 0.7 of the notes."""
    _, _, _, bridge, head = tiny
    wav = np.random.default_rng(0).normal(size=32000).astype(np.float32)
    notes = {}
    for mode in MODES:
        iface = SingingTranscriber(
            modules={"wav2vec2": bridge, "model": head}, hparams=HP,
            batch_size=2, chunk_seconds=1.0, quantize=mode, device="cpu")
        notes[mode] = iface.transcribe_batch({"s": wav})["s"]
        assert iface._get_transcriber().compute_dtype == torch.bfloat16
    assert notes["int8"]

    def times(ns):
        return [(round(n[0], 4), round(n[1], 4)) for n in ns]
    assert times(notes["int8"]) == times(notes[None])
    agree = sum(a[2] == b[2] for a, b in zip(notes["int8"], notes[None]))
    assert agree / len(notes[None]) > 0.7


def test_interface_checks_its_arguments(tiny, tmp_path):
    _, _, _, bridge, head = tiny
    modules = {"wav2vec2": bridge, "model": head}
    with pytest.raises(ValueError, match="int4"):
        SingingTranscriber(modules=modules, hparams=HP, quantize="int4",
                           device="cpu")
    with pytest.raises(ValueError, match="frame_rate"):
        SingingTranscriber(modules=modules, hparams={}, device="cpu")
    with pytest.raises(ValueError, match="model"):
        SingingTranscriber(modules={"wav2vec2": bridge}, hparams=HP,
                           device="cpu")
    iface = SingingTranscriber(modules=modules, hparams=HP, device="cpu")
    with pytest.raises(FileNotFoundError):
        iface.transcribe_file(str(tmp_path / "song.wav"))
    with pytest.raises(FileNotFoundError):
        SingingTranscriber.from_hparams(str(tmp_path / "missing"),
                                        savedir=str(tmp_path / "s"),
                                        device="cpu")
    for remote in ("some/source", "https://example.org/model"):
        with pytest.raises(ValueError, match="no network"):
            SingingTranscriber.from_hparams(remote,
                                            savedir=str(tmp_path / "s"),
                                            device="cpu")


def test_interface_needs_a_device_without_cuda(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, _, _, bridge, head = tiny
    modules = {"wav2vec2": bridge, "model": head}
    with pytest.raises(RuntimeError):
        SingingTranscriber(modules=modules, hparams=HP)
    with pytest.raises(RuntimeError):
        tinf.StreamingServer(bridge, head)
    with pytest.raises(RuntimeError):
        tinf.StreamingAMTTranscriber(bridge, head)
    assert SingingTranscriber(modules=modules, hparams=HP,
                              device="cpu").device == torch.device("cpu")


def test_init_params_is_seeded_and_int8_copy_is_shared():
    bridge, head = build_modules(tiny=True)
    iface = SingingTranscriber(modules={"wav2vec2": bridge, "model": head},
                               hparams=HP, batch_size=2, chunk_seconds=1.0,
                               quantize="int8", device="cpu")
    first = {k: v.clone() for k, v in iface.init_params().model
             .state_dict().items()}
    assert first["w"].abs().sum() > 0
    again = iface.init_params().model.state_dict()
    assert all(torch.equal(first[k], again[k]) for k in first)
    other = iface.init_params(seed=5).model.state_dict()
    assert not torch.equal(first["w"], other["w"])
    # one int8 copy for every stream and server, in full precision; each
    # transcriber casts a copy of its own and the float bridge stays float
    s1, s2, srv = iface.stream(), iface.stream(**F32), iface.serve()
    assert iface._serving_bridge() is iface._serving_bridge()
    shared = iface._serving_bridge().encoder.layers[0].ffn1
    assert shared.w_scale.dtype == torch.float32
    assert s1._tr.bridge.encoder.layers[0].ffn1.w_scale.dtype \
        == torch.bfloat16
    assert s2._tr.bridge.encoder.layers[0].ffn1.w_scale.dtype \
        == torch.float32
    for tr in (s1._tr, s2._tr, srv._tr):
        assert torch.equal(tr.bridge.encoder.layers[0].ffn1.w_q8,
                           shared.w_q8)
        assert tr.bridge.encoder.layers[0].ffn1.w_q8 is not shared.w_q8
    assert hasattr(bridge.encoder.layers[0].ffn1, "w")
    assert srv._tr.batch_size == 8 and s1._tr.batch_size == 1
    with pytest.raises(NotImplementedError):
        Pretrained(modules={"x": torch.nn.Conv1d(1, 1, 1)}).init_params()


# ---------------------------------------------------------------- streaming
@pytest.mark.parametrize("mode", MODES)
def test_stream_matches_jax_and_offline(tiny, mode):
    """Fed in odd pieces, the stream emits the JAX stream's notes, which are
    the offline transcriber's exact decode."""
    ji, ti = _interfaces(tiny, mode, batch_size=2, chunk_seconds=1.0)
    _, _, _, _, head = tiny
    rng = np.random.default_rng(5)
    wav = rng.normal(size=int(2.7 * SR)).astype(np.float32)
    steps = [int(rng.integers(1000, 30000)) for _ in range(60)]

    def run(stream):
        got, pos = [], 0
        for step in steps:
            if pos >= len(wav):
                break
            got += stream.feed(wav[pos:pos + step])
            pos += step
        return got + stream.flush()

    want = run(ji.stream(compute_dtype=jnp.float32))
    got = run(ti.stream(**F32))
    assert len(want) > 3 and got == want
    offline = tinf.BatchedAMTTranscriber(
        ti._serving_bridge(), head, chunk_seconds=1.0, batch_size=2, **F32)
    assert got == offline.transcribe({"s": wav}, fast=False)["s"]
    fresh = ti.stream(**F32)                  # sessions are independent
    assert fresh.feed(wav) + fresh.flush() == got
    assert fresh.flush() == []


@pytest.mark.parametrize("mode", MODES)
def test_server_sessions_match_jax_dedicated_streams_and_offline(tiny, mode):
    """Interleaved feeds in odd piece sizes across 3 sessions, one of them
    int16 PCM: per session the JAX server's notes, a dedicated stream's and
    the offline exact decode."""
    jb, jh, params, bridge, head = tiny
    songs = _songs(11, 3)
    songs["s1"] = (songs["s1"] * 6000).astype(np.int16)
    qb = _port_bridge(bridge, mode)
    servers = (
        jinf.StreamingServer(jb, jh, _jax_params(params, mode), batch_size=2,
                             chunk_seconds=1.0, compute_dtype=jnp.float32),
        tinf.StreamingServer(qb, head, batch_size=2, chunk_seconds=1.0,
                             **F32))
    results = []
    for server in servers:
        sessions = {name: server.open(name) for name in songs}
        got = {name: [] for name in songs}
        pos = {name: 0 for name in songs}
        rng = np.random.default_rng(7)
        while any(pos[n] < len(songs[n]) for n in songs):
            for name, wav in songs.items():
                if pos[name] >= len(wav):
                    continue
                step = int(rng.integers(1500, 26000))
                got[name] += sessions[name].feed(
                    wav[pos[name]:pos[name] + step])
                pos[name] += step
        for name in songs:
            got[name] += sessions[name].flush()
        assert server.open_sessions == 0 and server.pending == 0
        results.append(got)
    want, got = results
    assert sum(len(v) for v in want.values()) > 10
    assert got == want
    offline = tinf.BatchedAMTTranscriber(qb, head, chunk_seconds=1.0,
                                         batch_size=4, **F32)
    exact = offline.transcribe(songs, fast=False)
    for name, wav in songs.items():
        dedicated = tinf.StreamingAMTTranscriber(qb, head, chunk_seconds=1.0,
                                                 **F32)
        assert got[name] == dedicated.feed(wav) + dedicated.flush(), name
        assert got[name] == exact[name], name


def _server(tiny, batch_size, mode=None):
    _, _, _, bridge, head = tiny
    return tinf.StreamingServer(_port_bridge(bridge, mode), head,
                                batch_size=batch_size, chunk_seconds=1.0,
                                **F32)


def test_auto_pump_runs_full_batches(tiny):
    server = _server(tiny, 2)
    a, b = server.open(), server.open()
    assert (a.name, b.name) == ("stream0", "stream1")
    a.feed(np.zeros(SR, np.float32))         # 1 window queued: below batch
    assert server.pending == 1 and server.open_sessions == 2
    b.feed(np.zeros(SR, np.float32))         # fills the batch: auto-pump
    assert server.pending == 0
    a.feed(np.zeros(3 * SR, np.float32))     # 3 windows: one auto batch
    assert server.pending == 1               # the odd one waits
    assert server.pump() == 1                # forced partial batch
    assert server.pending == 0
    a.flush(), b.flush()
    assert server.open_sessions == 0


def test_partial_batch_is_padded_with_rows_of_length_zero(tiny):
    """A forced partial batch goes to the device at the full batch size,
    its missing rows zeros of relative length 0."""
    server = _server(tiny, 4)
    seen = []
    run_batch = server._tr.run_batch

    def spy(wavs, lens):
        seen.append((np.array(wavs), list(lens)))
        return run_batch(wavs, lens)
    server._tr.run_batch = spy
    s = server.open()
    s.feed(np.ones(SR + 4000, np.float32))
    s.flush()
    (wavs, lens), = seen
    assert wavs.shape == (4, SR) and wavs.dtype == np.float32
    assert lens == [1.0, 4000 / SR, 0.0, 0.0]
    assert (wavs[2:] == 0).all() and (wavs[1, 4000:] == 0).all()


def test_notes_are_handed_over_exactly_once(tiny):
    _, _, _, bridge, head = tiny
    rng = np.random.default_rng(3)
    wav = rng.normal(size=int(2.2 * SR)).astype(np.float32) * 2.0
    server = _server(tiny, 4)
    mine, other = server.open("mine"), server.open("other")
    assert mine.feed(wav) == []              # 2 windows queued, no batch yet
    # the other's feed brings the queue to 4: the auto-pump runs mine's too
    other.feed(rng.normal(size=int(2.0 * SR)).astype(np.float32))
    early = mine.poll()
    assert early and mine.poll() == []       # taken exactly once
    rest = mine.flush()
    assert mine.flush() == []                # idempotent
    dedicated = tinf.StreamingAMTTranscriber(bridge, head, chunk_seconds=1.0,
                                             **F32)
    assert early + rest == dedicated.feed(wav) + dedicated.flush()
    other.flush()
    with pytest.raises(RuntimeError, match="flushed"):
        mine.feed(np.zeros(100, np.float32))
    with pytest.raises(RuntimeError, match="flushed"):
        dedicated.feed(np.zeros(100, np.float32))


def test_mixed_dtype_sessions_and_dtype_switch_guard(tiny):
    """An int16 and a float32 session share batches (the int16 rows are
    converted on the host); a dtype switch mid-window raises, on a window
    boundary it is fine."""
    _, _, _, bridge, head = tiny
    rng = np.random.default_rng(5)
    pcm = (rng.normal(size=int(1.7 * SR)) * 6000).astype(np.int16)
    fwav = rng.normal(size=int(1.3 * SR)).astype(np.float32)
    server = _server(tiny, 2)
    batches = []
    run_batch = server._tr.run_batch
    server._tr.run_batch = lambda w, l: (batches.append(np.asarray(w).dtype),
                                         run_batch(w, l))[1]
    si, sf = server.open("i16"), server.open("f32")
    notes_i = si.feed(pcm)
    notes_f = sf.feed(fwav)
    notes_i += si.flush()
    notes_f += sf.flush()
    assert np.dtype(np.float32) in batches     # the mixed batch went as f32
    for wav, got in ((pcm, notes_i), (fwav, notes_f)):
        dedicated = tinf.StreamingAMTTranscriber(bridge, head,
                                                 chunk_seconds=1.0, **F32)
        assert got == dedicated.feed(wav) + dedicated.flush()
    # an all-int16 batch goes up as int16 and is scaled on the device
    batches.clear()
    s16 = server.open()
    s16.feed(pcm[:SR]), s16.flush()
    assert batches == [np.dtype(np.int16)]

    s = server.open()
    s.feed(pcm[:3000])
    with pytest.raises(ValueError, match="dtype switch"):
        s.feed(fwav[:3000])
    s2 = server.open()
    s2.feed(pcm[:SR])
    s2.feed(fwav[:100])
    s.flush(), s2.flush()
    tr = tinf.StreamingAMTTranscriber(bridge, head, chunk_seconds=1.0, **F32)
    tr.feed(np.zeros(1000, np.int16))
    with pytest.raises(ValueError, match="dtype switch"):
        tr.feed(np.zeros(1000, np.float32))
    with pytest.raises(ValueError, match="1-D"):
        tr.feed(np.zeros((2, 10), np.float32))


def test_empty_feed_is_a_no_op(tiny):
    for append in (jinf._append_pcm, tinf._append_pcm):
        buf = append(None, np.ones(100, np.int16))
        buf = append(buf, np.zeros(0, np.float32))
        assert buf.dtype == np.int16 and len(buf) == 100
        buf = append(buf, np.ones(50, np.int16))
        assert buf.dtype == np.int16 and len(buf) == 150
    server = _server(tiny, 2)
    s = server.open()
    wav = np.random.default_rng(2).normal(size=int(1.4 * SR)) \
        .astype(np.float32)
    got = s.feed(wav) + s.feed(np.zeros(0, np.float32)) + s.flush()
    s2 = server.open()
    assert got == s2.feed(wav) + s2.flush()


@pytest.mark.parametrize("compact", ["f32", "u16"])
def test_serve_and_stream_entries_match_jax(tiny, compact):
    """``serve()`` and ``stream()`` of an int8 interface transcribe like the
    JAX ones, keyword arguments passed through ("u16" packing included)."""
    ji, ti = _interfaces(tiny, "int8", batch_size=2, chunk_seconds=1.0)
    wav = np.random.default_rng(13).normal(size=int(1.9 * SR)) \
        .astype(np.float32)
    js = ji.serve(batch_size=2, compute_dtype=jnp.float32,
                  compact=compact).open()
    want = js.feed(wav) + js.flush()
    server = ti.serve(batch_size=2, compact=compact, **F32)
    assert any(n.endswith("w_q8")
               for n, _ in server._tr.bridge.named_buffers())
    s = server.open()
    got = s.feed(wav) + s.flush()
    assert len(want) > 2 and got == want
    st = ti.stream(compact=compact, **F32)
    assert st.feed(wav) + st.flush() == want


# ------------------------------------------------------- the numpy copies
@pytest.mark.parametrize("seed", range(3))
def test_incremental_decoder_copy_matches_jax_and_offline(seed):
    rng = np.random.default_rng(seed)
    n = 600
    frames = np.stack([rng.random(n), rng.random(n), rng.integers(0, 5, n),
                       rng.integers(0, 13, n)], axis=1).astype(np.float32)
    cuts = np.sort(rng.integers(0, n, size=7))
    out = []
    for mod in (tamt, jamt):
        dec = mod.IncrementalFrame2Note(0.6, 0.5)
        notes = []
        for piece in np.split(frames, cuts):
            notes += dec.feed(piece)
        out.append(notes + dec.flush())
    assert out[0] == out[1] and len(out[0]) > 5
    assert out[0] == tamt.frame2note(frames, 0.6, 0.5)
    assert tamt.frame2note_finegrain(frames, 0.6, 0.5) \
        == jamt.frame2note_finegrain(frames, 0.6, 0.5)
    meters = [mod.AverageMeter() for mod in (tamt, jamt)]
    for m in meters:
        for val, cnt in ((0.5, 2), (1.25, 3), (4.0, 1)):
            m.update(val, cnt)
    assert vars(meters[0]) == vars(meters[1]) and meters[0].avg == 8.75 / 6


@pytest.mark.parametrize("seed", range(3))
def test_transcription_eval_copy_scores_like_jax(seed):
    rng = np.random.default_rng(seed)
    n = 40
    onsets = np.sort(rng.uniform(0, 60, n))
    ref_i = np.stack([onsets, onsets + rng.uniform(0.1, 1.0, n)], axis=1)
    ref_p = teval.midi_to_hz(rng.integers(36, 84, n).astype(float))
    keep = rng.random(n) < 0.8
    est_i = ref_i[keep] + rng.normal(scale=0.04, size=(keep.sum(), 2))
    est_i[:, 1] = np.maximum(est_i[:, 1], est_i[:, 0] + 0.02)
    est_p = ref_p[keep] * 2 ** (rng.normal(scale=0.3, size=keep.sum()) / 12)
    got = teval.evaluate(ref_i, ref_p, est_i, est_p)
    want = jeval.evaluate(ref_i, ref_p, est_i, est_p)
    assert got == want and 0 < got["F-measure"] < 1
    assert teval.evaluate(ref_i, ref_p, ref_i, ref_p)["F-measure"] == 1.0
    assert teval.evaluate(ref_i, ref_p, np.zeros((0, 2)),
                          np.zeros(0))["F-measure"] == 0.0
    with pytest.raises(ValueError):
        teval.validate_intervals(np.zeros((2, 2)), np.zeros(3))


# --------------------------------------------------------------- convert_hf
def _hf_state_dict(num_layers, weight_norm_names):
    """A random state dict with the key names and shapes of the lv60
    manifest, cut to ``num_layers`` layers."""
    manifest = json.loads(
        (Path(__file__).parent / "fixtures" / "ckpt_manifests.json")
        .read_text())["wav2vec2-large-lv60"]
    rng = np.random.default_rng(0)
    sd = {}
    for key, shape in sorted(manifest.items()):
        if key.startswith("encoder.layers.") \
                and int(key.split(".")[2]) >= num_layers:
            continue
        if weight_norm_names:
            key = key.replace("parametrizations.weight.original0", "weight_g")
            key = key.replace("parametrizations.weight.original1", "weight_v")
        sd["wav2vec2." + key] = rng.normal(size=shape).astype(np.float32)
    return sd


@pytest.mark.parametrize("weight_norm_names", [False, True])
def test_convert_hf_fills_the_encoder_like_jax(weight_norm_names):
    """lv60 widths, depth cut to 2: both packages convert the same state
    dict; the port's filled encoder exports the JAX tree leaf by leaf."""
    sd = _hf_state_dict(2, weight_norm_names)
    want = jconvert_hf.convert_wav2vec2_state_dict(
        sd, dataclasses.replace(JConfig.large_lv60(), num_layers=2))
    config = Wav2Vec2Config(num_layers=2)
    encoder = Wav2Vec2Encoder(config)
    encoder.load_state_dict(convert_hf.convert_wav2vec2_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, config), strict=True)
    got = module_tree(encoder)

    def compare(g, w, path=""):
        assert sorted(g) == sorted(w), path
        for key, val in w.items():
            if isinstance(val, dict):
                compare(g[key], val, f"{path}{key}/")
            else:
                np.testing.assert_array_equal(g[key], np.asarray(val),
                                              err_msg=f"{path}{key}")
    compare(got, want)
    assert got["layers"]["1"]["ffn1"]["w"].shape == (1024, 4096)


def test_convert_hf_refuses_families_the_port_does_not_run(tmp_path):
    """Every family converts, activation sharding too; only an
    ``act_sharding`` that does not name the three activation axes is
    refused."""
    with pytest.raises(ValueError, match="act_sharding"):
        convert_hf.convert_wav2vec2_state_dict(
            {}, Wav2Vec2Config(act_sharding=("data", None)))
    base = {"hidden_size": 64, "num_hidden_layers": 1,
            "num_attention_heads": 4, "intermediate_size": 128,
            "conv_dim": [32] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
            "conv_stride": [5, 2, 2, 2, 2, 2, 2],
            "num_conv_pos_embeddings": 16,
            "num_conv_pos_embedding_groups": 4}
    for extra, want in (
            ({"model_type": "wavlm"}, dict(rel_pos_bias=True)),
            ({"model_type": "data2vec-audio"},
             dict(pos_conv_type="stacked", pos_conv_depth=16,
                  feat_extract_norm="layer")),
            ({"model_type": "hubert"}, dict(feat_extract_norm="group")),
            ({"feat_extract_norm": "group"}, dict(feat_extract_norm="group")),
            ({"feat_extract_norm": "layer", "do_stable_layer_norm": False},
             dict(feat_extract_norm="layer", do_stable_layer_norm=False))):
        got = convert_hf.config_from_hf({**base, **extra})
        assert {k: getattr(got, k) for k in want} == want, extra
    # a checkpoint directory with a config.json and a torch state dict
    hf = {**base, "feat_extract_norm": "layer", "do_stable_layer_norm": True,
          "conv_bias": True}
    config = convert_hf.config_from_hf(hf)
    source = Wav2Vec2Encoder(config)
    gen = torch.Generator().manual_seed(0)
    for p in source.parameters():
        p.data = torch.randn(p.shape, generator=gen)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    torch.save(_as_hf(source.state_dict(), config),
               tmp_path / "pytorch_model.bin")
    loaded, loaded_config = convert_hf.load_wav2vec2(str(tmp_path))
    assert loaded_config == config
    for name, value in source.state_dict().items():
        assert torch.equal(loaded.state_dict()[name], value), name


def _as_hf(state, config):
    """The port's encoder state dict under HF names and layouts (the
    inverse of the converter, for the round trip above)."""
    names = {"feat_proj_ln": "feature_projection.layer_norm",
             "feat_proj": "feature_projection.projection",
             "encoder_ln": "encoder.layer_norm",
             "pos_conv.g": "encoder.pos_conv_embed.conv.weight_g",
             "pos_conv.v": "encoder.pos_conv_embed.conv.weight_v",
             "pos_conv.b": "encoder.pos_conv_embed.conv.bias"}
    layer = {"ln1": "layer_norm", "ln2": "final_layer_norm",
             "ffn1": "feed_forward.intermediate_dense",
             "ffn2": "feed_forward.output_dense"}
    out = {"masked_spec_embed": torch.zeros(config.hidden_size)}
    for name, value in state.items():
        parts = name.split(".")
        leaf = parts[-1]
        if name in names:
            out[names[name]] = value
            continue
        if parts[0] == "feature_extractor":
            stem = f"feature_extractor.conv_layers.{parts[2]}.{parts[3]}"
        elif parts[0] == "layers" and parts[2] == "attn":
            proj = {"q": "q_proj", "k": "k_proj", "v": "v_proj",
                    "o": "out_proj"}[leaf[1]]
            stem = f"encoder.layers.{parts[1]}.attention.{proj}"
            leaf = "w" if leaf[0] == "w" else "b"
        elif parts[0] == "layers":
            stem = f"encoder.layers.{parts[1]}.{layer[parts[2]]}"
        else:
            stem = names[parts[0]]
        if leaf == "w":
            out[f"{stem}.weight"] = value.t().contiguous()
        else:
            out[f"{stem}.{ {'b': 'bias', 'scale': 'weight'}.get(leaf, leaf) }"] \
                = value
    return out
