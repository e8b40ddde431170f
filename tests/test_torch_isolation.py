"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never continue on the CPU unless asked to."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "svt_speechbrain_tpu_torch"

_PROBE = """
import sys
import torch
from svt_speechbrain_tpu_torch.flagship import build_flagship
from svt_speechbrain_tpu_torch.inference import (
    BatchedAMTTranscriber, StreamingAMTTranscriber, StreamingServer)
from svt_speechbrain_tpu_torch.tasks.amt import AudioAMT
from svt_speechbrain_tpu_torch.models import convert_hf, quantize
from svt_speechbrain_tpu_torch.ops import quant
from svt_speechbrain_tpu_torch.pretrained.interfaces import SingingTranscriber
from svt_speechbrain_tpu_torch.utils import transcription_eval
from svt_speechbrain_tpu_torch.decoders import TransducerBeamSearcher
from svt_speechbrain_tpu_torch.nnet import embedding, rnn, transducer_joint
from svt_speechbrain_tpu_torch.nnet.loss.transducer_loss import TransducerLoss
from svt_speechbrain_tpu_torch.ops import transducer_lattice
from svt_speechbrain_tpu_torch import config, core
from svt_speechbrain_tpu_torch.dataio import (batch, dataio, dataloader,
                                             dataset, sampler)
from svt_speechbrain_tpu_torch.nnet import schedulers
from svt_speechbrain_tpu_torch.parallel import distributed
from svt_speechbrain_tpu_torch.recipes.MIR_ST500 import (prepare_benchmarks,
                                                        train_audio_ssl)
from svt_speechbrain_tpu_torch.utils import (checkpoints, epoch_loop, logger,
                                             metric_stats, train_logger)
from svt_speechbrain_tpu_torch.processing import signal_processing
from svt_speechbrain_tpu_torch.models import fusion, transformer
from svt_speechbrain_tpu_torch.tasks.amt import FusionAMT
from svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_only import (
    extract_ssl_feats, prepare_benchmarks as n20em_benchmarks,
    prepare_n20emv2, train_audio_ssl as n20em_audio)
from svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_visual import (
    prepare_musan, prepare_n20emv2 as av_prep, run_noise_sweep,
    synthesis_noise, train_rca_a, train_rca_av)
from svt_speechbrain_tpu_torch.pretrained import fetching
from svt_speechbrain_tpu_torch.dataio import (encoder, iterators, legacy,
                                             preprocess, wer)
from svt_speechbrain_tpu_torch.utils import (callchains, edit_distance,
                                             parameter_transfer, superpowers)
rca = quantize.quantize_fusion(fusion.FusionRCA(0.5, 4, 32, 16),
                               quantize_attn=True)
with torch.no_grad():
    assert rca(torch.ones(1, 5, 16), torch.ones(1, 6, 16)).shape == (1, 5, 16)
assert signal_processing.mix_at_snr(torch.ones(4), torch.ones(4), 0).shape \
    == (4,)
model = build_flagship(tiny=True, device="cpu")
with torch.no_grad():
    outs = model(torch.zeros(1, 8000))
assert outs[2].shape == (1, 24, 5), outs[2].shape
iface = SingingTranscriber(
    modules={"wav2vec2": model.bridge, "model": model.head},
    hparams={"frame_rate": 49.8, "onset_threshold": 0.4,
             "offset_threshold": 0.5},
    batch_size=2, chunk_seconds=0.5, quantize="int8", device="cpu")
session = iface.serve(batch_size=2).open()
notes = session.feed(torch.zeros(12000).numpy()) + session.flush()
assert all(len(ev) == 3 for ev in notes)
logits = torch.zeros(1, 3, 2, 4, requires_grad=True)
TransducerLoss(blank_index=0, fused=True)(
    logits, torch.ones(1, 1, dtype=torch.long), torch.ones(1),
    torch.ones(1)).backward()
assert logits.grad.abs().sum() > 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "svt_speechbrain_tpu" or m.startswith("svt_speechbrain_tpu."))
print("LOADED", bad)
"""


def test_port_runs_without_loading_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout, res.stdout


def _public_names(path):
    """Top-level public classes, functions and assignments of a file, read
    with ``ast`` (no import)."""
    import ast

    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|svt_speechbrain_tpu)"
    r"(?![\w])", re.MULTILINE)


def test_no_source_file_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files
                 if _IMPORT.search(f.read_text())]
    assert offenders == []


def test_import_pattern_tells_the_packages_apart():
    assert _IMPORT.search("from svt_speechbrain_tpu.nnet import x")
    assert _IMPORT.search("import jax.numpy as jnp")
    assert not _IMPORT.search("from svt_speechbrain_tpu_torch.nnet import x")


def test_entry_points_raise_without_cuda_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from svt_speechbrain_tpu_torch import resolve_device
    from svt_speechbrain_tpu_torch.flagship import build_flagship

    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        build_flagship(tiny=True)
    assert resolve_device("cpu") == torch.device("cpu")


def test_brain_raises_without_cuda_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from svt_speechbrain_tpu_torch.core import Brain
    from svt_speechbrain_tpu_torch.nnet.linear import Linear
    from svt_speechbrain_tpu_torch.tasks.amt import AudioAMT

    for cls in (Brain, AudioAMT):
        with pytest.raises(RuntimeError):
            cls({"model": Linear(2, 2)})
        with pytest.raises(RuntimeError):
            cls({"model": Linear(2, 2)}, run_opts={"precision": "bf16"})
        assert cls({"model": Linear(2, 2)},
                   run_opts={"device": "cpu"}).device == torch.device("cpu")


_WITHOUT_YAML_OR_TQDM = """
import sys
sys.modules["yaml"] = None      # an import of any now raises ImportError
sys.modules["msgpack"] = None
sys.modules["tqdm"] = None
import tempfile
import numpy as np
import torch
import chip_smoke
from svt_speechbrain_tpu_torch.core import Stage
from svt_speechbrain_tpu_torch.models.wav2vec2 import (HuggingFaceWav2Vec2,
                                                      TINY_ARCH)
from svt_speechbrain_tpu_torch.recipes.MIR_ST500 import train_audio_ssl
root = tempfile.mkdtemp()
csvs = chip_smoke.make_recipe_set(root, np.random.default_rng(0), {
    "train": (6, 7), "valid": (6,), "test": (6,)})
hp = chip_smoke.recipe_hparams(
    data_folder=root, output_folder=root + "/out", train_csv=csvs["train"],
    valid_csv=csvs["valid"], test_csv=[csvs["test"]], num_workers=2,
    batch_size=2, feat_dim=64, wav2vec2=HuggingFaceWav2Vec2(
        source="tiny-test", arch_overrides=TINY_ARCH))
train, valid, tests = train_audio_ssl.dataio_prepare(hp)
brain = train_audio_ssl.AMT(modules=hp["modules"], hparams=hp,
                            run_opts={"device": "cpu"},
                            checkpointer=hp["checkpointer"])
brain.init_optimizers()
brain.on_stage_start(Stage.TRAIN, 1)
loss = brain.fit_batch(next(iter(brain.make_dataloader(
    train, Stage.TRAIN, **hp["train_dataloader_opts"]))))
brain.on_stage_start(Stage.VALID, 1)
eval_loss = brain.evaluate_batch(next(iter(brain.make_dataloader(
    valid, Stage.VALID, **hp["valid_dataloader_opts"]))), Stage.VALID)
assert np.isfinite(loss) and np.isfinite(eval_loss), (loss, eval_loss)
loaded = [m.split(".")[0] for m in sys.modules if sys.modules[m]]
assert "yaml" not in loaded and "msgpack" not in loaded
print("FIT-AND-EVALUATE-OK", loss, eval_loss)
"""


def test_engine_and_recipe_run_without_yaml_or_tqdm():
    """The engine, the data loading and the recipe import and run one TINY
    training step and one evaluated utterance, through loader worker
    processes, with PyYAML, msgpack and tqdm unavailable (the card machine
    need not have them): the recipe's objects come from ``chip_smoke.py``'s
    Python hparams."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _WITHOUT_YAML_OR_TQDM],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FIT-AND-EVALUATE-OK" in res.stdout, res.stdout


_DEPLOY_WITHOUT_PACKAGES = """
import json, os, shutil, sys, tempfile
sys.modules["yaml"] = None      # an import of any now raises ImportError
sys.modules["msgpack"] = None
sys.modules["tqdm"] = None
import numpy as np
import torch
from svt_speechbrain_tpu_torch.config import load_hyperyaml
from svt_speechbrain_tpu_torch.convert_jax import load_msgpack
from svt_speechbrain_tpu_torch.dataio.dataio import write_audio
from svt_speechbrain_tpu_torch.flagship import build_flagship
from svt_speechbrain_tpu_torch.models.wav2vec2 import TINY_ARCH
from svt_speechbrain_tpu_torch.pretrained.interfaces import SingingTranscriber
from svt_speechbrain_tpu_torch.tasks.amt import save_state_dict
tiny = ("wav2vec2: !new:svt_speechbrain_tpu_torch.models.wav2vec2."
        "HuggingFaceWav2Vec2 {source: tiny-test, arch_overrides: "
        + json.dumps(dict(TINY_ARCH)) + "}\\nfeat_dim: 64\\n")
root = tempfile.mkdtemp()
with open("svt_speechbrain_tpu_torch/recipes/MIR_ST500/hparams/"
          "train_audio_ssl.yaml") as f:
    hp = load_hyperyaml(f, "data_folder: " + root + "\\n" + tiny)
assert hp["modules"]["wav2vec2"].config.hidden_size == 64
model = build_flagship(tiny=True, device="cpu")
export = os.path.join(root, "export")
os.makedirs(export)
shutil.copy("tests/fixtures/singing_transcriber_hyperparams.yaml",
            os.path.join(export, "hyperparams.yaml"))
save_state_dict(model.bridge, os.path.join(export, "wav2vec2.pt"))
save_state_dict(model.head, os.path.join(export, "model.pt"))
wav = os.path.join(root, "song.wav")
write_audio(wav, 0.1 * np.random.default_rng(0).standard_normal(24000)
            .astype(np.float32), 16000)
face = SingingTranscriber.from_hparams(
    export, savedir=os.path.join(root, "saved"), overrides=tiny,
    device="cpu", batch_size=2, chunk_seconds=1.0)
notes = face.transcribe_file(wav)
assert all(len(ev) == 3 for ev in notes)
tree = load_msgpack("tests/fixtures/jax_export_small.msgpack")
assert tree["model"]["w"].shape == (16, 20)
loaded = [m.split(".")[0] for m in sys.modules if sys.modules[m]]
assert "yaml" not in loaded and "msgpack" not in loaded
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "svt_speechbrain_tpu" or m.startswith("svt_speechbrain_tpu."))
print("DEPLOY-OK", len(notes), bad)
"""


def test_deployment_runs_without_yaml_or_msgpack():
    """``load_hyperyaml`` of a recipe yaml, a TINY ``from_hparams`` on the
    inference yaml of ``tests/fixtures/`` with ``transcribe_file``, and the
    small JAX export read by ``load_msgpack``, with PyYAML, msgpack and tqdm
    unavailable and without loading JAX: the port reads both formats with
    its own readers."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _DEPLOY_WITHOUT_PACKAGES],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "DEPLOY-OK" in res.stdout and res.stdout.rstrip().endswith(
        "[]"), res.stdout
