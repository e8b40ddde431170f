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
