"""The port's runnable docstring examples: every module of
``svt_speechbrain_tpu_torch`` that carries ``>>>`` examples runs them on
the CPU, and all must pass."""
import doctest
import importlib

import pytest

MODULES = [
    "svt_speechbrain_tpu_torch",
    "svt_speechbrain_tpu_torch.config",
    "svt_speechbrain_tpu_torch.convert_jax",
    "svt_speechbrain_tpu_torch.core",
    "svt_speechbrain_tpu_torch.dataio.batch",
    "svt_speechbrain_tpu_torch.dataio.dataio",
    "svt_speechbrain_tpu_torch.dataio.dataloader",
    "svt_speechbrain_tpu_torch.dataio.dataset",
    "svt_speechbrain_tpu_torch.dataio.encoder",
    "svt_speechbrain_tpu_torch.dataio.iterators",
    "svt_speechbrain_tpu_torch.dataio.legacy",
    "svt_speechbrain_tpu_torch.dataio.preprocess",
    "svt_speechbrain_tpu_torch.dataio.sampler",
    "svt_speechbrain_tpu_torch.dataio.wer",
    "svt_speechbrain_tpu_torch.decoders.ctc",
    "svt_speechbrain_tpu_torch.decoders.fairseq_generator",
    "svt_speechbrain_tpu_torch.decoders.seq2seq",
    "svt_speechbrain_tpu_torch.decoders.transducer",
    "svt_speechbrain_tpu_torch.flagship",
    "svt_speechbrain_tpu_torch.inference",
    "svt_speechbrain_tpu_torch.models.avhubert_asr",
    "svt_speechbrain_tpu_torch.models.convert_hf",
    "svt_speechbrain_tpu_torch.models.crdnn",
    "svt_speechbrain_tpu_torch.models.features",
    "svt_speechbrain_tpu_torch.models.quantize",
    "svt_speechbrain_tpu_torch.models.seq2seq_decoder",
    "svt_speechbrain_tpu_torch.models.wav2vec2",
    "svt_speechbrain_tpu_torch.nnet.activations",
    "svt_speechbrain_tpu_torch.nnet.attention",
    "svt_speechbrain_tpu_torch.nnet.cnn",
    "svt_speechbrain_tpu_torch.nnet.containers",
    "svt_speechbrain_tpu_torch.nnet.dropout",
    "svt_speechbrain_tpu_torch.nnet.embedding",
    "svt_speechbrain_tpu_torch.nnet.linear",
    "svt_speechbrain_tpu_torch.nnet.loss.guidedattn_loss",
    "svt_speechbrain_tpu_torch.nnet.loss.si_snr_loss",
    "svt_speechbrain_tpu_torch.nnet.loss.transducer_loss",
    "svt_speechbrain_tpu_torch.nnet.losses",
    "svt_speechbrain_tpu_torch.nnet.normalization",
    "svt_speechbrain_tpu_torch.nnet.pooling",
    "svt_speechbrain_tpu_torch.nnet.rnn",
    "svt_speechbrain_tpu_torch.nnet.schedulers",
    "svt_speechbrain_tpu_torch.nnet.transducer_joint",
    "svt_speechbrain_tpu_torch.ops.conv_frontend",
    "svt_speechbrain_tpu_torch.ops.flash_attention",
    "svt_speechbrain_tpu_torch.ops.quant",
    "svt_speechbrain_tpu_torch.ops.transducer_lattice",
    "svt_speechbrain_tpu_torch.parallel.distributed",
    "svt_speechbrain_tpu_torch.pretrained.fetching",
    "svt_speechbrain_tpu_torch.pretrained.interfaces",
    "svt_speechbrain_tpu_torch.processing.features",
    "svt_speechbrain_tpu_torch.tasks.amt",
    "svt_speechbrain_tpu_torch.utils.amt",
    "svt_speechbrain_tpu_torch.utils.callchains",
    "svt_speechbrain_tpu_torch.utils.checkpoints",
    "svt_speechbrain_tpu_torch.utils.data_pipeline",
    "svt_speechbrain_tpu_torch.utils.data_utils",
    "svt_speechbrain_tpu_torch.utils.depgraph",
    "svt_speechbrain_tpu_torch.utils.edit_distance",
    "svt_speechbrain_tpu_torch.utils.epoch_loop",
    "svt_speechbrain_tpu_torch.utils.logger",
    "svt_speechbrain_tpu_torch.utils.metric_stats",
    "svt_speechbrain_tpu_torch.utils.parameter_transfer",
    "svt_speechbrain_tpu_torch.utils.superpowers",
    "svt_speechbrain_tpu_torch.utils.train_logger",
    "svt_speechbrain_tpu_torch.utils.transcription_eval",
]


@pytest.mark.parametrize("name", MODULES)
def test_module_examples_pass(name):
    result = doctest.testmod(importlib.import_module(name),
                             optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0, f"{name} has no examples"
    assert result.failed == 0
