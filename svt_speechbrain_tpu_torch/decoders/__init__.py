"""Decoding: the transducer search. The CTC and seq2seq searchers of the
JAX package wait for later slices."""

from svt_speechbrain_tpu_torch.decoders.transducer import (  # noqa: F401
    TransducerBeamSearcher)
