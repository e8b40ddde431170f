"""Decoding: CTC, seq2seq beam search (speechbrain searchers and the fairseq
generator), transducer search."""

from svt_speechbrain_tpu_torch.decoders.ctc import (  # noqa: F401
    CTCPrefixScorer, ctc_greedy_decode, filter_ctc_output)
from svt_speechbrain_tpu_torch.decoders.fairseq_generator import (  # noqa: F401
    FairseqSequenceGenerator)
from svt_speechbrain_tpu_torch.decoders.seq2seq import (  # noqa: F401
    S2SBeamSearcher, S2SGreedySearcher, S2SRNNBeamSearcher,
    S2SRNNBeamSearchLM, S2SRNNBeamSearchTransformerLM, S2SRNNGreedySearcher,
    S2STransformerBeamSearch, batch_filter_seq2seq_output,
    filter_seq2seq_output, inflate_tensor, mask_by_condition)
from svt_speechbrain_tpu_torch.decoders.transducer import (  # noqa: F401
    TransducerBeamSearcher)
