"""Forced alignment (port of ``svt_speechbrain_tpu/alignment``): the
Viterbi/HMM aligner and CTC segmentation."""
