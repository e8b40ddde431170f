"""Tokenization (port of ``svt_speechbrain_tpu/tokenizers``): the
SentencePiece wrapper over ``spm_lite`` and the char/word fallbacks."""
