"""The N20EMv2 audio-only recipe (port of ``recipes/N20EMv2/audio_only``):
data preparation, training and the feature dumps of stage 2."""
