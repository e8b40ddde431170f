"""The N20EMv2 audio-visual stage (port of ``recipes/N20EMv2/audio_visual``):
MUSAN preparation, noise synthesis, the RCA fusion recipes and the noise
sweep."""
