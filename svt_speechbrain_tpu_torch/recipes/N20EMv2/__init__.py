"""The N20EMv2 recipes (port of ``recipes/N20EMv2``): the audio-only family
and the RCA audio-visual fusion stage."""
