"""The N20EMv2 video-only recipe (port of ``recipes/N20EMv2/video_only``):
data preparation, training of AV-HuBERT's visual path and the video feature
dumps of stage 2."""
