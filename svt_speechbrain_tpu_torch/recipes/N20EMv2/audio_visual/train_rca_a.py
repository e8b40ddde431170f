#!/usr/bin/env python3
"""Recipe: the audio-only RCA control (port of
``recipes/N20EMv2/audio_visual/train_rca_a.py``): ``train_rca_av`` with
the video stream zeroed, for the A-against-AV noise comparison; its note
dumps are tagged "audio".

Run (``--device`` is ``cuda`` unless named):
> python -m svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_visual.train_rca_a \\
>     svt_speechbrain_tpu_torch/recipes/N20EMv2/audio_visual/hparams/train_rca_a.yaml \\
>     --data_folder=/path/to/N20EMv2
"""
from svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_visual.train_rca_av import main
from svt_speechbrain_tpu_torch.tasks.amt import FusionAMT


class AMT(FusionAMT):
    """The audio-only control: zero video (``train_rca_a.py:16``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, zero_video=True, **kwargs)


if __name__ == "__main__":
    main(AMT)
