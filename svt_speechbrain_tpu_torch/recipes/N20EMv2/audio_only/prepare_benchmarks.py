#!/usr/bin/env python3
"""MIR-ST500 benchmark preparation from the N20EMv2 audio recipe's folder
(port of ``recipes/N20EMv2/audio_only/prepare_benchmarks.py``): the mixed
training set needs ``mir_st500_train.csv`` beside the N20EMv2 CSVs. The
functions and the command line are the port's MIR-ST500 module's.

Run:
> python -m svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_only.prepare_benchmarks \\
>     --mir_st500 /path/to/MIR_ST500 --ismir ... --tonas ...
"""
import runpy

from svt_speechbrain_tpu_torch.recipes.MIR_ST500.prepare_benchmarks import (  # noqa: F401
    prepare_all_AMT_datasets, prepare_csv_benchmarks, prepare_frame_anno,
    resample_dataset)

if __name__ == "__main__":
    runpy.run_module(
        "svt_speechbrain_tpu_torch.recipes.MIR_ST500.prepare_benchmarks",
        run_name="__main__", alter_sys=True)
