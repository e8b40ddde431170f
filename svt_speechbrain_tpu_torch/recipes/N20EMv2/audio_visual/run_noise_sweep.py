#!/usr/bin/env python3
"""The noise-robustness sweep (port of
``recipes/N20EMv2/audio_visual/run_noise_sweep.py``): evaluate the AV
fusion model and the audio-only control, clean and for each noise type and
SNR, each from the checkpoint of greatest valid COnPOff F1 in its
condition's output folder.

Writes one JSON line per (system, noise type, SNR) to ``--out`` and prints
a table, as the JAX script does.

Run (``--device`` is ``cuda`` unless named):
> python -m svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_visual.run_noise_sweep \\
>     svt_speechbrain_tpu_torch/recipes/N20EMv2/audio_visual/hparams/train_rca_av.yaml \\
>     --data_folder=... [--noise_types accomp white] [--snrs -10 0 10]
"""
import argparse
import json
import logging

from svt_speechbrain_tpu_torch.config import load_hyperyaml
from svt_speechbrain_tpu_torch.convert_jax import init_modules
from svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_visual import (
    train_rca_a, train_rca_av)

logger = logging.getLogger(__name__)

SYSTEMS = {"av": train_rca_av.AMT, "a": train_rca_a.AMT}


def evaluate_condition(brain_cls, make_hparams, noise_type, snr_db, add_noise,
                       run_opts):
    """A fresh brain on ``make_hparams(overrides)`` (the recipe's
    hyperparameters with ``noise_type``, ``snr_db`` and ``add_noise`` set;
    its modules seeded, then recovered from the condition's best
    checkpoint), its optimizers registered so that the checkpoint's load,
    then ``evaluate`` of the first test set (``run_noise_sweep.py:32``).
    Returns {metric: average F1}."""
    hparams = make_hparams({"noise_type": noise_type, "snr_db": snr_db,
                            "add_noise": add_noise})
    init_modules(hparams["modules"], hparams["seed"])
    _, _, test_datasets = train_rca_av.dataio_prepare(hparams)
    brain = brain_cls(modules=hparams["modules"], hparams=hparams,
                      run_opts=run_opts, checkpointer=hparams["checkpointer"])
    brain.init_optimizers()
    brain.evaluate(list(test_datasets.values())[0], max_key="COnPOff_f1",
                   test_loader_kwargs=hparams["test_dataloader_opts"])
    return {name: float(getattr(brain, f"{name}_f1").avg)
            for name in brain.metric_names}


def sweep(make_hparams, systems=("av", "a"), noise_types=("accomp",),
          snrs=(-10, -5, 0, 5, 10), run_opts=None):
    """The rows of the sweep: for each system, clean first, then each noise
    type at each SNR (``run_noise_sweep.py:64-77``)."""
    run_opts = dict(run_opts or {}, noprogressbar=True)
    rows = []
    for system in systems:
        cls = SYSTEMS[system]
        metrics = evaluate_condition(cls, make_hparams, "accomp", 0, False,
                                     run_opts)
        rows.append({"system": system, "noise_type": "clean", "snr_db": None,
                     **metrics})
        for noise_type in noise_types:
            for snr in snrs:
                metrics = evaluate_condition(cls, make_hparams, noise_type,
                                             snr, True, run_opts)
                rows.append({"system": system, "noise_type": noise_type,
                             "snr_db": snr, **metrics})
    return rows


def write_rows(rows, out):
    """One JSON line per row to ``out``, then the table on stdout."""
    with open(out, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    print(f"{'system':>6} {'noise':>8} {'snr':>5} {'COn_f1':>8} "
          f"{'COnPOff_f1':>11}")
    for row in rows:
        print(f"{row['system']:>6} {row['noise_type']:>8} "
              f"{str(row['snr_db']):>5} {row['COn']:>8.3f} "
              f"{row['COnPOff']:>11.3f}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("hparams_file")
    parser.add_argument("--data_folder", required=True)
    parser.add_argument("--noise_types", nargs="*", default=["accomp"])
    parser.add_argument("--snrs", nargs="*", type=int,
                        default=[-10, -5, 0, 5, 10])
    parser.add_argument("--systems", nargs="*", default=["av", "a"],
                        choices=["av", "a"])
    parser.add_argument("--out", default="noise_sweep.jsonl")
    parser.add_argument("--device", default=None)
    args, extra = parser.parse_known_args(argv)

    base_overrides = f"data_folder: {args.data_folder}\n" + "\n".join(
        e.lstrip("-").replace("=", ": ", 1) for e in extra)

    def make_hparams(condition):
        overrides = base_overrides + "".join(
            f"\n{k}: {v}" for k, v in condition.items()) + "\n"
        with open(args.hparams_file) as fin:
            return load_hyperyaml(fin, overrides)

    rows = sweep(make_hparams, args.systems, args.noise_types, args.snrs,
                 run_opts={"device": args.device})
    write_rows(rows, args.out)
    return rows


if __name__ == "__main__":
    main()
