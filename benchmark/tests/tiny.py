"""Test-sized overrides of the cells: the configurations at the port's CI
widths (``TINY_ARCH``), the traffic cut to seconds of audio, run on the
CPU with the kernels' plain versions."""
from __future__ import annotations

from benchmark import run

SEED = 2 ** 31 + 11
TINY = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 128, "conv_dim": [32] * 7,
        "num_conv_pos_embedding_groups": 4}
SERVE = {"pool_seconds": [2.0, 3.3, 1.2, 2.6], "pairs": [[0, 1], [2, 3]],
         "batch_size": 4, "chunk_seconds": 1.0, "compute_dtype": "float32",
         "check_requests": 2, "profile_items": [1, 1]}
TRAIN = {"song_count": 16, "song_seconds": [1.0, 2.0],
         "max_batch_seconds": 6.0, "max_batch_songs": 4, "num_buckets": 4,
         "num_workers": 1,
         "profile_items": [1, 1]}
TRAIN_5S = {"song_count": 16, "song_seconds": [1.0, 1.0], "batch_size": 4,
            "num_workers": 1, "profile_items": [1, 1]}
# rows of 1024 frames or more: the attention's hash dropout
TRAIN_LONG = dict(TRAIN, song_count=4, song_seconds=[20.6, 20.8],
                  max_batch_seconds=42.0, max_batch_songs=2, checked_steps=2)


def overrides(cell, traffic=None):
    """The test-sized overrides of ``cell``; ``traffic`` is laid over the
    traffic's own (``TRAIN`` and ``TRAIN_LONG`` turn the fixed batches of
    the training cell into length buckets)."""
    wl, cfg, _ = run.cell_spec(cell)
    config = dict(TINY)
    if "conv_pos_kernel_size" not in cfg:
        config["num_conv_pos_embeddings"] = 16
    base = SERVE if "serve" in wl["traffic"] else TRAIN_5S
    return {"config": config, "traffic": dict(base, **(traffic or {}))}


def run_tiny(cell, seed=SEED, seconds=1.0, traffic=None, cell_class=None):
    """(result, checks, cell) of one CPU run of ``cell`` at test size."""
    return run.run_cell(cell, seed, seconds, 0, device="cpu",
                        overrides=overrides(cell, traffic),
                        cell_class=cell_class)
