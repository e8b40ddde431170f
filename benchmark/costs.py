"""The benchmark's yardstick: operations and bytes of the model and of the
kernels the timed paths launch, and the card's peaks.

Frozen copies, so that a change to the program cannot move them:

- ``frontend_cost``, ``attention_cost``, ``training_cost`` and ``bound`` are
  ``chip_smoke.py:1284``, ``:1307``, ``:1320`` and ``:1335``, with the
  extractor's kernels and strides taken from the configuration;
- ``conv_frontend_flops``, ``encoder_flops``, ``amt_forward_flops`` and
  ``amt_train_flops`` are ``svt_speechbrain_tpu_torch/utils/flops.py:34-88``
  with two repairs: data2vec's stack of positional convs is counted as the
  configuration states it (the original counted lv60's one conv of 128 taps
  for every family), and there is no environment override of a peak.

f32 work is held against three TF32 products a product (495 / 3 = 165
TFLOP/s): the port's f32 kernels (rows 1, 3b, 4a, 4b of the kernel table)
run that split on the tensor cores, so the 67 TFLOP/s SIMT rate would let
them read above 100%.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates
PEAK_FLOPS = {"bf16": 989e12, "f32": 495e12 / 3}
PEAK_BYTES = 3.35e12
SAMPLE_RATE = 16000


def conv_out(length, kernel, stride):
    """Frames of a valid strided conv (``nnet/cnn.py:23``)."""
    return (length - kernel) // stride + 1


def output_frames(config, samples):
    """Encoder frames of ``samples`` samples, clamped at 0."""
    t = samples
    for k, s in zip(config["conv_kernel"], config["conv_stride"]):
        t = max(conv_out(t, k, s), 0)
    return t


def conv_frontend_flops(config, samples):
    """FLOPs of the strided conv extractor on one example."""
    t, cin, total = samples, 1, 0.0
    for cout, k, s in zip(config["conv_dim"], config["conv_kernel"],
                          config["conv_stride"]):
        t = max(conv_out(t, k, s), 0)
        total += 2.0 * cin * k * cout * t
        cin = cout
    return total


def pos_conv_flops(config, t):
    """FLOPs of the positional embedding on ``t`` frames: one grouped conv
    of ``num_conv_pos_embeddings`` taps (wav2vec2), or data2vec's stack of
    ``num_conv_pos_embeddings`` convs of ``conv_pos_kernel_size`` taps."""
    d = config["hidden_size"]
    groups = config["num_conv_pos_embedding_groups"]
    if "conv_pos_kernel_size" in config:
        depth, k = config["num_conv_pos_embeddings"], config["conv_pos_kernel_size"]
    else:
        depth, k = 1, config["num_conv_pos_embeddings"]
    return depth * 2.0 * (d / groups) * k * d * t


def encoder_flops(config, t):
    """FLOPs of the encoder on one example of ``t`` frames: the feature
    projection, the positional embedding and every layer (projections,
    QK^T and PV over ``t`` keys, the FFN)."""
    d, f = config["hidden_size"], config["intermediate_size"]
    per_layer = 8.0 * t * d * d + 4.0 * t * t * d + 4.0 * t * d * f
    return (2.0 * t * config["conv_dim"][-1] * d + pos_conv_flops(config, t)
            + config["num_hidden_layers"] * per_layer)


def amt_forward_flops(config, samples):
    """Forward FLOPs of the AMT model (extractor, encoder, frame head) on
    one example of ``samples`` samples."""
    t = output_frames(config, samples)
    return (conv_frontend_flops(config, samples) + encoder_flops(config, t)
            + 2.0 * t * config["hidden_size"] * config["head_outputs"])


def amt_train_flops(config, samples):
    """FLOPs of one training example: the forward and a backward of twice
    its products."""
    return 3.0 * amt_forward_flops(config, samples)


def frontend_cost(config, b, t, itemsize):
    """(FLOPs, bytes) of the fused extractor kernels on (b, t) samples: the
    wav read once, the weights once, the last output written once, each
    layer's conv bias (where the configuration has one) and LayerNorm
    affine in f32."""
    flops, tin, cin = 0, t, 1
    for k, s, c in zip(config["conv_kernel"], config["conv_stride"],
                       config["conv_dim"]):
        tout = conv_out(tin, k, s)
        flops += 2 * b * tout * k * cin * c
        tin, cin = tout, c
    weights = sum(k * cin_ * c for k, cin_, c in zip(
        config["conv_kernel"], [1] + list(config["conv_dim"][:-1]),
        config["conv_dim"]))
    affine = (3 if config["conv_bias"] else 2) * sum(config["conv_dim"])
    nbytes = ((b * t + weights + b * tin * config["conv_dim"][-1]) * itemsize
              + affine * 4)
    return flops, nbytes


def attention_cost(shape, lengths, itemsize):
    """(FLOPs, bytes) of the short attention kernel on (B, H, T, D) with
    per-row key lengths: QK^T and PV over the valid keys; q read for rows
    with keys, k and v read up to each length, out written whole."""
    b, h, t, d = shape
    keys = sum(min(n, t) for n in lengths)
    flops = 4 * h * t * keys * d
    q_rows = sum(n > 0 for n in lengths)
    nbytes = h * d * (t * q_rows + 2 * keys + t * b) * itemsize + 4 * b
    return flops, nbytes


TRAIN_KERNELS = ("flash_attention_lse", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def training_cost(name, shape, itemsize):
    """(FLOPs, bytes) of the training attention kernels (3b, 4a, 4b)
    without key lengths: 4, 6 and 8 B·H·T²·D FLOPs; each input read once
    and each output written once (L and Δ f32 a query row)."""
    b, h, t, d = shape
    tile, rows = b * h * t * d * itemsize, b * h * t * 4
    flops = {"flash_attention_lse": 4, "flash_attention_bwd_dq": 6,
             "flash_attention_bwd_dkv": 8}[name] * b * h * t * t * d
    nbytes = {"flash_attention_lse": 4 * tile + rows,
              "flash_attention_bwd_dq": 5 * tile + 2 * rows,
              "flash_attention_bwd_dkv": 6 * tile + 2 * rows}[name]
    return flops, nbytes


def bound(flops, nbytes, peak):
    """The least time in seconds the card could take: the larger of the
    operations at ``peak`` and the bytes at the HBM rate."""
    return max(flops / peak, nbytes / PEAK_BYTES)
