"""Analytic FLOP counts of the wav2vec2 AMT pipeline and model FLOPs
utilization on the H100 (port of ``svt_speechbrain_tpu/utils/flops.py``).

MFU (model FLOPs utilization) is achieved FLOP/s over the card's peak; the
numerator counts only the model's useful work from an analytic count, so it
does not move with the host. One multiply-accumulate is 2 FLOPs; only the
matmul and convolution terms are counted (norms, activations and softmax
are bandwidth-bound).

The peaks are the NVIDIA H100 SXM's published dense rates (``PEAK_FLOPS``,
``PEAK_BYTES``). ``SVT_PEAK_TFLOPS`` overrides the peak of every type (the
JAX package's ``TPU_PEAK_TFLOPS``, renamed: ``docs/PORT_MAP.md``).
"""
from __future__ import annotations

import os

# H100 SXM, dense: bf16 and TF32 on the tensor cores, f32 outside them,
# int8 tensor-core operations a second; HBM3 bytes a second
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12,
              "int8": 1979e12}
PEAK_BYTES = 3.35e12


def peak_flops_per_sec(dtype="bf16") -> float:
    """The card's peak for ``dtype`` (a key of ``PEAK_FLOPS``), or
    ``SVT_PEAK_TFLOPS`` × 1e12 when that is set."""
    override = os.environ.get("SVT_PEAK_TFLOPS")
    if override is not None:
        return float(override) * 1e12
    return PEAK_FLOPS[dtype]


def conv_frontend_flops(config, num_samples: int) -> float:
    """FLOPs of the strided conv feature extractor on one example."""
    from svt_speechbrain_tpu_torch.nnet.cnn import conv_output_length

    t = num_samples
    in_ch = 1
    total = 0.0
    for out_ch, k, s in zip(config.conv_dim, config.conv_kernel,
                            config.conv_stride):
        t = conv_output_length(t, k, s, padding="valid")
        total += 2.0 * in_ch * k * out_ch * t
        in_ch = out_ch
    return total


def encoder_flops(config, t_frames: int) -> float:
    """FLOPs of the encoder (feature projection, positional conv and every
    layer) on one example of ``t_frames`` frames."""
    d = config.hidden_size
    f = config.ffn_size
    t = t_frames
    # grouped positional conv ("same" padding: t outputs)
    k = config.num_conv_pos_embeddings
    groups = config.num_conv_pos_embedding_groups
    total = 2.0 * (d / groups) * k * d * t
    # feature projection conv_dim[-1] → d
    total += 2.0 * t * config.conv_dim[-1] * d
    per_layer = (
        8.0 * t * d * d       # q/k/v/out projections
        + 4.0 * t * t * d     # scores (QK^T) and context (AV)
        + 4.0 * t * d * f     # FFN in and out
    )
    return total + config.num_layers * per_layer


def amt_forward_flops(config, num_samples: int, head_out: int = 20) -> float:
    """Forward FLOPs of the AMT pipeline (frontend, encoder, the linear
    frame head) on one example of ``num_samples`` samples."""
    t = config.output_length(num_samples)
    return (conv_frontend_flops(config, num_samples)
            + encoder_flops(config, t)
            + 2.0 * t * config.hidden_size * head_out)


def amt_train_flops(config, num_samples: int, head_out: int = 20,
                    remat: bool = False) -> float:
    """FLOPs of one training example: forward and backward (a matmul's
    backward costs twice its forward), and one more forward when
    rematerialization recomputes the activations."""
    fwd = amt_forward_flops(config, num_samples, head_out)
    return fwd * (4.0 if remat else 3.0)


def mfu(flops_per_example: float, examples_per_sec: float,
        dtype="bf16") -> float:
    """Model FLOPs utilization in [0, 1] against the ``dtype`` peak.

    Example
    -------
    >>> mfu(67e12, 0.5, dtype="f32")     # 33.5 TFLOP/s of f32 work
    0.5
    """
    return flops_per_example * examples_per_sec / peak_flops_per_sec(dtype)
