"""Seeded weights of a configuration, made on the device in a few large
draws and handed to both the program and the reference.

The scales are a frozen copy of the port's seeded-init conventions
(``svt_speechbrain_tpu_torch/convert_jax.py:351-488``, ``init_params``):
kaiming-uniform convs and linears (bound sqrt(1/fan_in)) with torch-style
biases (bound 1/sqrt(fan_in)), glorot-uniform attention projections with
zero biases, unit LayerNorms, and a weight-norm ``g`` equal to the norm of
``v``, so that activations and decoded notes are not degenerate. The leaves
are named as the brain's modules name them (``wav2vec2.<bridge state dict
key>``, ``model.w``, ``model.b``): the names are the program's weight
format, which both sides read.
"""
from __future__ import annotations

import math

import torch

UNIFORM, ONES, ZEROS, WEIGHT_NORM_G = "uniform", "ones", "zeros", "g"


def param_specs(cfg):
    """[(name, shape, rule, bound)] of every leaf, in a fixed order."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    enc = "wav2vec2.encoder."
    specs = []

    def uniform(name, shape, bound):
        specs.append((name, tuple(shape), UNIFORM, bound))

    def norm(name, n):
        specs.append((name + ".scale", (n,), ONES, None))
        specs.append((name + ".bias", (n,), ZEROS, None))

    cin = 1
    for i, (cout, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        layer = f"{enc}feature_extractor.layers.{i}."
        uniform(layer + "conv.weight", (cout, cin, k), math.sqrt(1.0 / (cin * k)))
        if cfg["conv_bias"]:
            uniform(layer + "conv.bias", (cout,), 1.0 / math.sqrt(cin * k))
        norm(layer + "layer_norm", cout)
        cin = cout
    norm(enc + "feat_proj_ln", cin)
    uniform(enc + "feat_proj.w", (cin, d), math.sqrt(1.0 / cin))
    uniform(enc + "feat_proj.b", (d,), 1.0 / math.sqrt(cin))
    in_g = d // cfg["num_conv_pos_embedding_groups"]
    if "conv_pos_kernel_size" in cfg:            # data2vec's stacked convs
        k = cfg["conv_pos_kernel_size"]
        for i in range(cfg["num_conv_pos_embeddings"]):
            uniform(f"{enc}pos_conv.{i}.w", (d, in_g, k),
                    math.sqrt(1.0 / (in_g * k)))
            uniform(f"{enc}pos_conv.{i}.b", (d,), 1.0 / math.sqrt(in_g * k))
    else:
        k = cfg["num_conv_pos_embeddings"]
        uniform(enc + "pos_conv.v", (d, in_g, k), math.sqrt(1.0 / (in_g * k)))
        specs.append((enc + "pos_conv.g", (1, 1, k), WEIGHT_NORM_G, None))
        uniform(enc + "pos_conv.b", (d,), 1.0 / math.sqrt(in_g * k))
    norm(enc + "encoder_ln", d)
    glorot = math.sqrt(6.0 / (2 * d))
    for i in range(cfg["num_hidden_layers"]):
        layer = f"{enc}layers.{i}."
        for p in "qkvo":
            uniform(f"{layer}attn.w{p}", (d, d), glorot)
            specs.append((f"{layer}attn.b{p}", (d,), ZEROS, None))
        uniform(layer + "ffn1.w", (d, f), math.sqrt(1.0 / d))
        uniform(layer + "ffn1.b", (f,), 1.0 / math.sqrt(d))
        uniform(layer + "ffn2.w", (f, d), math.sqrt(1.0 / f))
        uniform(layer + "ffn2.b", (d,), 1.0 / math.sqrt(f))
        norm(layer + "ln1", d)
        norm(layer + "ln2", d)
    n_out = cfg["head_outputs"]
    uniform("model.w", (d, n_out), math.sqrt(1.0 / d))
    uniform("model.b", (n_out,), 1.0 / math.sqrt(d))
    return specs


def make_weights(cfg, seed, device):
    """name → f32 tensor on ``device``: every uniform leaf cut from one
    draw of a ``torch.Generator`` on ``device`` seeded by ``seed``."""
    specs = param_specs(cfg)
    total = sum(math.prod(shape) for _, shape, rule, _ in specs
                if rule == UNIFORM)
    gen = torch.Generator(device).manual_seed(int(seed))
    draw = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out, at = {}, 0
    for name, shape, rule, bound in specs:
        if rule == UNIFORM:
            n = math.prod(shape)
            out[name] = draw[at:at + n].view(shape).mul(bound)
            at += n
        elif rule == ONES:
            out[name] = torch.ones(shape, device=device)
        elif rule == ZEROS:
            out[name] = torch.zeros(shape, device=device)
    del draw
    for name, shape, rule, _ in specs:
        if rule == WEIGHT_NORM_G:               # |v| over all axes but k
            v = out[name[:-1] + "v"]
            out[name] = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
    return out
