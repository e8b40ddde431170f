"""The system under test, as the benchmark builds it: the port's bridge
and frame head from a configuration file, holding the benchmark's weights.
The drivers import the program through here and nowhere else."""
from __future__ import annotations

import torch


def port_config(cfg):
    """The port's ``Wav2Vec2Config`` for a configuration file."""
    from svt_speechbrain_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    fields = dict(
        hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        ffn_size=cfg["intermediate_size"], conv_dim=tuple(cfg["conv_dim"]),
        conv_kernel=tuple(cfg["conv_kernel"]),
        conv_stride=tuple(cfg["conv_stride"]),
        feat_extract_norm=cfg["feat_extract_norm"], conv_bias=cfg["conv_bias"],
        num_conv_pos_embedding_groups=cfg["num_conv_pos_embedding_groups"],
        do_stable_layer_norm=cfg["do_stable_layer_norm"],
        layer_norm_eps=cfg["layer_norm_eps"],
        hidden_dropout=cfg["hidden_dropout"],
        attention_dropout=cfg["attention_dropout"],
        activation_dropout=cfg["activation_dropout"],
        feat_proj_dropout=cfg["feat_proj_dropout"])
    if "conv_pos_kernel_size" in cfg:
        fields.update(pos_conv_type="stacked",
                      pos_conv_depth=cfg["num_conv_pos_embeddings"],
                      pos_conv_kernel=cfg["conv_pos_kernel_size"])
    else:
        fields.update(num_conv_pos_embeddings=cfg["num_conv_pos_embeddings"])
    return Wav2Vec2Config(**fields)


def build_modules(cfg, weights, device):
    """(bridge, head) on ``device`` holding ``weights`` (name → tensor,
    ``weights.param_specs`` names), which they take over."""
    from svt_speechbrain_tpu_torch.models.wav2vec2 import HuggingFaceWav2Vec2
    from svt_speechbrain_tpu_torch.nnet.linear import Linear

    with torch.device(device):
        bridge = HuggingFaceWav2Vec2(source=cfg["source"],
                                     config=port_config(cfg),
                                     output_norm=True, normalize_wav=True)
        head = Linear(cfg["head_outputs"], cfg["hidden_size"])
    for module, prefix in ((bridge, "wav2vec2."), (head, "model.")):
        module.load_state_dict({k[len(prefix):]: v for k, v in weights.items()
                                if k.startswith(prefix)}, strict=True,
                               assign=True)
    return bridge, head
