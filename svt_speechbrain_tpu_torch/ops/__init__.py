"""The port's CUDA kernels and their plain PyTorch versions.

Every wrapper keeps a plain-integer ``launches`` count, raised by one at
each kernel launch and nowhere else (CPU calls run the plain version and
count nothing). ``launch_counts`` reads them, ``reset_launch_counts`` sets
them to 0, so a run can show which kernels its path went through.
"""
from __future__ import annotations


def kernel_wrappers():
    """name → wrapper function, one per TPU kernel the port replaces."""
    from svt_speechbrain_tpu_torch.ops.conv_frontend import fused_conv_frontend
    from svt_speechbrain_tpu_torch.ops import flash_attention as fa
    from svt_speechbrain_tpu_torch.ops.quant import int8_matmul
    from svt_speechbrain_tpu_torch.ops import transducer_lattice as tl

    return {"conv_frontend": fused_conv_frontend,
            "flash_attention_short": fa.flash_attention_short,
            "flash_attention": fa.flash_attention,
            "flash_attention_lse": fa.flash_attention_fwd_lse,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "int8_matmul": int8_matmul,
            "rnnt_lattice": tl.rnnt_lattice,
            "rnnt_grad": tl.rnnt_grad}


def launch_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0
