#!/usr/bin/env python3
"""Where an f32 training step of the CRDNN assembly loses precision.

Runs ``chip_smoke.py``'s phase-22 assembly (2 LiGRU layers, every other
width as in ``crdnn-ligru-timit``, dropouts 0, the batch's longest and
shortest rows) forward and backward in f32 and in f64 on one device, and
prints, for the gradient reaching each boundary of the forward (the CNN
blocks' outputs, the LiGRU's input and output, the DNN blocks' outputs,
the encoder output, the decoder's input embeddings and output, the two
heads' log-probabilities) and for the parameters of each module, the f32
gradient's distance from the f64 one relative to the f64 norm. With
``--no-cudnn`` the f32 step runs with cuDNN off (PyTorch's own
convolutions and RNN cells). TF32 is off throughout.

    python3 tools/crdnn_grad_probe.py [--device cuda] [--no-cudnn]
"""
import argparse
import copy
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from svt_speechbrain_tpu_torch.convert_jax import init_modules  # noqa: E402
from svt_speechbrain_tpu_torch.nnet import losses  # noqa: E402


def step(modules, batch, device, dtype):
    """Gradients at the forward's boundaries and of each module's
    parameters, on the CPU in f64."""
    m = {k: v.to(device, dtype) for k, v in copy.deepcopy(modules).items()}
    wavs = batch["sig"].data.to(device, dtype)
    wav_lens = torch.as_tensor(batch["sig"].lengths, device=device)
    tokens = batch["tokens"].data.to(device)
    eos = batch["tokens_eos"].data.to(device)
    enc = m["enc"]
    seen = {}

    def keep(name, t):
        t.retain_grad()
        seen[name] = t
        return t

    feats = m["normalize"](m["compute_features"](wavs), wav_lens, train=True)
    h = keep("cnn0", enc.cnn0(feats[..., None]))
    h = keep("cnn1", enc.cnn1(h))
    h = enc.time_pool(h)
    h = keep("rnn_in", h.reshape(h.shape[0], h.shape[1], -1))
    h = keep("rnn_out", enc.rnn(h, train=True)[0])
    h = keep("dnn0", enc.dnn0(h, train=True))
    x = keep("enc_out", enc.dnn1(h, train=True))
    p_ctc = keep("p_ctc", torch.log_softmax(m["ctc_lin"](x), -1))
    e = keep("emb", m["emb"](batch["tokens_bos"].data.to(device)))
    hd = keep("dec_out", m["dec"](e, x, wav_lens)[0])
    p_seq = keep("p_seq", torch.log_softmax(m["seq_lin"](hd), -1))
    ctc = losses.ctc_loss(p_ctc, tokens, wav_lens,
                          torch.as_tensor(batch["tokens"].lengths,
                                          device=device), cs.CRDNN_BLANK)
    nll = losses.nll_loss(p_seq, eos, length=torch.as_tensor(
        batch["tokens_eos"].lengths, device=device))
    loss = cs.CRDNN_CTC_WEIGHT * ctc + (1 - cs.CRDNN_CTC_WEIGHT) * nll
    loss.backward()
    grads = {k: t.grad.double().cpu() for k, t in seen.items()}
    params = {}
    for name, mod in m.items():
        for pname, p in mod.named_parameters():
            top = pname.split(".")[0]
            params.setdefault(f"{name}.{top}", []).append(
                p.grad.double().cpu().reshape(-1))
    grads.update({f"param {k}": torch.cat(v) for k, v in params.items()})
    return grads


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-cudnn", action="store_true")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = dict(cs.CRDNN_ARCH, rnn_layers=2, dropout=0.0)
    modules = cs.crdnn_modules(arch, dict(cs.CRDNN_DEC, dropout=0.0))
    init_modules(modules, cs.SEED + 71)
    batch = cs.crdnn_batch(np.random.default_rng(7),
                           (cs.CRDNN_SECONDS[0], cs.CRDNN_SECONDS[-1]))
    want = step(modules, batch, args.device, torch.float64)
    torch.backends.cudnn.enabled = not args.no_cudnn
    got = step(modules, batch, args.device, torch.float32)
    print(f"device {args.device}, cuDNN {'off' if args.no_cudnn else 'on'} "
          f"in f32: |f32 - f64| / |f64| of each gradient")
    for k, w in want.items():
        err = (torch.linalg.vector_norm(got[k] - w)
               / torch.linalg.vector_norm(w)).item()
        print(f"  {k:24s} {err:.3e}")


if __name__ == "__main__":
    main()
