#!/usr/bin/env python3
"""Find the batch sizes ``torch.linalg.eigh`` takes on the card for small
Hermitian matrices (the route ``processing/decomposition.py`` slices by
``EIGH_BATCH``): random well-conditioned 4 x 4 complex64 and complex128
batches of growing size, each reported as its time or the error it raises.

    python3 tools/eigh_batch_probe.py [--n 4] [--sizes 1000,16384,32768]
"""
import argparse
import time

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--sizes", default="1000,4096,16384,32767,32768,40000,"
                                       "65536,131072,804804")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("eigh_batch_probe: no CUDA device is available")
    torch.manual_seed(0)
    eye = torch.eye(args.n, device="cuda")
    for dtype in (torch.complex64, torch.complex128):
        for size in (int(s) for s in args.sizes.split(",")):
            a = torch.randn(size, args.n, args.n, dtype=dtype, device="cuda")
            h = a @ a.transpose(-1, -2).conj() + args.n * eye
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch.linalg.eigh(h)
                torch.cuda.synchronize()
                print(f"{dtype} {size}: ok, "
                      f"{(time.perf_counter() - t0) * 1e3:.2f} ms", flush=True)
            except RuntimeError as err:
                print(f"{dtype} {size}: {str(err).splitlines()[0][:100]}",
                      flush=True)


if __name__ == "__main__":
    main()
