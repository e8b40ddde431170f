"""Kernel 5's output dtype on the card: ``int8_matmul(out_dtype=...)``
writes the requested dtype from the kernel's f32 epilogue. Card-only (the
``cuda`` marker; skipped without a CUDA device, decided in a fixture); no
JAX, so it runs on the card machine with
    python -m pytest --noconftest -q tests/test_torch_int8_out_dtype_card.py
"""
import pytest
import torch

import chip_smoke
from svt_speechbrain_tpu_torch.ops import quant

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)])
@pytest.mark.parametrize("m,k,n", [(1992, 1024, 4096), (33, 1024, 128)])
def test_int8_matmul_writes_the_requested_dtype(cuda_device, dtype,
                                                out_dtype, m, k, n):
    """Against the plain version's f32 epilogue cast once to ``out_dtype``:
    within 1e-6 relative in f32 (the same f32 operations), one bf16 ulp in
    bf16; an f32 result of bf16 input is not a bf16 result widened."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x, w8, ws = chip_smoke.int8_inputs(m, k, n, dtype, gen)
    before = quant.int8_matmul.launches
    out = quant.int8_matmul(x, w8, ws, quant.pack_weight(w8),
                            out_dtype=out_dtype)
    assert quant.int8_matmul.launches == before + 1
    assert out.dtype == out_dtype and out.shape == (m, n)
    want = quant.int8_matmul_plain(x, w8, ws, out_dtype=out_dtype)
    tol = chip_smoke.INT8_RTOL["f32" if out_dtype == torch.float32
                               else "bf16"]
    err = (out.float() - want.float()).abs()
    assert (err <= tol * want.float().abs()).all()
    if out_dtype == torch.float32:
        widened = quant.int8_matmul_plain(x, w8, ws).float()
        assert not torch.equal(out, widened) or dtype == torch.float32
