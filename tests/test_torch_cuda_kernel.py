"""The CUDA BiACM kernel against its plain twin on the card. Needs a CUDA
device (and nvcc to build the kernel); skips without one. On the GPU
machine run it with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py``
(``--noconftest`` skips the JAX setup of ``tests/conftest.py``; this file
imports no JAX)."""

import pytest
import torch

from peneo_tpu_torch.ops import biacm_attention as ba

pytestmark = pytest.mark.cuda
NEG = torch.finfo(torch.float32).min / 2


@pytest.mark.parametrize("L", [1, 63, 128, 200, 512])
def test_kernel_matches_plain_twin_on_card(L):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(L)
    B, nh = 2, 12

    def heads(d):  # (B, nh, L, d) views of (B, L, nh, d), as the model passes
        x = torch.randn((B, L, nh, d), generator=gen, device="cuda")
        return x.to(torch.bfloat16).transpose(1, 2)

    qkv = [heads(64) for _ in range(3)] + [heads(16) for _ in range(3)]
    bias = torch.zeros((B, L), device="cuda")
    bias[0, : L // 2] = NEG       # leading keys padded (whole key tiles)
    bias[1, L - L // 3:] = NEG    # trailing keys padded
    before = ba.biacm_attention_cuda.launches
    got = ba.biacm_attention(*qkv, bias, 0.125, 0.25)
    want = ba.biacm_attention_reference(*(x.float() for x in qkv), bias,
                                        0.125, 0.25)
    torch.cuda.synchronize()
    assert ba.biacm_attention_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert (g.float() - w).abs().max().item() <= 2e-2
