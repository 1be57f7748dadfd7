"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips itself where ``torch.cuda.is_available()``
is False. This file imports neither JAX nor the JAX package, so it also runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: 2e-5 at f32, 5e-2 with
bf16 dot inputs.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
CASES = [(torch.float32, False), (torch.bfloat16, True)]


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc for sm_90a")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", CASES)
@pytest.mark.parametrize("S,hd,causal,q_offset", [(64, 64, True, 0), (67, 64, True, 0),
                                                  (37, 16, False, 0), (29, 32, True, 40),
                                                  (70, 128, True, 0)])
def test_flash_fwd_matches_plain(dtype, lowp, S, hd, causal, q_offset):
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn(2, 3, S, hd, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(2, 3, S + q_offset, hd, generator=g, device=dev).to(dtype)
            for _ in range(2))
    before = fa.launches["flash_fwd"]
    o, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal, q_offset=q_offset,
                                        lowp=lowp)
    ro, rl = ref.ref_flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset,
                                         lowp=lowp)
    tol = BF16 if lowp else F32
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    torch.testing.assert_close(lse, rl, **tol)
    assert fa.launches["flash_fwd"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", CASES)
@pytest.mark.parametrize("K,G,hd,hdv,scale", [(2, 4, 64, 64, None), (1, 8, 32, 16, 0.3),
                                              (2, 12, 16, 128, None)])
def test_flash_decode_matches_plain(dtype, lowp, K, G, hd, hdv, scale):
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(G)
    B, Smax = 5, 300
    q = torch.randn(B, K, G, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Smax, K, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Smax, K, hdv, generator=g, device=dev).to(dtype)
    lens = torch.tensor([0, 1, 33, Smax, Smax + 1], dtype=torch.int32, device=dev)
    out = fa.flash_decode(q, k, v, lens, scale=scale, lowp=lowp)
    want = ref.ref_flash_decode(q, k, v, lens, scale=scale, lowp=lowp)
    torch.testing.assert_close(out.float(), want.float(), **(BF16 if lowp else F32))
    assert not out[0].any(), "a length-0 row must return zeros"


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _device()
    with pytest.raises(ValueError, match="head dims"):
        x = torch.zeros(1, 2, 8, 24, device=dev)
        fa.flash_attention_fwd_lse(x, x, x)
    with pytest.raises(ValueError, match="hdv <= 128"):
        fa.flash_decode(torch.zeros(1, 1, 2, 16, device=dev),
                        torch.zeros(1, 4, 1, 16, device=dev),
                        torch.zeros(1, 4, 1, 256, device=dev), 2)
