"""The CUDA ``potrf_inv`` kernel against its plain version, on the card.

Marked ``gpu``: on a machine without a card every test skips (the check is
made inside the test, so every worker collects the same tests).  On the
card: ``python -m pytest --noconftest tests/test_torch_gpu.py -m gpu``
(``tests/conftest.py`` sets up JAX, which this file does not need).  Bounds as in
``tests/test_torch_chol_panel.py``, scaled with w / 256 above w = 256."""
import pytest
import torch

from elemental_tpu_torch.kernels import potrf_inv, potrf_inv_reference

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 3e-6, torch.float64: 1e-12}
LADDER = [(48, 16), (96, 32), (16, 512), (128, 64), (512, 512), (2048, 512)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _spd(w, dtype, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + w)
    G = torch.randn(w, w, generator=gen, device="cuda", dtype=dtype)
    return G @ G.T / w + w * torch.eye(w, device="cuda", dtype=dtype)


def _residual(L, Li, D):
    w = D.shape[0]
    eye = torch.eye(w, dtype=D.dtype, device=D.device)
    return max(float(torch.linalg.norm(L @ L.T - D) / torch.linalg.norm(D)),
               float(torch.linalg.norm(Li @ L - eye) / w ** 0.5))


@pytest.mark.parametrize("w,bs", LADDER)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_kernel_matches_plain_version(w, bs, dtype):
    _need_card()
    D = _spd(w, dtype)
    before = potrf_inv.launches
    L, Li = potrf_inv(D, bs=bs)
    torch.cuda.synchronize()
    assert potrf_inv.launches == before + 1
    Lp, Lip = potrf_inv_reference(D, bs=bs)
    tol = TOL[dtype] * max(1.0, w / 256)
    rk, rp = _residual(L, Li, D), _residual(Lp, Lip, D)
    assert rk < tol and rk < 10 * rp + tol
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert torch.equal(torch.triu(Li, 1), torch.zeros_like(Li))


def test_kernel_reads_lower_triangle_of_a_strided_view():
    _need_card()
    big = _spd(96, torch.float64)
    junk = big + torch.triu(torch.ones_like(big), 1)
    L1, Li1 = potrf_inv(junk[:64, :64], bs=32)     # leading dimension 96
    L2, Li2 = potrf_inv(big[:64, :64].contiguous(), bs=32)
    torch.cuda.synchronize()
    assert torch.equal(L1, L2) and torch.equal(Li1, Li2)


def test_kernel_refuses_complex():
    _need_card()
    with pytest.raises(ValueError, match="real-only"):
        potrf_inv(torch.eye(8, dtype=torch.complex64, device="cuda"))
