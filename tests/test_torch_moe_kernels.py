"""The port's grouped expert GEMM (``moe_matmul``), on the CPU: its plain
PyTorch version held against the jnp oracle ``repro.kernels.ref.
moe_matmul_ref`` and the JAX Pallas kernel (interpret mode, with the
blocks of tests/test_kernels.py, which pad every edge of these shapes),
on the same numpy inputs, at the shapes of tests/test_kernels.py.

The CUDA kernel runs only on a GPU; ``chip_smoke.py`` holds it against
this plain version there. Here the wrapper must route CPU tensors to the
plain version without counting a launch, and refuse what the kernel does
not take (on the CPU too).

Tolerance: atol 2e-5, rtol 2e-4 (tests/test_kernels.py's float32 case:
a d-long sum per output, in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import _build
from repro_torch.kernels import moe_matmul as tmm

TOL = dict(atol=2e-5, rtol=2e-4)
SHAPES = [(2, 32, 64, 48), (4, 40, 48, 56), (8, 16, 128, 128)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(E, C, D, F, seed=0):
    """The distributions of tests/test_kernels.py::test_moe_matmul: x
    normal, w normal * 0.1."""
    rng = np.random.default_rng(seed + E * C + D * F)
    return (rng.standard_normal((E, C, D)).astype(np.float32),
            (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("E,C,D,F", SHAPES)
def test_moe_matmul_plain_matches_reference(E, C, D, F):
    """Against the jnp oracle and the Pallas kernel (interpret mode,
    blocks 16 / 32 / 16, so C = 40, F = 48 and F = 56 are padded there)."""
    x, w = _inputs(E, C, D, F)
    got = tmm.moe_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (E, C, F) and got.dtype == torch.float32
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    for want in (ref.moe_matmul_ref(jx, jw),
                 ops.moe_matmul(jx, jw, block_c=16, block_f=32,
                                block_d=16)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    x, w = (torch.from_numpy(a) for a in _inputs(3, 5, 7, 12, seed=1))
    n0 = tmm.moe_matmul.launches
    assert torch.equal(tmm.moe_matmul(x, w), tmm.moe_matmul_plain(x, w))
    assert tmm.moe_matmul.launches == n0
    assert tmm.moe_matmul(x[:, :0], w).shape == (3, 0, 12)


def test_moe_matmul_refuses_what_the_kernel_does_not_take():
    """float32 and contiguous only, x (E,C,d) against w (E,d,f) on one
    device, f a multiple of 4 and w 16-byte aligned (read as float4),
    refused on the CPU as on the card; a device with no kernel raises
    too. The kernel is registered with its C signature."""
    x, w = (torch.from_numpy(a) for a in _inputs(2, 8, 16, 12, seed=2))
    shifted = torch.empty(w.numel() + 1)[1:].view(w.shape)  # 4-byte offset
    shifted.copy_(w)
    assert shifted.is_contiguous()
    bad = [(x.double(), w), (x, w.to(torch.bfloat16)),
           (x.transpose(1, 2).contiguous().transpose(1, 2), w),
           (x, w.transpose(1, 2).contiguous().transpose(1, 2)),
           (x[:, :, :8], w), (x[:1], w), (x[0], w[0]),
           (x, w[:, :, :10].contiguous()), (x, shifted)]
    for a, b in bad:
        with pytest.raises(ValueError, match="moe_matmul"):
            tmm.moe_matmul(a, b)
    with pytest.raises(ValueError, match="no kernel"):
        tmm.moe_matmul(x.to("meta"), w.to("meta"))
    assert len(_build.KERNELS["moe_matmul"]) == 7
    assert _build.library_path("moe_matmul").name.startswith("libmoe_matmul")
