"""The plain versions of the two fused scan kernels against the JAX models'
own functions, on the CPU, and what their ops and wrappers decide on the
host.

``ref.selective_scan_ref`` (what ``ops.selective_scan`` runs on the CPU, and
what the CUDA selective-scan kernel is held against on the card) against
``repro.models.ssm.selective_scan``; ``ref.rglru_gated_scan_ref`` (the same
for ``ops.rglru_gated_scan`` and the fused RG-LRU kernel) against
``repro.models.rglru.rglru_scan``: at f32 and bf16, with and without an
initial state, S in {1, 7, 33}, widths that are not multiples of 32.
Inputs from numpy seeds.  Tolerances: 1e-5 (f32) and 2e-2 (bf16) of the
largest value (tests/test_kernels.py:14), for the outputs and the last
states.  The dispatch tests make every CUDA query raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_gated_fwd, rglru_scan_fwd  # noqa: E402
from repro_torch.kernels.selective_scan import scan_lanes, selective_scan_fwd  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype="float32"):
    """The same values as a JAX array and a CPU tensor, rounded to dtype."""
    j = jnp.asarray(np.asarray(a, np.float32), DT[dtype][0])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(DT[dtype][1])


def _rel_close(got: torch.Tensor, want, tol: float):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _mamba_inputs(rng, Bn, S, C, N, dtype, with_h0):
    """The model's inputs to the scan: softplus'd dt, A = -exp(...) and D in
    f32, B and C as slices of one projection (strided, as the model passes
    them), h0 in f32."""
    R = 3
    ju, u = _pair(rng.randn(Bn, S, C), dtype)
    jdt, dt = _pair(np.log1p(np.exp(rng.randn(Bn, S, C) - 1.0)), dtype)
    jA, A = _pair(-np.exp(0.5 * rng.randn(C, N)))
    jproj, proj = _pair(rng.randn(Bn, S, R + 2 * N), dtype)
    jD, D = _pair(rng.randn(C))
    jh0, h0 = _pair(rng.randn(Bn, C, N)) if with_h0 else (None, None)
    jax_in = (ju, jdt, jA, jproj[..., R:R + N], jproj[..., R + N:], jD, jh0)
    port_in = (u, dt, A, proj[..., R:R + N], proj[..., R + N:], D, h0)
    return jax_in, port_in


@pytest.mark.parametrize("S", [1, 7, 33])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_ref_matches_jax(S, with_h0, dtype):
    rng = np.random.RandomState(20 + S)
    Bn, C, N = 2, 45, 16
    jax_in, port_in = _mamba_inputs(rng, Bn, S, C, N, dtype, with_h0)
    want_y, want_h = jssm.selective_scan(*jax_in[:6], h0=jax_in[6])
    y, h = ref.selective_scan_ref(*port_in)
    assert y.dtype == DT[dtype][1] and y.shape == (Bn, S, C)
    assert h.dtype == torch.float32 and h.shape == (Bn, C, N)
    _rel_close(y, want_y, TOL[dtype])
    _rel_close(h, want_h, TOL["float32"])  # the state is f32 for either input


@pytest.mark.parametrize("S", [1, 7, 33])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_gated_scan_ref_matches_jax(S, with_h0, dtype):
    rng = np.random.RandomState(30 + S)
    Bn, W = 3, 50
    jx, x = _pair(rng.randn(Bn, S, W), dtype)
    jr, r = _pair(1 / (1 + np.exp(-rng.randn(Bn, S, W))), dtype)
    ji, i = _pair(1 / (1 + np.exp(-rng.randn(Bn, S, W))), dtype)
    jlam, lam = _pair(rng.randn(W))
    jh0, h0 = _pair(rng.randn(Bn, W)) if with_h0 else (None, None)
    want_y, want_h = jrglru.rglru_scan(jx, jr, ji, jlam, h0=jh0)
    y, h = ref.rglru_gated_scan_ref(x, r, i, lam, h0)
    assert y.dtype == DT[dtype][1] and y.shape == (Bn, S, W)
    assert h.dtype == torch.float32 and h.shape == (Bn, W)
    _rel_close(y, want_y, TOL[dtype])
    _rel_close(h, want_h, TOL["float32"])


def test_rglru_gated_scan_ref_is_the_model_scan_bit_for_bit():
    """The model's plain path is the fused kernel's plain version; the decay
    coefficient the op hands the kernel is the one the plain version forms."""
    rng = np.random.RandomState(40)
    x, r, i = (torch.from_numpy(rng.rand(2, 9, 40).astype(np.float32)) for _ in range(3))
    lam = torch.from_numpy(rng.randn(40).astype(np.float32))
    got = rglru.rglru_scan(x, r, i, lam, kernel=False)
    want = ref.rglru_gated_scan_ref(x, r, i, lam)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    c = ref.rglru_decay(lam)
    assert torch.equal(torch.exp(c * r), torch.exp(-8.0 * ref.softplus(lam) * r))


def test_selective_scan_updates_the_state_in_place():
    """A state given to the model's scan (the decode's cache) takes the last
    state in place and is returned; y and the state equal those of the
    plain version writing a new state."""
    rng = np.random.RandomState(41)
    _, (u, dt, A, Bs, Cs, D, h0) = _mamba_inputs(rng, 2, 1, 37, 16, "float32", True)
    y, h = ref.selective_scan_ref(u, dt, A, Bs, Cs, D, h0)
    assert h is not h0
    state = h0.clone()
    for kernel in (False, True):  # the model's loop and the op's plain version
        state.copy_(h0)
        y2, h2 = ssm.selective_scan(u, dt, A, Bs, Cs, D, h0=state, kernel=kernel)
        assert h2 is state and torch.equal(state, h) and torch.equal(y2, y)


# ---------------------------------------------------------------------------
# dispatch and counters on the host
# ---------------------------------------------------------------------------


@pytest.fixture
def no_cuda(monkeypatch):
    """Any CUDA query from the code under test fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a host-side decision made a CUDA call")

    for name in ("current_device", "get_device_properties", "current_stream",
                 "device_count", "synchronize", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)


def test_fused_ops_run_the_plain_versions_on_the_cpu(no_cuda):
    """``ops.selective_scan`` and ``ops.rglru_gated_scan`` take the plain
    versions for CPU tensors and launch nothing; the kernel wrappers refuse
    CPU tensors before any CUDA call."""
    rng = np.random.RandomState(42)
    _, (u, dt, A, Bs, Cs, D, h0) = _mamba_inputs(rng, 2, 5, 33, 8, "float32", True)
    x = torch.rand(2, 5, 33)
    before = (selective_scan_fwd.launches, rglru_gated_fwd.launches, rglru_scan_fwd.launches)
    y, h = ops.selective_scan(u, dt, A, Bs, Cs, D, h0)
    assert all(torch.equal(a, b) for a, b in zip((y, h),
                                                 ref.selective_scan_ref(u, dt, A, Bs, Cs, D, h0)))
    y, h = ops.rglru_gated_scan(x, x, x, x[0, 0])
    assert all(torch.equal(a, b) for a, b in zip((y, h),
                                                 ref.rglru_gated_scan_ref(x, x, x, x[0, 0])))
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_fwd(u, dt, A, Bs, Cs, D, h0)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_gated_fwd(x, x, x, ref.rglru_decay(x[0, 0]))
    assert (selective_scan_fwd.launches, rglru_gated_fwd.launches,
            rglru_scan_fwd.launches) == before


@pytest.mark.parametrize("B,Ch,want", [(4, 8192, 2), (16, 8192, 1), (8, 8192, 1),
                                       (1, 8192, 4), (1, 64, 4), (2, 8192, 4)])
def test_selective_scan_lanes_fill_the_card(B, Ch, want, no_cuda):
    """Threads per channel: one while B * Ch channel threads give every one
    of 132 SMs 8 warps, else 2 or 4 (falcon-mamba-7b's serving prefill,
    B = 4 over d_inner 8192, takes 2)."""
    assert scan_lanes(B, Ch, 132) == want
