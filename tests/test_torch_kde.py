"""Weighted-KDE log-density of the PyTorch port against the JAX package.

The same numpy inputs (``numpy.random.default_rng``) go through
``pyabc_tpu.ops.kde`` (the XLA scan, and the Pallas kernel in interpret
mode) and ``pyabc_tpu_torch.ops.kde`` (the plain version, which is the
CPU path and the reference of the CUDA kernel).  Tolerances:

- against the XLA scan: atol 1e-4, rtol 1e-5 — the same float32 algorithm
  with a different summation order;
- against the Pallas kernel: atol 5e-3, rtol 1e-4 — the Pallas test's own
  tolerances (tests/test_ops_kde_pallas.py), set by its bf16x3 product;
- pad rows at -1e30: atol 1e-5.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyabc_tpu.ops.kde import weighted_kde_logpdf as jax_kde
from pyabc_tpu.ops.kde_pallas import weighted_kde_logpdf_pallas
from pyabc_tpu.transition import \
    MultivariateNormalTransition as JaxMVN
from pyabc_tpu_torch.convert import to_torch
from pyabc_tpu_torch.ops import kde, kde_cuda
from pyabc_tpu_torch.transition import MultivariateNormalTransition


def _problem(m=500, n=1000, d=3, seed=0):
    rng = np.random.default_rng(seed)
    support = rng.standard_normal((n, d)).astype(np.float32)
    x = rng.standard_normal((m, d)).astype(np.float32)
    log_w = (0.3 * rng.standard_normal(n)).astype(np.float32)
    log_w = (log_w - np.log(np.sum(np.exp(log_w)))).astype(np.float32)
    chol = (np.eye(d) * 0.3).astype(np.float32)
    log_norm = np.float32(-d / 2 * np.log(2 * np.pi) - d * np.log(0.3))
    return x, support, log_w, chol, log_norm


def _port(x, support, log_w, chol, log_norm, **kw):
    t = [torch.as_tensor(a) for a in (x, support, log_w, chol)]
    return kde.weighted_kde_logpdf(*t, float(log_norm), **kw).numpy()


@pytest.mark.parametrize("d,n", [(1, 1000), (2, 1000), (5, 1000),
                                 (3, 1537)])
def test_plain_matches_jax_scan(d, n):
    args = _problem(n=n, d=d, seed=d)
    ref = np.asarray(jax_kde(*[jnp.asarray(a) for a in args]))
    got = _port(*args)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_plain_blocking_is_invisible():
    """Query/support block sizes change the summation order only."""
    args = _problem(m=300, n=1537, d=2, seed=7)
    a = _port(*args)
    b = _port(*args, query_block=64, support_block=256)
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("d", [1, 2, 5])
def test_plain_matches_pallas_interpret(d):
    args = _problem(d=d, seed=10 + d)
    ref = np.asarray(weighted_kde_logpdf_pallas(
        *[jnp.asarray(a) for a in args], interpret=True))
    got = _port(*args)
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=1e-4)


@pytest.mark.parametrize("n_pad", [537, 2048])
def test_pad_rows_are_noops(n_pad):
    """-1e30 pad rows (pad_params, empty grid cells) contribute nothing,
    including a whole streamed block of pads."""
    x, support, log_w, chol, log_norm = _problem(n=1000, d=2, seed=3)
    support2 = np.concatenate([support, np.zeros((n_pad, 2), np.float32)])
    log_w2 = np.concatenate([log_w, np.full(n_pad, -1e30, np.float32)])
    ref = _port(x, support, log_w, chol, log_norm)
    padded = _port(x, support2, log_w2, chol, log_norm, support_block=512)
    np.testing.assert_allclose(padded, ref, atol=1e-5)


def _fitted_params(n, seed=0):
    rng = np.random.default_rng(seed)
    theta = (1.0 + 0.3 * rng.standard_normal((n, 1))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    tr = JaxMVN()
    tr.fit(theta, w)
    params = tr.pad_params(tr.get_params(), 1 << int(np.ceil(np.log2(n))))
    x = (1.0 + 0.25 * rng.standard_normal((400, 1))).astype(np.float32)
    return params, x, tr


@pytest.mark.parametrize("compressed", [True, False])
def test_log_pdf_from_params_via_convert(compressed):
    """The JAX transition's padded params, carried over by convert.py,
    give the same density in both packages — against the grid-compressed
    support (``c_support``) and against the full support."""
    params, x, tr = _fitted_params(20000)
    assert "c_support" in params
    if not compressed:
        params = {k: v for k, v in params.items()
                  if k not in ("c_support", "c_log_w")}
    ref = np.asarray(tr.log_pdf_from_params(jnp.asarray(x), params))
    got = MultivariateNormalTransition.log_pdf_from_params(
        torch.as_tensor(x), to_torch(params, "cpu")).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_auto_on_cpu_is_the_plain_version():
    args = _problem(m=100, n=300, d=2, seed=5)
    t = [torch.as_tensor(a) for a in args[:4]]
    auto = kde.weighted_kde_logpdf_auto(*t, float(args[4]))
    plain = kde.weighted_kde_logpdf(*t, float(args[4]))
    assert torch.equal(auto, plain)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is an error."""
    args = _problem(m=10, n=30, d=2)
    t = [torch.as_tensor(a) for a in args[:4]]
    with pytest.raises(ValueError, match="CUDA"):
        kde_cuda.weighted_kde_logpdf_cuda(*t, float(args[4]))


@pytest.mark.parametrize("m,n,d", [(16384, 16384, 1), (1_000_000, 8192, 1),
                                   (1_000_000, 65536, 1), (65536, 65536, 2),
                                   (65536, 65536, 5), (1000, 1537, 3),
                                   (1, 1, 1), (5, 300, 8), (3, 20_000_000, 1),
                                   (2500, 7001, 12), (70000, 300, 32)])
def test_split_plan_covers_support(m, n, d):
    """Every support row lies in exactly one split; a split is a whole
    number of G rows (the bulk copy's 16-byte granule and the sub-tile),
    fits the shared memory it is staged in, and the grid stays within
    CUDA's limits."""
    p, q, k, _ = kde_cuda.geometry(d)
    chunk, splits = kde_cuda.split_plan(m, n, d)
    assert chunk % kde_cuda.G == 0 and kde_cuda.G % k == 0
    assert chunk <= kde_cuda.MAX_CHUNK
    assert chunk * p * 4 <= kde_cuda.SMEM_BYTES
    assert 1 <= splits <= 65535
    n_pad = -(-n // kde_cuda.G) * kde_cuda.G
    covered = 0
    for s in range(splits):
        j0 = s * chunk
        cnt = min(chunk, n - j0)
        assert cnt >= 1
        cnt_pad = -(-cnt // kde_cuda.G) * kde_cuda.G
        assert j0 + cnt_pad <= n_pad            # the copy stays in bounds
        assert (j0 * p * 4) % 16 == 0 and (cnt_pad * p * 4) % 16 == 0
        covered += cnt
    assert covered == n
    assert -(-m // (kde_cuda.BLOCK * q)) < 2 ** 31


def test_split_plan_fills_the_card_at_small_query_counts():
    """16384 queries are 32 query blocks: the support split makes up the
    rest of about TARGET_BLOCKS."""
    _, q, _, _ = kde_cuda.geometry(1)
    chunk, splits = kde_cuda.split_plan(16384, 16384, 1)
    blocks = -(-16384 // (kde_cuda.BLOCK * q)) * splits
    assert kde_cuda.TARGET_BLOCKS / 2 <= blocks <= 2 * kde_cuda.TARGET_BLOCKS


def test_split_plan_refuses_a_support_the_grid_cannot_hold():
    with pytest.raises(ValueError, match="support rows"):
        kde_cuda.split_plan(10, 2 ** 31 - 1, 32)


def test_geometry_and_constants_match_the_source():
    """The wrapper plans with the source's block geometry: its defines
    and its Geometry<D> table, read from csrc/kde_logpdf.cu."""
    import re
    from pyabc_tpu_torch.ops import _build
    src = (_build.CSRC_DIR / "kde_logpdf.cu").read_text()
    defines = dict(re.findall(r"#define (\w+) (\S+)", src))
    assert int(defines["BLOCK"]) == kde_cuda.BLOCK
    assert int(defines["G"]) == kde_cuda.G
    assert int(defines["MAX_D"]) == kde_cuda.MAX_D
    assert float(defines["LOG2E"].rstrip("f")) == kde_cuda.LOG2E
    assert float(defines["HALF_LOG2E_SQRT"].rstrip("f")) == \
        kde_cuda.HALF_LOG2E_SQRT
    assert math.isclose(kde_cuda.HALF_LOG2E_SQRT ** 2, kde_cuda.LOG2E / 2,
                        rel_tol=1e-15)
    assert "P = D == 1 ? 2 : ((D + 1 + 3) / 4) * 4" in src
    assert "Q = D == MAX_D ? 2 : 4" in src
    assert "K = D == MAX_D ? 4 : 8" in src
    assert "E = D <= 2 ? 1 : 0" in src
    poly = [float(defines[f"EXP2_C{i}"].rstrip("f")) for i in range(6)]
    assert tuple(poly) == kde_cuda.EXP2_POLY
    for d in range(1, 33):
        p, q, k, e = kde_cuda.geometry(d)
        assert p >= d + 1 and (p % 4 == 0 or p == 2 or d > 8)
        assert 0 <= e < k
    with pytest.raises(ValueError):
        kde_cuda.geometry(33)


def _np_torch(args):
    return [torch.as_tensor(a) for a in args[:4]], float(args[4])


@pytest.mark.parametrize("d,m,n,n_pad,scale", [
    (1, 300, 1000, 0, 1.0), (1, 1000, 5000, 0, 10.0), (2, 300, 1537, 300, 1.0),
    (3, 77, 1001, 0, 1.0), (5, 100, 999, 0, 1.0), (8, 64, 513, 13, 1.0),
    (12, 50, 300, 0, 1.0)])
def test_base2_arithmetic_matches_plain(d, m, n, n_pad, scale):
    """The kernel's arithmetic (base 2, prescaled packed rows, sub-tiles
    with one max and one rescale, splits, NEVER fillers) in plain PyTorch
    against the plain version, at the smoke's tolerance; ``scale`` 10
    puts whitened |z| at a few tens."""
    x, support, log_w, chol, log_norm = _problem(m=m, n=n, d=d, seed=d)
    x, support = x * scale, support * scale
    if n_pad:
        support[-n_pad:] = 0.0
        log_w[-n_pad:] = -1e30
    t, ln = _np_torch((x, support, log_w, chol, log_norm))
    got = kde_cuda.base2_logpdf(*t, ln)
    ref = kde.weighted_kde_logpdf(*t, ln)
    assert torch.all((got - ref).abs() <= 1e-4 + 1e-5 * ref.abs())


def test_base2_all_pad_support_gives_what_plain_gives():
    """An all-pad support (every log w = -1e30) gives -1e30 in both: the
    base-2 running max starts at the base-2 image of -1e30, never -inf."""
    x, support, log_w, chol, log_norm = _problem(m=40, n=100, d=2, seed=1)
    log_w[:] = -1e30
    t, ln = _np_torch((x, support, log_w, chol, log_norm))
    got = kde_cuda.base2_logpdf(*t, ln)
    ref = kde.weighted_kde_logpdf(*t, ln)
    assert torch.isfinite(got).all()
    assert torch.all((got - ref).abs() <= 1e-4 + 1e-5 * ref.abs())
    assert torch.allclose(ref, torch.full_like(ref, -1e30))


def test_base2_far_queries_keep_the_terms_near_the_max():
    """Queries far beyond both ends of a sorted 1-D grid: every term but
    those near the max underflows, and the max subtraction keeps them."""
    n = 2048
    support = np.linspace(-1.0, 3.0, n, dtype=np.float32)[:, None]
    rng = np.random.default_rng(4)
    log_w = np.log(rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    x = np.array([[-40.0], [-3.0], [0.5], [1.0], [5.0], [60.0]], np.float32)
    chol = np.array([[64 * 4.0 / n]], np.float32)
    t, ln = _np_torch((x, support, log_w, chol, -0.5 * math.log(2 * math.pi)
                       - math.log(float(chol[0, 0]))))
    got = kde_cuda.base2_logpdf(*t, ln)
    ref = kde.weighted_kde_logpdf(*t, ln)
    assert torch.isfinite(got).all() and float(ref.min()) < -1e4
    assert torch.all((got - ref).abs() <= 1e-4 + 1e-5 * ref.abs())


def test_ptxas_report_reads_registers_and_spills():
    from pyabc_tpu_torch.ops import _build
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function "
        "'_Z18kde_partial_kernelILi1ELb1EEvPKfS1_S1_iiiiPfS2_' for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_Z18kde_partial_kernelILi1ELb1EEvPKfS1_S1_iiiiPfS2_\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers, 8 bytes smem, "
        "400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_Z16kde_merge_kernelPKfS0_iiS0_fPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_Z16kde_merge_kernelPKfS0_iiS0_fPf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 18 registers, 400 bytes cmem[0]\n")
    rows = _build.ptxas_report(log)
    assert rows == [
        {"function": "kde_partial_kernel<1,1>", "registers": 96,
         "stack": 0, "spill_stores": 8, "spill_loads": 4, "smem": 8},
        {"function": "kde_merge_kernel", "registers": 18,
         "stack": 0, "spill_stores": 0, "spill_loads": 0, "smem": 0}]


def test_bound_is_the_slower_of_exp_and_fp32_issue():
    """With a share phi of the exps on the FMA pipe the bound is the least
    over phi of the slower pipe: below the MUFU-only time at d < 4, the
    FP32-issue time from d = 4 on, never above either pipe alone."""
    f = 1.98e9
    m, n = 1_000_000, 65536
    pairs = m * n
    exp_s = pairs / (132 * 16 * f)
    c = kde_cuda.EXP2_FMA_COST
    for d in (1, 2, 3, 4, 5, 12, 32):
        got = kde_cuda.bound_seconds(m, n, d, f)
        fp32_s = pairs * (d + 4) / (132 * 128 * f)
        brute = min(max((1 - phi) / 16, (d + 4 + phi * c) / 128)
                    for phi in np.linspace(0.0, 1.0, 100001))
        assert math.isclose(got, pairs * brute / (132 * f), rel_tol=1e-4)
        assert fp32_s <= got * (1 + 1e-12) <= max(exp_s, fp32_s) * (1 + 1e-12)
        if d < 4:
            assert got < exp_s
        else:
            assert math.isclose(got, fp32_s)


def test_exp2_on_the_fma_pipe_is_within_1e6_of_exp2():
    """The kernel's polynomial exp2 (its constants, its float32 steps)
    against torch.exp2 on [-126, 0]: relative error <= 1e-6; below -126
    it returns at most 2^-125, never a negative or non-finite value."""
    x = torch.cat([torch.linspace(-126.0, 0.0, 2_000_001),
                   -torch.rand(100_000, generator=torch.Generator()
                               .manual_seed(0)) * 126.0,
                   torch.tensor([0.0, -0.5, -0.25, -1.0, -125.5, -126.0])])
    got = kde_cuda.exp2_fma(x).double()
    ref = torch.exp2(x.double())
    assert float(((got - ref).abs() / ref).max()) <= 1e-6
    low = kde_cuda.exp2_fma(torch.tensor([-126.5, -200.0, -3e38, -1.44e30]))
    assert torch.all(torch.isfinite(low)) and torch.all(low >= 0)
    assert torch.all(low <= 2.0 ** -125)


def _fake_nvcc(tmp_path, body):
    exe = tmp_path / "nvcc"
    exe.write_text("#!/bin/sh\n" + body + "\n")
    exe.chmod(0o755)
    return str(exe)


def test_failed_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    from pyabc_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(
        tmp_path, 'echo "kde_logpdf.cu(1): error: boom" >&2; exit 2'))
    with pytest.raises(RuntimeError, match="boom"):
        _build.build_all()
    assert not list((tmp_path / "kernels").iterdir())  # no partial library


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    """One build per source hash: a second call finds the library."""
    from pyabc_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    calls = tmp_path / "calls"
    monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(
        tmp_path, f'echo x >> {calls}; '
                  'while [ $# -gt 0 ]; do [ "$1" = -o ] && out="$2"; '
                  'shift; done; touch "$out"'))
    built = _build.build_all()
    assert set(built) == set(_build.SOURCES)
    assert _build.library_path("kde_logpdf").exists()
    assert _build.build_all() == {}
    assert calls.read_text().count("x") == len(_build.SOURCES)
