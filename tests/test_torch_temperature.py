"""The port's temperature schedules against the JAX package's.

- Every scheme on the same host inputs: rtol 1e-9 (float64 numpy and
  scipy on both sides).
- The device acceptance-rate solve against the JAX package's
  ``acceptance_rate_solve_trace`` on the same records: b to 1e-4
  absolute, the two rates to 1e-5, with NaN rows, −inf densities, +inf
  ratios, all-invalid records and the linear kernel scale.
- ``Temperature`` over a 5-generation sequence on host records, both
  aggregations: the same temperatures (rtol 1e-9), the last one 1, the
  clamp after 1, never rising.
- The port's device route through a ``Sample``'s records agrees with its
  host route (the record columns and scipy) to the solve's precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.epsilon import temperature as jtemp
from pyabc_tpu_torch.epsilon import temperature as ptemp
from pyabc_tpu_torch.sampler.base import Sample

RTOL = 1e-9
SCHEMES = ["AcceptanceRateScheme", "ExpDecayFixedIterScheme",
           "ExpDecayFixedRatioScheme", "PolynomialDecayFixedIterScheme",
           "DalyScheme", "FrielPettittScheme", "EssScheme"]


def _records(seed, n=3000, lin=False, list_form=False):
    rng = np.random.default_rng(seed)
    logd = rng.normal(-20.0, 15.0, n)
    pd_prev = rng.uniform(0.1, 2.0, n)
    pd = rng.uniform(0.1, 2.0, n)
    pd_prev[:5] = 0.0
    dist = np.exp(logd) if lin else logd
    cols = {"distance": dist, "transition_pd_prev": pd_prev,
            "transition_pd": pd, "accepted": rng.uniform(size=n) < 0.3}
    if list_form:
        return [{k: v[i] for k, v in cols.items()} for i in range(n)]
    return cols


def _weighted(seed, n=400):
    rng = np.random.default_rng(seed)
    return rng.normal(-15.0, 6.0, n), rng.dirichlet(np.ones(n))


@pytest.mark.parametrize("name", SCHEMES)
def test_scheme_matches_jax(name):
    j_scheme, scheme = getattr(jtemp, name)(), getattr(ptemp, name)()
    for t, (prev, rate) in enumerate([(None, 1.0), (300.0, 0.4),
                                      (40.0, 5e-5), (6.0, 0.7),
                                      (1.5, 0.2)]):
        for lin in (False, True):
            recs = _records(t, lin=lin)
            d, w = _weighted(t)
            if lin:
                d = np.exp(d)
            kw = dict(t=t, get_weighted_distances=lambda: (d, w),
                      get_all_records=lambda: recs, max_nr_populations=5,
                      pdf_norm=-2.0,
                      kernel_scale="SCALE_LIN" if lin else "SCALE_LOG",
                      prev_temperature=prev, acceptance_rate=rate)
            try:
                ref = j_scheme(**kw)
            except ValueError:
                # no root in the bracket: both raise (Temperature logs it
                # and drops the proposal)
                with pytest.raises(ValueError):
                    scheme(**kw)
                continue
            got = scheme(**kw)
            if ref is None:
                assert got is None
            else:
                np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_acceptance_rate_scheme_min_rate_and_formats():
    for min_rate, rate in ((0.1, 0.05), (0.1, 0.5)):
        kw = dict(t=2, get_all_records=lambda: _records(4), pdf_norm=0.0,
                  acceptance_rate=rate)
        assert ptemp.AcceptanceRateScheme(min_rate=min_rate)(**kw) == \
            jtemp.AcceptanceRateScheme(min_rate=min_rate)(**kw)
    for lin in (False, True):
        for list_form in (False, True):
            recs = _records(9, n=200, lin=lin, list_form=list_form)
            scale = "SCALE_LIN" if lin else "SCALE_LOG"
            got = ptemp._records_to_arrays(lambda: recs, scale)
            ref = jtemp._records_to_arrays(lambda: recs, scale)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- device


def _solve_case(name, seed=0, n=5000):
    rng = np.random.default_rng(seed)
    ld = rng.normal(-30.0, 20.0, n).astype(np.float32)
    lr = rng.normal(0.0, 1.5, n).astype(np.float32)
    lin = False
    if name == "nan_rows":
        ld[rng.choice(n, n // 5, replace=False)] = np.nan
        lr[rng.choice(n, n // 7, replace=False)] = np.nan
    elif name == "neg_inf_densities":
        ld[: n // 3] = -np.inf
    elif name == "pos_inf_ratios":
        lr[: n // 4] = np.inf
    elif name == "all_invalid":
        ld[:] = np.nan
    elif name == "all_zero_ratios":
        lr[:] = -np.inf
    elif name == "lin_scale":
        ld = np.exp(ld / 4.0).astype(np.float32)
        ld[:20] = 0.0
        lin = True
    elif name == "easy":
        ld = rng.normal(-0.1, 0.05, n).astype(np.float32)
    return ld, lr, lin


SOLVE_CASES = ["plain", "nan_rows", "neg_inf_densities", "pos_inf_ratios",
               "all_invalid", "all_zero_ratios", "lin_scale", "easy"]


@pytest.mark.parametrize("case", SOLVE_CASES)
def test_device_solve_matches_jax(case):
    ld, lr, lin = _solve_case(case)
    for pdf_norm, target in ((0.0, 0.3), (-5.0, 0.05)):
        ref = jax.jit(lambda a, b, c, d: jtemp.acceptance_rate_solve_trace(
            a, b, c, d, lin))(jnp.asarray(ld), jnp.asarray(lr),
                              jnp.float32(pdf_norm), jnp.float32(target))
        got = ptemp.acceptance_rate_solve(torch.as_tensor(ld),
                                          torch.as_tensor(lr), pdf_norm,
                                          target, lin)
        b, r0, rmin = (float(v) for v in got)
        jb, jr0, jrmin = (float(v) for v in ref)
        assert abs(b - jb) <= 1e-4, (case, b, jb)
        assert abs(r0 - jr0) <= 1e-5 and abs(rmin - jrmin) <= 1e-5
        if case == "all_invalid":
            assert r0 == 0.0 and rmin == 0.0


# ---------------------------------------------------------------- Temperature


GENS = 5


def _temperature_run(pkg, aggregate, schemes):
    schemes, kwargs = schemes(pkg)
    temp = pkg.Temperature(schemes=schemes, aggregate_fun=aggregate,
                           **kwargs)
    acc_rates = [1.0, 0.35, 0.25, 0.3, 0.2]
    for t in range(GENS):
        recs = _records(20 + t)
        d, w = _weighted(20 + t)
        kw = dict(get_weighted_distances=lambda d=d, w=w: (d, w),
                  get_all_records=lambda recs=recs: recs,
                  acceptor_config={"pdf_norm": -3.0,
                                   "kernel_scale": "SCALE_LOG"})
        if t == 0:
            temp.initialize(0, max_nr_populations=GENS, **kw)
        else:
            temp.update(t, acceptance_rate=acc_rates[t], **kw)
    return temp


@pytest.mark.parametrize("aggregate", [min, max])
@pytest.mark.parametrize("schemes", [
    lambda pkg: (None, {}),
    lambda pkg: ([pkg.AcceptanceRateScheme(target_rate=0.6),
                  pkg.ExpDecayFixedRatioScheme(alpha=0.05)], {}),
    lambda pkg: ([pkg.DalyScheme(), pkg.EssScheme(),
                  pkg.PolynomialDecayFixedIterScheme()],
                 {"initial_temperature": 50.0}),
], ids=["default", "fast", "feedback"])
def test_temperature_sequence_matches_jax(aggregate, schemes):
    ref = _temperature_run(jpt, aggregate, schemes)
    got = _temperature_run(pt, aggregate, schemes)
    assert sorted(got.temperatures) == list(range(GENS))
    for t in range(GENS):
        np.testing.assert_allclose(got(t), ref(t), rtol=RTOL)
    assert got.temperature_proposals.keys() == ref.temperature_proposals.keys()
    temps = [got(t) for t in range(GENS)]
    assert temps[-1] == 1.0
    assert got.temperature_proposals[GENS - 1] == {"final": 1.0}
    assert all(a >= b for a, b in zip(temps, temps[1:]))
    assert all(1.0 <= v < np.inf for v in temps)
    first = temps.index(1.0)
    for t in range(first + 1, GENS - 1):
        assert got.temperature_proposals[t] == {"clamped": 1.0}


def test_the_fast_schedule_reaches_the_clamp():
    temp = _temperature_run(pt, min, lambda pkg: (
        [pkg.AcceptanceRateScheme(target_rate=0.6),
         pkg.ExpDecayFixedRatioScheme(alpha=0.05)], {}))
    assert temp.temperature_proposals[3] == {"clamped": 1.0}


def test_installed_temperatures_are_kept():
    temp = pt.Temperature()
    pt.convert.install_annealing(temp, pt.StochasticAcceptor(),
                                 {0: 50.0, 1: 9.0}, {})
    temp.initialize(0, get_all_records=lambda: _records(1),
                    max_nr_populations=5)
    temp.update(1, get_all_records=lambda: _records(2))
    assert temp.temperatures == {0: 50.0, 1: 9.0}


def test_device_route_through_sample_records():
    """A Sample holding device records: ``Temperature`` takes the device
    solve through ``get_records_device``, and the value agrees with the
    host route over ``get_records_columns`` (scipy, float64)."""
    rng = np.random.default_rng(2)
    n = 4000
    theta = rng.normal(0.0, 1.0, (n, 1)).astype(np.float32)
    sample = Sample(record_rejected=True)
    sample.append_record_batch({
        "rec_stats": torch.zeros(n, 1),
        "rec_distance": torch.as_tensor(
            rng.normal(-40.0, 25.0, n).astype(np.float32)),
        "rec_accepted": torch.ones(n, dtype=torch.bool),
        "rec_m": torch.zeros(n, dtype=torch.int64),
        "rec_theta": torch.as_tensor(theta),
        "rec_log_proposal": torch.as_tensor(
            (-0.5 * theta[:, 0] ** 2).astype(np.float32)),
        "rec_count": n})

    def new_density(m, th):
        return -0.5 * (th[:, 0] - 0.3) ** 2 / 1.2

    sample.transition_log_pdf_device = lambda m, th: new_density(m, th)
    sample.transition_log_pdf = lambda m, th: new_density(
        torch.as_tensor(m), torch.as_tensor(th)).numpy()
    dev = sample.get_records_device()
    assert dev is not None and set(dev) == {"log_dens", "log_ratio"}
    scheme = pt.AcceptanceRateScheme()
    kw = dict(t=1, pdf_norm=0.0, kernel_scale="SCALE_LOG")
    on_device = scheme(get_all_records=sample.get_records_columns,
                       get_device_records=sample.get_records_device, **kw)
    on_host = scheme(get_all_records=sample.get_records_columns, **kw)
    jax_host = jpt.AcceptanceRateScheme()(
        get_all_records=sample.get_records_columns, **kw)
    assert on_host == pytest.approx(jax_host, rel=RTOL)
    assert np.log(on_device) == pytest.approx(np.log(on_host), abs=1e-4)

    temp = pt.Temperature(schemes=[pt.AcceptanceRateScheme()])
    temp.temperatures[0] = 1e6
    temp._max_nr_populations = 10
    temp.update(1, get_all_records=sample.get_records_columns)
    assert temp(1) == on_device
