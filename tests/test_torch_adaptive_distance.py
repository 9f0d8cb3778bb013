"""The port's AdaptivePNormDistance against the JAX package's.

Both distances go through the same sequence of stats blocks —
``initialize`` on a calibration block, then ``update`` three times on
record blocks (NaN rows included, as record buffers carry them) — as
tests/test_distance.py drives the JAX one.  Checked: ``weights[t]``
(rtol 1e-5), ``compute`` under the JAX package's fitted schedule
installed into the port (rtol 1e-5), ``max_weight_ratio`` and
``normalize_weights``, the JSON weight log, ``update``'s return value
and ``configure_sampler``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.sumstat import SumStatSpec as JaxSpec
from pyabc_tpu_torch.convert import install_weights, to_torch
from pyabc_tpu_torch.sumstat import SumStatSpec

X0 = {"a": np.float32(0.5), "b": np.array([1.0, -2.0, 0.0], np.float32),
      "c": np.float32(3.0)}

CONFIGS = [
    ("median_absolute_deviation", True, None),
    ("standard_deviation", False, None),
    ("mean_absolute_deviation_to_observation", True, 3.0),
    ("combined_median_absolute_deviation", False, 2.0),
    ("span", True, 1.5),
]


def _blocks(seed):
    """Calibration block and three record blocks ``[R, 5]``: columns of
    very different spread, one constant column in the second record
    block (zero scale, zero weight), NaN rows in the record blocks."""
    rng = np.random.default_rng(seed)
    spread = np.array([0.1, 1.0, 10.0, 3.0, 0.01], np.float32)
    blocks = []
    for k, rows in enumerate((400, 1001, 800, 1500)):
        b = (rng.standard_normal((rows, 5)) * spread * (1.0 + 0.5 * k)
             + rng.standard_normal(5)).astype(np.float32)
        if k:
            b[rng.choice(rows, rows // 10, replace=False)] = np.nan
        if k == 2:
            b[:, 3] = 7.0
        blocks.append(b)
    return blocks


def _pair(scale_function, normalize, ratio, log_dir=None):
    kw = dict(p=2, scale_function=scale_function,
              normalize_weights=normalize, max_weight_ratio=ratio)
    j_dist = jpt.AdaptivePNormDistance(
        **kw, log_file=str(log_dir / "jax.json") if log_dir else None)
    dist = pt.AdaptivePNormDistance(
        **kw, log_file=str(log_dir / "port.json") if log_dir else None)
    j_spec = JaxSpec.from_example({k: jnp.asarray(v) for k, v in X0.items()})
    spec = SumStatSpec.from_example(X0)
    j_dist.bind(j_spec, X0)
    dist.bind(spec, X0)
    return j_dist, j_spec, dist, spec


def _drive(j_dist, j_spec, dist, spec, blocks):
    j_dist.initialize(0, lambda: j_spec.unflatten(jnp.asarray(blocks[0])),
                      X0, j_spec)
    dist.initialize(0, lambda: spec.unflatten(torch.as_tensor(blocks[0])),
                    X0, spec)
    for t, b in enumerate(blocks[1:], start=1):
        j_changed = j_dist.update(t, lambda: j_spec.unflatten(
            jnp.asarray(b)))
        changed = dist.update(t, lambda: spec.unflatten(torch.as_tensor(b)))
        assert changed == j_changed


@pytest.mark.parametrize("scale_function,normalize,ratio", CONFIGS)
def test_weights_follow_jax(scale_function, normalize, ratio):
    j_dist, j_spec, dist, spec = _pair(scale_function, normalize, ratio)
    _drive(j_dist, j_spec, dist, spec, _blocks(1))
    assert sorted(dist.weights) == sorted(j_dist.weights) == [0, 1, 2, 3]
    for t in range(4):
        np.testing.assert_allclose(dist.weights[t], j_dist.weights[t],
                                   rtol=1e-5, atol=1e-7)
        w = dist.weights[t]
        if ratio is not None:
            pos = w[w > 0]
            assert pos.max() <= pos.min() * ratio * (1 + 1e-6)
        if normalize:
            assert w.sum() == pytest.approx(w.size, rel=1e-5)
    # the constant column of block 2 gets no weight under a spread scale
    if scale_function in ("median_absolute_deviation", "standard_deviation",
                          "span"):
        assert dist.weights[2][3] == j_dist.weights[2][3] == 0.0


@pytest.mark.parametrize("scale_function,normalize,ratio", CONFIGS[:3])
def test_compute_under_installed_jax_schedule(scale_function, normalize,
                                              ratio):
    j_dist, j_spec, dist, spec = _pair(scale_function, normalize, ratio)
    _drive(j_dist, j_spec, dist, spec, _blocks(2))
    fresh = pt.AdaptivePNormDistance(p=2, scale_function=scale_function)
    fresh.bind(spec, X0)
    install_weights(fresh, j_dist.weights)
    rng = np.random.default_rng(3)
    stats = rng.standard_normal((257, 5)).astype(np.float32)
    obs = np.array(j_spec.flatten_single(X0))
    for t in range(5):   # t = 4 takes the latest entry, 3
        ref = np.asarray(j_dist.compute(jnp.asarray(stats), jnp.asarray(obs),
                                        j_dist.get_params(t)))
        for d in (fresh, dist):
            got = d.compute(torch.as_tensor(stats), torch.as_tensor(obs),
                            to_torch(d.get_params(t), "cpu")).numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_weight_log_matches_jax(tmp_path):
    j_dist, j_spec, dist, spec = _pair("median_absolute_deviation", True,
                                       None, log_dir=tmp_path)
    _drive(j_dist, j_spec, dist, spec, _blocks(4))
    j_log = json.loads((tmp_path / "jax.json").read_text())
    log = pt.storage.load_dict_from_json(str(tmp_path / "port.json"))
    assert sorted(log) == [0, 1, 2, 3]
    for t, w in log.items():
        np.testing.assert_allclose(w, j_log[str(t)], rtol=1e-5, atol=1e-7)


def test_update_return_values_match_jax():
    """Fixed weights never change; an already-fitted t reports a change
    without refitting; an empty record block keeps the weights."""
    blocks = _blocks(5)
    for adaptive in (False, True):
        j_dist, j_spec, dist, spec = _pair("median_absolute_deviation",
                                           True, None)
        j_dist.adaptive = dist.adaptive = adaptive
        _drive(j_dist, j_spec, dist, spec, blocks)
        b = blocks[1]
        assert dist.update(2, lambda: spec.unflatten(
            torch.as_tensor(b))) == j_dist.update(
            2, lambda: j_spec.unflatten(jnp.asarray(b))) == adaptive
        # (the JAX package's flatten cannot take a block of 0 rows)
        assert not dist.update(9, lambda: spec.unflatten(
            torch.zeros(0, 5)))
        assert sorted(dist.weights) == sorted(j_dist.weights)
        assert dist.params_time_invariant() == \
            j_dist.params_time_invariant()


def test_configure_sampler_requests_records():
    sampler = pt.VectorizedSampler(device="cpu")
    assert not sampler.record_rejected
    pt.PNormDistance().configure_sampler(sampler)
    assert not sampler.record_rejected
    pt.AdaptivePNormDistance().configure_sampler(sampler)
    assert sampler.record_rejected
