"""The two parts of the covariance-form update that the port lacked until
the square-root slice: measured-subset compaction (``budget``) and the
materialized Joseph form (``joseph_form="product"``), against the JAX
package on the CPU.  Inputs are made with numpy from a seed.

Tolerances: the mean within 1e-5 and Σ within 1e-4·max|Σ| (a 2B-wide
Cholesky solve in f32 in another op order), as
tests/test_torch_core.py holds the full update.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.core import state as jstate
from ekf_vio_tpu.core import update as jupd
from ekf_vio_tpu_torch import interop
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import update

N = 16
D = 22 + 3 * N


def _inputs(seed, pass_frac):
    rng = np.random.RandomState(seed)
    a = rng.normal(size=(D, D)).astype(np.float32)
    sigma = (a @ a.T / D + np.diag(rng.uniform(0.1, 2.0, D))).astype(
        np.float32)
    q = rng.normal(size=4)
    base = rng.normal(scale=0.5, size=22)
    base[3:7] = q / np.linalg.norm(q)
    feat = np.stack([rng.uniform(-0.6, 0.6, N), rng.uniform(-0.4, 0.4, N),
                     rng.uniform(0.3, 2.5, N)], -1).astype(np.float32)
    d = dict(base_mu=base.astype(np.float32), feat_mu=feat,
             active=rng.uniform(size=N) < 0.8,
             klt_ref=(feat[:, :2] + rng.normal(scale=0.01, size=(N, 2))
                      ).astype(np.float32),
             Sigma=0.5 * (sigma + sigma.T), t=np.float32(1.25),
             age=rng.randint(0, 9, N).astype(np.int32))
    z = (feat[:, :2] + rng.normal(scale=0.02, size=(N, 2))).astype(np.float32)
    r = rng.uniform(0.5e-4, 2e-4, (N, 2)).astype(np.float32)
    R = np.zeros((N, 2, 2), np.float32)
    R[:, 0, 0], R[:, 1, 1] = r[:, 0], r[:, 1]
    passed = rng.uniform(size=N) < pass_frac
    return d, z, R, passed


def _both(d, z, R, passed, budget=None, **cfg_kw):
    t = torch.from_numpy
    got = update.update_with_feature_positions(
        interop.filter_state_from_numpy(d, "cpu"),
        VIOConfig(max_features=N, **cfg_kw), t(z), t(R), t(passed),
        budget=budget)
    ref = jupd.update_with_feature_positions(
        jstate.FilterState(**{k: jnp.asarray(v) for k, v in d.items()}),
        JConfig(max_features=N, **cfg_kw), jnp.asarray(z), jnp.asarray(R),
        jnp.asarray(passed), budget=budget)
    return got, ref


def _assert_state(got, ref):
    for k in ("base_mu", "feat_mu", "klt_ref"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), atol=1e-5)
    sig = np.asarray(ref.Sigma)
    np.testing.assert_allclose(got.Sigma.numpy(), sig,
                               atol=1e-4 * np.abs(sig).max())
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(ref.active))


@pytest.mark.parametrize("joseph", ["expanded", "product"])
@pytest.mark.parametrize("seed,pass_frac,budget", [
    (0, 0.4, 8),     # the measured count fits the budget
    (1, 1.0, 6),     # over budget: the first 6 measured slots correct
    (2, 0.0, 4),     # nothing measured
    (3, 0.6, N),     # budget = N: the full path
])
def test_budget_compaction_matches_jax(seed, pass_frac, budget, joseph):
    d, z, R, passed = _inputs(seed, pass_frac)
    got, ref = _both(d, z, R, passed, budget=budget, joseph_form=joseph)
    _assert_state(got, ref)
    meas = passed & d["active"]
    # every measured feature refreshes klt_ref, over budget or not
    np.testing.assert_array_equal(got.klt_ref.numpy()[meas], z[meas])
    np.testing.assert_array_equal(got.klt_ref.numpy()[~meas],
                                  d["klt_ref"][~meas])


def test_budget_that_fits_equals_the_full_update():
    d, z, R, passed = _inputs(4, 0.4)
    assert (passed & d["active"]).sum() <= 8
    t = torch.from_numpy
    s = interop.filter_state_from_numpy(d, "cpu")
    cfg = VIOConfig(max_features=N)
    full = update.update_with_feature_positions(s, cfg, t(z), t(R), t(passed))
    part = update.update_with_feature_positions(s, cfg, t(z), t(R), t(passed),
                                                budget=8)
    np.testing.assert_allclose(part.base_mu.numpy(), full.base_mu.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(part.Sigma.numpy(), full.Sigma.numpy(),
                               atol=1e-4 * full.Sigma.abs().max().item())


@pytest.mark.parametrize("seed,pass_frac", [(5, 0.8), (6, 0.3)])
def test_product_joseph_form_matches_jax(seed, pass_frac):
    d, z, R, passed = _inputs(seed, pass_frac)
    got, ref = _both(d, z, R, passed, joseph_form="product")
    _assert_state(got, ref)
    exp, _ = _both(d, z, R, passed, joseph_form="expanded")
    # the two Joseph forms are the same algebra
    np.testing.assert_allclose(got.Sigma.numpy(), exp.Sigma.numpy(),
                               atol=1e-4 * exp.Sigma.abs().max().item())
