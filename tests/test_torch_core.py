"""Parity of the PyTorch filter core (ekf_vio_tpu_torch/core) with the JAX
package on the CPU: lie algebra, state ops, dynamics, predict and the
masked update.  Inputs are made with numpy from a seed and fed to both.

Tolerances: lie, dynamics and predict within 1e-5·max(|x|, 1) (f32
roundoff of the same formulas in another op order); the update within
1e-5 on μ and 1e-4·max|Σ| on Σ (a 2N-wide Cholesky solve in f32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.core import dynamics as jdyn
from ekf_vio_tpu.core import filter as jfilt
from ekf_vio_tpu.core import lie as jlie
from ekf_vio_tpu.core import state as jstate
from ekf_vio_tpu.core import update as jupd
from ekf_vio_tpu_torch import interop
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import dynamics, lie, state, update
from ekf_vio_tpu_torch.core import filter as tfilt

N = 16


def _close(got, ref, rel=1e-5):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


def _quat(rng, n=None):
    q = rng.normal(size=(4,) if n is None else (n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _base(rng):
    mu = rng.normal(scale=0.5, size=22).astype(np.float32)
    mu[3:7] = _quat(rng)
    return mu


def _filter_dict(seed, n=N, active_frac=0.75):
    """A filter state with correlated Σ, a random active set and finite
    means in every slot."""
    rng = np.random.RandomState(seed)
    d = 22 + 3 * n
    a = rng.normal(size=(d, d)).astype(np.float32)
    sigma = (a @ a.T / d + np.diag(rng.uniform(0.1, 2.0, d))).astype(np.float32)
    feat = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.4, 0.4, n),
                     rng.uniform(0.3, 2.5, n)], -1).astype(np.float32)
    return dict(
        base_mu=_base(rng), feat_mu=feat,
        active=rng.uniform(size=n) < active_frac,
        klt_ref=(feat[:, :2] + rng.normal(scale=0.01, size=(n, 2))).astype(
            np.float32),
        Sigma=sigma, t=np.float32(1.25),
        age=rng.randint(0, 9, n).astype(np.int32))


def _jax_state(d):
    return jstate.FilterState(**{k: jnp.asarray(v) for k, v in d.items()})


def _assert_state(got, ref, mu_tol=1e-5, sig_rel=1e-5):
    _close(got.base_mu, ref.base_mu, mu_tol)
    _close(got.feat_mu, ref.feat_mu, mu_tol)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(ref.active))
    _close(got.klt_ref, ref.klt_ref, mu_tol)
    _close(got.Sigma, ref.Sigma, sig_rel)
    np.testing.assert_array_equal(got.age.numpy(), np.asarray(ref.age))


class TestLie:
    def test_quaternion_ops(self):
        rng = np.random.RandomState(0)
        q1, q2 = _quat(rng, 8), _quat(rng, 8)
        v = rng.normal(size=(8, 3)).astype(np.float32)
        t = torch.from_numpy
        _close(lie.quat_mul(t(q1), t(q2)), jlie.quat_mul(q1, q2))
        _close(lie.quat_conj(t(q1)), jlie.quat_conj(q1))
        _close(lie.quat_rotate(t(q1), t(v)), jlie.quat_rotate(q1, v))
        _close(lie.quat_to_matrix(t(q1)), jlie.quat_to_matrix(q1))
        _close(lie.skew(t(v)), jlie.skew(v))
        _close(lie.quat_normalize(t(3 * q1)), jlie.quat_normalize(3 * q1))

    @pytest.mark.parametrize("scale", [0.0, 1e-6, 0.3, 4.0])
    def test_exp_omega_both_branches(self, scale):
        rng = np.random.RandomState(1)
        om = (scale * rng.normal(size=(6, 3))).astype(np.float32)
        _close(lie.quat_exp_omega(torch.from_numpy(om), 0.05),
               jlie.quat_exp_omega(om, 0.05))


class TestState:
    def test_init_state(self):
        cfg = VIOConfig(max_features=N)
        got = state.init_state(cfg, t0=0.5)
        ref = jstate.init_state(JConfig(max_features=N), t0=0.5)
        _assert_state(got, ref)
        assert got.age.dtype == torch.int32 and got.t.dtype == torch.float32

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_plan_insertion(self, seed):
        rng = np.random.RandomState(seed)
        active = rng.uniform(size=N) < 0.6
        valid = rng.uniform(size=N) < 0.5
        take, src = state.plan_insertion(torch.from_numpy(active),
                                         torch.from_numpy(valid))
        jt, js = jstate.plan_insertion(jnp.asarray(active), jnp.asarray(valid))
        np.testing.assert_array_equal(take.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(src.numpy()[take.numpy()],
                                      np.asarray(js)[np.asarray(jt)])

    def test_add_drop_and_check_sigma(self):
        d = _filter_dict(3)
        rng = np.random.RandomState(4)
        uv = rng.uniform(-0.5, 0.5, (N, 2)).astype(np.float32)
        valid = rng.uniform(size=N) < 0.7
        drop = rng.uniform(size=N) < 0.3
        cfg, jcfg = VIOConfig(max_features=N), JConfig(max_features=N)
        got = interop.filter_state_from_numpy(d, "cpu")
        ref = _jax_state(d)
        got = state.add_features(got, cfg, torch.from_numpy(uv),
                                 torch.from_numpy(valid))
        ref = jstate.add_features(ref, jcfg, jnp.asarray(uv),
                                  jnp.asarray(valid))
        _assert_state(got, ref)
        got = state.drop_features(got, torch.from_numpy(drop))
        ref = jstate.drop_features(ref, jnp.asarray(drop))
        _assert_state(got, ref)
        for g, r in zip(state.check_sigma(got), jstate.check_sigma(ref)):
            _close(g, r)


class TestDynamics:
    def _inputs(self):
        rng = np.random.RandomState(5)
        mu = _base(rng)
        feats = np.stack([rng.uniform(-0.5, 0.5, N), rng.uniform(-0.5, 0.5, N),
                          rng.uniform(0.4, 2.0, N)], -1).astype(np.float32)
        return mu, feats, np.float32(0.05)

    def test_transport_and_blocks_match_jax(self):
        mu, feats, dt = self._inputs()
        tmu, tf = torch.from_numpy(mu), torch.from_numpy(feats)
        _close(dynamics.convolve_base_state(tmu, dt),
               jdyn.convolve_base_state(mu, dt))
        _close(dynamics.convolve_features(tmu, tf, dt),
               jdyn.convolve_features(mu, feats, dt))
        _close(dynamics.camera_motion_qt(tmu, dt),
               jdyn.camera_motion_qt(mu, dt))
        for g, r in zip(dynamics.process_jacobian_blocks(tmu, tf, dt),
                        jdyn.process_jacobian_blocks(mu, feats, dt)):
            _close(g, r)

    def test_analytic_blocks_match_jacfwd(self):
        """The closed-form feature blocks against torch.func.jacfwd of the
        per-feature transport (tests/test_dynamics.py does this in JAX)."""
        mu, feats, dt = self._inputs()
        tmu, tf = torch.from_numpy(mu), torch.from_numpy(feats)
        _, Ffb, Ff = dynamics.process_jacobian_blocks(tmu, tf, dt)

        def one(base, f):
            return dynamics.convolve_features(base, f[None], dt)[0]

        for i in range(N):
            Ffb_i = jacfwd(one, argnums=0)(tmu, tf[i])
            Ff_i = jacfwd(one, argnums=1)(tmu, tf[i])
            np.testing.assert_allclose(Ffb[i].numpy(), Ffb_i.numpy(),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(Ff[i].numpy(), Ff_i.numpy(),
                                       rtol=1e-5, atol=1e-5)

    def test_process_noise(self):
        active = np.random.RandomState(6).uniform(size=N) < 0.5
        cfg, jcfg = VIOConfig(max_features=N), JConfig(max_features=N)
        _close(dynamics.process_noise_diag(0.05, N, torch.from_numpy(active),
                                           cfg),
               jdyn.process_noise_diag(0.05, N, jnp.asarray(active), jcfg))


class TestPredict:
    @pytest.mark.parametrize("seed,dt", [(7, 0.05), (8, 0.0), (9, 0.2)])
    def test_predict_matches_jax(self, seed, dt):
        d = _filter_dict(seed)
        cfg, jcfg = VIOConfig(max_features=N), JConfig(max_features=N)
        got = tfilt.predict(interop.filter_state_from_numpy(d, "cpu"), cfg, dt)
        ref = jfilt.predict(_jax_state(d), jcfg, dt)
        _assert_state(got, ref)
        _close(got.t, ref.t)


class TestUpdate:
    def _inputs(self, seed, pass_frac):
        d = _filter_dict(seed)
        rng = np.random.RandomState(seed + 100)
        z = (d["feat_mu"][:, :2]
             + rng.normal(scale=0.02, size=(N, 2))).astype(np.float32)
        R = np.tile(np.diag([1e-4, 2e-4]).astype(np.float32), (N, 1, 1))
        passed = rng.uniform(size=N) < pass_frac
        return d, z, R, passed

    @pytest.mark.parametrize("seed,pass_frac", [(10, 0.8), (11, 1.0),
                                                (12, 0.3)])
    def test_update_matches_jax(self, seed, pass_frac):
        d, z, R, passed = self._inputs(seed, pass_frac)
        cfg, jcfg = VIOConfig(max_features=N), JConfig(max_features=N)
        got = update.update_with_feature_positions(
            interop.filter_state_from_numpy(d, "cpu"), cfg,
            torch.from_numpy(z), torch.from_numpy(R), torch.from_numpy(passed))
        ref = jupd.update_with_feature_positions(
            _jax_state(d), jcfg, jnp.asarray(z), jnp.asarray(R),
            jnp.asarray(passed))
        _assert_state(got, ref, mu_tol=1e-5, sig_rel=1e-4)

    def test_no_measurement_is_a_noop(self):
        d, z, R, _ = self._inputs(13, 0.0)
        passed = np.zeros(N, bool)
        cfg = VIOConfig(max_features=N)
        got = update.update_with_feature_positions(
            interop.filter_state_from_numpy(d, "cpu"), cfg,
            torch.from_numpy(z), torch.from_numpy(R), torch.from_numpy(passed))
        ref = jupd.update_with_feature_positions(
            _jax_state(d), JConfig(max_features=N), jnp.asarray(z),
            jnp.asarray(R), jnp.asarray(passed))
        _assert_state(got, ref, mu_tol=1e-5, sig_rel=1e-4)
        assert torch.isfinite(got.Sigma).all()
        base = d["base_mu"].copy()
        base[3:7] /= np.linalg.norm(base[3:7])
        np.testing.assert_allclose(got.base_mu.numpy(), base, atol=1e-6)
        np.testing.assert_allclose(got.Sigma.numpy(), d["Sigma"], atol=1e-6)

    def test_innovation_statistics(self):
        d, z, R, passed = self._inputs(14, 0.7)
        got_s = interop.filter_state_from_numpy(d, "cpu")
        ref_s = _jax_state(d)
        tz, tR, tp = map(torch.from_numpy, (z, R, passed))
        _close(update.innovation_stats(got_s, tz, tp),
               jupd.innovation_stats(ref_s, z, passed))
        _close(update.innovation_nis_per_feature(got_s, tz, tR),
               jupd.innovation_nis_per_feature(ref_s, z, R), 1e-4)
        _close(update.innovation_nis(got_s, tz, tR, tp),
               jupd.innovation_nis(ref_s, z, R, passed), 1e-4)

    def test_off_slice_options_raise(self):
        """What the port still refuses is what the JAX package refuses:
        ``budget`` with ``square_root_form`` (ValueError in both).  The
        options that used to be off the slice run."""
        d, z, R, passed = self._inputs(15, 0.5)
        s = interop.filter_state_from_numpy(d, "cpu")
        args = (torch.from_numpy(z), torch.from_numpy(R),
                torch.from_numpy(passed))
        sq = dict(max_features=N, square_root_form=True)
        with pytest.raises(ValueError, match="budget"):
            tfilt.update_with_feature_positions(s, VIOConfig(**sq), *args,
                                                budget=4)
        with pytest.raises(ValueError, match="budget"):
            jfilt.update_with_feature_positions(
                _jax_state(d), JConfig(**sq), jnp.asarray(z), jnp.asarray(R),
                jnp.asarray(passed), budget=4)
        for cfg, kw in ((VIOConfig(max_features=N), dict(budget=4)),
                        (VIOConfig(max_features=N, joseph_form="product"),
                         {})):
            out = update.update_with_feature_positions(s, cfg, *args, **kw)
            assert torch.isfinite(out.Sigma).all()
        out = tfilt.predict(s, VIOConfig(**sq), 0.05)
        assert torch.isfinite(out.Sigma).all()
