"""The port's closed-loop simulator (``sim/simulator.py``) and
``rendered.evaluate_ate`` against the JAX package on the CPU.

Bars: the six reference scenarios cut to 20 steps at 32 slots, in the
covariance and the square-root form, fed the JAX package's scene points:
pos_err and feat_err within 1e-4 at every step, and the covariance
form's min diagonal and asymmetry within 1e-4; ``evaluate_ate`` on 22
rendered frames (rounded to camera bytes, with the JAX side given the
FAST margin order the port follows at 320x240, as in
``test_torch_engine.py``) within 1e-3 m of the JAX one, vision-only and
mono-inertial, with equal tracked counts.
"""
import jax
import numpy as np
import pytest
import torch

from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.sim import rendered as jrendered
from ekf_vio_tpu.sim import simulator as jsimulator
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.sim import rendered, simulator
from test_torch_batched import one_torch_thread  # noqa: F401  (fixture)
from test_torch_engine import jax_fast_rule  # noqa: F401  (fixture)

STEPS, SLOTS = 20, 32


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("k", range(6))
def test_scenarios_match_jax(k, sqrt):
    scn = simulator.REFERENCE_SCENARIOS[k]
    assert tuple(scn) == tuple(jsimulator.REFERENCE_SCENARIOS[k])
    kw = dict(max_features=SLOTS, square_root_form=sqrt)
    key = jax.random.PRNGKey(k)
    pts, valid = jsimulator.generate_scene(key, jsimulator.Scenario(*scn),
                                           SLOTS)
    _, _, jtel = jsimulator.run_scenario(key, jsimulator.Scenario(*scn),
                                         JConfig(**kw), STEPS)
    state, gt, tel = simulator.run_scenario(
        scn, VIOConfig(**kw), STEPS, points=np.array(pts), device="cpu")
    assert state.Sigma.shape == (22 + 3 * SLOTS,) * 2  # squared at the end
    for i, name in enumerate(("min_diag", "asym", "pos_err", "feat_err")):
        got, want = tel[i].numpy(), np.asarray(jtel[i])
        assert got.shape == (STEPS,)
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
    assert float(tel[3][-1]) < 1e-3


def test_generated_scene_follows_the_reference_recipe():
    scn = simulator.REFERENCE_SCENARIOS[5]
    pts, valid = simulator.generate_scene(torch.Generator().manual_seed(0),
                                          scn, 128)
    again, _ = simulator.generate_scene(torch.Generator().manual_seed(0),
                                        scn, 128)
    assert torch.equal(pts, again) and int(valid.sum()) == 100
    z = pts[:, 2]
    assert (z - 0.5).abs().max() < 0.1 and z.std() > 1e-3
    assert ((pts[:, :2] / z[:, None]).abs() <= 1.5).all()
    results = simulator.run_reference_scenarios(device="cpu")
    assert len(results) == 6
    for _, _, _, (min_diag, asym, _, feat_err) in results:
        assert float(min_diag.min()) >= -1e-5 and float(asym.max()) < 1e-3
        assert float(feat_err[-1]) < 1e-3


ATE_KW = dict(max_features=32, num_features=25, min_new_feature_dist=10.0,
              fast_threshold=25, triangulate_new_features=True,
              klt_measurement_variance_px=0.001, q_feature=1e-7,
              use_imu=True, vi_init_frames=6)


@pytest.mark.parametrize("use_imu", [True, False])
def test_evaluate_ate_matches_jax(jax_fast_rule, use_imu):
    seq = rendered.generate(num_frames=22)
    seq = seq._replace(frames=np.round(seq.frames))
    jseq = jrendered.generate(num_frames=22)
    jseq = jseq._replace(frames=np.round(jseq.frames))
    ate, outs = rendered.evaluate_ate(seq, VIOConfig(**ATE_KW),
                                      use_imu=use_imu, device="cpu")
    jate, jouts = jrendered.evaluate_ate(jseq, JConfig(**ATE_KW),
                                         use_imu=use_imu)
    np.testing.assert_array_equal(outs.num_tracked.numpy(),
                                  np.asarray(jouts.num_tracked))
    assert abs(ate - jate) < 1e-3
    assert np.isfinite(ate) and ate < 0.05
