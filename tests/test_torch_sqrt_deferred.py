"""The factor-form step's deferred triangularization, exact on the CPU.

``engine.step`` in the factor form (``sqrt_filter.FactorForm``) carries a
non-square factor F of Σ (Σ = F Fᵀ) from the IMU propagation (or the
predict) to the end of ``vio.replenish`` and runs two QRs, the update
array and the close (``core/sqrt_filter.py``).  Here each step is held
against the same step in a composed factor form, whose operations are the
public square-in, square-out functions, which make L square after every
change: five QRs a mono-inertial step (IMU, depth re-prime, update array,
posterior, slot add), four a vision-only one.

The inputs are the ``euroc_mono_inertial_sqrt`` cell's at a CPU size (the
camera halved, 128 slots, D = 406, a rendered session from the traffic
generator, VI init over 10 frames and one step).  A float32 step records
what the front end decided (tracks, gates, the measurement covariance,
FAST candidates, two-view depths); both forms then run the filter on it
in float64, so they differ by float64 rounding only: Σ = L Lᵀ within
1e-12 of the composed one, each entry scaled by √(Σᵢᵢ Σⱼⱼ), and the means
within 1e-12.  The deferred L is square lower-triangular, its zero rows
exactly the composed L's and every free slot's.

Cases: a frame that re-primes depths and fills slots; an update skipped
for a non-finite gain; a tracking-lost reset of the carried factor; a
frame with no re-prime and no fill; a reset and a fill of exactly as many
slots as the compacted prior has room for; a vision-only step.

The composed step shares each ``*_array`` function with the deferred
one, so each is also held on its own against the covariance form's
operation on F Fᵀ, in float64 with every noise term large enough to show,
along one chain of non-square factors: predict or IMU propagation, the
ρ re-prime, the update, drops, and a slot add at its compaction's limit.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ekf_vio_tpu_torch import engine
from ekf_vio_tpu_torch.config import BASE_STATE_SIZE, VIOConfig
from ekf_vio_tpu_torch.core import filter as ekf
from ekf_vio_tpu_torch.core import imu as imu_mod
from ekf_vio_tpu_torch.core import sqrt_filter
from ekf_vio_tpu_torch.core import state as state_mod
from ekf_vio_tpu_torch.core import update as update_mod
from ekf_vio_tpu_torch.frontend.camera import Camera
from portbench.traffic.generate import make_session

ROOT = Path(__file__).resolve().parent.parent / "portbench"
SEED = 2 ** 31 + 4242
K0 = 10
FRAME = K0 + 1  # the frame the cases step: young tracks whose depth re-primes
TOL = 1e-12
FULL = 20     # num_features of the case that fills every compacted column


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cell():
    """The cell's configuration, a session at the CPU size and the state
    after the VI initialization."""
    cfg = json.loads((ROOT / "configs" / "euroc_mono_inertial_sqrt.json")
                     .read_text())
    tf = json.loads((ROOT / "traffic" / "euroc_replay_sqrt.json").read_text())
    c = cfg["camera"]
    for k in ("width", "height"):
        c[k] //= 2
    for k in ("fx", "fy", "cx", "cy"):
        c[k] /= 2.0
    tf["scene"].update(texture_px=768, texture_px_per_m=160.0)
    d = make_session(cfg, tf, SEED, FRAME + 1, "cpu")
    vcfg = VIOConfig(**cfg["vio"])
    cam = Camera(c["fx"], c["fy"], c["cx"], c["cy"], c["width"],
                 c["height"])
    es = engine.initialize_imu(d["frames"][:K0], d["times"][:K0],
                               d["imu_dt"][:K0 - 1], d["imu_gyro"][:K0 - 1],
                               d["imu_accel"][:K0 - 1], d["gravity_w"], vcfg,
                               cam, K0, device="cpu")
    for f in range(K0, FRAME):
        es, _ = engine.step(es, d["frames"][f], d["times"][f], vcfg, cam,
                            imu_batch=imu_mod.ImuSample(*_imu(d, f)),
                            gravity_w=d["gravity_w"])
    return {"seq": d, "cfg": vcfg, "cam": cam, "es": es}


def _imu(d, f):
    return d["imu_dt"][f - 1], d["imu_gyro"][f - 1], d["imu_accel"][f - 1]


def _f64(x):
    return x.double() if torch.is_tensor(x) and x.is_floating_point() else x


def _f64_state(es):
    f = es.filt
    f = f.replace(**{k: getattr(f, k).double()
                     for k in ("base_mu", "feat_mu", "klt_ref", "Sigma", "t")})
    return dataclasses.replace(es, filt=f, lin_base=es.lin_base.double())


# the front end of a step, whose results both forms are handed (with the
# form's measurement covariance)
FRONT = ("_track_and_gate", "_replenish_candidates", "_two_view_depths")


class Composed(sqrt_filter.FactorForm):
    """The factor form with each carried-factor operation replaced by its
    public square-out counterpart."""

    predict = staticmethod(sqrt_filter.predict_sqrt_factor)
    propagate_imu = staticmethod(sqrt_filter.propagate_imu_factor)

    def reprime_depths(self, filt, boot, sig_tri):
        n, dtype = filt.n_max, filt.Sigma.dtype
        return filt.replace(Sigma=sqrt_filter.wipe_rows_factor(
            filt.Sigma, state_mod.rho_vec(boot.to(dtype), n),
            state_mod.rho_vec((sig_tri * sig_tri).to(dtype), n)))

    def update(self, filt, cfg, measured_uv, meas_cov, passed):
        nis = update_mod.innovation_nis(filt, measured_uv, meas_cov, passed,
                                        factor=True)
        return sqrt_filter.update_sqrt_factor(filt, cfg, measured_uv,
                                              meas_cov, passed), nis

    def add(self, filt, cfg, new_uv, valid, depths, depth_vars):
        return sqrt_filter.add_features_factor(
            filt, cfg, new_uv, valid, depths=depths, depth_vars=depth_vars)


CASES = {
    "reprime_and_fill": dict(),
    "skipped": dict(nan_cov=True),
    "lost": dict(cfg=dict(minimum_trackable_features=10 ** 6)),
    "quiet": dict(cfg=dict(bootstrap_max_age=-1), no_candidates=True),
    "full": dict(cfg=dict(minimum_trackable_features=10 ** 6,
                          num_features=FULL)),
    "vision": dict(vision=True),
}


def _run_case(cell, case, monkeypatch):
    """The f32 step that records the front end, then the deferred and the
    composed step in float64 on its results.  Returns, for each form, the
    state, the outputs, the QR roles in order and what the step saw."""
    spec = CASES[case]
    d, cam = cell["seq"], cell["cam"]
    cfg = cell["cfg"].replace(**spec.get("cfg", {}))
    es = cell["es"]
    img, t = d["frames"][FRAME], d["times"][FRAME]
    batch = (None if spec.get("vision") else
             imu_mod.ImuSample(*_imu(d, FRAME)))

    front = {name: getattr(engine, name) for name in FRONT}
    seen = {}

    def recording(name):
        def call(*a, **kw):
            out = front[name](*a, **kw)
            if name == "_replenish_candidates" and spec.get("no_candidates"):
                out = (out[0], torch.zeros_like(out[1]), out[2])
            seen[name] = out
            return out
        return call

    def meas_cov(*a):
        out = sqrt_filter.FACTOR.measurement_covariance(*a)
        if spec.get("nan_cov"):
            out = out.clone()
            meas = seen["_track_and_gate"][3] & es.filt.active
            out[int(torch.nonzero(meas)[0, 0])] = torch.nan
        seen["meas_cov"] = out
        return out

    form = sqrt_filter.FactorForm()
    form.measurement_covariance = meas_cov
    with monkeypatch.context() as m:
        for name in FRONT:
            m.setattr(engine, name, recording(name))
        engine.step(es, img, t, cfg, cam, imu_batch=batch,
                    gravity_w=d["gravity_w"], form=form)
    recorded = {name: tuple(map(_f64, v)) if isinstance(v, tuple)
                else _f64(v) for name, v in seen.items()}
    # the tracker takes float32 points: the track result and the points
    # handed to it stay as they were
    recorded["_track_and_gate"] = (seen["_track_and_gate"][:3]
                                   + recorded["_track_and_gate"][3:])
    if "_replenish_candidates" in seen:
        recorded["_replenish_candidates"] = (
            seen["_replenish_candidates"][:2]
            + recorded["_replenish_candidates"][2:])

    b64 = None if batch is None else imu_mod.ImuSample(*map(_f64, batch))
    runs = {}
    for name, form in (("deferred", sqrt_filter.FactorForm()),
                       ("composed", Composed())):
        form.measurement_covariance = lambda *a, v=recorded["meas_cov"]: v
        roles, boots, oks = [], [], []
        qr = sqrt_filter._qr_r
        pick = engine._depth_boot_select
        update = sqrt_filter.update_sqrt_array

        def qr_r(pre_T, role, qr=qr):
            roles.append(role)
            return qr(pre_T, role)

        def boot_select(*a, pick=pick):
            out = pick(*a)
            boots.append(bool(out[0].any()))
            return out

        def update_array(*a, update=update):
            out = update(*a)
            oks.append(out[1])
            return out

        with monkeypatch.context() as m:
            for f in FRONT:
                m.setattr(engine, f, lambda *a, v=recorded.get(f), **kw: v)
            m.setattr(sqrt_filter, "_qr_r", qr_r)
            m.setattr(sqrt_filter, "update_sqrt_array", update_array)
            m.setattr(engine, "_depth_boot_select", boot_select)
            es1, out = engine.step(_f64_state(es), img, t, cfg, cam,
                                   imu_batch=b64,
                                   gravity_w=_f64(d["gravity_w"]), form=form)
        runs[name] = dict(es=es1, out=out, roles=roles, boot=any(boots),
                          ok=oks[0])
    return runs, cfg


def _scaled_gap(S, S_ref):
    s = torch.sqrt(torch.diagonal(S_ref))
    live = s > 0
    gap = (S - S_ref).abs()[live][:, live] / (s[live][:, None]
                                              * s[live][None, :])
    dead = (S - S_ref).abs()[~live]
    return float(torch.cat([gap.reshape(-1), dead.reshape(-1)]).max())


@pytest.mark.parametrize("case", list(CASES))
def test_the_deferred_step_equals_the_composed_step(cell, case,
                                                    monkeypatch):
    runs, cfg = _run_case(cell, case, monkeypatch)
    dfr, cmp = runs["deferred"], runs["composed"]
    vision = case == "vision"

    # the QRs each form runs
    assert dfr["roles"] == ["update", "close"]
    assert cmp["roles"] == (["predict", "update", "posterior", "wipe"]
                            if vision else
                            ["imu", "wipe", "update", "posterior", "wipe"])

    # what each case is for
    out, f = dfr["out"], dfr["es"].filt
    assert bool(dfr["ok"]) == (case != "skipped")
    if not vision:
        assert dfr["boot"] == cmp["boot"] == (case not in ("quiet",))
    assert bool(out.tracking_lost) == (case in ("lost", "full"))
    added = int(out.num_active) - int(out.num_tracked)
    if case in ("lost", "full"):
        added = int(out.num_active)
    if case == "quiet":
        assert added == 0
    else:
        assert added > 0
    if case == "full":
        assert int(out.num_active) == cfg.num_features == FULL

    # Σ = L Lᵀ and the means agree at float64 rounding
    L, Lc = f.Sigma, cmp["es"].filt.Sigma
    assert L.dtype == torch.float64 and L.shape == Lc.shape == (
        f.state_dim, f.state_dim)
    assert _scaled_gap(L @ L.T, Lc @ Lc.T) <= TOL
    for k in ("base_mu", "feat_mu"):
        a, b = getattr(f, k), getattr(cmp["es"].filt, k)
        assert float((a - b).abs().max()) <= TOL * (1 + float(b.abs().max()))
    assert torch.equal(f.active, cmp["es"].filt.active)
    assert torch.equal(f.age, cmp["es"].filt.age)
    for k in ("num_tracked", "num_active", "tracking_lost"):
        assert torch.equal(getattr(out, k), getattr(cmp["out"], k)), k

    # the state at the step's boundary: square lower-triangular, zero
    # rows exactly the composed factor's and every free slot's
    assert torch.equal(L, torch.tril(L))
    zero = (L == 0).all(1)
    assert torch.equal(zero, (Lc == 0).all(1))
    assert bool(zero[22:].reshape(-1, 3).all(1)[~f.active].all())
    assert not bool(zero[22:].reshape(-1, 3).any(1)[f.active].any())


# --------------------------------------------------------------------------
# Each carried array against the covariance form
# --------------------------------------------------------------------------

N = 16


def _random_factor_state(seed):
    """A float64 factor state as the engine keeps it: a correlated Σ over
    ~2 decades, zero rows at the pose gauge and every free slot."""
    rng = np.random.RandomState(seed)
    d = BASE_STATE_SIZE + 3 * N
    a = rng.normal(size=(d, d))
    scale = 10.0 ** rng.uniform(-2.0, 0.0, d)
    sigma = (a @ a.T / d + np.eye(d)) * scale[:, None] * scale[None, :]
    active = rng.uniform(size=N) < 0.75
    live = np.concatenate([np.zeros(7), np.ones(15), np.repeat(active, 3)])
    sigma = sigma * live[:, None] * live[None, :]
    q = rng.normal(size=4)
    base = rng.normal(scale=0.3, size=22)
    base[3:7] = q / np.linalg.norm(q)
    feat = np.stack([rng.uniform(-0.6, 0.6, N), rng.uniform(-0.4, 0.4, N),
                     rng.uniform(0.3, 2.5, N)], -1)
    t = torch.from_numpy
    dense = state_mod.FilterState(
        base_mu=t(base), feat_mu=t(feat), active=t(active),
        klt_ref=t(feat[:, :2] + 0.01), Sigma=t(0.5 * (sigma + sigma.T)),
        t=torch.tensor(1.25, dtype=torch.float64),
        age=t(rng.randint(0, 9, N).astype(np.int32)))
    return sqrt_filter.to_factor(dense), rng


def _dense(f):
    return f.replace(Sigma=f.Sigma @ f.Sigma.T)


def _chain(first):
    """{stage: (the carried state after it, the covariance form's state
    from the carried one before it)} along the chain."""
    cfg = VIOConfig(max_features=N, use_imu=True, q_feature=1e-2,
                    sigma_jitter_rel=0.0)
    f, rng = _random_factor_state(5)
    t = torch.from_numpy
    out = {}

    def stage(name, new, want):
        out[name] = (new, want)
        return new

    if first == "predict":
        f = stage("predict", sqrt_filter.predict_sqrt_array(f, cfg, 0.05),
                  ekf.predict(_dense(f), cfg, 0.05))
    else:
        k = 10
        batch = imu_mod.ImuSample(
            t(np.full(k, 0.005)), t(rng.normal(scale=0.3, size=(k, 3))),
            t(rng.normal(scale=0.5, size=(k, 3)) + [0.0, 9.81, 0.0]))
        g = t(np.array([0.0, -9.81, 0.0]))
        f = stage("imu", sqrt_filter.propagate_imu_array(f, cfg, batch,
                                                         g)[0],
                  imu_mod.propagate_imu_batch_with_motion(_dense(f), cfg,
                                                          batch, g)[0])

    boot = f.active & (torch.arange(N) % 2 == 0)
    wipe = state_mod.rho_vec(boot.double(), N)
    var = state_mod.rho_vec(t(rng.uniform(0.01, 0.1, N)), N)
    rows = BASE_STATE_SIZE + 2 + 3 * torch.arange(N)
    dense = _dense(f)
    keep = 1.0 - wipe
    f = stage("reprime",
              f.replace(Sigma=sqrt_filter.wipe_rows_array(f.Sigma, wipe, var,
                                                          rows=rows)),
              dense.replace(Sigma=dense.Sigma * keep[:, None] * keep[None, :]
                            + torch.diag(wipe * var)))

    z = f.feat_mu[:, :2] + t(rng.normal(scale=3e-3, size=(N, 2)))
    r = rng.uniform(0.5e-5, 2e-5, (N, 2))
    cov = np.zeros((N, 2, 2))
    cov[:, 0, 0], cov[:, 1, 1] = r[:, 0], r[:, 1]
    passed = torch.arange(N) % 3 != 0
    f = stage("update",
              sqrt_filter.update_sqrt_array(f, cfg, z, t(cov), passed)[0],
              update_mod.update_with_feature_positions(_dense(f), cfg, z,
                                                       t(cov), passed))

    drop = ~passed
    f = stage("drop", sqrt_filter.drop_features_factor(f, drop),
              state_mod.drop_features(_dense(f), drop))

    # as many candidates as the compacted prior has room for, each
    # finding a free slot
    k = int((~f.active).sum())
    valid = torch.arange(N) < k
    uv = t(rng.uniform(-0.5, 0.5, (N, 2)))
    depths, dvars = t(rng.uniform(1.0, 4.0, N)), t(rng.uniform(1e-3, 0.1, N))
    stage("add",
          sqrt_filter.add_features_array(f, cfg, uv, valid, depths=depths,
                                         depth_vars=dvars, slots=k),
          state_mod.add_features(_dense(f), cfg, uv, valid, depths=depths,
                                 depth_vars=dvars))
    return out


STAGES = [("predict", "predict")] + [
    ("imu", s) for s in ("imu", "reprime", "update", "drop", "add")]


@pytest.mark.parametrize("first,stage", STAGES)
def test_each_array_is_a_factor_of_the_covariance_forms_result(first,
                                                               stage):
    chain = _chain(first)
    got, want = chain[stage]
    S = want.Sigma
    assert float((got.Sigma @ got.Sigma.T - S).abs().max()) <= \
        TOL * float(S.abs().max())
    for k in ("base_mu", "feat_mu", "klt_ref"):
        assert float((getattr(got, k) - getattr(want, k)).abs().max()) <= TOL
    for k in ("active", "age"):
        assert torch.equal(getattr(got, k), getattr(want, k))
    if stage == "add":   # the compaction's limit: every column filled
        before = chain["drop"][0]
        k = int((~before.active).sum())
        assert k > 0 and bool(got.active.all())
        assert got.Sigma.shape[1] == before.Sigma.shape[1] + 3 * k
        assert bool((got.Sigma[:, -3 * k:] != 0).any(0).all())
