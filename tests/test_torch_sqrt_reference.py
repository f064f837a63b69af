"""The square-root-form deployment of the benchmark on the CPU: the plain
factor-form reference (``portbench/reference/vio_sqrt.py``) against the
port's factor-form engine and against the frozen covariance reference
(``portbench/reference/vio.py``), and the QR roofline's count
(``portbench/roofline/tria.py``).

The inputs are the cell's own at a CPU size: ``euroc_mono_inertial_sqrt``
with the camera halved (188 × 120), 128 slots (D = 406), a rendered
session from the traffic generator with a small texture, VI init over 10
frames.  Every gap is the benchmark's (``reference/compare.py``) on
Σ = L Lᵀ of both sides: ``sigma_gap`` scales each entry of Σ by the
reference's standard deviations, each variance floored at its float32
resolution after the update (√D·ε₃₂ × the variance it started from);
``mean_gap`` is the state's difference in the reference's standard
deviations.  A different discrete outcome (live slots, ages, counts)
reads 1e9 and fails every bar.
"""
import json
from pathlib import Path

import pytest
import torch

from ekf_vio_tpu_torch import engine
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import imu as imu_mod
from ekf_vio_tpu_torch.frontend.camera import Camera
from portbench.reference import compare, vio, vio_sqrt
from portbench.roofline import tria
from portbench.traffic.generate import make_session

ROOT = Path(__file__).resolve().parent.parent / "portbench"
SEED = 2 ** 31 + 4242
K0 = 10
FRAMES = 10   # filtered frames after the VI initialization


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cell():
    """The cell's configuration and a session at the CPU size."""
    cfg = json.loads((ROOT / "configs" / "euroc_mono_inertial_sqrt.json")
                     .read_text())
    tf = json.loads((ROOT / "traffic" / "euroc_replay_sqrt.json").read_text())
    c = cfg["camera"]
    for k in ("width", "height"):
        c[k] //= 2
    for k in ("fx", "fy", "cx", "cy"):
        c[k] /= 2.0
    tf["scene"].update(texture_px=768, texture_px_per_m=160.0)
    d = make_session(cfg, tf, SEED, K0 + FRAMES, "cpu")
    return {"cfg": cfg, "seq": d,
            "cam": Camera(c["fx"], c["fy"], c["cx"], c["cy"], c["width"],
                          c["height"]),
            "rcam": {k: c[k] for k in ("fx", "fy", "cx", "cy", "width",
                                       "height")}}


def _imu(d, f):
    return d["imu_dt"][f - 1], d["imu_gyro"][f - 1], d["imu_accel"][f - 1]


def _init(mod, d, cfg, cam):
    return mod.initialize_imu(d["frames"][:K0], d["times"][:K0],
                              d["imu_dt"][:K0 - 1], d["imu_gyro"][:K0 - 1],
                              d["imu_accel"][:K0 - 1], d["gravity_w"], cfg,
                              cam, K0)


def _ref_step(mod, s, d, f, cfg, cam):
    return mod.step(s, d["frames"][f], d["times"][f], cfg, cam,
                    imu=_imu(d, f), gravity_w=d["gravity_w"])


def _program(es):
    return vio_sqrt.squared(vio_sqrt.from_program(es))


# The port against the factor-form reference.  Both run the front end
# bitwise alike (the kernels' plain versions against the same plain
# LK and FAST); the arithmetic of Σ differs by rounding only: the IMU
# noise factor (29 columns of a Cholesky of the compounded noise against
# 12 a sample carried by the chain), the gain's route (G S^c⁻¹ against a
# Cholesky solve) and the QRs of different pre-arrays.  Measured on these
# inputs: at most 4.4e-3 (Σ, the features' variances at their float32
# floor) and 1.5e-3 σ (means); the bars leave about 4x.
STEP_SIGMA, STEP_MEAN = 2e-2, 1e-2


def test_the_programs_factor_step_matches_the_reference(cell):
    """Each frame, the reference takes the program's state (its L) and
    makes one step: the states after it, as Σ = L Lᵀ and means, and the
    outputs agree."""
    d, cfg = cell["seq"], cell["cfg"]
    vcfg, rcfg = VIOConfig(**cfg["vio"]), vio_sqrt.make_cfg(cfg["vio"])
    es = engine.initialize_imu(d["frames"][:K0], d["times"][:K0],
                               d["imu_dt"][:K0 - 1], d["imu_gyro"][:K0 - 1],
                               d["imu_accel"][:K0 - 1], d["gravity_w"], vcfg,
                               cell["cam"], K0, device="cpu")
    for f in range(K0, K0 + FRAMES):
        s = vio_sqrt.from_program(es)
        es, out = engine.step(es, d["frames"][f], d["times"][f], vcfg,
                              cell["cam"],
                              imu_batch=imu_mod.ImuSample(*_imu(d, f)),
                              gravity_w=d["gravity_w"])
        s, r_out = _ref_step(vio_sqrt, s, d, f, rcfg, cell["rcam"])
        out = out._asdict()
        g = compare.state_gaps(_program(es), out, vio_sqrt.squared(s), r_out)
        o = compare.output_gaps(out, r_out)
        assert g["sigma_gap"] <= STEP_SIGMA and o["sigma_gap"] <= STEP_SIGMA, (f, g, o)
        assert g["mean_gap"] <= STEP_MEAN and o["mean_gap"] <= STEP_MEAN, (f, g, o)


def test_the_programs_factor_rollout_matches_the_reference(cell):
    """``engine.run_sequence_imu`` in factor form (VI init inside, then the
    ``scan`` loop) against the reference from its own VI initialization
    over the same frames: every frame's outputs and the final state."""
    d, cfg = cell["seq"], cell["cfg"]
    vcfg, rcfg = VIOConfig(**cfg["vio"]), vio_sqrt.make_cfg(cfg["vio"])
    es, outs = engine.run_sequence_imu(
        d["frames"], d["times"], d["imu_dt"], d["imu_gyro"], d["imu_accel"],
        d["gravity_w"], vcfg, cell["cam"], init_frames=K0, device="cpu")
    s = _init(vio_sqrt, d, rcfg, cell["rcam"])
    for j, f in enumerate(range(K0, K0 + FRAMES)):
        s, r_out = _ref_step(vio_sqrt, s, d, f, rcfg, cell["rcam"])
        o = compare.output_gaps({k: v[j] for k, v in outs._asdict().items()},
                                r_out)
        assert o["sigma_gap"] <= STEP_SIGMA and o["mean_gap"] <= STEP_MEAN, (f, o)
    g = compare.state_gaps(_program(es), {k: v[-1] for k, v in
                                          outs._asdict().items()},
                           vio_sqrt.squared(s), r_out)
    assert g["sigma_gap"] <= STEP_SIGMA and g["mean_gap"] <= STEP_MEAN, g
    # the state carries a lower factor, not Σ
    L = es.filt.Sigma
    assert torch.equal(L, torch.tril(L))


# The two forms share their semantics: ten frames of each from the same
# VI initialization take the same discrete steps, and their Σ and means
# differ by float32 rounding.  Where a variance cancels from its prior
# (~4e-2, a new feature's u after the IMU step) to its posterior (~1e-7)
# the covariance form's result lies at its float32 floor, 9e-8, and
# differs from the factor form's by up to 0.093 of it on these inputs;
# every other entry by under 1e-3.  The means drift apart by up to
# 8.8e-3 σ over the ten frames, as rounding compounds.
FORMS_SIGMA, FORMS_MEAN = 0.25, 0.05


def test_the_factor_reference_matches_the_covariance_reference(cell):
    d, cfg = cell["seq"], cell["cfg"]
    scfg = vio_sqrt.make_cfg(cfg["vio"])
    ccfg = vio.make_cfg(dict(cfg["vio"], square_root_form=False))
    s = _init(vio_sqrt, d, scfg, cell["rcam"])
    r = _init(vio, d, ccfg, cell["rcam"])
    # the same means; Σ's diagonal through its square root and back
    g = compare.state_gaps(vio_sqrt.squared(s), None, r, None)
    assert g["sigma_gap"] <= 1e-6 and g["mean_gap"] == 0.0, g
    for f in range(K0, K0 + FRAMES):
        s, s_out = _ref_step(vio_sqrt, s, d, f, scfg, cell["rcam"])
        r, r_out = _ref_step(vio, r, d, f, ccfg, cell["rcam"])
        g = compare.state_gaps(vio_sqrt.squared(s), s_out, r, r_out)
        o = compare.output_gaps(s_out, r_out)
        assert g["sigma_gap"] <= FORMS_SIGMA and g["mean_gap"] <= FORMS_MEAN, (f, g)
        assert o["sigma_gap"] <= FORMS_SIGMA and o["mean_gap"] <= FORMS_MEAN, (f, o)
        assert int(s_out["num_active"]) > 0


def test_the_factor_reference_refuses_the_covariance_form(cell):
    """``vio_sqrt.make_cfg`` runs the factor form only, and refuses what
    ``vio.make_cfg`` refuses."""
    v = cell["cfg"]["vio"]
    with pytest.raises(ValueError, match="square_root_form"):
        vio_sqrt.make_cfg(dict(v, square_root_form=False))
    with pytest.raises(ValueError, match="innovation_gate_chi2"):
        vio_sqrt.make_cfg(dict(v, innovation_gate_chi2=9.0))
    assert vio_sqrt.make_cfg(v).square_root_form is True


def test_tria_gives_a_factor_of_the_arrays_gram_matrix():
    g = torch.Generator().manual_seed(3)
    A = torch.randn(6, 9, generator=g, dtype=torch.float64)
    A[2] = 0.0   # a zero row stays a zero row
    T = vio_sqrt.tria(A)
    assert torch.equal(T, torch.tril(T))
    torch.testing.assert_close(T @ T.T, A @ A.T)
    assert torch.all(T[2] == 0)


# ----------------------------------------------------------------- roofline


def test_qr_work_on_a_known_shape():
    """A 4 × 2 QR: 2·4·2² − ⅔·2³ = 80/3 operations; 4·2 + 2²/2 = 10
    words of 4 bytes."""
    nbytes, flops = tria.qr_work(4, 2)
    assert nbytes == 40.0
    assert flops == pytest.approx(80.0 / 3.0)
    with pytest.raises(ValueError):
        tria.qr_work(2, 4)


def test_the_steps_qrs_at_128_slots():
    """At 128 slots (D = 406): the 841 × 406 IMU array, the 662 × 662
    update array, the 662 × 406 posterior and two 812 × 406 wipes; about
    1.24 GFLOP, 18.5 µs at the H100's 67 TFLOP/s (every QR compute-bound
    there)."""
    got = tria.shapes(128)
    assert got == {"imu": [(841, 406)], "update": [(662, 662)],
                   "posterior": [(662, 406)],
                   "wipe": [(812, 406), (812, 406)]}
    flops = sum(tria.qr_work(m, n)[1] for a in got.values() for m, n in a)
    assert flops == pytest.approx(1.2392e9, rel=1e-3)
    kind = "NVIDIA H100 80GB HBM3"
    assert tria.bound_s(128, kind) == pytest.approx(
        flops / tria.peaks(kind)["f32_flops_per_s"])
    assert tria.run_bound_ms() is None   # no benchmark run here


def _reader(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_tria_readers():
    """``tria_replay_ms.offline`` sums the ``vio.tria.*`` spans of the span
    slice (and nothing else); both readers read nothing where the slice
    has no such span (the covariance form, or a program without them),
    and the roofline share nothing outside a benchmark run on a card."""
    got = {"span_slice": "replay_sqrt", "replay_spans_ms": {
        "vio.step": 10.4, "vio.imu": 2.9, "vio.tria.imu": 1.5,
        "vio.tria.wipe": 2.9, "vio.tria.update": 2.2}}
    assert _reader("tria_replay_ms.offline").read(got) == pytest.approx(6.6)
    bare = {"span_slice": "replay", "replay_spans_ms": {"vio.imu": 1.3}}
    for name in ("tria_replay_ms.offline", "tria_roofline_pct"):
        assert _reader(name).read(dict(bare)) is None
    assert _reader("tria_roofline_pct").read(got) is None
