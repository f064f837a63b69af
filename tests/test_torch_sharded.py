"""The port's distributed layer (``parallel/mesh``, ``sharded_filter``,
``sharded_engine``, ``evidence`` and the mesh halves of ``batched`` /
``batched_engine``) on 4 gloo CPU ranks, against the JAX package's
sharded ops on 4 of the conftest's 8 virtual CPU devices.

One spawn of 4 rank processes serves the whole module (each rank runs
this file as a script, imports only torch, numpy and the port, and runs
torch on one thread with ``OMP_NUM_THREADS=1``); rank 0 writes each
case's merged result to an npz file.  The JAX oracle runs in the pytest
process while the ranks work.

Bars, those of ``tests/test_sharded_filter.py`` for its cases (the port
on ns = 4 against JAX's shard_map op on ns = 4): split/merge bitwise;
predict base_mu atol 1e-6, Σ atol 2e-5; partial update means atol
2e-5, Σ atol 5e-5, klt_ref equal; drop / add Σ and means atol 1e-7,
active equal; IMU qt and base_mu atol 1e-6, Σ atol 3e-5; compacted
update means 2e-5, Σ 1e-4 against JAX's compacted op and against the
port's full sharded update; the engine step on the blocky 160x120 pair
against JAX's sharded ``step``, JAX's dense ``engine.step`` and the
port's dense ``step`` (tracked count and active equal, means atol 2e-5,
Σ atol 5e-4); the
28-frame rendered blackout on the sharded IMU engine against the port's
dense ``run_sequence_imu`` (tracking_lost and num_tracked equal frame
for frame, base_mu atol 2e-3; lost raised and recovered from).  The
evidence: collectives > 0 in a profiler trace, a rank's Σ bytes <= the
replicated D²·4 / ns plus the replicated bb.  The mesh step at
(2 data x 2 state), with the default config, square_root_form and
joseph_form="product", against the mesh-less step lane by lane at
``tests/test_parallel.py:21``'s bars (mean rtol 1e-5 atol 1e-5, Σ rtol
1e-4 atol 5e-5); ``run_sequences_sharded`` on 2 data groups equal to
``run_sequences_batched`` in every count, base_mu within 1e-4.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

NS = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SLOTS = 16            # aligned_feature_capacity(14, 4)
BLACKOUT = (14, 19)     # frames blanked in the recovery case


def _mesh_step_cfgs(base):
    """The mesh step's cases: the default config and each option that
    changes the step's algebra."""
    return {"default": base,
            "square_root": base.replace(square_root_form=True),
            "joseph_product": base.replace(joseph_form="product")}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ==========================================================================
# Rank side: ``python tests/test_torch_sharded.py RANK WORLD PORT WORKDIR``
# ==========================================================================


def _blocky_pair():
    """The image pair of tests/test_sharded_filter.py:151-160."""
    w, h = 160, 120
    rng = np.random.RandomState(0)
    base = rng.uniform(0, 255, (h, w + 8)).astype(np.float32)
    base = (base > 128).astype(np.float32) * 200.0
    K = [[115.0, 0.0, w / 2], [0.0, 115.0, h / 2], [0.0, 0.0, 1.0]]
    return (np.ascontiguousarray(base[:, :w]),
            np.ascontiguousarray(base[:, 2:w + 2]), K, w, h)


def _blackout_cfg(cfg_cls):
    return cfg_cls(max_features=64, min_new_feature_dist=8.0,
                   fast_threshold=20, triangulate_new_features=True,
                   klt_measurement_variance_px=0.05)


def _lane_frames():
    """4 lanes x 4 frames of 96x128 textured planes (test_parallel.py)."""
    import scipy.ndimage as ndi

    rng = np.random.RandomState(0)
    h, w, t = 96, 128, 4
    seqs = []
    for _ in range(4):
        big = ndi.gaussian_filter(rng.uniform(0, 255, (h + 20, w + 30)), 1.5)
        big = ((big - big.min()) / (np.ptp(big) + 1e-9) * 255).astype(
            np.float32)
        seqs.append(np.stack([big[10:10 + h, 10 + i:10 + i + w]
                              for i in range(t)]))
    times = np.tile(np.arange(t, dtype=np.float32) * 0.05, (4, 1))
    K = [[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1]]
    return np.stack(seqs), times, K, w, h


def _rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    from ekf_vio_tpu_torch import engine, interop
    from ekf_vio_tpu_torch.config import VIOConfig
    from ekf_vio_tpu_torch.core import filter as ekf
    from ekf_vio_tpu_torch.core import imu
    from ekf_vio_tpu_torch.parallel import batched, batched_engine, evidence
    from ekf_vio_tpu_torch.parallel import mesh as mesh_mod
    from ekf_vio_tpu_torch.parallel import multihost
    from ekf_vio_tpu_torch.parallel import sharded_engine as se
    from ekf_vio_tpu_torch.parallel import sharded_filter as sf
    from ekf_vio_tpu_torch.sim import rendered

    info = multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                            platform="cpu")
    assert info["process_count"] == world and info["process_index"] == rank
    engine.use_f32_matmul()
    mesh = mesh_mod.make_mesh(1, NS, device="cpu")
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    cfg = VIOConfig(max_features=N_SLOTS)
    dense = interop.filter_state_from_numpy(inp, "cpu")
    t = torch.from_numpy

    def save(case, **arrays):
        if rank == 0:
            np.savez(os.path.join(workdir, case + ".npz"), **{
                k: v.detach().numpy() if torch.is_tensor(v) else v
                for k, v in arrays.items()})

    def save_filter(case, filt, **extra):
        save(case, **{k: getattr(filt, k) for k in interop.FILTER_FIELDS},
             **extra)

    def timed(case, fn):
        t0 = time.perf_counter()
        fn()
        save(case + "_seconds", s=np.float64(time.perf_counter() - t0))

    # ---- split / merge, predict, update, drop / add, IMU, compacted
    timed("split_merge", lambda: save_filter(
        "split_merge", sf.merge_state(sf.split_state(dense, mesh), mesh)))
    timed("predict", lambda: save_filter("predict", sf.merge_state(
        sf.sharded_predict(sf.split_state(dense, mesh), cfg, 0.05, mesh),
        mesh)))
    mc = (torch.eye(2) * 1e-5).expand(N_SLOTS, 2, 2)
    slots = torch.arange(N_SLOTS)

    def update():
        passed = (slots % 3 != 0) & dense.active
        z = dense.feat_mu[:, :2] + 0.01
        save_filter("update", sf.merge_state(sf.sharded_update(
            sf.split_state(dense, mesh), cfg, z, mc, passed, mesh), mesh))

    timed("update", update)

    def drop_add():
        drop = slots % 5 == 0
        sd = sf.merge_state(sf.sharded_drop_features(
            sf.split_state(dense, mesh), drop, mesh), mesh)
        sa = sf.merge_state(sf.sharded_add_features(
            sf.split_state(sd, mesh), cfg, t(inp["new_uv"]), slots < 5,
            mesh, depths=torch.full((N_SLOTS,), 0.8)), mesh)
        save("drop_add", drop_Sigma=sd.Sigma, drop_active=sd.active,
             add_Sigma=sa.Sigma, add_feat_mu=sa.feat_mu,
             add_active=sa.active)

    timed("drop_add", drop_add)

    def imu_case():
        batch = imu.ImuSample(t(inp["imu_dt"]), t(inp["imu_gyro"]),
                              t(inp["imu_accel"]))
        s, qt = sf.sharded_propagate_imu_batch(
            sf.split_state(dense, mesh), cfg, batch, t(inp["g_w"]), mesh)
        save_filter("imu", sf.merge_state(s, mesh), qt=qt)

    timed("imu", imu_case)

    def compact():
        passed = (slots % 2 == 0) & dense.active
        budget = int((passed & dense.active).sum()) + 2
        z = dense.feat_mu[:, :2] + 0.004
        got = sf.merge_state(sf.sharded_update(
            sf.split_state(dense, mesh), cfg, z, mc, passed, mesh, budget),
            mesh)
        full = sf.merge_state(sf.sharded_update(
            sf.split_state(dense, mesh), cfg, z, mc, passed, mesh), mesh)
        save_filter("compact", got, full_Sigma=full.Sigma,
                    budget=np.int64(budget))

    timed("compact", compact)

    # ---- evidence: collectives in a trace, this rank's Σ bytes
    def evidence_case():
        s = sf.split_state(dense, mesh)
        z = dense.feat_mu[:, :2] + 0.01
        upd = evidence.collective_inventory(
            lambda: sf.sharded_update(s, cfg, z, mc, s.active, mesh))
        pred = evidence.collective_inventory(
            lambda: sf.sharded_predict(s, cfg, 0.05, mesh))
        mem = evidence.memory_analysis(s)
        save("evidence", **{f"update_{k}": v for k, v in upd.items()},
             **{f"predict_{k}": v for k, v in pred.items()},
             **{f"mem_{k}": v for k, v in mem.items()},
             ff_shape=np.array(s.ff.shape))

    timed("evidence", evidence_case)

    # ---- the full engine step on the blocky pair, sharded and dense
    def engine_step():
        img0, img1, K, w, h = _blocky_pair()
        cam = interop.camera_from_K(K, w, h)
        s0 = se.initialize(t(img0), torch.tensor(0.0), cfg, cam, mesh)
        s1, sout = se.step(s0, t(img1), torch.tensor(0.05), cfg, cam, mesh)
        d0 = engine.initialize(t(img0), torch.tensor(0.0), cfg, cam,
                               device="cpu")
        d1, dout = engine.step(d0, t(img1), torch.tensor(0.05), cfg, cam)
        save_filter("engine_step", sf.merge_state(s1.filt, mesh),
                    num_tracked=sout.num_tracked, mean_nis=sout.mean_nis,
                    dense_Sigma=d1.filt.Sigma, dense_base_mu=d1.filt.base_mu,
                    dense_feat_mu=d1.filt.feat_mu,
                    dense_active=d1.filt.active,
                    dense_num_tracked=dout.num_tracked)

    timed("engine_step", engine_step)

    # ---- the rendered blackout on the sharded mono-inertial engine
    def blackout():
        seq = rendered.generate(num_frames=28, w=192, h=144, f=160.0)
        frames = seq.frames.copy()
        frames[BLACKOUT[0]:BLACKOUT[1]] = 0.0
        bcfg = _blackout_cfg(VIOConfig)
        h, w = frames.shape[1:]
        cam = interop.camera_from_K(seq.K, w, h)
        args = (frames, seq.times, seq.imu_dt, seq.imu_gyro, seq.imu_accel,
                seq.gravity_w)
        _, souts = se.run_sequence_imu(*args, bcfg, cam, mesh,
                                       init_frames=bcfg.vi_init_frames)
        out = {f"sharded_{k}": getattr(souts, k)
               for k in ("tracking_lost", "num_tracked", "base_mu",
                         "mean_nis")}
        if rank == 0:  # the dense reference, on one rank
            _, douts = engine.run_sequence_imu(
                *args, bcfg, cam, init_frames=bcfg.vi_init_frames,
                device="cpu")
            out.update({f"dense_{k}": getattr(douts, k)
                        for k in ("tracking_lost", "num_tracked",
                                  "base_mu")})
        save("blackout", **out)

    timed("blackout", blackout)

    # ---- the mesh halves of batching at (2 data x 2 state)
    mesh22 = mesh_mod.make_mesh(2, 2, device="cpu")

    def mesh_step():
        base = VIOConfig(max_features=mesh_mod.aligned_capacity(16, 4))
        for case, bcfg in _mesh_step_cfgs(base).items():
            state = batched.init_batched_state(bcfg, 4,
                                               uv=t(inp["lane_uv"]),
                                               device="cpu")
            z = state.feat_mu[:, :, :2] + 0.01
            ref = batched.make_batched_filter_step(bcfg)(state, z, 0.05)
            specs = mesh_mod.filter_state_shardings(mesh22, True)
            local = mesh_mod.local_blocks(state, specs, mesh22)
            z_l = mesh_mod.local_blocks(z, ("data", None, None), mesh22)
            got_l = batched.make_batched_filter_step(bcfg, mesh22)(
                local, z_l, 0.05)
            got = mesh_mod.gather_blocks(got_l, specs, mesh22)
            save_filter(f"mesh_step_{case}", got, ref_Sigma=ref.Sigma,
                        ref_base_mu=ref.base_mu, ref_feat_mu=ref.feat_mu,
                        local_sigma_shape=np.array(got_l.Sigma.shape))

    timed("mesh_step", mesh_step)

    def sharded_lanes():
        images, times, K, w, h = _lane_frames()
        lcfg = VIOConfig(max_features=24, num_features=16,
                         fast_threshold=12, min_new_feature_dist=10.0)
        cam = interop.camera_from_K(K, w, h)
        _, outs = batched_engine.run_sequences_sharded(
            t(images), t(times), lcfg, cam, mesh22)
        res = {f"sharded_{k}": getattr(outs, k)
               for k in ("num_tracked", "num_active", "base_mu")}
        if rank == 0:
            _, ref = batched_engine.run_sequences_batched(
                t(images), t(times), lcfg, cam, device="cpu")
            res.update({f"batched_{k}": getattr(ref, k)
                        for k in ("num_tracked", "num_active", "base_mu")})
        save("sharded_lanes", **res)

    timed("sharded_lanes", sharded_lanes)

    # every rank holds the same merged results: rank 3 checks its own
    back = sf.merge_state(sf.split_state(dense, mesh), mesh)
    rep = mesh_mod.replicate(mesh, torch.full((3,), float(rank)))
    assert torch.equal(back.Sigma, dense.Sigma) and rep.eq(0).all()
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*(int(a) for a in sys.argv[1:4]), sys.argv[4])
    sys.exit(0)


# ==========================================================================
# pytest side: the inputs, the spawn, and the JAX oracle
# ==========================================================================

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ekf_vio_tpu.config import VIOConfig as JConfig  # noqa: E402
from ekf_vio_tpu.core import filter as jekf  # noqa: E402
from ekf_vio_tpu.core import imu as jimu  # noqa: E402
from ekf_vio_tpu.parallel import sharded_filter as jsf  # noqa: E402
from ekf_vio_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from ekf_vio_tpu_torch.parallel import sharded_filter as sf  # noqa: E402


@pytest.fixture(scope="module")
def jcfg():
    return JConfig(max_features=jsf.aligned_feature_capacity(14, NS))


@pytest.fixture(scope="module")
def jmesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:NS]), ("state",))


@pytest.fixture(scope="module")
def dense_state(jcfg):
    """tests/test_sharded_filter.py's state: a dense FilterState with real
    cross-correlations (two filter steps)."""
    import functools

    st = jekf.init_state(jcfg)
    uv = jax.random.uniform(jax.random.PRNGKey(0), (jcfg.max_features, 2),
                            minval=-1.0, maxval=1.0)
    valid = jnp.arange(jcfg.max_features) < 12
    st = jax.jit(jekf.add_features, static_argnums=1)(st, jcfg, uv, valid)
    mc = jnp.tile(jnp.eye(2) * 1e-5, (jcfg.max_features, 1, 1))

    @functools.partial(jax.jit, static_argnums=1)
    def pu(st, cfg):
        st = jekf.predict(st, cfg, 0.05)
        z = st.feat_mu[:, :2] + 0.003
        return jekf.update_with_feature_positions(st, cfg, z, mc, st.active)

    for _ in range(2):
        st = pu(st, jcfg)
    return st


def _imu_inputs():
    rng = np.random.RandomState(3)
    k = 8
    return dict(
        imu_dt=np.full(k, 0.005, np.float32),
        imu_gyro=(0.1 * rng.normal(size=(k, 3))).astype(np.float32),
        imu_accel=(np.array([0.0, 0.0, 9.81], np.float32)
                   + 0.1 * rng.normal(size=(k, 3))).astype(np.float32),
        g_w=np.array([0.0, 0.0, -9.81], np.float32))


@pytest.fixture(scope="module")
def inputs(dense_state):
    rng = np.random.RandomState(2)
    d = {k: np.asarray(getattr(dense_state, k))
         for k in ("base_mu", "feat_mu", "active", "klt_ref", "Sigma", "t",
                   "age")}
    d["new_uv"] = rng.uniform(-1, 1, (N_SLOTS, 2)).astype(np.float32)
    d["lane_uv"] = rng.uniform(-1, 1, (4, mesh_mod.aligned_capacity(16, 4),
                                       2)).astype(np.float32)
    d.update(_imu_inputs())
    return d


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Spawn the 4 ranks once; yields a loader of rank 0's results.  The
    JAX oracle of each test runs while the ranks work."""
    workdir = str(tmp_path_factory.mktemp("ranks"))
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("EKF_VIO_PLATFORM", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(NS),
         str(port), workdir], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(NS)]
    state = {"done": False}

    def load(case):
        if not state["done"]:
            errs = []
            for r, p in enumerate(procs):
                try:
                    _, err = p.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    p.kill()
                    _, err = p.communicate()
                if p.returncode != 0:
                    errs.append(f"rank {r} rc {p.returncode}:\n{err[-3000:]}")
            state["done"] = True
            state["errs"] = errs
        assert not state["errs"], "\n".join(state["errs"])
        return dict(np.load(os.path.join(workdir, case + ".npz")))

    yield load
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _place(st, jmesh):
    return jax.device_put(jsf.split_state(st), jsf.state_shardings(jmesh))


def _mc(jcfg):
    return jnp.tile(jnp.eye(2) * 1e-5, (jcfg.max_features, 1, 1))


def test_split_merge_roundtrip(ranks, dense_state):
    got = ranks("split_merge")
    np.testing.assert_array_equal(got["Sigma"], np.asarray(dense_state.Sigma))
    np.testing.assert_array_equal(got["Sigma"], got["Sigma"].T)
    for k in ("base_mu", "feat_mu", "active", "klt_ref", "age"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(dense_state,
                                                                  k)))


def test_sharded_predict_matches_jax(ranks, dense_state, jcfg, jmesh):
    want = jsf.merge_state(jax.jit(jsf.sharded_predict, static_argnums=(1, 3))(
        _place(dense_state, jmesh), jcfg, 0.05, jmesh))
    got = ranks("predict")
    np.testing.assert_allclose(got["base_mu"], np.asarray(want.base_mu),
                               atol=1e-6)
    np.testing.assert_allclose(got["Sigma"], np.asarray(want.Sigma),
                               atol=2e-5)
    np.testing.assert_allclose(float(got["t"]), float(want.t), atol=1e-6)


def test_sharded_update_partial_measurements_matches_jax(
        ranks, dense_state, jcfg, jmesh):
    passed = (jnp.arange(jcfg.max_features) % 3 != 0) & dense_state.active
    z = dense_state.feat_mu[:, :2] + 0.01
    want = jsf.merge_state(jax.jit(jsf.sharded_update, static_argnums=(1, 5))(
        _place(dense_state, jmesh), jcfg, z, _mc(jcfg), passed, jmesh))
    got = ranks("update")
    for k in ("base_mu", "feat_mu"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(want, k)),
                                   atol=2e-5)
    np.testing.assert_allclose(got["Sigma"], np.asarray(want.Sigma),
                               atol=5e-5)
    np.testing.assert_array_equal(got["klt_ref"], np.asarray(want.klt_ref))


def test_sharded_drop_and_add_match_jax(ranks, dense_state, inputs, jcfg,
                                        jmesh):
    n = jcfg.max_features
    drop = jnp.arange(n) % 5 == 0
    sd = jsf.merge_state(jax.jit(jsf.sharded_drop_features,
                                 static_argnums=2)(
        _place(dense_state, jmesh), drop, jmesh))
    sa = jsf.merge_state(jax.jit(jsf.sharded_add_features,
                                 static_argnums=(1, 4))(
        _place(sd, jmesh), jcfg, jnp.asarray(inputs["new_uv"]),
        jnp.arange(n) < 5, jmesh, depths=jnp.full((n,), 0.8)))
    got = ranks("drop_add")
    np.testing.assert_allclose(got["drop_Sigma"], np.asarray(sd.Sigma),
                               atol=1e-7)
    np.testing.assert_array_equal(got["drop_active"], np.asarray(sd.active))
    np.testing.assert_allclose(got["add_Sigma"], np.asarray(sa.Sigma),
                               atol=1e-7)
    np.testing.assert_allclose(got["add_feat_mu"], np.asarray(sa.feat_mu),
                               atol=1e-7)
    np.testing.assert_array_equal(got["add_active"], np.asarray(sa.active))


def test_sharded_imu_matches_jax(ranks, dense_state, inputs, jcfg, jmesh):
    batch = jimu.ImuSample(*(jnp.asarray(inputs[k]) for k in
                             ("imu_dt", "imu_gyro", "imu_accel")))
    s, qt = jax.jit(jsf.sharded_propagate_imu_batch, static_argnums=(1, 4))(
        _place(dense_state, jmesh), jcfg, batch, jnp.asarray(inputs["g_w"]),
        jmesh)
    want = jsf.merge_state(s)
    got = ranks("imu")
    np.testing.assert_allclose(got["qt"], np.asarray(qt), atol=1e-6)
    np.testing.assert_allclose(got["base_mu"], np.asarray(want.base_mu),
                               atol=1e-6)
    np.testing.assert_allclose(got["Sigma"], np.asarray(want.Sigma),
                               atol=3e-5)


def test_sharded_update_compacted_matches_jax(ranks, dense_state, jcfg,
                                              jmesh):
    passed = (jnp.arange(jcfg.max_features) % 2 == 0) & dense_state.active
    got = ranks("compact")
    budget = int(got["budget"])
    assert budget == int(jnp.sum(passed & dense_state.active)) + 2
    z = dense_state.feat_mu[:, :2] + 0.004
    want = jsf.merge_state(jax.jit(jsf.sharded_update,
                                   static_argnums=(1, 5, 6))(
        _place(dense_state, jmesh), jcfg, z, _mc(jcfg), passed, jmesh,
        budget))
    for k in ("base_mu", "feat_mu"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(want, k)),
                                   atol=2e-5)
    np.testing.assert_allclose(got["Sigma"], np.asarray(want.Sigma),
                               atol=1e-4)
    np.testing.assert_array_equal(got["klt_ref"], np.asarray(want.klt_ref))
    # and against the port's full sharded update (same measurement set)
    np.testing.assert_allclose(got["Sigma"], got["full_Sigma"], atol=1e-4)


def test_aligned_capacities():
    assert sf.aligned_feature_capacity(14, 4) == 16
    assert sf.aligned_feature_capacity(256, 8) == 256
    assert sf.aligned_feature_capacity(257, 8) == 264
    assert mesh_mod.aligned_capacity(16, 4) == 18  # 22+54=76 = 4*19
    assert mesh_mod.aligned_capacity(16, 2) == 16  # 70 already even


def test_collectives_ran_and_sigma_is_split(ranks, jcfg):
    """The evidence of distribution: the update's trace holds all-gathers
    and the all-to-all transpose (at least 3 collectives, as the JAX test
    asks of the HLO), the predict's an all-gather; each rank holds 1/ns
    of ff, and its Σ bytes stay within the replicated D²·4 / ns plus the
    replicated bb."""
    ev = ranks("evidence")
    assert ev["update_all-gather"] >= 1 and ev["update_all-to-all"] >= 1
    assert ev["update_total"] >= 3
    assert ev["predict_all-gather"] >= 1
    n3 = 3 * jcfg.max_features
    assert tuple(ev["ff_shape"]) == (n3 // NS, n3)
    assert ev["mem_ff"] == n3 * n3 * 4 // NS
    d = 22 + n3
    assert ev["mem_replicated_sigma_bytes"] == d * d * 4
    assert ev["mem_rank_sigma_bytes"] <= d * d * 4 / NS + ev["mem_bb"]


def test_full_sharded_engine_step_matches_jax(ranks, jcfg, jmesh):
    """The whole per-frame pipeline on 4 ranks against JAX's sharded
    ``step`` on 4 devices, JAX's dense ``engine.step`` and the port's own
    dense ``step``, on the blocky pair."""
    from ekf_vio_tpu import engine as jengine
    from ekf_vio_tpu.parallel import sharded_engine as jse

    img0, img1, K, w, h = _blocky_pair()
    cam = jengine.make_hashable_camera(K, w, h)
    s0 = jse.initialize(jnp.asarray(img0), 0.0, jcfg, cam, jmesh)
    s1, sout = jax.jit(jse.step, static_argnums=(3, 4, 5))(
        s0, jnp.asarray(img1), jnp.float32(0.05), jcfg, cam, jmesh)
    d0 = jengine.initialize(jnp.asarray(img0), 0.0, jcfg, cam)
    d1, dout = jax.jit(jengine.step, static_argnums=(3, 4))(
        d0, jnp.asarray(img1), jnp.float32(0.05), jcfg, cam)
    refs = [(jsf.merge_state(s1.filt), int(sout.num_tracked)),
            (d1.filt, int(dout.num_tracked))]
    got = ranks("engine_step")
    assert float(got["mean_nis"]) == 0.0  # the reference defect
    refs = [({k: np.asarray(getattr(f, k)) for k in
              ("active", "base_mu", "feat_mu", "Sigma")}, n)
            for f, n in refs]
    refs.append(({k: got[f"dense_{k}"] for k in
                  ("active", "base_mu", "feat_mu", "Sigma")},
                 int(got["dense_num_tracked"])))
    for want, tracked in refs:
        assert int(got["num_tracked"]) == tracked > 10
        np.testing.assert_array_equal(got["active"], want["active"])
        np.testing.assert_allclose(got["base_mu"], want["base_mu"],
                                   atol=2e-5)
        np.testing.assert_allclose(got["feat_mu"], want["feat_mu"],
                                   atol=2e-5)
        np.testing.assert_allclose(got["Sigma"], want["Sigma"], atol=5e-4)


def test_sharded_blackout_recovery_matches_dense(ranks):
    got = ranks("blackout")
    slost = got["sharded_tracking_lost"]
    assert slost.any(), "the sharded path must raise tracking_lost"
    assert not slost[-3:].any(), f"the sharded path is still lost: {slost}"
    assert int(got["sharded_num_tracked"][-1]) > 10
    assert np.isfinite(got["sharded_base_mu"]).all()
    assert (got["sharded_mean_nis"] == 0.0).all()
    np.testing.assert_array_equal(slost, got["dense_tracking_lost"])
    np.testing.assert_array_equal(got["sharded_num_tracked"],
                                  got["dense_num_tracked"])
    np.testing.assert_allclose(got["sharded_base_mu"], got["dense_base_mu"],
                               atol=2e-3)


@pytest.mark.parametrize("case", ["default", "square_root",
                                  "joseph_product"])
def test_mesh_step_matches_the_meshless_step(ranks, case):
    got = ranks(f"mesh_step_{case}")
    n = mesh_mod.aligned_capacity(16, 4)
    d = 22 + 3 * n
    # each rank stored its [B/nd, D, D/ns] block
    assert tuple(got["local_sigma_shape"]) == (2, d, d // 2)
    np.testing.assert_allclose(got["base_mu"], got["ref_base_mu"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["feat_mu"], got["ref_feat_mu"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["Sigma"], got["ref_Sigma"], rtol=1e-4,
                               atol=5e-5)


def test_run_sequences_sharded_matches_batched(ranks):
    got = ranks("sharded_lanes")
    assert got["sharded_base_mu"].shape == (4, 3, 22)
    for k in ("num_tracked", "num_active"):
        np.testing.assert_array_equal(got[f"sharded_{k}"],
                                      got[f"batched_{k}"])
    assert got["sharded_num_tracked"].min() > 0
    np.testing.assert_allclose(got["sharded_base_mu"],
                               got["batched_base_mu"], atol=1e-4)
