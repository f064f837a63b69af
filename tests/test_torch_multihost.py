"""The port's multi-process layer (``parallel/multihost``) on the CPU:
the ``torch.distributed`` bootstrap from the ``EKF_VIO_*`` variables,
the host-aware mesh layout, the per-process batch share, and a real
2-process gloo cluster running the batched filter step on a mesh.

The layouts are those ``tests/test_multihost.py`` asks of the JAX
``make_pod_mesh`` (8 devices, synthetic hosts), on the pure
``pod_layout``, whose rank grid equals the JAX mesh's device grid.  The
2-process cases are the counterparts of ``tests/test_multiproc.py:55-89`` (data 2, then data 1 x state 2); they
are held against the mesh-less step at ``tests/test_parallel.py:21``'s
bars (mean rtol 1e-5 atol 1e-5, Σ rtol 1e-4 atol 5e-5), not against
``benchmarks/multihost_scaling.py``, which the port does not carry.  Each
process runs this file as a script with torch and numpy only, on one
thread.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rank_main(workdir: str) -> None:
    """One process of the 2-process cluster: everything from the
    launcher's EKF_VIO_* variables."""
    torch.set_num_threads(1)
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.config import VIOConfig
    from ekf_vio_tpu_torch.parallel import batched
    from ekf_vio_tpu_torch.parallel import mesh as mesh_mod
    from ekf_vio_tpu_torch.parallel import multihost

    info = multihost.initialize_distributed()
    engine.use_f32_matmul()
    rank = info["process_index"]
    out = {f"info_{k}": v for k, v in info.items()}
    try:
        mesh_mod.make_mesh(2, 2, device="cpu")
        out["too_small_raises"] = False
    except ValueError:
        out["too_small_raises"] = True

    uv = torch.from_numpy(np.load(os.path.join(workdir, "uv.npz"))["uv"])
    for tag, n_state in (("data2", 1), ("state2", 2)):
        mesh = multihost.make_pod_mesh(n_state=n_state, device="cpu")
        out[f"{tag}_mesh"] = np.array(mesh.mesh.shape)
        cfg = VIOConfig(max_features=mesh_mod.aligned_capacity(16, n_state))
        state = batched.init_batched_state(
            cfg, 4, uv=uv[:, :cfg.max_features], device="cpu")
        z = state.feat_mu[:, :, :2] + 0.01
        ref = batched.make_batched_filter_step(cfg)(state, z, 0.05)
        specs = mesh_mod.filter_state_shardings(mesh, True)
        local = mesh_mod.local_blocks(state, specs, mesh)
        got = mesh_mod.gather_blocks(
            batched.make_batched_filter_step(cfg, mesh)(
                local, mesh_mod.local_blocks(z, ("data", None, None), mesh),
                0.05), specs, mesh)
        out[f"{tag}_local_sigma"] = np.array(local.Sigma.shape)
        for k in ("base_mu", "feat_mu", "Sigma"):
            out[f"{tag}_{k}"] = getattr(got, k).numpy()
            out[f"{tag}_ref_{k}"] = getattr(ref, k).numpy()
        out[f"{tag}_probe_s"] = batched.scaling_efficiency_probe(
            cfg, mesh, 4, steps=2)
    if rank == 0:
        np.savez(os.path.join(workdir, "out.npz"), **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1])
    sys.exit(0)


import jax  # noqa: E402

from ekf_vio_tpu.parallel import multihost as jmultihost  # noqa: E402
from ekf_vio_tpu_torch.parallel import multihost  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """Two processes bootstrapped through EKF_VIO_COORDINATOR,
    EKF_VIO_NUM_PROCESSES, EKF_VIO_PROCESS_ID and EKF_VIO_PLATFORM=cpu."""
    workdir = str(tmp_path_factory.mktemp("cluster"))
    uv = np.random.RandomState(5).uniform(-1, 1, (4, 16, 2)).astype(
        np.float32)
    np.savez(os.path.join(workdir, "uv.npz"), uv=uv)
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
                   EKF_VIO_COORDINATOR=f"127.0.0.1:{port}",
                   EKF_VIO_NUM_PROCESSES="2", EKF_VIO_PROCESS_ID=str(pid),
                   EKF_VIO_PLATFORM="cpu")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), workdir], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    errs = []
    for pid, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        if p.returncode != 0:
            errs.append(f"process {pid} rc {p.returncode}:\n{err[-3000:]}")
    assert not errs, "\n".join(errs)
    return dict(np.load(os.path.join(workdir, "out.npz")))


def test_initialize_distributed_single_process(monkeypatch):
    import torch.distributed as dist

    for k in ("EKF_VIO_COORDINATOR", "EKF_VIO_NUM_PROCESSES",
              "EKF_VIO_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("EKF_VIO_PLATFORM", "cpu")
    assert not dist.is_initialized()
    try:
        info = multihost.initialize_distributed()
        assert info == {"process_count": 1, "process_index": 0,
                        "local_devices": 1, "global_devices": 1}
        assert dist.get_backend() == "gloo"
        # a group that is up is left as it is
        assert multihost.initialize_distributed() == info
        assert multihost.host_local_batch(8) == 8  # single process
    finally:
        dist.destroy_process_group()


def test_initialize_distributed_needs_a_card_or_the_cpu(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("EKF_VIO_PLATFORM", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="EKF_VIO_PLATFORM=cpu"):
        multihost.initialize_distributed()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize_distributed(num_processes=2, process_id=0,
                                         platform="cpu")
    # the mesh entry points default to the card as well
    from ekf_vio_tpu_torch.parallel import mesh as mesh_mod

    for make in (lambda: mesh_mod.make_mesh(1, 1),
                 lambda: multihost.make_pod_mesh()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_pod_layout_single_host():
    ranks = multihost.pod_layout(8, n_state=2)
    assert tuple(ranks.shape) == (4, 2)
    assert ranks.reshape(-1).tolist() == list(range(8))


def test_pod_layout_state_stays_within_host():
    """2 synthetic hosts of 4 ranks: every state row is one host's."""
    ranks = multihost.pod_layout(8, n_state=2, n_hosts=2)
    assert tuple(ranks.shape) == (4, 2)
    for row in ranks.tolist():
        assert len({r // 4 for r in row}) == 1, "state row crosses hosts"


def test_pod_layout_data_spans_hosts():
    ranks = multihost.pod_layout(8, n_state=1, n_hosts=2)
    assert tuple(ranks.shape) == (8, 1)
    assert set(ranks.reshape(-1).tolist()) == set(range(8))


@pytest.mark.parametrize("n_state,n_hosts", [(1, 1), (2, 1), (2, 2), (1, 2),
                                             (4, 2), (8, 1)])
def test_pod_layout_matches_jax(n_state, n_hosts):
    """The rank grid is the JAX mesh's device grid on the conftest's 8
    virtual devices (device i standing for rank i)."""
    devices = jax.devices()[:8]
    jmesh = jmultihost.make_pod_mesh(n_state=n_state, devices=devices,
                                     n_hosts=n_hosts)
    want = np.vectorize(lambda d: devices.index(d))(np.asarray(jmesh.devices))
    got = multihost.pod_layout(8, n_state=n_state, n_hosts=n_hosts)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pod_layout_validates_divisibility():
    with pytest.raises(ValueError):
        multihost.pod_layout(8, n_state=3, n_hosts=2)
    with pytest.raises(ValueError):
        multihost.pod_layout(8, n_state=1, n_hosts=3)


def test_host_local_batch():
    assert multihost.host_local_batch(8) == 8
    assert multihost.host_local_batch(8, 2) == 4
    with pytest.raises(ValueError):
        multihost.host_local_batch(7, 2)


def test_two_process_cluster_runs_the_mesh_step(cluster):
    """2 processes -> a (data 2, state 1) mesh: each process steps its 2
    lanes; gathered, the step equals the mesh-less step."""
    assert cluster["info_process_count"] == 2
    assert cluster["info_global_devices"] == 2
    assert cluster["info_local_devices"] == 1
    assert bool(cluster["too_small_raises"])
    assert tuple(cluster["data2_mesh"]) == (2, 1)
    d = 22 + 3 * 16
    assert tuple(cluster["data2_local_sigma"]) == (2, d, d)
    _assert_step(cluster, "data2")


def test_two_process_cluster_with_state_axis(cluster):
    """The Σ column split across processes: a (data 1, state 2) mesh, each
    process holding [B, D, D/2]."""
    assert tuple(cluster["state2_mesh"]) == (1, 2)
    d = 22 + 3 * 16
    assert tuple(cluster["state2_local_sigma"]) == (4, d, d // 2)
    _assert_step(cluster, "state2")


def _assert_step(out, tag):
    for k, rtol, atol in (("base_mu", 1e-5, 1e-5), ("feat_mu", 1e-5, 1e-5),
                          ("Sigma", 1e-4, 5e-5)):
        np.testing.assert_allclose(out[f"{tag}_{k}"], out[f"{tag}_ref_{k}"],
                                   rtol=rtol, atol=atol)
    assert out[f"{tag}_probe_s"] > 0
