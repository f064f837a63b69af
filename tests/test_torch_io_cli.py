"""The port's io (EuRoC loader, frame loader, checkpoint), insight,
profiling and CLI against the JAX package on the CPU, and its independence
from JAX.

Bars: csv parsing and IMU batching exact; ``load_images`` against the
JAX package's OpenCV path within 1e-4 gray levels (the radtan map is
float64 rounded to float32 as OpenCV's; the remap blends the four taps
as OpenCV 5's float remap does, bitwise here; OpenCV 4's fixed-point
tables, which round the map to 1/32 px, would differ from it by up to
about one gray level on this texture; the resize blends at s·d +
(s − 1)/2 as ``cv2.resize`` does, bitwise at factors 2 and 4); both
frame-loader routes bitwise equal on 8-bit gray and RGB PNGs; a JAX
``save_npz`` file resumes in the port with one step equal to the JAX
step (the bars of ``test_torch_engine.py``), and a port ``save_npz``
file (the CLI's ``--checkpoint``) resumes in JAX at the same bars; insight outputs bitwise
equal to the JAX module's; ``info`` and ``run --synthetic 12 --device
cpu`` with the JAX CLI's summary keys, frames and mean_tracked.
"""
import json
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from ekf_vio_tpu import engine as jengine
from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.io import checkpoint as jcheckpoint
from ekf_vio_tpu.io import euroc as jeuroc
from ekf_vio_tpu.viz import insight as jinsight
from ekf_vio_tpu_torch import engine, interop
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.io import checkpoint, euroc, frame_loader
from ekf_vio_tpu_torch.utils import profiling
from ekf_vio_tpu_torch.viz import insight
from test_torch_batched import one_torch_thread  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0_NS = 1403636579763555584  # past float64's exact integers
FRAME_NS, IMU_NS = 50_000_000, 5_000_000
N_FRAMES, W, H = 4, 752, 480


@pytest.fixture(scope="module")
def mav0(tmp_path_factory):
    """A format-faithful ASL tree (as tests/test_euroc_tree.py builds it)
    of a texture moving 1.5 px a frame, with a moving IMU and GT."""
    root = tmp_path_factory.mktemp("euroc") / "mav0"
    cam_dir = root / "cam0" / "data"
    cam_dir.mkdir(parents=True)
    (root / "imu0").mkdir()
    (root / "state_groundtruth_estimate0").mkdir()
    rng = np.random.RandomState(0)
    tex = ndi.gaussian_filter(rng.uniform(0, 255, (H, W + 16)), 2.0)
    tex = (tex - tex.min()) / np.ptp(tex) * 255.0
    lines = ["#timestamp [ns],filename"]
    for i in range(N_FRAMES):
        ts = T0_NS + i * FRAME_NS
        shifted = ndi.shift(tex, (0, -1.5 * i), order=1, mode="nearest")
        cv2.imwrite(str(cam_dir / f"{ts}.png"),
                    shifted[:, :W].round().astype(np.uint8))
        lines.append(f"{ts},{ts}.png")
    (root / "cam0" / "data.csv").write_text("\n".join(lines) + "\n")
    imu = ["#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z"]
    for k in range(N_FRAMES * FRAME_NS // IMU_NS + 3):
        ts = T0_NS + k * IMU_NS - 7
        imu.append(f"{ts},{0.01 * k},-0.02,0.003,{0.1 * np.sin(k)},0.2,9.81")
    (root / "imu0" / "data.csv").write_text("\n".join(imu) + "\n")
    gt = ["#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z,v,v,v,bw,bw,bw,ba,ba,ba"]
    for i in range(N_FRAMES):
        gt.append(f"{T0_NS + i * FRAME_NS},{0.01 * i},0.5,-0.25,1,0,0,0,"
                  "0,0,0,0,0,0,0,0,0")
    (root / "state_groundtruth_estimate0" / "data.csv").write_text(
        "\n".join(gt) + "\n")
    return str(root)


def test_load_sequence_and_imu_are_exact(mav0):
    seq, jseq = euroc.load_sequence(mav0, "x"), jeuroc.load_sequence(mav0, "x")
    assert seq.image_paths == jseq.image_paths
    assert all(os.path.exists(p) for p in seq.image_paths)
    for a, b in zip(seq[1:], jseq[1:]):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(euroc.imu_between_frames(seq, max_per_frame=12),
                    jeuroc.imu_between_frames(jseq, max_per_frame=12)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("undistort", [True, False])
def test_load_images_match_the_opencv_path(mav0, scale, undistort):
    seq = euroc.load_sequence(mav0)
    got, K = euroc.load_images(seq, inverse_scale=scale, undistort=undistort)
    want, jK = jeuroc.load_images(jeuroc.load_sequence(mav0),
                                  inverse_scale=scale, undistort=undistort)
    assert got.shape == want.shape == (N_FRAMES, H // scale, W // scale)
    np.testing.assert_array_equal(K, jK)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[0][20:-20, 20:-20].std() > 5.0


def test_undistortion_pieces_match_opencv():
    rng = np.random.RandomState(1)
    img = ndi.gaussian_filter(rng.uniform(0, 255, (H, W)), 1.0).astype(
        np.float32)
    mx, my = euroc.undistort_map(euroc.CAM0_K, euroc.CAM0_DIST, (W, H))
    d5 = np.concatenate([euroc.CAM0_DIST, np.zeros(1, np.float32)])
    cx, cy = cv2.initUndistortRectifyMap(euroc.CAM0_K, d5, None,
                                         euroc.CAM0_K.copy(), (W, H),
                                         cv2.CV_32FC1)
    np.testing.assert_array_equal(mx, cx)
    np.testing.assert_array_equal(my, cy)
    np.testing.assert_allclose(euroc.remap_bilinear(img, mx, my),
                               cv2.remap(img, cx, cy, cv2.INTER_LINEAR),
                               atol=1e-4)
    for s in (2, 4):  # not the s x s box mean
        small = euroc.resize_linear(img, (W // s, H // s))
        np.testing.assert_array_equal(small, cv2.resize(img, (W // s,
                                                              H // s)))
    box = img.reshape(H // 4, 4, W // 4, 4).mean((1, 3))
    assert np.abs(euroc.resize_linear(img, (W // 4, H // 4)) - box).max() > 1


@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("color", [False, True])
def test_frame_loader_routes_agree(tmp_path, monkeypatch, scale, color):
    rng = np.random.RandomState(2)
    paths = []
    for i in range(3):
        shape = (37, 53, 3) if color else (37, 53)
        img = rng.randint(0, 256, shape).astype(np.uint8)
        img[:5] = 7  # rows the encoder filters differently
        paths.append(str(tmp_path / f"{i}.png"))
        cv2.imwrite(paths[-1], img)
    native = frame_loader.FrameLoader(paths, inverse_scale=scale)
    assert native.route == "native"
    a = dict(native)
    native.close()
    monkeypatch.setattr(frame_loader, "_lib", lambda: None)
    python = frame_loader.FrameLoader(paths, inverse_scale=scale)
    assert python.route == "python"
    b = dict(python)
    assert sorted(a) == sorted(b) == [0, 1, 2]
    for i in a:
        np.testing.assert_array_equal(a[i], b[i])
    if not color and scale == 1:
        np.testing.assert_array_equal(
            a[0], cv2.imread(paths[0], cv2.IMREAD_GRAYSCALE).astype(
                np.float32))


def test_native_loader_builds_outside_native_dir():
    lib = frame_loader.build()
    assert lib is not None and lib.parent == frame_loader.BUILD_DIR
    assert "native" not in lib.parent.parts[-1:]


def _small_frames(n):
    from ekf_vio_tpu.frontend import camera as jcam
    from ekf_vio_tpu_torch.sim import frames as sim_frames

    frames, times = sim_frames.make_frames(seed=0, n_frames=n)
    return np.array(jcam.downscale_image(jnp.asarray(frames), 4)), times


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    small, times = _small_frames(3)
    kw = dict(max_features=64, num_features=50, min_new_feature_dist=8.0,
              fast_threshold=30)
    jcfg, cfg = JConfig(**kw), VIOConfig(**kw)
    K = [[458.0 / 4, 0, 80.0], [0, 458.0 / 4, 60.0], [0, 0, 1]]
    jc = jengine.make_hashable_camera(K, 160, 120)
    step = jax.jit(jengine.step, static_argnums=(3, 4))
    es0 = jengine.initialize(jnp.asarray(small[0]), times[0], jcfg, jc)
    es1, _ = step(es0, jnp.asarray(small[1]), jnp.float32(times[1]), jcfg,
                  jc)
    path = str(tmp_path / "state.npz")
    jcheckpoint.save_npz(path, es1.filt)
    filt = checkpoint.load_npz(path, device="cpu")
    for k in interop.FILTER_FIELDS:
        np.testing.assert_array_equal(getattr(filt, k).numpy(),
                                      np.asarray(getattr(es1.filt, k)))
    es2, jout = step(es1, jnp.asarray(small[2]), jnp.float32(times[2]), jcfg,
                     jc)
    ts1 = engine.EngineState(
        filt=filt, prev_pyr=tuple(torch.from_numpy(np.array(x))
                                  for x in es1.prev_pyr),
        frame_idx=torch.tensor(int(es1.frame_idx), dtype=torch.int32),
        lin_base=filt.base_mu)
    ts2, out = engine.step(ts1, torch.from_numpy(small[2]),
                           torch.tensor(times[2]), cfg,
                           interop.camera_from_K(K, 160, 120))
    assert int(out.num_tracked) == int(jout.num_tracked) > 30
    np.testing.assert_array_equal(ts2.filt.active.numpy(),
                                  np.asarray(es2.filt.active))
    assert np.abs(ts2.filt.base_mu.numpy()
                  - np.asarray(es2.filt.base_mu)).max() < 1e-4
    sig = np.asarray(es2.filt.Sigma)
    assert np.abs(ts2.filt.Sigma.numpy() - sig).max() < 1e-3 * max(
        np.abs(sig).max(), 1.0)
    # torch.save round trip
    checkpoint.save(str(tmp_path / "state.pt"), ts2.filt)
    back = checkpoint.load(str(tmp_path / "state.pt"), device="cpu")
    for k in interop.FILTER_FIELDS:
        assert torch.equal(getattr(back, k), getattr(ts2.filt, k))


def test_a_port_checkpoint_resumes_in_jax(tmp_path):
    """The mirror image of the test above: the JAX ``load_npz`` reads a
    file the port's ``save_npz`` wrote, and one JAX step from it equals
    one port step, at the same bars."""
    small, times = _small_frames(3)
    kw = dict(max_features=64, num_features=50, min_new_feature_dist=8.0,
              fast_threshold=30)
    jcfg, cfg = JConfig(**kw), VIOConfig(**kw)
    K = [[458.0 / 4, 0, 80.0], [0, 458.0 / 4, 60.0], [0, 0, 1]]
    cam = interop.camera_from_K(K, 160, 120)
    ts0 = engine.initialize(torch.from_numpy(small[0]),
                            torch.tensor(times[0]), cfg, cam, device="cpu")
    ts1, _ = engine.step(ts0, torch.from_numpy(small[1]),
                         torch.tensor(times[1]), cfg, cam)
    path = str(tmp_path / "state.npz")
    checkpoint.save_npz(path, ts1.filt)
    filt = jcheckpoint.load_npz(path)
    for k in interop.FILTER_FIELDS:
        got = np.asarray(getattr(filt, k))
        want = getattr(ts1.filt, k).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want)
    # and the port reads its own file back
    back = checkpoint.load_npz(path, device="cpu")
    for k in interop.FILTER_FIELDS:
        assert torch.equal(getattr(back, k), getattr(ts1.filt, k))
    ts2, out = engine.step(ts1, torch.from_numpy(small[2]),
                           torch.tensor(times[2]), cfg, cam)
    es1 = jengine.EngineState(
        filt=filt, prev_pyr=tuple(jnp.asarray(x.numpy())
                                  for x in ts1.prev_pyr),
        frame_idx=jnp.int32(int(ts1.frame_idx)), lin_base=filt.base_mu)
    jc = jengine.make_hashable_camera(K, 160, 120)
    es2, jout = jax.jit(jengine.step, static_argnums=(3, 4))(
        es1, jnp.asarray(small[2]), jnp.float32(times[2]), jcfg, jc)
    assert int(out.num_tracked) == int(jout.num_tracked) > 30
    np.testing.assert_array_equal(ts2.filt.active.numpy(),
                                  np.asarray(es2.filt.active))
    assert np.abs(ts2.filt.base_mu.numpy()
                  - np.asarray(es2.filt.base_mu)).max() < 1e-4
    sig = np.asarray(es2.filt.Sigma)
    assert np.abs(ts2.filt.Sigma.numpy() - sig).max() < 1e-3 * max(
        np.abs(sig).max(), 1.0)


def test_checkpoint_loads_default_to_the_card(tmp_path):
    """Like every entry point, ``load`` and ``load_npz`` put the state on
    the card unless the caller passes device="cpu", and raise without
    one."""
    state = engine.initialize(torch.zeros(48, 64), torch.tensor(0.0),
                              VIOConfig(max_features=8),
                              interop.camera_from_K(
                                  [[50.0, 0, 32.0], [0, 50.0, 24.0],
                                   [0, 0, 1]], 64, 48), device="cpu").filt
    checkpoint.save(str(tmp_path / "s.pt"), state)
    np.savez(str(tmp_path / "s.npz"), __treedef__=np.array("x"),
             **{f"leaf_{i}": getattr(state, k).numpy()
                for i, k in enumerate(interop.FILTER_FIELDS)})
    for load, name in ((checkpoint.load, "s.pt"),
                       (checkpoint.load_npz, "s.npz")):
        if torch.cuda.is_available():
            assert load(str(tmp_path / name)).Sigma.is_cuda
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                load(str(tmp_path / name))
        back = load(str(tmp_path / name), device="cpu")
        for k in interop.FILTER_FIELDS:
            assert torch.equal(getattr(back, k), getattr(state, k))


def test_insight_matches_the_jax_module(tmp_path):
    rng = np.random.RandomState(3)
    n = 12
    img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    px = rng.uniform(-5, 85, (n, 2)).astype(np.float32)
    active = rng.uniform(size=n) < 0.7
    a = rng.normal(size=(n, 2, 2)).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1) * 4.0
    d = 22 + 3 * n
    b = rng.normal(size=(d, d)).astype(np.float32)
    sigma = b @ b.T
    mu = np.c_[rng.normal(size=(n, 2)), rng.uniform(0.2, 2, n)].astype(
        np.float32)
    t = torch.from_numpy
    for args, targs in (((img, px, active, cov), (t(img), t(px),
                                                   t(active), t(cov))),):
        want = jinsight.render_insight(*args)
        np.testing.assert_array_equal(insight.render_insight(*args), want)
        np.testing.assert_array_equal(insight.render_insight(*targs), want)
    for c in cov:
        assert insight.error_ellipse(t(c)) == jinsight.error_ellipse(c)
    for got in (insight.landmarks_point_cloud(mu, active, img, px),
                insight.landmarks_point_cloud(t(mu), t(active), t(img),
                                              t(px))):
        for x, y in zip(got, jinsight.landmarks_point_cloud(mu, active, img,
                                                            px)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        insight.feature_pixel_covariances(t(sigma), 100.0, 90.0, n),
        jinsight.feature_pixel_covariances(sigma, 100.0, 90.0, n))
    # the PNG writer, read back by OpenCV (which stores BGR)
    frame = insight.render_insight(img, px, active, cov)
    insight.write_png(str(tmp_path / "a.png"), frame)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "a.png"))[..., ::-1], frame)
    insight.write_png(str(tmp_path / "g.png"), img.astype(np.uint8))
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_GRAYSCALE),
        img.astype(np.uint8))


def test_frame_timer():
    logs = []
    ft = profiling.FrameTimer(log_every=2, log_fn=logs.append)
    for _ in range(4):
        with ft.frame():
            pass
    assert ft.count == 4
    assert ft.fps > 0
    assert len(logs) == 2 and "average dt" in logs[0]


def test_device_timer_and_trace(tmp_path):
    t = profiling.device_timer(lambda x: x * 2.0, torch.ones(8), warmup=1,
                               iters=3)
    assert t > 0
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(16).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def _cli(module, *argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", module, *argv],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout[r.stdout.index("{"):])


def test_cli_info_and_run_match_the_jax_cli(tmp_path):
    info, jinfo = (_cli("ekf_vio_tpu_torch", "info"),
                   _cli("ekf_vio_tpu", "info"))
    assert set(jinfo) <= set(info) and info["state_dim"] == 22 + 3 * 128
    assert info["config"] == {k: v for k, v in jinfo["config"].items()
                              if k in info["config"]}
    got = _cli("ekf_vio_tpu_torch", "run", "--synthetic", "12", "--device",
               "cpu", "--out", str(tmp_path / "t.tum"), "--checkpoint",
               str(tmp_path / "s.npz"))
    want = _cli("ekf_vio_tpu", "run", "--synthetic", "12")
    assert set(got) - {"trajectory", "checkpoint"} == set(want)
    assert got["frames"] == want["frames"] == 12
    assert got["mean_tracked"] == want["mean_tracked"]
    assert np.loadtxt(tmp_path / "t.tum").shape == (11, 8)
    # --checkpoint writes the JAX package's npz: its load_npz reads it
    jback = jcheckpoint.load_npz(str(tmp_path / "s.npz"))
    back = checkpoint.load_npz(str(tmp_path / "s.npz"), device="cpu")
    assert back.Sigma.shape == jback.Sigma.shape == (406, 406)
    for k in interop.FILTER_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jback, k)),
                                      getattr(back, k).numpy())


def test_cli_without_a_card_asks_for_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "ekf_vio_tpu_torch", "run",
                        "--synthetic", "3"], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=600)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0 and "device='cpu'" in r.stderr


def test_the_port_imports_no_jax():
    """Every module of the port imports with jax and ekf_vio_tpu blocked,
    the distributed layer's among them."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ekf_vio_tpu'] = None\n"
        "import ekf_vio_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'ekf_vio_tpu_torch.') if not m.name.endswith('__main__')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "need = {'ekf_vio_tpu_torch.parallel.' + m for m in ('mesh', "
        "'sharded_filter', 'sharded_engine', 'multihost', 'evidence')}\n"
        "assert need <= set(names), need - set(names)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('ekf_vio_tpu.')]\n"
        "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
        "print(len(names))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=dict(os.environ,
                                                     PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 35
