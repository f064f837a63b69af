"""The generator: one seed, one session; EuRoC's rates; frames the port
can track."""
import json
from pathlib import Path

import torch

from portbench.tests._tiny import ROOT, patch
from portbench.traffic.generate import make_session

HERE = ROOT / "portbench"


class _Cell:
    def __init__(self, config, traffic):
        self.config = json.loads((HERE / "configs" / f"{config}.json").read_text())
        self.traffic = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())


def _small(config="euroc_mono_inertial", traffic="euroc_stream"):
    c = _Cell(config, traffic)
    patch(c)
    return c


def test_one_seed_one_session_and_seeds_differ():
    c = _small()
    a = make_session(c.config, c.traffic, 2 ** 31 + 11, 6, "cpu")
    b = make_session(c.config, c.traffic, 2 ** 31 + 11, 6, "cpu")
    other = make_session(c.config, c.traffic, 2 ** 31 + 12, 6, "cpu")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["frames"], other["frames"])
    assert not torch.equal(a["imu_gyro"], other["imu_gyro"])
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in other.items()}


def test_euroc_rates():
    cfg = json.loads((HERE / "configs" / "euroc_mono_inertial.json").read_text())
    assert (cfg["camera"]["width"], cfg["camera"]["height"]) == (376, 240)
    c = _small()
    s = make_session(c.config, c.traffic, 5, 5, "cpu")
    assert torch.allclose(s["times"][1:] - s["times"][:-1], torch.tensor(0.05))
    assert s["imu_dt"].shape == (4, 10)
    assert torch.allclose(s["imu_dt"].sum(1), torch.tensor(0.05))
    assert s["imu_gyro"].shape == s["imu_accel"].shape == (4, 10, 3)
    # gravity along -y of the first camera; the accelerometer reads about
    # +9.81 m/s^2 on y, plus the trajectory's own ~0.2 m/s^2
    assert torch.equal(s["gravity_w"], torch.tensor([0.0, -9.81, 0.0]))
    assert abs(float(s["imu_accel"][0, :, 1].mean()) - 9.81) < 0.5


def test_the_port_tracks_the_generated_frames():
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.config import VIOConfig
    from ekf_vio_tpu_torch.frontend.camera import Camera

    c = _small()
    s = make_session(c.config, c.traffic, 2 ** 31 + 99, 16, "cpu")
    cfg = VIOConfig(**c.config["vio"])
    k = c.config["camera"]
    cam = Camera(k["fx"], k["fy"], k["cx"], k["cy"], k["width"], k["height"])
    _, outs = engine.run_sequence_imu(
        s["frames"], s["times"], s["imu_dt"], s["imu_gyro"], s["imu_accel"],
        s["gravity_w"], cfg, cam, init_frames=cfg.vi_init_frames, device="cpu")
    assert int(outs.num_tracked[4:].min()) > 10
