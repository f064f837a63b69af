"""The tracking bound never exceeds what the plain tracker does for the
same inputs, so a share of it cannot read above 100 %."""
import torch

from portbench.roofline import track as roof
from portbench.tests.test_portbench_traffic import _small
from portbench.traffic.generate import make_session


def _plain_work(prev_pyr, cur_pyr, px, seed, valid, cfg, shapes):
    """(bytes, flops) the plain tracker spends level by level: the
    distinct pixels of its patches (side win + 11) in both images at the
    rows it tracks, and per tracked row the gradients, template and
    Hessian plus 11 a window pixel for every iteration."""
    from ekf_vio_tpu_torch.frontend import klt

    win, p = cfg.klt_window_size, cfg.klt_window_size + 11
    top = len(shapes) - 1
    g, ok = seed / float(2 ** top), valid
    nbytes = flops = 0
    for lvl in range(top, -1, -1):
        q = px / float(2 ** lvl)
        live = ok.clone()
        nbytes += 4 * (roof._union_pixels(q[live], shapes[lvl], p)
                       + roof._union_pixels(g[live], shapes[lvl], p))
        flops += int(live.sum()) * (12 * (win + 1) ** 2 + 33 * win * win
                                    + 11 * win * win * cfg.klt_iterations)
        g, ok, _, _ = klt.track_level_plain(
            prev_pyr[lvl], cur_pyr[lvl], q, g, ok, win=win,
            iters=cfg.klt_iterations, eps=cfg.klt_eps,
            min_eigen=cfg.klt_min_eigen, gate_eig=lvl == 0)
        if lvl > 0:
            g = g * 2.0
    return nbytes, flops, g, ok


def test_bound_is_below_the_plain_trackers_work():
    from ekf_vio_tpu_torch.config import VIOConfig
    from ekf_vio_tpu_torch.frontend import pyramid, replenish

    c = _small()
    cam = c.config["camera"]
    cfg = VIOConfig(**c.config["vio"])
    s = make_session(c.config, c.traffic, 2 ** 31 + 3, 2, "cpu")
    n = cfg.max_features
    px, valid = replenish.replenish(s["frames"][0], torch.zeros(n, 2),
                                    torch.zeros(n, dtype=torch.bool), cfg, n)
    pp = pyramid.build_pyramid(s["frames"][0], cfg.klt_max_pyramid_level)
    cp = pyramid.build_pyramid(s["frames"][1], cfg.klt_max_pyramid_level)
    shapes = roof.level_shapes(cam["height"], cam["width"],
                               cfg.klt_max_pyramid_level, cfg.klt_window_size)
    assert len(shapes) >= 2 and int(valid.sum()) > 10
    real_b, real_f, pts, ok = _plain_work(pp, cp, px, px, valid, cfg, shapes)
    b, f = roof.work(px, pts, ok, int(valid.sum()), shapes, cfg.klt_window_size)
    assert 0 < b <= real_b and 0 < f <= real_f
    # a feature that fails is charged no window and no iteration
    b0, f0 = roof.work(px, pts, torch.zeros_like(ok), int(valid.sum()), shapes,
                       cfg.klt_window_size)
    assert f0 == 0 and b0 == int(valid.sum()) * roof.IO_BYTES_PER_FEATURE
    assert roof.bound_s(b, f, "NVIDIA H100 80GB HBM3") > 0


def test_level_shapes_skip_levels_smaller_than_the_window():
    assert roof.level_shapes(240, 376, 3, 21) == [(240, 376), (120, 188),
                                                  (60, 94), (30, 47)]
    assert roof.level_shapes(120, 188, 3, 21) == [(120, 188), (60, 94), (30, 47)]
