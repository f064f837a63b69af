"""The pyramid LK call of the port (``lk_cuda.track_pyramid``, one
``lk_level`` launch per run of levels on the card) on CPU tensors, where it
runs its plain twin ``klt.track_pyramid_plain``.

Held against the level loop that ``klt.track`` ran before the kernel took
every level in one launch (bitwise: the same operations in the same
order), against the JAX package's ``klt.track`` (xla rule, the bar of
test_torch_frontend.py: status identical, points within 2e-3 px, err
within 1e-3 + 1e-3 relative, min_eig within rtol 1e-4), and on its input
checks.  The kernel itself is held against the same twin on the card in
test_torch_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.frontend import klt as jklt
from ekf_vio_tpu.frontend import pyramid as jpyr
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.frontend import klt, klt_cuda, lk_cuda, pyramid
from ekf_vio_tpu_torch.sim import rendered
from test_torch_kernels import LK_CASES, _scene, lk_case


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pyramids(prev, cur, levels):
    return (pyramid.build_pyramid(_t(prev), levels),
            pyramid.build_pyramid(_t(cur), levels))


def _level_loop(pp, cp, prev_pts, init_pts, valid, cfg):
    """``klt.track`` as it ran one kernel launch per level: the top level
    is the coarsest at least as large as the window, each level runs
    ``klt_level`` where the klt rule takes it and ``lk_level`` otherwise,
    and the guess doubles between levels."""
    win = cfg.klt_window_size
    n = prev_pts.shape[0]
    top = max(lvl for lvl, img in enumerate(pp) if min(img.shape) >= win)
    use_klt = klt.tracker_rule(pp[0].shape, n, cfg) == "pallas_klt"
    g = init_pts / float(2 ** top)
    ok = valid
    for lvl in range(top, -1, -1):
        q = prev_pts / float(2 ** lvl)
        kw = dict(win=win, iters=cfg.klt_iterations, eps=cfg.klt_eps)
        if use_klt and klt.klt_supported(pp[lvl].shape, n):
            g, inb, min_eig, err = klt.track_level_klt_plain(
                pp[lvl], cp[lvl], q, g, ok, **kw,
                min_eigen=cfg.klt_min_eigen if lvl == 0 else -1.0)
            ok = ok & inb
        else:
            g, ok, min_eig, err = klt.track_level_plain(
                pp[lvl], cp[lvl], q, g, ok, **kw,
                min_eigen=cfg.klt_min_eigen, gate_eig=lvl == 0)
        if lvl > 0:
            g = g * 2.0
    return g, ok, min_eig, err


def _assert_bitwise(got, ref):
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("case", LK_CASES)
def test_pyramid_call_equals_the_level_loop(case):
    prev, cur, q, init, valid, levels = lk_case(case)
    pp, cp = _pyramids(prev, cur, levels)
    cfg = VIOConfig(max_features=q.shape[0])
    before = lk_cuda.launches()
    got = lk_cuda.track_pyramid(pp, cp, _t(q), _t(init), _t(valid), cfg,
                                0, levels)
    ref = _level_loop(pp, cp, _t(q), _t(init), _t(valid), cfg)
    _assert_bitwise(got, ref)
    res = klt.track(pp, cp, _t(q), _t(init), _t(valid), cfg)
    _assert_bitwise((res.points, res.status, res.min_eig, res.error), ref)
    assert lk_cuda.launches() == before  # CPU tensors: no kernel


@pytest.mark.parametrize("case", ["translation", "seeded_flow", "borders",
                                  "invalid_nan", "n100"])
def test_pyramid_call_matches_jax_track(case):
    prev, cur, q, init, valid, levels = lk_case(case)
    n = q.shape[0]
    pp, cp = _pyramids(prev, cur, levels)
    g, ok, min_eig, err = lk_cuda.track_pyramid(
        pp, cp, _t(q), _t(init), _t(valid), VIOConfig(max_features=n), 0,
        levels)
    ref = jklt.track(jpyr.build_pyramid(jnp.asarray(prev), levels),
                     jpyr.build_pyramid(jnp.asarray(cur), levels),
                     jnp.asarray(q), jnp.asarray(init), jnp.asarray(valid),
                     JConfig(max_features=n))
    ok, rok = _np(ok), _np(ref.status)
    np.testing.assert_array_equal(ok, rok)
    assert ok.sum() >= 0.5 * valid.sum()
    assert np.abs(_np(g) - _np(ref.points))[ok].max() <= 2e-3
    np.testing.assert_allclose(_np(err)[ok], _np(ref.error)[ok], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(_np(min_eig)[ok], _np(ref.min_eig)[ok],
                               rtol=1e-4)


@pytest.mark.parametrize("level", [3, 0])
def test_one_level_call_equals_track_level_plain(level):
    """lo == hi: the guess and the points at that level's scale, the
    min-eigenvalue gate only at level 0 (path (b) runs level 3 alone)."""
    seq = rendered.generate(num_frames=2)
    rng = np.random.RandomState(5)
    q = np.stack([rng.uniform(20, 300, 64), rng.uniform(20, 220, 64)],
                 -1).astype(np.float32)
    init = q + np.float32([1.1, -0.7])
    valid = np.ones(64, bool)
    valid[[2, 7]] = False
    pp, cp = _pyramids(seq.frames[0], seq.frames[1], 3)
    cfg = VIOConfig(max_features=64, klt_window_size=17)
    got = lk_cuda.track_pyramid(pp, cp, _t(q), _t(init), _t(valid), cfg,
                                level, level)
    s = float(2 ** level)
    ref = klt.track_level_plain(pp[level], cp[level], _t(q) / s, _t(init) / s,
                                _t(valid), win=17, iters=30, eps=0.01,
                                min_eigen=1e-4, gate_eig=level == 0)
    _assert_bitwise(got, ref)
    assert _np(got[1]).sum() >= 40


def test_track_splits_levels_into_runs():
    """A 6-level pyramid at an 11-px window is two lk_level calls (4 + 2
    levels); a 1280x960 level 0 under the klt rule (above 6 MB per level
    pair) runs lk_level below three klt_level levels.  Both equal the
    level loop bitwise: the guess crosses a call boundary scaled to level
    0 and back by powers of two."""
    prev, cur, q = _scene(h=480, w=640, n=32, shift=(1.2, -2.1), seed=8)
    pp, cp = _pyramids(prev, cur, 5)
    cfg = VIOConfig(max_features=32, klt_window_size=11)
    assert min(pp[5].shape) >= 11
    v = torch.ones(32, dtype=torch.bool)
    res = klt.track(pp, cp, _t(q), _t(q), v, cfg)
    ref = _level_loop(pp, cp, _t(q), _t(q), v, cfg)
    _assert_bitwise((res.points, res.status, res.min_eig, res.error), ref)
    assert _np(res.status).sum() >= 24

    prev, cur, q = _scene(h=960, w=1280, n=32, shift=(0.9, -1.3), seed=9)
    pp, cp = _pyramids(prev, cur, 3)
    cfg = VIOConfig(max_features=32, klt_window_size=17)
    assert klt.tracker_rule(pp[0].shape, 32, cfg) == "pallas_klt"
    assert [klt.klt_supported(p.shape, 32) for p in pp] == [False, True,
                                                            True, True]
    before = (lk_cuda.launches(), klt_cuda.launches())
    res = klt.track(pp, cp, _t(q), _t(q), v, cfg)
    assert (lk_cuda.launches(), klt_cuda.launches()) == before
    ref = _level_loop(pp, cp, _t(q), _t(q), v, cfg)
    _assert_bitwise((res.points, res.status, res.min_eig, res.error), ref)
    assert _np(res.status).sum() >= 24


def test_bad_inputs_raise():
    prev, cur, q, init, valid, _ = lk_case("translation")
    pp, cp = _pyramids(prev, cur, 4)
    cfg = VIOConfig(max_features=32)
    args = (_t(q), _t(init), _t(valid))
    before = lk_cuda.launches()
    with pytest.raises(ValueError, match="at most"):  # 5 > MAX_LEVELS
        lk_cuda.track_pyramid(pp, cp, *args, cfg, 0, lk_cuda.MAX_LEVELS)
    with pytest.raises(ValueError, match="outside"):
        lk_cuda.track_pyramid(pp, cp[:2], *args, cfg, 0, 2)
    with pytest.raises(ValueError, match="equal"):
        lk_cuda.track_pyramid(pp, [c.T.contiguous() for c in cp], *args,
                              cfg, 0, 2)
    with pytest.raises(ValueError, match="contiguous"):
        lk_cuda.track_pyramid(pp, cp, _t(q.T.copy()).T, *args[1:], cfg, 0,
                              2)
    with pytest.raises(ValueError, match="float32"):
        lk_cuda.track_pyramid(pp, cp, args[0].double(), *args[1:], cfg, 0,
                              2)
    with pytest.raises(ValueError, match="bool"):
        lk_cuda.track_pyramid(pp, cp, *args[:2], args[2].to(torch.uint8),
                              cfg, 0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        lk_cuda.track_pyramid_cuda(pp, cp, *args, lo=0, hi=2, win=21,
                                   iters=30, eps=0.01, min_eigen=1e-4)
    assert lk_cuda.launches() == before
