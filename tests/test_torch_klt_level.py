"""The whole-level LK of the port (``klt.track_level_klt_plain``, the plain
version of the ``klt_level`` CUDA kernel) against the JAX package's
``pallas_klt.track_level_pallas`` in interpret mode on the CPU, the
pyramid ``track`` under the klt rule against a level loop built here from
the JAX functions, and the dispatch rule against the JAX envelopes.

Bars: status identical; points within 2e-3 px, err within 1e-3 and
min_eig within rtol 1e-4 where tracked (window sums reduce in another
order; the gather sampling rounds the two taps where the one-hot matmul
accumulates them).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.frontend import klt as jklt
from ekf_vio_tpu.frontend import pallas_klt as jpallas_klt
from ekf_vio_tpu.frontend import pallas_lk as jpallas_lk
from ekf_vio_tpu.frontend import pyramid as jpyr
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.frontend import klt, klt_cuda, lk_cuda, pyramid
from ekf_vio_tpu_torch.sim import rendered


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _scene(h=128, w=192, n=32):
    """tests/test_pallas_kernels.py's TestPallasKLT scene."""
    import scipy.ndimage as ndi

    rng = np.random.RandomState(3)
    img = ndi.gaussian_filter(rng.uniform(0, 255, (h, w)), 1.5)
    img2 = ndi.shift(img, (0.8, -1.4), order=3, mode="nearest")
    q = rng.uniform(30, min(h, w) - 30, (n, 2)).astype(np.float32)
    return img.astype(np.float32), img2.astype(np.float32), q


def _rendered_pair(n=32, border=True):
    """Rendered frames 0 and 1 at 320x240 with n seeds on texture; with
    ``border`` the first rows sit within 17 px of the frame border, so
    their patch origins clamp."""
    seq = rendered.generate(num_frames=2)
    rng = np.random.RandomState(5)
    q = np.stack([rng.uniform(20, 300, n), rng.uniform(20, 220, n)],
                 -1).astype(np.float32)
    if border:
        q[:6] = [(2.5, 2.5), (316.0, 120.0), (150.0, 236.5), (10.2, 200.7),
                 (305.3, 8.9), (40.0, 16.0)]
    return seq.frames[0], seq.frames[1], q


def _assert_level(got, ref, tracked_at_least):
    g, ok, eig, err = (_np(x) for x in got)
    rg, reig, rerr, rok = (_np(x) for x in ref)
    np.testing.assert_array_equal(ok, rok)
    assert ok.sum() >= tracked_at_least
    assert np.abs(g - rg)[ok].max() <= 2e-3
    np.testing.assert_allclose(err[ok], rerr[ok], atol=1e-3)
    np.testing.assert_allclose(eig[ok], reig[ok], rtol=1e-4)
    # invalid, NaN and untracked rows: same finiteness
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(rg))


KW = dict(iters=30, eps=0.01, min_eigen=1e-4)


@pytest.mark.parametrize("case", ["scene_w21", "scene_w17", "rendered_w17",
                                  "nan_and_invalid", "coarse_gate_off"])
def test_plain_level_matches_pallas_klt(case):
    win = 21 if case == "scene_w21" else 17
    min_eigen = -1.0 if case == "coarse_gate_off" else 1e-4
    if case.startswith("scene"):
        prev, cur, q = _scene()
        init = q
    else:
        prev, cur, q = _rendered_pair()
        init = q + np.float32([0.7, -0.4])
    valid = np.ones(q.shape[0], bool)
    if case == "nan_and_invalid":
        q = q.copy()
        q[7] = np.nan
        init = init.copy()
        init[9] = np.nan
        valid[[7, 11, 12]] = False
    kw = dict(KW, win=win, min_eigen=min_eigen)
    t = torch.from_numpy
    got = klt.track_level_klt_plain(t(prev), t(cur), t(q), t(init),
                                    t(valid), **kw)
    ref = jpallas_klt.track_level_pallas(
        jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(q),
        jnp.asarray(init), jnp.asarray(valid), interpret=True, **kw)
    _assert_level(got, ref, tracked_at_least=20)
    if case == "nan_and_invalid":
        g = _np(got[0])
        assert np.isnan(g[7]).all() and np.isnan(g[9]).all()
        np.testing.assert_array_equal(g[[11, 12]], init[[11, 12]])


def test_plain_level_takes_any_n():
    """N off the 32-block grid (the kernel masks its tail): each row is
    the same as in the padded 32-row call."""
    prev, cur, q = _rendered_pair(border=False)
    t = torch.from_numpy
    v = torch.ones(32, dtype=torch.bool)
    full = klt.track_level_klt_plain(t(prev), t(cur), t(q), t(q), v,
                                     win=17, **KW)
    part = klt.track_level_klt_plain(t(prev), t(cur), t(q[:20]), t(q[:20]),
                                     v[:20], win=17, **KW)
    for a, b in zip(part, full):
        np.testing.assert_array_equal(_np(a), _np(b)[:20])


def _jax_klt_track(prev_pyr, cur_pyr, prev_pts, init_pts, valid, cfg):
    """klt.py:318-339 under the 'pallas_klt' rule, built from the JAX
    level functions (the Pallas kernel in interpret mode)."""
    win = cfg.klt_window_size
    top = max(lvl for lvl in range(len(prev_pyr))
              if min(prev_pyr[lvl].shape) >= win)
    g = init_pts / float(2 ** top)
    ok = valid
    for lvl in range(top, -1, -1):
        q = prev_pts / float(2 ** lvl)
        if jpallas_klt.supported(prev_pyr[lvl].shape, q.shape[0]):
            g, min_eig, err, inb = jpallas_klt.track_level_pallas(
                prev_pyr[lvl], cur_pyr[lvl], q, g, ok, win=win,
                iters=cfg.klt_iterations, eps=cfg.klt_eps,
                min_eigen=cfg.klt_min_eigen if lvl == 0 else -1.0,
                interpret=True)
        else:
            g, min_eig, err, inb = jklt._track_level(
                prev_pyr[lvl], cur_pyr[lvl], q, g, ok, cfg)
            if lvl == 0:
                inb = inb & (min_eig > cfg.klt_min_eigen)
        ok = ok & inb
        if lvl > 0:
            g = g * 2.0
    return g, ok, err, min_eig


def test_track_under_the_klt_rule_matches_jax_level_loop():
    prev, cur, q = _rendered_pair()
    init = q + np.float32([1.3, -0.9])
    valid = np.ones(32, bool)
    valid[3] = False
    cfg = VIOConfig(max_features=32, klt_window_size=17)
    jcfg = JConfig(max_features=32, klt_window_size=17)
    assert klt.selected_backend((240, 320), 32, cfg, "cpu") == "torch_klt"
    assert klt.selected_backend((240, 320), 32, cfg, "cuda") == "cuda_klt"

    pp = pyramid.build_pyramid(torch.from_numpy(prev), 3)
    cp = pyramid.build_pyramid(torch.from_numpy(cur), 3)
    before = (klt_cuda.launches, lk_cuda.launches)
    got = klt.track(pp, cp, torch.from_numpy(q), torch.from_numpy(init),
                    torch.from_numpy(valid), cfg)
    assert (klt_cuda.launches, lk_cuda.launches) == before  # CPU: no kernel
    ref = _jax_klt_track(jpyr.build_pyramid(jnp.asarray(prev), 3),
                         jpyr.build_pyramid(jnp.asarray(cur), 3),
                         jnp.asarray(q), jnp.asarray(init),
                         jnp.asarray(valid), jcfg)
    ok, rok = _np(got.status), _np(ref[1])
    np.testing.assert_array_equal(ok, rok)
    assert ok.sum() >= 20
    assert np.abs(_np(got.points) - _np(ref[0]))[ok].max() <= 2e-3
    np.testing.assert_allclose(_np(got.error)[ok], _np(ref[2])[ok],
                               atol=1e-3)
    np.testing.assert_allclose(_np(got.min_eig)[ok], _np(ref[3])[ok],
                               rtol=1e-4)


SHAPES = [(120, 160), (240, 320), (256, 256), (255, 256), (480, 640),
          (30, 40), (40, 30), (960, 1280), (800, 960)]


@pytest.mark.parametrize("win", [21, 17])
@pytest.mark.parametrize("n", [32, 100, 128])
def test_dispatch_rule_matches_jax_envelopes(win, n):
    for use in (True, False):
        cfg = VIOConfig(max_features=n, klt_window_size=win,
                        use_pallas_klt=use)
        for shape in SHAPES:
            if use and jpallas_lk.supported(shape, n, win):
                want = "pallas_lk"
            elif use and shape[0] * shape[1] >= 64 * 1024:
                want = "pallas_klt"
            else:
                want = "xla"
            assert klt.tracker_rule(shape, n, cfg) == want, (shape, use)
            assert klt.klt_supported(shape, n) == jpallas_klt.supported(
                shape, n), shape
            kind = "klt" if want == "pallas_klt" else "lk"
            assert klt.selected_backend(shape, n, cfg, "cpu") == f"torch_{kind}"


def test_wrapper_checks_and_cpu_dispatch():
    prev, cur, q = _scene()
    t = torch.from_numpy
    v = torch.ones(32, dtype=torch.bool)
    before = klt_cuda.launches
    got = klt_cuda.track_level(t(prev), t(cur), t(q), t(q), v, win=17, **KW)
    ref = klt.track_level_klt_plain(t(prev), t(cur), t(q), t(q), v, win=17,
                                    **KW)
    assert klt_cuda.launches == before
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_np(a), _np(b))
    with pytest.raises(ValueError):
        klt_cuda.track_level_cuda(t(prev), t(cur), t(q), t(q), v, win=17,
                                  **KW)
