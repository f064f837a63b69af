"""The pyramid call of the whole-level LK (``klt_cuda.track_pyramid``, one
``klt_level`` launch per run of levels on the card) on CPU tensors, where
it runs its plain version ``klt.track_pyramid_klt_plain``.

Held against the level loop over ``track_level_klt_plain`` that
``klt.track`` ran before the kernel took every level in one launch
(bitwise: the same operations in the same order); against the JAX
package's chain of ``pallas_klt.track_level_pallas`` calls in interpret
mode (the bar of test_torch_klt_level.py: status identical, points within
2e-3 px, err within 1e-3, min_eig within rtol 1e-4 where tracked: window
sums reduce in another order, and gather sampling rounds the two taps
where the one-hot matmul accumulates them); on the number of calls
``klt.track`` makes; and on its input checks.  The kernel itself is held
against the same plain version on the card in test_torch_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_vio_tpu.frontend import pallas_klt as jpallas_klt
from ekf_vio_tpu.frontend import pyramid as jpyr
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.frontend import klt, klt_cuda, lk_cuda, pyramid
from ekf_vio_tpu_torch.sim import rendered

KW = dict(iters=30, eps=0.01, min_eigen=1e-4)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def frames():
    seq = rendered.generate(num_frames=2)
    return seq.frames[0], seq.frames[1]


def klt_case(name, n=32):
    """(level-0 points, level-0 guesses, valid) on a 320x240 frame."""
    rng = np.random.RandomState(5)
    q = np.stack([rng.uniform(20, 300, n), rng.uniform(20, 220, n)],
                 -1).astype(np.float32)
    init = q + np.float32([0.7, -0.4])
    valid = np.ones(n, bool)
    if name == "border":   # patch origins clamp into the level
        q[:6] = [(2.5, 2.5), (316.0, 120.0), (150.0, 236.5), (10.2, 200.7),
                 (305.3, 8.9), (40.0, 16.0)]
        init = q + np.float32([0.7, -0.4])
    elif name == "nan_and_invalid":
        q[7] = np.nan
        init[9] = np.nan
        valid[[7, 11, 12]] = False
    elif name == "far_guess":   # the +-5 px margin fails these at level 2
        init[::2] += np.float32([30.0, -26.0])
    elif name != "plain":
        raise KeyError(name)
    return q, init, valid


CASES = ["plain", "border", "nan_and_invalid", "far_guess"]


def _level_loop(pp, cp, prev_pts, init_pts, valid, lo, hi, win):
    """The loop ``klt.track`` ran with one ``klt_level`` call per level."""
    g = init_pts / float(2 ** hi)
    ok = valid
    for lvl in range(hi, lo - 1, -1):
        g, inb, min_eig, err = klt.track_level_klt_plain(
            pp[lvl], cp[lvl], prev_pts / float(2 ** lvl), g, ok,
            **dict(KW, win=win, min_eigen=1e-4 if lvl == 0 else -1.0))
        ok = ok & inb
        if lvl > lo:
            g = g * 2.0
    return g, ok, min_eig, err


@pytest.mark.parametrize("n", [32, 20])
@pytest.mark.parametrize("win", [17, 21])
@pytest.mark.parametrize("case", CASES)
def test_pyramid_call_equals_the_level_loop(frames, case, win, n):
    pp = pyramid.build_pyramid(_t(frames[0]), 3)
    cp = pyramid.build_pyramid(_t(frames[1]), 3)
    q, init, valid = (_t(a[:n]) for a in klt_case(case))
    cfg = VIOConfig(max_features=n, klt_window_size=win)
    before = klt_cuda.launches()
    got = klt_cuda.track_pyramid(pp, cp, q, init, valid, cfg, 0, 2)
    assert klt_cuda.launches() == before  # CPU tensors: no kernel
    ref = _level_loop(pp, cp, q, init, valid, 0, 2, win)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_np(a), _np(b))
    plain = klt.track_pyramid_klt_plain(pp, cp, q, init, valid, lo=0, hi=2,
                                        win=win, **KW)
    for a, b in zip(plain, ref):
        np.testing.assert_array_equal(_np(a), _np(b))
    if case == "nan_and_invalid":
        g, ok = _np(got[0]), _np(got[1])
        assert np.isnan(g[7]).all() and np.isnan(g[9]).all()
        assert not ok[[7, 9, 11, 12]].any()
    if case == "far_guess":
        assert 0 < _np(got[1]).sum() < n
    else:
        assert _np(got[1]).sum() >= 0.6 * n


@pytest.mark.parametrize("lo,hi", [(1, 2), (2, 2), (0, 0)])
def test_partial_runs_equal_the_level_loop(frames, lo, hi):
    """Runs that do not reach level 0 gate no eigenvalue; a one-level run
    is ``track_level_klt_plain`` with ``valid`` ANDed in."""
    pp = pyramid.build_pyramid(_t(frames[0]), 3)
    cp = pyramid.build_pyramid(_t(frames[1]), 3)
    q, init, valid = (_t(a) for a in klt_case("nan_and_invalid"))
    cfg = VIOConfig(max_features=32, klt_window_size=17,
                    klt_min_eigen=1e9)   # a gate that fails every feature
    got = klt_cuda.track_pyramid(pp, cp, q, init, valid, cfg, lo, hi)
    g = init / float(2 ** hi)
    ok = valid
    for lvl in range(hi, lo - 1, -1):
        g, inb, min_eig, err = klt.track_level_klt_plain(
            pp[lvl], cp[lvl], q / float(2 ** lvl), g, ok, win=17, iters=30,
            eps=0.01, min_eigen=1e9 if lvl == 0 else -1.0)
        ok = ok & inb
        if lvl > lo:
            g = g * 2.0
    for a, b in zip(got, (g, ok, min_eig, err)):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert _np(got[1]).any() == (lo > 0)


def _jax_chain(prev, cur, q, init, valid, win, levels=3):
    """The JAX package's level chain under the 'pallas_klt' rule on levels
    2-0 (klt.py:318-339), the Pallas kernel in interpret mode."""
    pp = jpyr.build_pyramid(jnp.asarray(prev), levels)
    cp = jpyr.build_pyramid(jnp.asarray(cur), levels)
    g = jnp.asarray(init) / 4.0
    ok = jnp.asarray(valid)
    for lvl in (2, 1, 0):
        g, min_eig, err, inb = jpallas_klt.track_level_pallas(
            pp[lvl], cp[lvl], jnp.asarray(q) / float(2 ** lvl), g, ok,
            win=win, iters=30, eps=0.01,
            min_eigen=1e-4 if lvl == 0 else -1.0, interpret=True)
        ok = ok & inb
        if lvl > 0:
            g = g * 2.0
    return g, ok, min_eig, err


@pytest.mark.parametrize("case,win", [("plain", 17), ("border", 17),
                                      ("nan_and_invalid", 17),
                                      ("plain", 21)])
def test_pyramid_call_matches_the_jax_chain(frames, case, win):
    q, init, valid = klt_case(case)
    pp = pyramid.build_pyramid(_t(frames[0]), 3)
    cp = pyramid.build_pyramid(_t(frames[1]), 3)
    g, ok, eig, err = klt_cuda.track_pyramid(
        pp, cp, _t(q), _t(init), _t(valid),
        VIOConfig(max_features=32, klt_window_size=win), 0, 2)
    rg, rok, reig, rerr = (_np(x) for x in _jax_chain(
        frames[0], frames[1], q, init, valid, win))
    ok = _np(ok)
    np.testing.assert_array_equal(ok, rok)
    assert ok.sum() >= 20
    assert np.abs(_np(g) - rg)[ok].max() <= 2e-3
    np.testing.assert_allclose(_np(err)[ok], rerr[ok], atol=1e-3)
    np.testing.assert_allclose(_np(eig)[ok], reig[ok], rtol=1e-4)
    np.testing.assert_array_equal(np.isfinite(_np(g)), np.isfinite(rg))


@pytest.mark.parametrize("n", [32, 128])
def test_track_makes_one_call_per_kernel(frames, monkeypatch, n):
    """Under the 'pallas_klt' rule at 320x240 ``klt.track`` makes exactly
    one ``lk_cuda`` pyramid call (level 3 alone) and one ``klt_cuda``
    pyramid call (levels 2-0)."""
    calls = []
    real_lk, real_klt = lk_cuda.track_pyramid, klt_cuda.track_pyramid

    def lk(*a):
        calls.append(("lk", a[-2], a[-1]))
        return real_lk(*a)

    def kl(*a):
        calls.append(("klt", a[-2], a[-1]))
        return real_klt(*a)

    monkeypatch.setattr(lk_cuda, "track_pyramid", lk)
    monkeypatch.setattr(klt_cuda, "track_pyramid", kl)
    q, init, valid = (_t(a) for a in klt_case("plain", n))
    pp = pyramid.build_pyramid(_t(frames[0]), 3)
    cp = pyramid.build_pyramid(_t(frames[1]), 3)
    cfg = VIOConfig(max_features=n, klt_window_size=17)
    assert klt.selected_backend((240, 320), n, cfg, "cuda") == "cuda_klt"
    res = klt.track(pp, cp, q, init, valid, cfg)
    assert calls == [("lk", 3, 3), ("klt", 0, 2)]
    assert _np(res.status).sum() >= 0.6 * n
    # the 21-px window at the same size: every level in one lk call
    calls.clear()
    klt.track(pp, cp, q, init, valid, VIOConfig(max_features=n))
    assert calls == [("lk", 0, 3)]


def test_a_run_longer_than_the_kernel_takes_is_split():
    """At 640x480 with a 9-px window the klt rule takes levels 0-3 and
    4 (40x30) is lk_level's: with MAX_LEVELS = 4 that is two calls; a
    5-level klt run would be split at MAX_LEVELS."""
    import scipy.ndimage as ndi

    rng = np.random.RandomState(8)
    img = ndi.gaussian_filter(rng.uniform(0, 255, (480, 640)), 1.5)
    prev = img.astype(np.float32)
    cur = ndi.shift(img, (1.2, -2.1), order=3, mode="nearest").astype(
        np.float32)
    q = rng.uniform(40, 440, (32, 2)).astype(np.float32)
    pp = pyramid.build_pyramid(_t(prev), 4)
    cp = pyramid.build_pyramid(_t(cur), 4)
    cfg = VIOConfig(max_features=32, klt_window_size=9,
                    klt_max_pyramid_level=4)
    assert [klt.klt_supported(p.shape, 32) for p in pp] == [
        True, True, True, True, False]
    v = torch.ones(32, dtype=torch.bool)
    res = klt.track(pp, cp, _t(q), _t(q), v, cfg)
    # the level loop: lk_level's plain version at level 4, then 3..0
    g, ok, _, _ = klt.track_level_plain(
        pp[4], cp[4], _t(q) / 16.0, _t(q) / 16.0, v, win=9, iters=30,
        eps=0.01, min_eigen=1e-4, gate_eig=False)
    ref = _level_loop(pp, cp, _t(q), g * 16.0, ok, 0, 3, 9)
    for a, b in zip((res.points, res.status, res.min_eig, res.error), ref):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert _np(res.status).sum() >= 20


def test_bad_inputs_raise(frames):
    pp = pyramid.build_pyramid(_t(frames[0]), 3)
    cp = pyramid.build_pyramid(_t(frames[1]), 3)
    q, init, valid = (_t(a) for a in klt_case("plain"))
    cfg = VIOConfig(max_features=32, klt_window_size=17)
    before = klt_cuda.launches()
    with pytest.raises(ValueError, match="40x40"):   # level 3 is 40x30
        klt_cuda.track_pyramid(pp, cp, q, init, valid, cfg, 0, 3)
    with pytest.raises(ValueError, match="outside"):
        klt_cuda.track_pyramid(pp, cp[:2], q, init, valid, cfg, 0, 2)
    with pytest.raises(ValueError, match="window"):
        klt_cuda.track_pyramid(pp, cp, q, init, valid,
                               cfg.replace(klt_window_size=41), 0, 2)
    with pytest.raises(ValueError, match="contiguous"):
        klt_cuda.track_pyramid(pp, cp, _t(_np(q).T.copy()).T, init, valid,
                               cfg, 0, 2)
    with pytest.raises(ValueError, match="float32"):
        klt_cuda.track_pyramid(pp, cp, q.double(), init, valid, cfg, 0, 2)
    with pytest.raises(ValueError, match="bool"):
        klt_cuda.track_pyramid(pp, cp, q, init, valid.to(torch.uint8), cfg,
                               0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        klt_cuda.track_pyramid_cuda(pp, cp, q, init, valid, lo=0, hi=2,
                                    win=17, **KW)
    with pytest.raises(ValueError, match="CUDA"):
        klt_cuda.track_level_cuda(pp[0], cp[0], q, init, valid, win=17, **KW)
    assert klt_cuda.launches() == before
