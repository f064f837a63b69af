"""The CUDA kernels of ekf_vio_tpu_torch against their plain PyTorch twins
on the same CUDA tensors.  Every test here needs a card and skips without
one; the file imports no JAX (the scenes below are numpy from a seed), so
on a machine with a card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Bars: lk_level and klt_level (one level per launch, and a whole pyramid
per launch) — status identical, points within 2e-3 px, err within 1e-2 and
min_eig within rtol 1e-3 where tracked (window sums reduce in another
order), the same finiteness of every point; fast9 — bitwise on
integer-valued frames, 1e-4 otherwise, at both margin orders, also on
sides off the tile grid.
"""
import numpy as np
import pytest
import torch

from ekf_vio_tpu_torch.frontend import (fast, fast_cuda, klt, klt_cuda,
                                        lk_cuda, pyramid)


def _np(x):
    return x.detach().cpu().numpy()


# Scenes made with numpy from a seed; test_torch_frontend.py shares them.

def blocks(h=120, w=160, seed=0, n=40):
    """Integer-valued frame of bright squares on black (FAST-rich)."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w), np.float32)
    for _ in range(n):
        y, x = rng.randint(4, h - 12), rng.randint(4, w - 12)
        img[y: y + rng.randint(4, 9), x: x + rng.randint(4, 9)] = rng.randint(
            60, 250)
    return img


def textured(h=120, w=160, seed=1):
    import scipy.ndimage as ndi

    rng = np.random.RandomState(seed)
    return (ndi.gaussian_filter(rng.uniform(0, 255, (h, w)), 1.5)
            .astype(np.float32))


def _scene(h=128, w=192, n=32, shift=(1.6, -2.4), shear=0.0, seed=3):
    """tests/test_pallas_lk.py's scene: cur = prev translated by `shift`
    (dy, dx), optionally sheared; n feature positions on texture."""
    import scipy.ndimage as ndi

    rng = np.random.RandomState(seed)
    img = ndi.gaussian_filter(rng.uniform(0, 255, (h, w)), 1.5)
    if shear:
        mat = np.array([[1.0, shear], [0.0, 1.0]])
        img2 = ndi.affine_transform(img, mat, order=3, mode="nearest")
        img2 = ndi.shift(img2, shift, order=3, mode="nearest")
    else:
        img2 = ndi.shift(img, shift, order=3, mode="nearest")
    q = rng.uniform(25, min(h, w) - 25, (n, 2)).astype(np.float32)
    return img.astype(np.float32), img2.astype(np.float32), q


def lk_case(name):
    """(prev, cur, q, init, valid, levels) of each tests/test_pallas_lk.py
    case."""
    valid = np.ones(32, bool)
    if name == "translation":
        prev, cur, q = _scene()
        return prev, cur, q, q, valid, 2
    if name == "shear":
        prev, cur, q = _scene(shear=0.04, shift=(0.7, 1.1))
        return prev, cur, q, q, valid, 2
    if name == "seeded_flow":
        prev, cur, q = _scene(shift=(3.0, -3.5))
        return prev, cur, q, q + np.float32([-3.5, 3.0]), valid, 2
    if name == "borders":
        prev, cur, q = _scene(shift=(0.0, -4.0))
        q = q.copy()
        q[:4] = [(2.0, 2.0), (189.0, 125.0), (3.0, 64.0), (96.0, 2.5)]
        return prev, cur, q, q, valid, 2
    if name == "margin_loss":
        prev, cur, q = _scene(shift=(0.0, 0.0))
        return prev, cur, q, q + np.float32([14.0, 0.0]), valid, 0
    if name == "flat":
        _, _, q = _scene()
        flat = np.full((128, 192), 80.0, np.float32)
        return flat, flat, q, q, valid, 2
    if name == "invalid_nan":
        prev, cur, q = _scene()
        q = q.copy()
        q[5] = q[9] = np.nan
        valid[[5, 9, 11]] = False
        return prev, cur, q, q, valid, 2
    if name == "n100":
        prev, cur, q = _scene(n=100, seed=4)
        return prev, cur, q, q, np.ones(100, bool), 2
    raise KeyError(name)


LK_CASES = ["translation", "shear", "seeded_flow", "borders", "margin_loss",
            "flat", "invalid_nan", "n100"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
class TestKernelsOnCard:
    """Each kernel and its plain twin on the same CUDA tensors."""

    @pytest.mark.parametrize("case", LK_CASES)
    def test_lk_kernel_matches_plain_twin(self, cuda, case):
        prev, cur, q, init, valid, levels = lk_case(case)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
        pp = pyramid.build_pyramid(t(prev), levels)
        cp = pyramid.build_pyramid(t(cur), levels)
        for lvl in range(levels + 1):
            s = float(2 ** lvl)
            args = (pp[lvl], cp[lvl], t(q) / s, t(init) / s, t(valid))
            kw = dict(win=21, iters=30, eps=0.01, min_eigen=1e-4,
                      gate_eig=lvl == 0)
            g, ok, eig, err = lk_cuda.track_level_cuda(*args, **kw)
            rg, rok, reig, rerr = klt.track_level_plain(*args, **kw)
            np.testing.assert_array_equal(_np(ok), _np(rok))
            both = _np(ok)
            if both.any():
                assert np.abs(_np(g) - _np(rg))[both].max() <= 2e-3
                np.testing.assert_allclose(_np(err)[both], _np(rerr)[both],
                                           atol=1e-2)
                np.testing.assert_allclose(_np(eig)[both], _np(reig)[both],
                                           rtol=1e-3)

    @pytest.mark.parametrize("case", LK_CASES)
    def test_lk_pyramid_kernel_matches_plain_twin(self, cuda, case):
        """Every level in one launch against the plain level loop."""
        prev, cur, q, init, valid, levels = lk_case(case)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
        pp = pyramid.build_pyramid(t(prev), levels)
        cp = pyramid.build_pyramid(t(cur), levels)
        kw = dict(lo=0, hi=levels, win=21, iters=30, eps=0.01,
                  min_eigen=1e-4)
        before = lk_cuda.launches
        g, ok, eig, err = lk_cuda.track_pyramid_cuda(
            pp, cp, t(q), t(init), t(valid), **kw)
        assert lk_cuda.launches == before + 1
        rg, rok, reig, rerr = klt.track_pyramid_plain(
            pp, cp, t(q), t(init), t(valid), **kw)
        np.testing.assert_array_equal(_np(ok), _np(rok))
        np.testing.assert_array_equal(np.isfinite(_np(g)),
                                      np.isfinite(_np(rg)))
        both = _np(ok)
        if both.any():
            assert np.abs(_np(g) - _np(rg))[both].max() <= 2e-3
            np.testing.assert_allclose(_np(err)[both], _np(rerr)[both],
                                       atol=1e-2)
            np.testing.assert_allclose(_np(eig)[both], _np(reig)[both],
                                       rtol=1e-3)

    @pytest.mark.parametrize("case", LK_CASES + ["border_origins"])
    @pytest.mark.parametrize("win", [17, 21])
    def test_klt_kernel_matches_plain_twin(self, cuda, case, win):
        if case == "border_origins":  # patch origins clamp into the image
            prev, cur, q = _scene(h=240, w=320, n=64, seed=7)
            q = q.copy()
            q[:6] = [(2.5, 2.5), (316.0, 120.0), (150.0, 236.5),
                     (10.2, 200.7), (305.3, 8.9), (40.0, 16.0)]
            init, valid, levels = q + np.float32([0.6, -0.3]), \
                np.ones(64, bool), 2
        else:
            prev, cur, q, init, valid, levels = lk_case(case)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
        pp = pyramid.build_pyramid(t(prev), levels)
        cp = pyramid.build_pyramid(t(cur), levels)
        for lvl in range(levels + 1):
            if min(pp[lvl].shape) < klt_cuda.PATCH:
                continue
            s = float(2 ** lvl)
            args = (pp[lvl], cp[lvl], t(q) / s, t(init) / s, t(valid))
            kw = dict(win=win, iters=30, eps=0.01,
                      min_eigen=1e-4 if lvl == 0 else -1.0)
            g, ok, eig, err = klt_cuda.track_level_cuda(*args, **kw)
            rg, rok, reig, rerr = klt.track_level_klt_plain(*args, **kw)
            np.testing.assert_array_equal(_np(ok), _np(rok))
            np.testing.assert_array_equal(np.isfinite(_np(g)),
                                          np.isfinite(_np(rg)))
            both = _np(ok)
            if both.any():
                assert np.abs(_np(g) - _np(rg))[both].max() <= 2e-3
                np.testing.assert_allclose(_np(err)[both], _np(rerr)[both],
                                           atol=1e-2)
                np.testing.assert_allclose(_np(eig)[both], _np(reig)[both],
                                           rtol=1e-3)

    @pytest.mark.parametrize("case", ["plain", "border", "nan_and_invalid",
                                      "far_guess", "n100"])
    @pytest.mark.parametrize("win", [17, 21, 9])
    def test_klt_pyramid_kernel_matches_plain_twin(self, cuda, case, win):
        """Levels 2-0 of a 320x240 scene in one launch against the plain
        level loop; win 9 runs the generic instantiation."""
        n = 100 if case == "n100" else 64
        prev, cur, q = _scene(h=240, w=320, n=n, seed=7)
        q = q.copy()
        init = q + np.float32([0.6, -0.3])
        valid = np.ones(n, bool)
        if case == "border":
            q[:6] = [(2.5, 2.5), (316.0, 120.0), (150.0, 236.5),
                     (10.2, 200.7), (305.3, 8.9), (40.0, 16.0)]
            init = q + np.float32([0.6, -0.3])
        elif case == "nan_and_invalid":
            q[5] = np.nan
            init[9] = np.nan
            valid[[5, 9, 11]] = False
        elif case == "far_guess":
            init[::2] += np.float32([30.0, -26.0])
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
        pp = pyramid.build_pyramid(t(prev), 3)
        cp = pyramid.build_pyramid(t(cur), 3)
        kw = dict(lo=0, hi=2, win=win, iters=30, eps=0.01, min_eigen=1e-4)
        before = klt_cuda.launches
        g, ok, eig, err = klt_cuda.track_pyramid_cuda(
            pp, cp, t(q), t(init), t(valid), **kw)
        assert klt_cuda.launches == before + 1
        rg, rok, reig, rerr = klt.track_pyramid_klt_plain(
            pp, cp, t(q), t(init), t(valid), **kw)
        np.testing.assert_array_equal(_np(ok), _np(rok))
        np.testing.assert_array_equal(np.isfinite(_np(g)),
                                      np.isfinite(_np(rg)))
        both = _np(ok)
        assert both.any()
        assert np.abs(_np(g) - _np(rg))[both].max() <= 2e-3
        np.testing.assert_allclose(_np(err)[both], _np(rerr)[both], atol=1e-2)
        np.testing.assert_allclose(_np(eig)[both], _np(reig)[both], rtol=1e-3)

    @pytest.mark.parametrize("integer", [True, False])
    @pytest.mark.parametrize("shape", [(120, 160), (240, 320)])
    def test_fast_kernel_matches_plain_twin(self, cuda, integer, shape):
        img = blocks(*shape) if integer else (textured(*shape) * 0.5
                                              + blocks(*shape) * 0.5)
        x = torch.from_numpy(img).to(cuda)
        got = _np(fast_cuda.detect_cuda(x, 30.0))
        ref = _np(fast.detect(x, 30.0))
        if integer:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-4)

    @pytest.mark.parametrize("integer", [True, False])
    @pytest.mark.parametrize("shape", [(117, 203), (235, 301)])
    def test_fast_kernel_at_sides_off_the_tile(self, cuda, shape, integer):
        """Frames whose sides are not multiples of the 32 x 8 tile, at
        both margin orders (117x203 is below 128x256 px, 235x301 above)."""
        img = blocks(*shape, seed=2, n=80) if integer else (
            textured(*shape) * 0.5 + blocks(*shape, seed=2, n=80) * 0.5)
        x = torch.from_numpy(img).to(cuda)
        before = fast_cuda.launches
        got = _np(fast_cuda.detect_cuda(x, 30.0))
        assert fast_cuda.launches == before + 1
        ref = _np(fast.detect(x, 30.0))
        assert (ref > 0).sum() > 20
        if integer:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-4)


def _bits(t):
    """float32 as int32 bit patterns (NaN included), for bitwise tests."""
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _lane_scene(cuda, n_lanes, win_shape=(128, 192)):
    """Lane-shaped pyramids and points: lane b is tests/test_pallas_lk.py's
    scene of seed b + 1 shifted by (0.9 (b + 1), -1.1); the last lane's
    points are NaN and the one before it has every row invalid."""
    scenes = [_scene(*win_shape, seed=b + 1, shift=(0.9 * (b + 1), -1.1))
              for b in range(n_lanes)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    prev = t(np.stack([s[0] for s in scenes]))
    cur = t(np.stack([s[1] for s in scenes]))
    q = np.stack([s[2] for s in scenes])
    q[-1] = np.nan
    valid = np.ones(q.shape[:2], bool)
    valid[-2] = False
    return (pyramid.build_pyramid(prev, 2), pyramid.build_pyramid(cur, 2),
            t(q), t(valid))


@pytest.mark.requires_cuda
class TestLanesOnCard:
    """One launch over B lanes: each lane bitwise equal to a one-lane
    launch on it, and within the bars above of the plain twin with
    lanes."""

    @pytest.mark.parametrize("kernel,win", [("lk", 21), ("klt", 17),
                                            ("klt", 21)])
    def test_lanes_equal_single_lane_launches(self, cuda, kernel, win):
        shape = (128, 192) if kernel == "lk" else (240, 320)
        pp, cp, q, valid = _lane_scene(cuda, 5, shape)
        module, plain = ((lk_cuda, klt.track_pyramid_plain) if kernel == "lk"
                         else (klt_cuda, klt.track_pyramid_klt_plain))
        kw = dict(lo=0, hi=2, win=win, iters=30, eps=0.01, min_eigen=1e-4)
        before = module.launches
        got = module.track_pyramid_cuda(pp, cp, q, q, valid, **kw)
        assert module.launches == before + 1
        for b in range(q.shape[0]):
            one = module.track_pyramid_cuda([x[b] for x in pp],
                                            [x[b] for x in cp], q[b], q[b],
                                            valid[b], **kw)
            for x, y in zip(got, one):
                assert torch.equal(_bits(x[b]), _bits(y))
        g, ok, eig, err = (_np(x) for x in got)
        rg, rok, reig, rerr = (_np(x) for x in plain(pp, cp, q, q, valid,
                                                     **kw))
        np.testing.assert_array_equal(ok, rok)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(rg))
        assert not ok[-2:].any() and ok[:-2].sum() >= 0.6 * ok[:-2].size
        assert np.abs(g - rg)[ok].max() <= 2e-3
        np.testing.assert_allclose(err[ok], rerr[ok], atol=1e-2)
        np.testing.assert_allclose(eig[ok], reig[ok], rtol=1e-3)

    @pytest.mark.parametrize("integer", [True, False])
    @pytest.mark.parametrize("shape", [(120, 160), (240, 320)])
    def test_fast_lanes_equal_single_frames(self, cuda, integer, shape):
        imgs = [blocks(*shape, seed=s) if integer else
                textured(*shape, seed=s) * 0.5 + blocks(*shape, seed=s) * 0.5
                for s in range(4)]
        imgs[-1] = np.full(shape, np.nan, np.float32)  # a NaN lane
        x = torch.from_numpy(np.stack(imgs)).to(cuda)
        before = fast_cuda.launches
        got = fast_cuda.detect_cuda(x, 30.0)
        assert fast_cuda.launches == before + 1
        for b in range(4):
            assert torch.equal(_bits(got[b]),
                               _bits(fast_cuda.detect_cuda(x[b], 30.0)))
        ref = _np(fast.detect(x, 30.0))
        assert (ref[:-1] > 0).sum((1, 2)).min() > 20 and not ref[-1].any()
        if integer:
            np.testing.assert_array_equal(_np(got), ref)
        else:
            np.testing.assert_allclose(_np(got), ref, atol=1e-4)

    def test_vmapped_track_and_detect_are_one_launch_each(self, cuda):
        """``torch.func.vmap`` over ``klt.track`` and ``fast_cuda.detect``
        folds the lanes into one launch of each kernel, with each lane's
        result that of a one-lane call."""
        from ekf_vio_tpu_torch.config import VIOConfig

        pp, cp, q, valid = _lane_scene(cuda, 4)
        cfg = VIOConfig(max_features=32)
        before = (lk_cuda.launches, fast_cuda.launches)
        res = torch.func.vmap(
            lambda a, b, p, v: tuple(klt.track(a, b, p, p, v, cfg)))(
                pp, cp, q, valid)
        score = torch.func.vmap(lambda im: fast_cuda.detect(im, 30.0))(pp[0])
        assert (lk_cuda.launches, fast_cuda.launches) == (before[0] + 1,
                                                          before[1] + 1)
        for b in range(4):
            one = klt.track([x[b] for x in pp], [x[b] for x in cp], q[b],
                            q[b], valid[b], cfg)
            for x, y in zip(res, one):
                assert torch.equal(_bits(x[b]), _bits(y))
            assert torch.equal(score[b], fast_cuda.detect(pp[0][b], 30.0))
