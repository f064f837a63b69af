"""The CUDA kernels of ekf_vio_tpu_torch against their plain PyTorch twins
on the same CUDA tensors.  Every test here needs a card and skips without
one; the file imports no JAX (the scenes below are numpy from a seed), so
on a machine with a card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Bars: lk_level — status identical, points within 2e-3 px, err within
1e-2 and min_eig within rtol 1e-3 where tracked (window sums reduce in
another order); fast9 — bitwise on integer-valued frames, 1e-4 otherwise.
"""
import numpy as np
import pytest
import torch

from ekf_vio_tpu_torch.frontend import fast, fast_cuda, klt, lk_cuda, pyramid


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

    @pytest.mark.parametrize("integer", [True, False])
    def test_fast_kernel_matches_plain_twin(self, cuda, integer):
        img = blocks() if integer else textured() * 0.5 + blocks() * 0.5
        x = torch.from_numpy(img).to(cuda)
        got = _np(fast_cuda.detect_cuda(x, 30.0))
        ref = _np(fast.detect(x, 30.0))
        if integer:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-4)
