"""Plain reference of one VIO step and of the two initializations.

Plain PyTorch, one function per stage, no kernels, no CUDA graph, no lane
axis, and nothing imported from the program under test.  It covers the
paths the benchmark's configurations run and refuses the others:

* covariance form (no square-root factor), expanded Joseph update,
  constant measurement covariance, no relative-structure or chi-square
  gate;
* pyramidal Lucas-Kanade on every level (21-px window, slots a multiple of
  32), FAST-9 with non-maximum suppression, grid-cell replenishment;
* vision-only: the random-walk predict; mono-inertial: the compound IMU
  propagation of one camera interval with first-estimate Jacobians and
  the depth bootstrap against the exact IMU baseline, after the
  closed-form visual-inertial initialization;
* re-bootstrap when tracking is lost.

The equations are those of the reference C++ filter (TightlyCoupledEKF,
KLTTracker, EKFVIO) as the repository's packages state them; this file is
a frozen copy kept with the benchmark, so that a later change to the
program is held against what the step computed when the benchmark was
written.  ``State`` holds the filter and the previous pyramid;
``from_program`` reads a state of the program under test field by field,
for the step-by-step comparison of the streaming cells.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch.func import jacfwd, vmap

NB = 22  # base state: p(3) q(4) v(3) w(3) a(3) b_a(3) b_g(3)


@contextlib.contextmanager
def precision(tf32: bool = False):
    """The reference's float32: matmuls and convolutions in full f32 (TF32
    keeps ~3 decimal digits); ``tf32=True`` is the control, the precision
    below it.  Restores full f32 on the way out, as the program runs."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def make_cfg(vio: dict) -> SimpleNamespace:
    cfg = SimpleNamespace(**vio)
    unsupported = {
        "square_root_form": cfg.square_root_form,
        "joseph_form != expanded": cfg.joseph_form != "expanded",
        "klt_covariance != constant": cfg.klt_covariance != "constant",
        "min_eigen_rel_gate": cfg.min_eigen_rel_gate > 0,
        "innovation_gate_chi2": cfg.innovation_gate_chi2 > 0,
        "fast_blur_sigma": cfg.fast_blur_sigma > 0,
        "klt_window_size != 21": cfg.klt_window_size != 21,
        "max_features % 32": cfg.max_features % 32 != 0,
        "use_pallas_klt off": not cfg.use_pallas_klt,
        "two-view depths": cfg.triangulate_new_features and not cfg.use_imu,
        "no FEJ": cfg.use_imu and not cfg.use_fej,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"the plain reference does not cover {bad}")
    cfg.num_features = min(cfg.num_features, cfg.max_features)
    return cfg


# --------------------------------------------------------------- rotations

def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    w, u = q[..., 0:1], q[..., 1:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_exp_omega(omega, dt):
    t2 = torch.sum(omega * omega, dim=-1, keepdim=True) * (dt * dt)
    small = t2 < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    w = torch.where(small, 1.0 - t2 / 8.0 + t2 * t2 / 384.0,
                    torch.cos(theta / 2.0))
    k = torch.where(small, 0.5 - t2 / 48.0 + t2 * t2 / 3840.0,
                    torch.sin(theta / 2.0) / theta)
    return torch.cat([w, omega * dt * k], dim=-1)


def quat_to_matrix(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], dim=-2)


def skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], dim=-2)


def _const(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


# ------------------------------------------------------------------ camera

def pixel_to_metric(cam, px):
    return torch.stack([(px[..., 0] - cam["cx"]) / cam["fx"],
                        (px[..., 1] - cam["cy"]) / cam["fy"]], -1)


def metric_to_pixel(cam, uv):
    return torch.stack([uv[..., 0] * cam["fx"] + cam["cx"],
                        uv[..., 1] * cam["fy"] + cam["cy"]], -1)


def in_kill_box(cam, px, pad):
    x, y = px[..., 0], px[..., 1]
    return ((x >= pad) & (y >= pad) & (cam["width"] - x >= pad)
            & (cam["height"] - y >= pad))


# ------------------------------------------------------------------ pyramid

_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _edge_pad(img, ph, pw):
    h, w = img.shape[-2:]
    p = F.pad(img.reshape(-1, 1, h, w), (pw, pw, ph, ph), mode="replicate")
    return p.reshape(*img.shape[:-2], h + 2 * ph, w + 2 * pw)


def pyr_down(img):
    h, w = img.shape[-2:]
    p = _edge_pad(img, 2, 0)
    img = sum(p[..., i: i + h, :] * _K5[i] for i in range(5))
    p = _edge_pad(img, 0, 2)
    img = sum(p[..., i: i + w] * _K5[i] for i in range(5))
    return img[..., ::2, ::2].contiguous()


def build_pyramid(img, levels):
    out = [img.to(torch.float32)]
    for _ in range(levels):
        out.append(pyr_down(out[-1]))
    return tuple(out)


# --------------------------------------------------------- Lucas-Kanade

_MARGIN = 5
_SMOOTH = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)
_DERIV = (-1.0, 0.0, 1.0)


def _patches(img, anchor, p):
    """[N, p, p] patches at floored top-left ``anchor``, clamped at the
    border, rounded to bf16 (the tracker's patch precision)."""
    h, w = img.shape
    ar = torch.arange(p, device=img.device)
    ax = anchor[:, 0].clamp(-p - w, p + w).long()
    ay = anchor[:, 1].clamp(-p - h, p + h).long()
    ys = (ay[:, None] + ar).clamp(0, h - 1)
    xs = (ax[:, None] + ar).clamp(0, w - 1)
    return img[ys[:, :, None], xs[:, None, :]].to(torch.bfloat16).to(
        torch.float32)


def _scharr(patch):
    def sep(x, ky, kx):
        n = x.shape[1]
        xp = torch.cat([x[:, :1], x, x[:, -1:]], 1)
        x = sum(xp[:, i: i + n, :] * ky[i] for i in range(3))
        xp = torch.cat([x[:, :, :1], x, x[:, :, -1:]], 2)
        return sum(xp[:, :, i: i + n] * kx[i] for i in range(3))

    return sep(patch, _SMOOTH, _DERIV), sep(patch, _DERIV, _SMOOTH)


def _taps(floor_base, frac, win, p):
    i0 = torch.nan_to_num(floor_base).clamp(-2 * p, 2 * p).long()
    idx = i0[:, None] + torch.arange(win, device=frac.device)
    a, b = idx.clamp(0, p - 1), (idx + 1).clamp(0, p - 1)
    wa = (1.0 - frac)[:, None].expand(-1, win)
    wb = frac[:, None].expand(-1, win)
    same = a == b
    return a, b, torch.where(same, wa + wb, wa), torch.where(same, 0.0, wb)


def _windows(patch, center, win):
    n, p, _ = patch.shape
    base = center - (win - 1) / 2.0
    fl = torch.floor(base)
    frac = base - fl
    ya, yb, wya, wyb = _taps(fl[:, 1], frac[:, 1], win, p)
    xa, xb, wxa, wxb = _taps(fl[:, 0], frac[:, 0], win, p)
    rows = lambda i: torch.gather(patch, 1, i[:, :, None].expand(n, win, p))  # noqa: E731
    tmp = rows(ya) * wya[:, :, None] + rows(yb) * wyb[:, :, None]
    cols = lambda i: torch.gather(tmp, 2, i[:, None, :].expand(n, win, win))  # noqa: E731
    return cols(xa) * wxa[:, None, :] + cols(xb) * wxb[:, None, :]


def track_level(prev, cur, q, g, valid, win, iters, eps, min_eigen, gate_eig):
    """One pyramid level of LK: all ``iters`` iterations, a converged
    feature frozen.  Returns (g, ok, min_eig, err)."""
    n = q.shape[0]
    half = (win - 1) // 2
    p = win + 2 * _MARGIN + 1
    h, w = prev.shape
    off = float(half + _MARGIN)
    a0 = torch.floor(torch.nan_to_num(q)) - off
    prev_patch = _patches(prev, a0, p)
    pix, piy = _scharr(prev_patch)
    c_prev = q - a0
    tpl = _windows(prev_patch, c_prev, win).reshape(n, -1)
    ix = _windows(pix, c_prev, win).reshape(n, -1)
    iy = _windows(piy, c_prev, win).reshape(n, -1)
    gxx, gxy, gyy = (ix * ix).sum(-1), (ix * iy).sum(-1), (iy * iy).sum(-1)
    det_half = torch.sqrt(torch.clamp((gxx - gyy) ** 2 / 4.0 + gxy * gxy,
                                      min=0.0))
    min_eig = ((gxx + gyy) / 2.0 - det_half) / (win * win)
    det = gxx * gyy - gxy * gxy
    inv_ok = det > 1e-12
    det_safe = torch.where(inv_ok, det, 1.0)
    i00, i01, i11 = gyy / det_safe, -gxy / det_safe, gxx / det_safe
    g0 = g
    c0 = torch.floor(torch.nan_to_num(g0)) - off
    cur_patch = _patches(cur, c0, p)
    done = torch.zeros_like(valid)
    for _ in range(iters):
        r = tpl - _windows(cur_patch, g - c0, win).reshape(n, -1)
        bx, by = (r * ix).sum(-1), (r * iy).sum(-1)
        delta = torch.stack([i00 * bx + i01 * by, i01 * bx + i11 * by], -1)
        step_ok = valid & ~done & inv_ok
        g = g + torch.where(step_ok[:, None], delta, 0.0)
        done = done | ((delta * delta).sum(-1) < eps ** 2)
    r = tpl - _windows(cur_patch, g - c0, win).reshape(n, -1)
    err = torch.mean(torch.abs(r), -1)
    within = torch.all(torch.abs(g - g0) <= _MARGIN, -1)
    inb = ((g[:, 0] >= 1) & (g[:, 1] >= 1) & (g[:, 0] < w - 2)
           & (g[:, 1] < h - 2) & (q[:, 0] >= 1) & (q[:, 1] >= 1)
           & (q[:, 0] < w - 2) & (q[:, 1] < h - 2))
    ok = valid & inb & inv_ok & within
    if gate_eig:
        ok = ok & (min_eig > min_eigen)
    return g, ok, min_eig, err


def track(prev_pyr, cur_pyr, prev_pts, init_pts, valid, cfg):
    """Pyramidal LK from the coarsest level whose image holds the window
    down to level 0.  Returns (points, status, min_eig)."""
    win = cfg.klt_window_size
    top = max(lvl for lvl, img in enumerate(prev_pyr) if min(img.shape) >= win)
    g, ok = init_pts / float(2 ** top), valid
    for lvl in range(top, -1, -1):
        g, ok, min_eig, _ = track_level(
            prev_pyr[lvl], cur_pyr[lvl], prev_pts / float(2 ** lvl), g, ok,
            win, cfg.klt_iterations, cfg.klt_eps, cfg.klt_min_eigen,
            gate_eig=lvl == 0)
        if lvl > 0:
            g = g * 2.0
    return g, ok, min_eig


def measurement_cov(cam, n, cfg, device):
    var = cfg.klt_measurement_variance_px
    vx = torch.full((n,), var / (cam["fx"] * cam["fx"]), device=device)
    vy = torch.full((n,), var / (cam["fy"] * cam["fy"]), device=device)
    return torch.diag_embed(torch.stack([vx, vy], -1))


# -------------------------------------------------------------- FAST-9

_CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2),
           (3, 1), (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3),
           (-2, -2), (-3, -1))


def fast_scores(img, threshold):
    """FAST-9 score map (max over qualifying 9-arcs of the summed excess
    over the threshold), NMS'd, the 3-px margin zeroed before NMS from
    128x256 pixels up and after it below."""
    img = img.to(torch.float32)
    h, w = img.shape
    pd = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    ring = torch.stack([pd[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w]
                        for dy, dx in _CIRCLE])
    diff = ring - img[None]
    bright, dark = diff > threshold, diff < -threshold
    excess = torch.abs(diff) - threshold
    bright2 = torch.cat([bright, bright[:8]])
    dark2 = torch.cat([dark, dark[:8]])
    excess2 = torch.cat([excess, excess[:8]])
    score = torch.zeros_like(img)
    for s in range(16):
        ok = torch.all(bright2[s: s + 9], 0) | torch.all(dark2[s: s + 9], 0)
        arc = sum(excess2[s + k] for k in range(9))
        score = torch.maximum(score, torch.where(ok, arc, 0.0))

    def nms(sc):
        pooled = F.max_pool2d(sc[None, None], 3, stride=1, padding=1)[0, 0]
        return torch.where((sc >= pooled) & (sc > 0.0), sc, 0.0)

    def margin(sc):
        ys = torch.arange(h, device=sc.device)[:, None]
        xs = torch.arange(w, device=sc.device)[None, :]
        keep = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
        return torch.where(keep, sc, 0.0)

    if h * w >= 128 * 256:
        return nms(margin(score))
    return margin(nms(score))


def replenish(img, existing_px, existing_valid, cfg, k_max):
    """One best corner per free cell of ``min_new_feature_dist`` px,
    ranked by response: (cand_px [k_max, 2], cand_valid [k_max])."""
    score_map = fast_scores(img, float(cfg.fast_threshold))
    needed = cfg.num_features - existing_valid.sum()
    h, w = score_map.shape
    dev = score_map.device
    cell = max(int(cfg.min_new_feature_dist), 1)
    ch, cw = -(-h // cell), -(-w // cell)
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    pad = float(cfg.kill_pad)
    inbox = (xs >= pad) & (ys >= pad) & (w - xs >= pad) & (h - ys >= pad)
    score = torch.where(inbox, score_map, 0.0)
    score_p = F.pad(score, (0, cw * cell - w, 0, ch * cell - h))
    cells = score_p.reshape(ch, cell, cw, cell).permute(0, 2, 1, 3).reshape(
        ch, cw, cell * cell)
    best, arg = torch.max(cells, dim=-1)
    cy = arg // cell + torch.arange(ch, device=dev)[:, None] * cell
    cx = arg % cell + torch.arange(cw, device=dev)[None, :] * cell
    bx, by = cx.reshape(-1).to(torch.float32), cy.reshape(-1).to(torch.float32)
    d2 = ((bx[None] - existing_px[:, 0:1]) ** 2
          + (by[None] - existing_px[:, 1:2]) ** 2)
    near = torch.any((d2 < cfg.min_new_feature_dist ** 2)
                     & existing_valid[:, None], dim=0)
    cand = torch.where(near, 0.0, best.reshape(-1))
    k = min(k_max, cand.shape[0])
    top_score, top_idx = torch.sort(cand, descending=True, stable=True)
    top_score, top_idx = top_score[:k], top_idx[:k]
    valid = (top_score > 0.0) & (torch.arange(k, device=dev) < needed)
    px = torch.stack([bx[top_idx], by[top_idx]], dim=-1)
    if k < k_max:
        px = torch.cat([px, px.new_zeros(k_max - k, 2)])
        valid = torch.cat([valid, valid.new_zeros(k_max - k)])
    return px, valid


# ---------------------------------------------------------------- filter

@dataclasses.dataclass
class State:
    base_mu: torch.Tensor   # [22]
    feat_mu: torch.Tensor   # [N, 3] (u, v, 1/depth)
    active: torch.Tensor    # [N] bool
    klt_ref: torch.Tensor   # [N, 2] last measured uv
    Sigma: torch.Tensor     # [D, D]
    t: torch.Tensor         # []
    age: torch.Tensor       # [N] int32
    prev_pyr: tuple = ()
    lin_base: torch.Tensor | None = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def n(self):
        return self.feat_mu.shape[0]


def from_program(estate) -> State:
    """A copy of a program state (``.filt`` with the filter's fields,
    ``.prev_pyr`` and ``.lin_base``), read attribute by attribute."""
    f = estate.filt
    c = lambda x: x.detach().clone()  # noqa: E731
    return State(base_mu=c(f.base_mu), feat_mu=c(f.feat_mu),
                 active=c(f.active), klt_ref=c(f.klt_ref), Sigma=c(f.Sigma),
                 t=c(f.t), age=c(f.age),
                 prev_pyr=tuple(c(p) for p in estate.prev_pyr),
                 lin_base=c(estate.lin_base))


def init_state(cfg, device):
    n = cfg.max_features
    kw = dict(device=device, dtype=torch.float32)
    base_mu = torch.zeros(NB, **kw)
    base_mu[3] = 1.0
    sig = torch.cat([torch.full((7,), cfg.init_pose_variance, **kw),
                     torch.full((9,), cfg.init_kinematic_variance, **kw),
                     torch.full((6,), cfg.init_bias_variance, **kw),
                     torch.zeros(3 * n, **kw)])
    feat_mu = torch.zeros(n, 3, **kw)
    feat_mu[:, 2] = 1.0 / cfg.default_point_depth
    return State(base_mu=base_mu, feat_mu=feat_mu,
                 active=torch.zeros(n, dtype=torch.bool, device=device),
                 klt_ref=torch.zeros(n, 2, **kw), Sigma=torch.diag(sig),
                 t=torch.zeros((), **kw),
                 age=torch.zeros(n, dtype=torch.int32, device=device))


def _uv_cols(M):
    tail = M[:, NB:]
    return tail.reshape(M.shape[0], -1, 3)[:, :, :2].reshape(M.shape[0], -1)


def _uv_rows(M):
    tail = M[NB:]
    blk = tail.reshape((-1, 3) + tail.shape[1:])[:, :2]
    return blk.reshape((-1,) + M.shape[1:])


def _block_diag(B):
    n, k, _ = B.shape
    eye = torch.eye(n, dtype=B.dtype, device=B.device)
    return (B[:, :, None, :] * eye[:, None, :, None]).reshape(n * k, n * k)


def _slot_keep(mask, dtype):
    head = torch.ones(NB, dtype=dtype, device=mask.device)
    return torch.cat([head, 1.0 - mask.repeat_interleave(3).to(dtype)])


def _plan_insertion(active, valid):
    """Candidate j goes to the j-th free slot: (take [N], src [N])."""
    k = valid.shape[0]
    free = ~active
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    cand_rank = torch.cumsum(valid.to(torch.int32), 0) - 1
    n_insert = torch.minimum(free.sum(), valid.sum())
    take = free & (free_rank < n_insert)
    dest = torch.where(valid, cand_rank.long(), k)
    idx_of_rank = torch.zeros(k + 1, dtype=torch.long,
                              device=valid.device).scatter(
        0, dest, torch.arange(k, device=valid.device))
    src = idx_of_rank[:k][free_rank.clamp(0, k - 1).long()]
    return take, src


def add_features(s: State, cfg, new_uv, valid, depths=None) -> State:
    n, dtype = s.n, s.Sigma.dtype
    take, src = _plan_insertion(s.active, valid)
    if depths is None:
        rho = torch.full((n, 1), 1.0 / cfg.default_point_depth,
                         dtype=dtype, device=s.Sigma.device)
    else:
        rho = (1.0 / torch.clamp(depths[src], 1e-3, 1e3))[:, None]
    uv_src = new_uv[src]
    feat_mu = torch.where(take[:, None], torch.cat([uv_src, rho], -1),
                          s.feat_mu)
    klt_ref = torch.where(take[:, None], uv_src, s.klt_ref)
    keep = _slot_keep(take, dtype)
    Sigma = s.Sigma * (keep[:, None] * keep[None, :])
    dvar = torch.full((n,), cfg.default_point_depth_variance, dtype=dtype,
                      device=Sigma.device)
    hv = torch.full((n,), cfg.default_point_homogenous_variance, dtype=dtype,
                    device=Sigma.device)
    prior = torch.where(take[:, None], torch.stack([hv, hv, dvar], -1), 0.0)
    diag = torch.diagonal(Sigma)
    diag[NB:] += prior.reshape(-1)
    return s.replace(feat_mu=feat_mu, active=s.active | take, klt_ref=klt_ref,
                     Sigma=Sigma, age=torch.where(take, 0, s.age))


def drop_features(s: State, drop) -> State:
    drop = drop & s.active
    keep = _slot_keep(drop, s.Sigma.dtype)
    return s.replace(active=s.active & ~drop,
                     Sigma=s.Sigma * (keep[:, None] * keep[None, :]))


# ---------------------------------------------------------- process model

def convolve_base_state(base_mu, dt):
    pos, quat = base_mu[0:3], base_mu[3:7]
    vel, omega, accel = base_mu[7:10], base_mu[10:13], base_mu[13:16]
    disp = dt * vel + 0.5 * dt * dt * accel
    pos = pos + quat_rotate(quat, disp)
    dq = quat_exp_omega(omega, dt)
    dq_inv = quat_conj(dq)
    vel = quat_rotate(dq_inv, vel + dt * accel)
    accel_new = quat_rotate(dq_inv, accel)
    quat = quat_mul(quat, dq)
    return torch.cat([pos, quat, vel, omega, accel_new, base_mu[16:22]])


def convolve_features(base_mu, feat_mu, dt):
    vel, omega, accel = base_mu[7:10], base_mu[10:13], base_mu[13:16]
    z = 1.0 / feat_mu[:, 2]
    p = torch.stack([feat_mu[:, 0] * z, feat_mu[:, 1] * z, z], -1)
    translation = dt * vel + 0.5 * dt * dt * accel
    dq_inv = quat_conj(quat_exp_omega(omega, dt))
    p = quat_rotate(dq_inv, p) - quat_rotate(dq_inv, translation)
    return torch.stack([p[:, 0] / p[:, 2], p[:, 1] / p[:, 2], 1.0 / p[:, 2]],
                       -1)


def camera_motion_qt(base_mu, dt):
    vel, omega, accel = base_mu[7:10], base_mu[10:13], base_mu[13:16]
    dq_inv = quat_conj(quat_exp_omega(omega, dt))
    d = dt * vel + 0.5 * dt * dt * accel
    return torch.cat([dq_inv, -quat_rotate(dq_inv, d)])


def _rotate_jac_quat(q, p):
    w, u = q[0], q[1:4]
    col_w = 2.0 * cross(u, p)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    utp = torch.sum(u * p, -1)
    block_u = 2.0 * (utp[:, None, None] * eye + u[:, None] * p[:, None, :]
                     - 2.0 * p[:, :, None] * u[None, :] - w * skew(p))
    return torch.cat([col_w[:, :, None], block_u], -1)


def transport_jacobians(feat_mu, qt):
    """(feat' [N,3], Ff [N,3,3], W [N,3,7] = d feat' / d (q, t))."""
    q, t = qt[0:4], qt[4:7]
    R = quat_to_matrix(q)
    z = 1.0 / feat_mu[:, 2]
    h = torch.stack([feat_mu[:, 0], feat_mu[:, 1], torch.ones_like(z)], -1)
    p = z[:, None] * h
    p2 = p @ R.T + t
    inv_z2 = 1.0 / p2[:, 2]
    zero, one = torch.zeros_like(inv_z2), torch.ones_like(inv_z2)
    P = inv_z2[:, None, None] * torch.stack([
        torch.stack([one, zero, -p2[:, 0] * inv_z2], -1),
        torch.stack([zero, one, -p2[:, 1] * inv_z2], -1),
        torch.stack([zero, zero, -inv_z2], -1)], -2)
    dp = torch.stack([
        torch.stack([z, zero, -z * z * h[:, 0]], -1),
        torch.stack([zero, z, -z * z * h[:, 1]], -1),
        torch.stack([zero, zero, -z * z], -1)], -2)
    Ff = (P @ R) @ dp
    W = torch.cat([P @ _rotate_jac_quat(q, p), P], -1)
    feat2 = torch.stack([p2[:, 0] * inv_z2, p2[:, 1] * inv_z2, inv_z2], -1)
    return feat2, Ff, W


def _mask_jacobians(Ffb, Ff, active):
    a = active[:, None, None]
    eye3 = torch.eye(3, dtype=Ff.dtype, device=Ff.device)
    return torch.where(a, Ffb, 0.0), torch.where(a, Ff, eye3)


def propagate_covariance(Sigma, Fb, Ffb, Ff, q_diag):
    """Sigma <- F Sigma F^T + Q, F = [[Fb, 0], [Ffb, blkdiag(Ff)]]."""
    n = Ff.shape[0]
    top = torch.cat([Fb, Fb.new_zeros(NB, 3 * n)], 1)
    bot = torch.cat([Ffb.reshape(3 * n, NB), _block_diag(Ff)], 1)
    Fm = torch.cat([top, bot], 0)
    out = Fm @ Sigma @ Fm.T + torch.diag(q_diag)
    return 0.5 * (out + out.T)


def predict(s: State, cfg, dt) -> State:
    """Vision-only process step (TightlyCoupledEKF::process)."""
    Fb = jacfwd(convolve_base_state)(s.base_mu, dt)
    qt = camera_motion_qt(s.base_mu, dt)
    Jqt = jacfwd(camera_motion_qt)(s.base_mu, dt)
    _, Ff, W = transport_jacobians(s.feat_mu, qt)
    Ffb, Ff = _mask_jacobians(W @ Jqt, Ff, s.active)
    new_feat = convolve_features(s.base_mu, s.feat_mu, dt)
    feat_mu = torch.where(s.active[:, None], new_feat, s.feat_mu)
    base_mu = convolve_base_state(s.base_mu, dt)
    kw = dict(dtype=torch.float32, device=s.active.device)
    base_q = torch.cat([torch.full((7,), cfg.q_pos, **kw),
                        torch.full((3,), cfg.q_vel, **kw),
                        torch.full((3,), cfg.q_omega, **kw),
                        torch.full((3,), cfg.q_accel, **kw),
                        torch.full((6,), cfg.q_bias, **kw)])
    feat_q = torch.where(s.active[:, None], cfg.q_feature, 0.0) * torch.ones(
        s.n, 3, **kw)
    q_diag = torch.cat([base_q, feat_q.reshape(-1)]) * dt
    Sigma = propagate_covariance(s.Sigma, Fb, Ffb, Ff, q_diag)
    return s.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=Sigma,
                     t=s.t + dt)


# ------------------------------------------------------ IMU propagation

def substitute_imu_controls(base_mu, gyro_m, accel_m, gravity_w):
    q = base_mu[..., 3:7]
    omega = gyro_m - base_mu[..., 19:22]
    a_body = (accel_m - base_mu[..., 16:19]) + quat_rotate(quat_conj(q),
                                                           gravity_w)
    return torch.cat([base_mu[..., :10], omega, a_body, base_mu[..., 16:]],
                     -1)


def _imu_psd(cfg, like):
    return _const([cfg.imu_gyro_noise ** 2] * 3 + [cfg.imu_accel_noise ** 2] * 3
                  + [cfg.imu_gyro_bias_walk ** 2] * 3
                  + [cfg.imu_accel_bias_walk ** 2] * 3, like)


def _with_remainder(dt, gyro, accel, rem):
    """Append the zero-order-hold sample covering ``rem`` seconds of the
    interval not spanned by samples (dt = 0 padding when rem <= 1e-6)."""
    k = dt.shape[0]
    ar = torch.arange(k, device=dt.device)
    idx = torch.clamp(torch.max(torch.where(dt > 0, ar, -1)), min=0)
    rem = torch.where(rem > 1e-6, rem, 0.0).reshape(1)
    pick = idx.reshape(1)
    return (torch.cat([dt, rem]), torch.cat([gyro, gyro.index_select(0, pick)]),
            torch.cat([accel, accel.index_select(0, pick)]))


def _motion_step29(x29, gyro_m, accel_m, noise, dt, gravity_w):
    base, qc, tc = x29[0:22], x29[22:26], x29[26:29]
    n_g, n_a, n_bg, n_ba = noise[0:3], noise[3:6], noise[6:9], noise[9:12]
    base = torch.cat([base[:16], base[16:19] + n_ba * dt,
                      base[19:22] + n_bg * dt])
    mu_sub = substitute_imu_controls(base, gyro_m + n_g, accel_m + n_a,
                                     gravity_w)
    vel, omega, acc = mu_sub[7:10], mu_sub[10:13], mu_sub[13:16]
    dq_inv = quat_conj(quat_exp_omega(omega, dt))
    d = dt * vel + 0.5 * dt * dt * acc
    qc2 = quat_mul(dq_inv, qc)
    tc2 = quat_rotate(dq_inv, tc - d)
    return torch.cat([convolve_base_state(mu_sub, dt), qc2, tc2])


def _step29_xn(xn, gyro_m, accel_m, dt, gravity_w):
    return _motion_step29(xn[:29], gyro_m, accel_m, xn[29:], dt, gravity_w)


_jac29_xn = vmap(jacfwd(_step29_xn), in_dims=(0, 0, 0, 0, None))


def _cumulative_quat_mul(dq):
    k, c, s = dq.shape[-2], dq, 1
    while s < k:
        c = torch.cat([c[..., :s, :], quat_mul(c[..., :-s, :], c[..., s:, :])],
                      -2)
        s *= 2
    return c


def mean_chain(x0, dt, gyro, accel, gravity_w):
    """Closed-form mean of the [base, qc, tc] system over the samples, for
    L chains x0 [L, 29]: (x_final [L, 29], xs [L, K, 29] pre-sample)."""
    k, n_l = dt.shape[0], x0.shape[0]
    p0, q0, v0 = x0[:, None, 0:3], x0[:, None, 3:7], x0[:, None, 7:10]
    b_a, b_g = x0[:, None, 16:19], x0[:, None, 19:22]
    dtc = dt[:, None]
    omega = gyro - b_g
    dq = quat_exp_omega(omega, dtc)
    c = _cumulative_quat_mul(dq)
    ident = _const([1.0, 0.0, 0.0, 0.0], x0)
    c_excl = torch.cat([ident.expand(n_l, 1, 4), c[:, :-1]], 1)
    q_pre = quat_mul(q0, c_excl)
    q_pre_inv = quat_conj(q_pre)
    A = quat_rotate(q_pre, accel - b_a) + gravity_w
    dv = dtc * A
    w0 = quat_rotate(q0, v0)
    w_pre = w0 + torch.cumsum(dv, 1) - dv
    D = dtc * w_pre + 0.5 * (dt * dt)[:, None] * A
    p_pre = p0 + torch.cumsum(D, 1) - D
    v_pre = quat_rotate(q_pre_inv, w_pre)
    qc_pre = quat_conj(c_excl)
    tc_pre = quat_rotate(q_pre_inv, p0 - p_pre)
    rest = x0[:, None, 10:22].expand(n_l, k, 12)
    xs = torch.cat([p_pre, q_pre, v_pre, rest, qc_pre, tc_pre], -1)
    c_last = c[:, -1]
    q_fin = quat_mul(q0[:, 0], c_last)
    q_fin_inv = quat_conj(q_fin)
    w_fin = w0[:, 0] + torch.sum(dv, 1)
    p_fin = p0[:, 0] + torch.sum(D, 1)
    v_fin = quat_rotate(q_fin_inv, w_fin)
    qc_fin = quat_conj(c_last)
    tc_fin = quat_rotate(q_fin_inv, p0[:, 0] - p_fin)
    ar = torch.arange(k, device=dt.device)
    last = torch.max(torch.where(dt > 0, ar, -1))
    has = last >= 0
    idx = torch.clamp(last, min=0).reshape(1)
    a_pre = accel - b_a + quat_rotate(q_pre_inv, gravity_w.expand(n_l, k, 3))
    a_post = quat_rotate(quat_conj(dq), a_pre)
    om_fin = torch.where(has, omega.index_select(1, idx)[:, 0], x0[:, 10:13])
    ac_fin = torch.where(has, a_post.index_select(1, idx)[:, 0], x0[:, 13:16])
    x_fin = torch.cat([p_fin, q_fin, v_fin, om_fin, ac_fin, x0[:, 16:22],
                       qc_fin, tc_fin], -1)
    return x_fin, xs


def _compose_chain(Ji, Qi):
    while Ji.shape[0] > 1:
        k = Ji.shape[0]
        even = k - (k % 2)
        Ja, Qa, Jb, Qb = Ji[0:even:2], Qi[0:even:2], Ji[1:even:2], Qi[1:even:2]
        Jc = torch.einsum("kij,kjl->kil", Jb, Ja)
        Qc = torch.einsum("kij,kjl,kml->kim", Jb, Qa, Jb) + Qb
        if k % 2:
            Jc, Qc = torch.cat([Jc, Ji[-1:]], 0), torch.cat([Qc, Qi[-1:]], 0)
        Ji, Qi = Jc, Qc
    return Ji[0], Qi[0]


def propagate_imu(s: State, cfg, dt, gyro, accel, gravity_w):
    """One camera interval of IMU samples as ONE covariance propagation,
    transition and noise Jacobians along the first-estimate chain from
    ``s.lin_base``.  Returns (state, the camera motion qt [7])."""
    dtype = s.Sigma.dtype
    psd = _imu_psd(cfg, s.base_mu)
    tail = _const([1.0] + [0.0] * 6, s.base_mu)
    x0 = torch.cat([s.base_mu, tail])
    x0_lin = torch.cat([s.lin_base.to(dtype), tail])
    xf, xs = mean_chain(torch.stack([x0, x0_lin]), dt, gyro, accel, gravity_w)
    x, x_lin, xs_lin = xf[0], xf[1], xs[1]
    k = dt.shape[0]
    xn = torch.cat([xs_lin, torch.zeros(k, 12, dtype=dtype,
                                        device=dt.device)], -1)
    JG = _jac29_xn(xn, gyro, accel, dt, gravity_w)
    Ji, Gi = JG[:, :, :29], JG[:, :, 29:]
    qn = psd[None, :] / torch.clamp(dt, min=1e-6)[:, None]
    GQG = torch.einsum("kij,kj,klj->kil", Gi, qn, Gi)
    ok = (dt > 0)[:, None, None]
    Ji = torch.where(ok, Ji, torch.eye(29, dtype=dtype, device=dt.device))
    GQG = torch.where(ok, GQG, 0.0)
    J, Q29 = _compose_chain(Ji, GQG)
    base_mu, qt, qt_lin, total_dt = x[0:22], x[22:29], x_lin[22:29], dt.sum()

    n = s.n
    z = 1.0 / s.feat_mu[:, 2]
    p = torch.stack([s.feat_mu[:, 0] * z, s.feat_mu[:, 1] * z, z], -1)
    p = quat_rotate(qt[0:4], p) + qt[4:7]
    new_feat = torch.stack([p[:, 0] / p[:, 2], p[:, 1] / p[:, 2],
                            1.0 / p[:, 2]], -1)
    _, Ff, W = transport_jacobians(s.feat_mu, qt_lin)
    Ffb = torch.einsum("nij,jb->nib", W, J[NB:, :NB])
    Ffb, Ff = _mask_jacobians(Ffb, Ff, s.active)
    W = torch.where(s.active[:, None, None], W, 0.0)
    q_feat = torch.where(s.active[:, None], cfg.q_feature, 0.0) * torch.ones(
        n, 3, dtype=dtype, device=dt.device) * total_dt
    q_diag = torch.cat([torch.zeros(NB, dtype=dtype, device=dt.device),
                        q_feat.reshape(-1)])
    Sigma = propagate_covariance(s.Sigma, J[:NB, :NB], Ffb, Ff, q_diag)
    Wm = W.reshape(3 * n, 7)
    Qbf = Q29[:NB, NB:] @ Wm.T
    Qn = torch.cat([torch.cat([Q29[:NB, :NB], Qbf], 1),
                    torch.cat([Qbf.T, Wm @ Q29[NB:, NB:] @ Wm.T], 1)], 0)
    Sigma = Sigma + Qn
    Sigma = 0.5 * (Sigma + Sigma.T)
    feat_mu = torch.where(s.active[:, None], new_feat, s.feat_mu)
    return s.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=Sigma,
                     t=s.t + total_dt), qt


# ---------------------------------------------------------------- update

def update(s: State, cfg, measured_uv, meas_cov, passed) -> State:
    """Masked EKF update, Joseph form expanded through H's selector
    structure; a failed Cholesky skips it (TightlyCoupledEKF.cpp:579)."""
    n, dtype = s.n, s.Sigma.dtype
    meas = passed & s.active
    mu = torch.cat([s.base_mu, s.feat_mu.reshape(-1)])
    m = meas.repeat_interleave(2).to(dtype)
    y = (measured_uv.reshape(-1) - s.feat_mu[:, :2].reshape(-1)) * m
    A = _uv_cols(s.Sigma)
    S = _uv_rows(A) + _block_diag(meas_cov)
    mm = m[:, None] * m[None, :]
    S_true = S * mm
    S = S * mm + torch.diag(1.0 - m)
    lam = cfg.sigma_jitter + cfg.sigma_jitter_rel * torch.max(
        torch.diagonal(S) * m)
    S = S + lam * torch.eye(2 * n, dtype=dtype, device=S.device)
    A = A * m[None, :]
    L, info = torch.linalg.cholesky_ex(S)
    K = torch.cholesky_solve(A.T, L).T
    K = torch.where(torch.isfinite(K).all() & (info == 0), K, 0.0)
    mu = mu + K @ y
    B = K @ A.T
    Sigma = s.Sigma - B - B.T + (K @ S_true) @ K.T
    Sigma = 0.5 * (Sigma + Sigma.T)
    quat = mu[3:7] / torch.linalg.vector_norm(mu[3:7])
    mu = torch.cat([mu[:3], quat, mu[7:]])
    klt_ref = torch.where(meas[:, None], measured_uv, s.klt_ref)
    return s.replace(base_mu=mu[:NB], feat_mu=mu[NB:].reshape(n, 3),
                     Sigma=Sigma, klt_ref=klt_ref)


def _nis_per_feature(s: State, measured_uv, meas_cov):
    y = measured_uv - s.feat_mu[:, :2]
    n = s.n
    tail = s.Sigma[NB:, NB:]
    blocks = torch.diagonal(tail.reshape(n, 3, n, 3), dim1=0, dim2=2)
    S = blocks.permute(2, 0, 1)[:, :2, :2] + meas_cov
    det = torch.clamp(S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0],
                      min=1e-30)
    return (S[:, 1, 1] * y[:, 0] ** 2 - 2 * S[:, 0, 1] * y[:, 0] * y[:, 1]
            + S[:, 0, 0] * y[:, 1] ** 2) / det


# ---------------------------------------------------------- triangulation

def _hom(h):
    return torch.cat([h, torch.ones_like(h[..., :1])], -1)


def triangulate(h_prev, h_cur, R, t, default_depth):
    """Frame-current depths from two views (closed form, then 5 clamped
    Gauss-Newton steps): (z_cur, ok, rel_sigma)."""
    h2h, rh1 = _hom(h_cur), _hom(h_prev) @ R.T
    a, c = cross(h2h, rh1), cross(h2h, t)
    den = torch.sum(a * a, -1)
    ok = den > 1e-3 * 1e-3
    z = -torch.sum(a * c, -1) / torch.where(ok, den, 1.0)
    ok = ok & (z > 0.02) & (z < 10.0)
    z1 = torch.where(ok, z, default_depth)
    zr = z1
    for _ in range(5):
        p = rh1 * zr[..., None] + t
        r = p[..., :2] / p[..., 2:3] - h_cur
        J = (rh1[..., :2] * p[..., 2:3] - p[..., :2] * rh1[..., 2:3]) / (
            p[..., 2:3] * p[..., 2:3])
        jtj, jtr = torch.sum(J * J, -1), torch.sum(J * r, -1)
        zr = torch.clamp(zr - jtr / torch.where(jtj > 1e-12, jtj, 1.0),
                         0.02, 10.0)
    z1 = torch.where(ok, zr, z1)
    z_cur = torch.clamp(rh1[..., 2] * z1 + t[2], 0.02, 10.0)
    rel = 1.0 / torch.clamp(torch.linalg.vector_norm(cross(h2h, rh1), dim=-1),
                            min=1e-6)
    return torch.where(ok, z_cur, default_depth), ok, rel


def _rho_vec(vals, n):
    z = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return torch.cat([torch.zeros(NB, dtype=vals.dtype, device=vals.device),
                      torch.stack([z, z, vals], -1).reshape(-1)])


def depth_bootstrap(s: State, cfg, cam, measured_uv, passed, qt) -> State:
    """Young tracked features whose depth, triangulated against the exact
    IMU motion, disagrees with their estimate get rho and its variance
    re-initialized (their rho rows and columns of Sigma wiped first)."""
    z_new, tri_ok, rel_sig = triangulate(
        s.klt_ref, measured_uv, quat_to_matrix(qt[0:4]), qt[4:7],
        cfg.default_point_depth)
    rho_new = 1.0 / z_new
    sigma_ang = math.sqrt(cfg.klt_measurement_variance_px) * 2.0 / (
        cam["fx"] + cam["fy"])
    good = sigma_ang * rel_sig < cfg.triangulation_max_rel_error
    rel = torch.clamp(2.0 * sigma_ang * rel_sig, min=cfg.bootstrap_depth_sigma_rel)
    sig_tri = rel * rho_new
    rho_old = s.feat_mu[:, 2]
    boot = ((s.age <= cfg.bootstrap_max_age) & tri_ok & good & passed
            & s.active & (torch.abs(rho_new - rho_old) > sig_tri))
    rho = torch.where(boot, rho_new, rho_old)
    n, dtype = s.n, s.Sigma.dtype
    keep = 1.0 - _rho_vec(boot.to(dtype), n)
    Sigma = s.Sigma * (keep[:, None] * keep[None, :])
    Sigma = Sigma + torch.diag(_rho_vec(
        torch.where(boot, sig_tri * sig_tri, 0.0).to(dtype), n))
    return s.replace(feat_mu=torch.cat([s.feat_mu[:, :2], rho[:, None]], 1),
                     Sigma=Sigma)


def _recover(s: State, cfg, lost) -> State:
    """Re-bootstrap on lost tracking: pose and biases kept (non-finite
    entries reset), every slot freed, kinematic variances re-inflated."""
    init_mu = _const([0.0] * 3 + [1.0] + [0.0] * 18, s.base_mu)
    base = torch.where(torch.isfinite(s.base_mu), s.base_mu, init_mu)
    qn = torch.linalg.vector_norm(base[3:7])
    q = torch.where(qn > 1e-6, base[3:7] / torch.clamp(qn, min=1e-6),
                    init_mu[3:7])
    base = torch.cat([base[:3], q, base[7:]])
    diag = torch.diagonal(s.Sigma)

    def safe(d, fallback):
        return torch.clamp(torch.where(torch.isfinite(d), d, fallback), min=0.0)

    sig = torch.cat([safe(diag[:7], cfg.init_pose_variance),
                     torch.full((9,), cfg.init_kinematic_variance,
                                dtype=diag.dtype, device=diag.device),
                     safe(diag[16:22], cfg.init_bias_variance),
                     torch.zeros(3 * s.n, dtype=diag.dtype, device=diag.device)])
    rec = dict(base_mu=base, active=torch.zeros_like(s.active),
               Sigma=torch.diag(sig), age=torch.zeros_like(s.age))
    return s.replace(**{k: torch.where(lost, v, getattr(s, k))
                        for k, v in rec.items()})


# ------------------------------------------------------------------ step

def step(s: State, img, t, cfg, cam, imu=None, gravity_w=None):
    """One frame: predict (random walk, or the interval's IMU samples
    ``imu`` = (dt [K], gyro [K, 3], accel [K, 3])), LK seeded at the
    predicted positions, kill box, depth bootstrap (IMU), update, drop of
    failed features, recovery, FAST replenishment.  Returns (state,
    outputs dict)."""
    dev = s.Sigma.device
    img = img.to(device=dev, dtype=torch.float32)
    t = torch.as_tensor(t, dtype=torch.float32).to(dev)
    s = s.replace(age=torch.where(s.active, s.age + 1, 0))
    dt = torch.clamp(t - s.t, min=0.0)
    qt = None
    if imu is not None:
        idt, gyro, accel = (x.to(dev) for x in imu)
        rem = torch.clamp(t - (s.t + idt.sum()), min=0.0)
        s, qt = propagate_imu(s, cfg, *_with_remainder(idt, gyro, accel, rem),
                              gravity_w.to(dev))
    else:
        s = predict(s, cfg, dt)
    s = s.replace(t=t)
    lin_base = s.base_mu

    cur_pyr = build_pyramid(img, cfg.klt_max_pyramid_level)
    prev_px = metric_to_pixel(cam, s.klt_ref)
    seed_px = metric_to_pixel(cam, s.feat_mu[:, :2])
    pts, status, _ = track(s.prev_pyr, cur_pyr, prev_px, seed_px, s.active, cfg)
    passed = status & in_kill_box(cam, pts, cfg.kill_pad)
    measured = pixel_to_metric(cam, pts)
    if imu is not None and cfg.triangulate_new_features:
        s = depth_bootstrap(s, cfg, cam, measured, passed, qt)

    meas_cov = measurement_cov(cam, s.n, cfg, dev)
    meas = passed & s.active
    cnt = torch.clamp(meas.sum(), min=1)
    mag = torch.linalg.vector_norm(measured - s.feat_mu[:, :2], dim=-1)
    innov = torch.sum(torch.where(meas, mag, 0.0)) / cnt
    nis = torch.sum(torch.where(meas, _nis_per_feature(s, measured, meas_cov),
                                0.0)) / cnt
    prior_var = torch.diagonal(s.Sigma).clone()
    s = update(s, cfg, measured, meas_cov, passed)
    num_tracked = torch.sum(passed & s.active, dtype=torch.int32)
    s = drop_features(s, s.active & ~passed)
    diag = torch.diagonal(s.Sigma)
    lost = ((num_tracked < cfg.minimum_trackable_features)
            | ~torch.isfinite(s.base_mu).all() | ~torch.isfinite(diag).all())
    if cfg.recover_on_tracking_lost:
        s = _recover(s, cfg, lost)
        lin_base = torch.where(lost, s.base_mu, lin_base)

    feat_px = metric_to_pixel(cam, s.feat_mu[:, :2])
    cand_px, cand_valid = replenish(img, feat_px, s.active, cfg, s.n)
    s = add_features(s, cfg, pixel_to_metric(cam, cand_px), cand_valid)
    out = {"base_mu": s.base_mu, "num_tracked": num_tracked,
           "num_active": s.active.sum(dtype=torch.int32),
           "mean_innovation": innov,
           "pose_cov_diag": torch.diagonal(s.Sigma)[:7],
           "tracking_lost": lost, "pos_cov": s.Sigma[:3, :3], "mean_nis": nis,
           "prior_var": prior_var}
    return s.replace(prev_pyr=cur_pyr, lin_base=lin_base), out


# -------------------------------------------------------- initialization

def initialize(img, t, cfg, cam) -> State:
    """Vision-only bootstrap on the first frame: the filter clock and the
    first feature set."""
    dev = img.device
    s = init_state(cfg, dev)
    s = s.replace(t=torch.as_tensor(t, dtype=torch.float32).to(dev).reshape(()))
    n = cfg.max_features
    px, valid = replenish(img.to(torch.float32), torch.zeros(n, 2, device=dev),
                          torch.zeros(n, dtype=torch.bool, device=dev), cfg, n)
    uv = pixel_to_metric(cam, px)
    s = add_features(s, cfg, uv, valid)
    s = s.replace(klt_ref=torch.where(valid[:, None], uv, s.klt_ref))
    return s.replace(prev_pyr=build_pyramid(img, cfg.klt_max_pyramid_level),
                     lin_base=s.base_mu)


def integrate_motion(times, imu_dt, imu_gyro, imu_accel, gravity_w,
                     v0=None, gyro_bias=None, accel_bias=None):
    """Rotations and v0-free translations frame 0 -> i over the first K
    frames, and the base state integrated to frame K-1."""
    k, s_per = times.shape[0], imu_dt.shape[1]
    zeros3 = torch.zeros(3, dtype=imu_accel.dtype, device=imu_accel.device)
    ident = _const([1.0, 0.0, 0.0, 0.0], imu_accel)
    v0 = zeros3 if v0 is None else v0
    bg = zeros3 if gyro_bias is None else gyro_bias
    ba = zeros3 if accel_bias is None else accel_bias
    x0 = torch.cat([zeros3, ident, v0, zeros3, zeros3, ba, bg, ident, zeros3])
    x_fin, xs = mean_chain(x0[None], imu_dt[:k - 1].reshape(-1),
                           imu_gyro[:k - 1].reshape(-1, 3),
                           imu_accel[:k - 1].reshape(-1, 3), gravity_w)
    x_fin, xs = x_fin[0], xs[0]
    ends = torch.cat([xs[s_per::s_per], x_fin[None]])
    quats = torch.cat([ident[None], ends[:, 22:26]])
    tcs = torch.cat([zeros3[None], ends[:, 26:29]])
    return quat_to_matrix(quats), tcs, times - times[0], x_fin[0:22]


def align(h_obs, valid, R_i, tc_i, tau_i, min_parallax=1e-4):
    """Joint linear solve for (v0, depths), depths eliminated by a Schur
    complement: (v0, depths0, depth_ok)."""
    h0, hi = _hom(h_obs[0]), _hom(h_obs[1:])
    Rh0 = torch.einsum("kab,nb->kna", R_i[1:], h0)
    A = cross(hi, Rh0)
    C = -cross(hi, tc_i[1:, None, :])
    M = -tau_i[1:, None, None, None] * torch.einsum("knab,kbc->knac", skew(hi),
                                                    R_i[1:])
    OK = (valid[1:] & valid[0][None])[..., None].to(A.dtype)
    A, M, C = A * OK, M * OK[..., None], C * OK
    ata = torch.sum(A * A, dim=(0, 2))
    cond_ok = ata > min_parallax
    ata_safe = torch.where(cond_ok, ata, 1.0)
    atM = torch.einsum("kna,knab->nb", A, M)
    atc = torch.einsum("kna,kna->n", A, C)
    MtM = torch.einsum("knab,knac->nbc", M, M)
    Mtc = torch.einsum("knab,kna->nb", M, C)
    w = cond_ok.to(A.dtype)
    proj = w / ata_safe
    H = torch.sum(w[:, None, None] * MtM
                  - proj[:, None, None] * atM[:, :, None] * atM[:, None, :], 0)
    b = torch.sum(w[:, None] * Mtc - proj[:, None] * atM * atc[:, None], 0)
    v0 = torch.linalg.solve(H + 1e-8 * torch.eye(3, dtype=H.dtype,
                                                 device=H.device), b)
    z = (atc - atM @ v0) / ata_safe
    return v0, z, cond_ok & (z > 0.01) & (z < 100.0)


def initialize_imu(images, times, imu_dt, imu_gyro, imu_accel, gravity_w,
                   cfg, cam, k) -> State:
    """Closed-form visual-inertial initialization over the first ``k``
    frames: chained LK tracks, ``vi_init_gn_rounds`` Gauss-Newton rounds
    on the IMU biases around the (v0, depths) solve, then the filter at
    frame k-1 with the aligned velocity, biases and depths."""
    dev, n = images.device, cfg.max_features
    px, valid = replenish(images[0], torch.zeros(n, 2, device=dev),
                          torch.zeros(n, dtype=torch.bool, device=dev), cfg, n)
    pyr = build_pyramid(images[0], cfg.klt_max_pyramid_level)
    hs, vs = [pixel_to_metric(cam, px)], [valid]
    for i in range(1, k):
        pyr_i = build_pyramid(images[i], cfg.klt_max_pyramid_level)
        pts, ok, _ = track(pyr, pyr_i, px, px, valid, cfg)
        valid = valid & ok & in_kill_box(cam, pts, cfg.kill_pad)
        pyr, px = pyr_i, pts
        hs.append(pixel_to_metric(cam, px))
        vs.append(valid)
    h_obs, valid_obs = torch.stack(hs), torch.stack(vs)
    imu = (times[:k], imu_dt[:k - 1], imu_gyro[:k - 1], imu_accel[:k - 1],
           gravity_w)
    if not (cfg.vi_init_estimate_gyro_bias and cfg.vi_init_estimate_accel_bias):
        raise ValueError("the plain reference covers the joint bias estimate")
    h0, hi = _hom(h_obs[0]), _hom(h_obs[1:])

    def residuals(b_, v0, z, depth_ok):
        R_i, tc_i, tau, _ = integrate_motion(*imu, gyro_bias=b_[0:3],
                                             accel_bias=b_[3:6])
        t_i = tc_i[1:] - tau[1:, None] * (R_i[1:] @ v0)
        p = (torch.einsum("kab,nb->kna", R_i[1:], h0) * z[None, :, None]
             + t_i[:, None, :])
        r = cross(hi, p)
        w = (valid_obs[1:] & valid_obs[0][None] & depth_ok[None]).to(r.dtype)
        return (r * w[..., None]).reshape(-1)

    b = torch.zeros(6, dtype=imu_accel.dtype, device=dev)
    damp = torch.diag(_const([1e-8] * 3 + [1e-4] * 3, imu_accel))
    for _ in range(cfg.vi_init_gn_rounds):
        R_i, tc_i, tau, _ = integrate_motion(*imu, gyro_bias=b[0:3],
                                             accel_bias=b[3:6])
        v0, z0, dok = align(h_obs, valid_obs, R_i, tc_i, tau)
        z = torch.where(dok, z0, 0.0)
        r = residuals(b, v0, z, dok)
        J = jacfwd(residuals)(b, v0, z, dok)
        delta = torch.clamp(torch.linalg.solve(J.T @ J + damp, -(J.T @ r)),
                            -0.2, 0.2)
        b = b + delta
        b = torch.cat([torch.clamp(b[0:3], -0.05, 0.05),
                       torch.clamp(b[3:6], -0.3, 0.3)])
    bg0, ba0 = b[0:3], b[3:6]
    R_i, tc_i, tau, _ = integrate_motion(*imu, gyro_bias=bg0, accel_bias=ba0)
    v0, z0, dok = align(h_obs, valid_obs, R_i, tc_i, tau)
    base22 = integrate_motion(*imu, v0=v0, gyro_bias=bg0, accel_bias=ba0)[3]
    base22 = torch.cat([base22[:16], ba0, bg0])

    RK, tcK = R_i[k - 1], tc_i[k - 1]
    tK = tcK - tau[k - 1] * (RK @ v0)
    pK = (torch.cat([h_obs[0], torch.ones(n, 1, device=dev)], -1) @ RK.T
          ) * z0[:, None] + tK
    keep = valid_obs[k - 1] & dok & (pK[:, 2] > 0.02)
    s = init_state(cfg, dev)
    s = s.replace(base_mu=base22, t=times[k - 1].clone())
    s = add_features(s, cfg, h_obs[k - 1], keep, depths=pK[:, 2])
    d = torch.diagonal(s.Sigma).clone()
    d[7:10] = cfg.init_aligned_velocity_variance
    d[16:19] = cfg.init_accel_bias_sigma ** 2
    d[19:22] = cfg.init_gyro_bias_sigma ** 2
    rho_idx = NB + 3 * torch.arange(n, device=dev) + 2
    sig_rho = cfg.bootstrap_depth_sigma_rel * s.feat_mu[:, 2]
    d[rho_idx] = torch.where(s.active, sig_rho * sig_rho, d[rho_idx])
    Sigma = s.Sigma.clone()
    Sigma.diagonal().copy_(d)
    return s.replace(Sigma=Sigma, prev_pyr=pyr, lin_base=base22)
