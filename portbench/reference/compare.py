"""The comparison that decides ``correct``: gaps between what the program
produced and what the plain reference works out from the same inputs.

Two numbers, each the worst over the compared frames:

* ``sigma_gap``: covariance entries, each scaled by the reference's
  standard deviations of its row and column, |dS_ij| / sqrt(S_ii S_jj),
  so every entry is judged on the scale of its own correlation whatever
  its units (rho variances of new features are 1e2, pose ones 1e-8);
  after a step each variance is floored at its float32 resolution
  (``resolution``): under a 1e-5 px^2 measurement variance a tracked
  feature's posterior variance (~2e-10) lies below the rounding of the
  update, whose results on the card come in steps of 2^-33, the float32
  spacing of the ~1e-3 variance it started from;
* ``mean_gap``: state entries in units of the reference's standard
  deviation, |dx_i| / sqrt(S_ii), over the base state and the live
  features.

A step whose discrete outcome differs (which slots are live, their ages,
the counts of tracked and live features, the tracking-lost flag) reads
``MISMATCH`` in both: its arithmetic cannot be compared.
"""
from __future__ import annotations

import torch

NB = 22
MISMATCH = 1.0e9


def _f64(x):
    return x.detach().to(torch.float64)


def _scaled_sigma_gap(Sp, Sr, rows, floor):
    """max |Sp - Sr|_ij / (s_i s_j) over i, j in ``rows`` whose scale
    s_i = sqrt(max(Sr_ii, floor_i)) is positive; the other rows of Sp
    must be exact zeros as in Sr."""
    d = torch.diagonal(Sr)
    scale = torch.maximum(d, floor)
    ok = rows & (scale > 0) & torch.isfinite(d)
    s = torch.sqrt(torch.where(ok, scale, 1.0))
    diff = (Sp - Sr).abs()
    G = diff[ok][:, ok] / (s[ok][:, None] * s[ok][None, :])
    rest = diff[~ok]
    if rest.numel() and not bool(torch.all(rest == 0)):
        return MISMATCH, G
    if not bool(torch.isfinite(G).all()):
        return MISMATCH, G
    return (float(G.max()) if G.numel() else 0.0), G


def resolution(ref_out: dict | None, dim: int) -> torch.Tensor | float:
    """Each variance's float32 resolution after a step's update: sqrt(D)
    eps32 times the variance the update started from (the probabilistic
    rounding bound of a length-D inner product).  Below it a variance is
    the residue of the update's cancellation, which neither side
    resolves; it is the floor of the scale each entry is judged on.  No
    floor for an initialization (``ref_out`` None)."""
    if ref_out is None or "prior_var" not in ref_out:
        return 0.0
    eps = torch.finfo(torch.float32).eps
    return (dim ** 0.5) * eps * _f64(ref_out["prior_var"]).clamp(min=0.0)


def state_gaps(prog, prog_out: dict, ref, ref_out: dict) -> dict:
    """Gaps of one step, or of one initialization (``prog_out`` and
    ``ref_out`` None): ``prog`` a program state read into the reference's
    ``State`` (``vio.from_program``), ``ref`` the reference's.  Each
    entry is judged on the reference's standard deviations; for the
    covariance they are floored at their float32 resolution
    (``resolution``), for the mean they are not (a mean is no residue of
    the update's cancellation, and the program passes without the floor)."""
    same = (torch.equal(prog.active, ref.active) and torch.equal(prog.age, ref.age))
    if prog_out is not None:
        for k in ("num_tracked", "num_active", "tracking_lost"):
            same = same and torch.equal(prog_out[k].reshape(()).to(torch.int64),
                                        ref_out[k].reshape(()).to(torch.int64))
    if not same:
        return {"sigma_gap": MISMATCH, "mean_gap": MISMATCH}
    rows = torch.cat([torch.ones(NB, dtype=torch.bool, device=ref.active.device),
                      ref.active.repeat_interleave(3)])
    Sp, Sr = _f64(prog.Sigma), _f64(ref.Sigma)
    d = torch.diagonal(Sr)
    floor = torch.zeros_like(d) + resolution(ref_out, d.numel())
    sg, G = _scaled_sigma_gap(Sp, Sr, torch.ones_like(rows), floor)
    xp = torch.cat([_f64(prog.base_mu), _f64(prog.feat_mu).reshape(-1)])
    xr = torch.cat([_f64(ref.base_mu), _f64(ref.feat_mu).reshape(-1)])
    ok = rows & (d > 0)
    # entries the filter holds as certain (zero variance, as the pose right
    # after the VI initialization) are judged relative to their value
    certain = rows & ~ok
    mg = torch.cat([(xp - xr).abs()[ok] / torch.sqrt(d[ok]),
                    (xp - xr).abs()[certain]
                    / xr.abs()[certain].clamp(min=1e-3)])
    if not bool(torch.isfinite(mg).all()):
        return {"sigma_gap": sg, "mean_gap": MISMATCH}
    dx = (xp - xr).abs() / torch.sqrt(torch.where(ok, d, 1.0))
    parts = {"base": dx[:NB][ok[:NB]], "features": dx[NB:][ok[NB:]],
             "certain": mg[int(ok.sum()):]}
    out = {"sigma_gap": sg, "mean_gap": float(mg.max()) if mg.numel() else 0.0,
           "parts": {k: float(v.max()) if v.numel() else 0.0
                     for k, v in parts.items()}}
    if sg != MISMATCH and G.numel():
        nb = int(ok[:NB].sum())
        out["parts"]["sigma_base"] = float(G[:nb].max())
        out["parts"]["sigma_features"] = float(G[nb:].max()) if G.shape[0] > nb else 0.0
    return out


def output_gaps(prog: dict, ref: dict) -> dict:
    """Gaps of one frame's outputs alone (no state): pose variances,
    position covariance and mean NIS for ``sigma_gap``; pose and mean
    innovation for ``mean_gap``."""
    for k in ("num_tracked", "num_active", "tracking_lost"):
        if not torch.equal(prog[k].reshape(()).to(torch.int64),
                           ref[k].reshape(()).to(torch.int64)):
            return {"sigma_gap": MISMATCH, "mean_gap": MISMATCH}
    pr = _f64(ref["pose_cov_diag"])
    ok = pr > 0
    dp = (_f64(prog["pose_cov_diag"]) - pr).abs()
    if not bool(torch.all(dp[~ok] == 0)):
        return {"sigma_gap": MISMATCH, "mean_gap": MISMATCH}
    sig = [dp[ok] / pr[ok]]
    names = ["pose_var"]
    C = _f64(ref["pos_cov"])
    dc = torch.diagonal(C)
    okc = dc > 0
    s = torch.sqrt(torch.where(okc, dc, 1.0))
    sig.append(((_f64(prog["pos_cov"]) - C).abs() / (s[:, None] * s[None, :]))[okc][:, okc].reshape(-1))
    nr = _f64(ref["mean_nis"]).reshape(1)
    sig.append((_f64(prog["mean_nis"]).reshape(1) - nr).abs() / nr.abs().clamp(min=1e-30))
    names += ["pos_cov", "nis"]
    mean = [(_f64(prog["base_mu"])[:7] - _f64(ref["base_mu"])[:7]).abs()[ok]
            / torch.sqrt(pr[ok])]
    ir = _f64(ref["mean_innovation"]).reshape(1)
    mean.append((_f64(prog["mean_innovation"]).reshape(1) - ir).abs() / ir.abs().clamp(min=1e-30))
    out = {"parts": {}}
    for k, parts, nm in (("sigma_gap", sig, names), ("mean_gap", mean, ["pose", "innovation"])):
        v = torch.cat([p.reshape(-1) for p in parts])
        out[k] = float(v.max()) if bool(torch.isfinite(v).all()) and v.numel() else (
            0.0 if not v.numel() else MISMATCH)
        out["parts"].update({n: float(p.max()) if p.numel() else 0.0
                             for n, p in zip(nm, parts)})
    return out


def worst(gaps: list) -> dict:
    """The worst of each gap over a list of per-frame gap dicts, with the
    worst of each part that made them."""
    out = {k: max((g[k] for g in gaps), default=0.0)
           for k in ("sigma_gap", "mean_gap")}
    parts = {}
    for g in gaps:
        for k, v in g.get("parts", {}).items():
            parts[k] = max(parts.get(k, 0.0), v)
    out["parts"] = parts
    return out
