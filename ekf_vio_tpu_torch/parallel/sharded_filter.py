"""Distributed large-state filter: Σ block-partitioned over the mesh's
``state`` ranks, with the collectives written out.

Port of ``ekf_vio_tpu/parallel/sharded_filter.py`` (the Schur-style
block-partitioned covariance update of BASELINE.json config 5; the
distributed analog of the reference's gain solve and Joseph update,
TightlyCoupledEKF.cpp:559-596).

Representation
--------------
Σ is split so block boundaries align with the state structure (base
block 22 wide, feature blocks 3 wide), and each rank of the ``state``
group holds only its own blocks:

    bb   [22, 22]        base block                 — on every rank
    bf_l [22, 3N/ns]     base-feature cross columns — rank k's columns
    ff_l [3N/ns, 3N]     feature block rows         — rank k's rows

for the contiguous range of N/ns features rank k owns (``bf`` and ``ff``
fields of ``ShardedFilterState``).  The JAX module holds global arrays
sharded by GSPMD; here ``split_state`` cuts out the calling rank's
blocks and ``merge_state`` all-gathers them into the dense FilterState.
Per-rank covariance memory is O(D²/ns).

The algebra (module docstring of the JAX file): with U = HΣ (one
all-gather), the replicated S = U Hᵀ + R, V = S⁻¹U, K = Vᵀ,

    μ += Vᵀ y,   M = Σ − Vᵀ U,   Σ' = M − M[:, uv] V + Vᵀ R V,

every O(D²·M) product local to a rank's row block.  The collectives sit
where JAX places them: all-gathers of U and V, of Σbf Bᵀ in the predict
and of M_bf's uv columns, the all-to-all block transpose that
symmetrizes ff, and the compacted update's [22, 3N] gather.  The
numerical recipe (jitter, masking, Joseph form, quaternion renorm,
solve-failure guard) is that of ``core/update.py``; products run in true
f32 (callers keep TF32 off, ``engine.use_f32_matmul``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.device_mesh import DeviceMesh

from ekf_vio_tpu_torch.config import BASE_STATE_SIZE as NB, VIOConfig
from ekf_vio_tpu_torch.core import dynamics
from ekf_vio_tpu_torch.core import imu as imu_mod
from ekf_vio_tpu_torch.core import state as state_mod
from ekf_vio_tpu_torch.core.dynamics import blk_left, blk_right
from ekf_vio_tpu_torch.core.state import (FilterState, block_diag,
                                          register_dataclass_pytree)
from ekf_vio_tpu_torch.parallel.mesh import (all_gather, all_to_all_blocks,
                                             axis)

AXIS = "state"


@dataclasses.dataclass
class ShardedFilterState:
    """FilterState with Σ split into (bb, bf, ff); ``bf`` and ``ff`` hold
    this rank's blocks, everything else is whole on every rank."""
    base_mu: torch.Tensor  # [22]
    feat_mu: torch.Tensor  # [N, 3]
    active: torch.Tensor   # [N] bool
    klt_ref: torch.Tensor  # [N, 2]
    bb: torch.Tensor       # [22, 22]
    bf: torch.Tensor       # [22, 3N/ns]  this rank's columns
    ff: torch.Tensor       # [3N/ns, 3N]  this rank's rows
    t: torch.Tensor
    age: torch.Tensor      # [N] int32

    @property
    def n_max(self) -> int:
        return self.feat_mu.shape[-2]

    def replace(self, **kw) -> "ShardedFilterState":
        return dataclasses.replace(self, **kw)


register_dataclass_pytree(ShardedFilterState)


def aligned_feature_capacity(n_features: int, n_state: int) -> int:
    """Round the slot capacity up so each state rank owns whole features."""
    return -(-n_features // n_state) * n_state


def split_state(state: FilterState, mesh: DeviceMesh) -> ShardedFilterState:
    """The calling rank's blocks of a dense FilterState (whole on every
    rank).  Needs N divisible by the ``state`` size."""
    _, k, ns = axis(mesh, AXIS)
    n = state.n_max
    if n % ns:
        raise ValueError(f"{n} feature slots do not split over {ns} state "
                         f"ranks (aligned_feature_capacity)")
    n3b = 3 * n // ns
    S = state.Sigma
    lo, hi = NB + k * n3b, NB + (k + 1) * n3b
    return ShardedFilterState(
        base_mu=state.base_mu, feat_mu=state.feat_mu, active=state.active,
        klt_ref=state.klt_ref, bb=S[:NB, :NB].contiguous(),
        bf=S[:NB, lo:hi].contiguous(), ff=S[lo:hi, NB:].contiguous(),
        t=state.t, age=state.age)


def merge_state(s: ShardedFilterState, mesh: DeviceMesh) -> FilterState:
    """The dense FilterState on every rank: the blocks all-gathered along
    ``state``; Σ's lower-left block is bfᵀ, so Σ is symmetric across the
    base/feature boundary by construction."""
    g, _, _ = axis(mesh, AXIS)
    bf = all_gather(s.bf, g, dim=1)                           # [22, 3N]
    ff = all_gather(s.ff, g, dim=0)                           # [3N, 3N]
    Sigma = torch.cat([torch.cat([s.bb, bf], 1),
                       torch.cat([bf.T, ff], 1)], 0)
    return FilterState(base_mu=s.base_mu, feat_mu=s.feat_mu, active=s.active,
                       klt_ref=s.klt_ref, Sigma=Sigma, t=s.t, age=s.age)


# --------------------------------------------------------------------------
# Index helpers
# --------------------------------------------------------------------------


def _uv_of(nfeat: int, device) -> torch.Tensor:
    """(u, v) row indices within a 3·nfeat feature block."""
    base = 3 * torch.arange(nfeat, device=device)
    return torch.stack([base, base + 1], -1).reshape(-1)      # [2·nfeat]


def _transpose_ff(ff_l: torch.Tensor, group) -> torch.Tensor:
    """Row block k of ffᵀ from row-split ff: the all-to-all block
    transpose gives ff[:, my columns]."""
    return all_to_all_blocks(ff_l, group).T


# --------------------------------------------------------------------------
# Per-rank predict:  Σ ← F Σ Fᵀ + Q  with F = [[Fb, 0], [L, blkdiag(Ff)]]
# --------------------------------------------------------------------------


def _propagate_shard(bb, bf_l, ff_l, Fb, Ffb, Ff, q_base, q_feat,
                     mesh: DeviceMesh):
    """One covariance propagation on this rank's row/column block (the
    distributed form of ``dynamics.propagate_covariance_blocked``).

    Inputs other than the blocks are whole on every rank: Fb [22, 22],
    Ffb [N, 3, 22], Ff [N, 3, 3] (masked), q_base [22], q_feat [3N].  One
    [22, 3N] all-gather; everything else is local."""
    g, k, _ = axis(mesh, AXIS)
    n3b = ff_l.shape[0]          # 3·(N/ns)
    nb_feat = n3b // 3

    L = Ffb.reshape(-1, NB)                                   # [3N, 22]
    L_l = L[k * n3b:(k + 1) * n3b]                            # [3Nb, 22]
    Ff_l = Ff[k * nb_feat:(k + 1) * nb_feat]

    Sbb_Lt_l = bb @ L_l.T                                     # [22, 3Nb]
    Sbf_Bt_l = blk_right(bf_l, Ff_l)                          # [22, 3Nb]
    new_bf_l = Fb @ (Sbb_Lt_l + Sbf_Bt_l)

    # the one collective: assemble Σbf Bᵀ column blocks
    Sbf_Bt = all_gather(Sbf_Bt_l, g, dim=1)                   # [22, 3N]

    bb_Lt = bb @ L.T                                          # [22, 3N]
    term1 = L_l @ bb_Lt                                       # L Σbb Lᵀ rows
    term2 = L_l @ Sbf_Bt                                      # L (Σbf Bᵀ)
    term3 = Sbf_Bt_l.T @ L.T                                  # (L Σbf Bᵀ)ᵀ rows
    term4 = blk_right(blk_left(Ff_l, ff_l), Ff)               # B Σff Bᵀ rows

    new_ff_l = term1 + term2 + term3 + term4
    new_ff_l.diagonal(k * n3b).add_(q_feat[k * n3b:(k + 1) * n3b])

    new_bb = Fb @ bb @ Fb.T + torch.diag(q_base)
    new_bb = 0.5 * (new_bb + new_bb.T)
    return new_bb, new_bf_l, new_ff_l


# --------------------------------------------------------------------------
# Per-rank measurement update (Joseph form, gain solve distributed)
# --------------------------------------------------------------------------


def _gain(S, Ub_m, Uf_m_mycols, g):
    """Cholesky of the replicated S and V = S⁻¹U over this rank's columns;
    a failed factorization (read from the gathered V and the factor's
    info, the same on every rank) zeroes the gain.  Returns (Vb, Vf,
    Vf_l)."""
    L, info = torch.linalg.cholesky_ex(S)
    Vb = torch.cholesky_solve(Ub_m, L)                        # [2M, 22]
    Vf_l = torch.cholesky_solve(Uf_m_mycols.contiguous(), L)  # [2M, 3Nb]
    Vf = all_gather(Vf_l, g, dim=1)                           # [2M, 3N]
    # the solve-failure guard (TightlyCoupledEKF.cpp:579)
    solve_ok = (torch.isfinite(Vb).all() & torch.isfinite(Vf).all()
                & (info == 0))
    return (torch.where(solve_ok, Vb, 0.0), torch.where(solve_ok, Vf, 0.0),
            torch.where(solve_ok, Vf_l, 0.0))


def _masked_S(Uf_uv, meas_cov, m, cfg: VIOConfig):
    """S = HΣHᵀ + R, masked and floored exactly as the dense update."""
    S = Uf_uv + block_diag(meas_cov)
    S = S * (m[:, None] * m[None, :]) + torch.diag(1.0 - m)
    lam = cfg.sigma_jitter + cfg.sigma_jitter_rel * torch.max(
        torch.diagonal(S) * m)
    return S + lam * torch.eye(S.shape[0], dtype=S.dtype, device=S.device)


def _rmul(Rb, X):
    """(blkdiag(Rb) @ X) for Rb [M, 2, 2] and X [2M, c]."""
    m = Rb.shape[0]
    return torch.einsum("nij,njc->nic", Rb, X.reshape(m, 2, -1)).reshape(
        2 * m, -1)


def _renorm(base):
    return torch.cat([base[:3], base[3:7] / torch.linalg.vector_norm(
        base[3:7]), base[7:]])


def _update_shard(bb, bf_l, ff_l, base_mu, feat_mu, klt_ref, measured_uv,
                  meas_cov, meas, cfg: VIOConfig, mesh: DeviceMesh):
    """The distributed EKF update (module docstring).  ``meas`` [N] bool
    is the effective measurement mask (passed & active), whole on every
    rank.  Mirrors core/update.py step for step."""
    g, k, _ = axis(mesh, AXIS)
    n = feat_mu.shape[0]
    n3b = ff_l.shape[0]
    dev, dtype = ff_l.device, ff_l.dtype

    uvg = _uv_of(n, dev)          # [2N] (u,v) rows within the 3N block
    uvl = _uv_of(n3b // 3, dev)   # [2Nb] within my rows
    m = meas.repeat_interleave(2).to(dtype)                   # [2N]

    # ---- U = HΣ, gathered:  [2N, 22] ⊕ [2N, 3N]
    Ub = all_gather(bf_l[:, uvl].T, g, dim=0)                 # [2N, 22]
    Uf = all_gather(ff_l[uvl, :], g, dim=0)                   # [2N, 3N]

    S = _masked_S(Uf[:, uvg], meas_cov, m, cfg)
    Ub_m = Ub * m[:, None]
    Uf_m = Uf * m[:, None]
    Uf_m_mycols = Uf_m[:, k * n3b:(k + 1) * n3b]
    Vb, Vf, Vf_l = _gain(S, Ub_m, Uf_m_mycols, g)

    # ---- mean update  μ += Ky = Vᵀ y
    y = (measured_uv.reshape(-1) - feat_mu.reshape(-1)[uvg]) * m
    new_base = _renorm(base_mu + Vb.T @ y)
    new_feat = feat_mu.reshape(-1) + Vf.T @ y

    # ---- Joseph covariance:  M = Σ − Vᵀ U;  Σ' = M − M[:,uv] V + Vᵀ R V
    M_bb = bb - Vb.T @ Ub_m                                   # [22, 22]
    M_bf_l = bf_l - Vb.T @ Uf_m_mycols                        # [22, 3Nb]
    M_ff_l = ff_l - Vf_l.T @ Uf_m                             # [3Nb, 3N]
    Mbf_uv = all_gather(M_bf_l[:, uvl], g, dim=1)             # [22, 2N]

    # R is 2x2 block diagonal (masked: R_i · meas_i), applied blockwise
    Rb = meas_cov * meas[:, None, None].to(dtype)             # [N, 2, 2]
    new_bb = M_bb - Mbf_uv @ Vb + Vb.T @ _rmul(Rb, Vb)
    new_bb = 0.5 * (new_bb + new_bb.T)
    new_bf_l = M_bf_l - Mbf_uv @ Vf_l + Vb.T @ _rmul(Rb, Vf_l)
    new_ff_l = M_ff_l - M_ff_l[:, uvg] @ Vf + Vf_l.T @ _rmul(Rb, Vf)
    # distributed symmetrization of ff (the dense path's 0.5(Σ+Σᵀ))
    new_ff_l = 0.5 * (new_ff_l + _transpose_ff(new_ff_l, g))

    new_klt = torch.where(meas[:, None], measured_uv, klt_ref)
    return (new_bb, new_bf_l, new_ff_l, new_base, new_feat.reshape(n, 3),
            new_klt)


def _update_shard_compact(bb, bf_l, ff_l, base_mu, feat_mu, klt_ref,
                          measured_uv, meas_cov, meas, idx_c,
                          cfg: VIOConfig, mesh: DeviceMesh):
    """Compacted distributed update: only the B = len(idx_c) slots the
    caller gathered enter the factorization (the dense compacted path of
    core/update.py, with the collectives of ``_update_shard``; the
    replicated Cholesky runs at [2B, 2B])."""
    g, k, _ = axis(mesh, AXIS)
    n = feat_mu.shape[0]
    n3b = ff_l.shape[0]
    dev, dtype = ff_l.device, ff_l.dtype
    b = idx_c.shape[0]

    uvl = _uv_of(n3b // 3, dev)
    two = torch.arange(2, device=dev)[None, :]
    uvg_c = (3 * idx_c[:, None] + two).reshape(-1)            # [2B]
    row_c = (2 * idx_c[:, None] + two).reshape(-1)            # [2B]
    m = meas[idx_c].repeat_interleave(2).to(dtype)            # [2B]

    # ---- U = HΣ over ALL uv rows (the full path's collectives), then the
    # compacted row set, whole on every rank
    Ub = all_gather(bf_l[:, uvl].T, g, dim=0)                 # [2N, 22]
    Uf = all_gather(ff_l[uvl, :], g, dim=0)                   # [2N, 3N]
    Ub_c, Uf_c = Ub[row_c], Uf[row_c]                         # [2B, ...]

    S = _masked_S(Uf_c[:, uvg_c], meas_cov[idx_c], m, cfg)
    Ub_m = Ub_c * m[:, None]
    Uf_m = Uf_c * m[:, None]
    Uf_m_mycols = Uf_m[:, k * n3b:(k + 1) * n3b]
    Vb, Vf, Vf_l = _gain(S, Ub_m, Uf_m_mycols, g)

    y = (measured_uv[idx_c].reshape(-1) - feat_mu.reshape(-1)[uvg_c]) * m
    new_base = _renorm(base_mu + Vb.T @ y)
    new_feat = feat_mu.reshape(-1) + Vf.T @ y

    M_bb = bb - Vb.T @ Ub_m
    M_bf_l = bf_l - Vb.T @ Uf_m_mycols
    M_ff_l = ff_l - Vf_l.T @ Uf_m
    # M_bf's columns at the compacted uv positions span ranks: gather the
    # whole bf row block (22·3N, the same order as the full path's 22·2N)
    Mbf_uv = all_gather(M_bf_l, g, dim=1)[:, uvg_c]           # [22, 2B]

    Rb = meas_cov[idx_c] * meas[idx_c][:, None, None].to(dtype)  # [B,2,2]
    new_bb = M_bb - Mbf_uv @ Vb + Vb.T @ _rmul(Rb, Vb)
    new_bb = 0.5 * (new_bb + new_bb.T)
    new_bf_l = M_bf_l - Mbf_uv @ Vf_l + Vb.T @ _rmul(Rb, Vf_l)
    new_ff_l = M_ff_l - M_ff_l[:, uvg_c] @ Vf + Vf_l.T @ _rmul(Rb, Vf)
    new_ff_l = 0.5 * (new_ff_l + _transpose_ff(new_ff_l, g))

    # every measured feature caches its tracker result, the measured but
    # over-budget ones too (as the dense compacted path)
    new_klt = torch.where(meas[:, None], measured_uv, klt_ref)
    return (new_bb, new_bf_l, new_ff_l, new_base, new_feat.reshape(n, 3),
            new_klt)


# --------------------------------------------------------------------------
# Per-rank slot reset and IMU-interval covariance terms
# --------------------------------------------------------------------------


def _slot_reset_shard(bf_l, ff_l, wipe3, diag_new, mesh: DeviceMesh):
    """wipe3 [3N] bool: feature-state rows/cols to clear; diag_new [3N]:
    values written on the cleared diagonal entries (0 for drops)."""
    _, k, _ = axis(mesh, AXIS)
    n3b = ff_l.shape[0]
    w_l = wipe3[k * n3b:(k + 1) * n3b]
    d_l = diag_new[k * n3b:(k + 1) * n3b]
    bf_l = torch.where(w_l[None, :], 0.0, bf_l)
    ff_l = torch.where(w_l[:, None] | wipe3[None, :], 0.0, ff_l)
    diag = ff_l.diagonal(k * n3b)
    diag.copy_(torch.where(w_l, d_l, diag))
    return bf_l, ff_l


def _imu_cov_shard(bb, bf_l, ff_l, Fb, Ffb, Ff, q_feat, Q29, W,
                   mesh: DeviceMesh):
    """The split-Σ analog of the Σ algebra of
    ``imu.propagate_imu_batch_with_motion``: blocked FΣFᵀ + Q plus the
    interval's IMU noise (base block Q29[:22, :22], rank-7 feature block
    W Q29_qt Wᵀ and the cross terms)."""
    g, k, _ = axis(mesh, AXIS)
    n3b = ff_l.shape[0]
    bb2, bf_l2, ff_l2 = _propagate_shard(
        bb, bf_l, ff_l, Fb, Ffb, Ff, torch.zeros(NB, dtype=bb.dtype,
                                                 device=bb.device),
        q_feat, mesh)
    Wm = W.reshape(-1, 7)                                     # [3N, 7]
    Wm_l = Wm[k * n3b:(k + 1) * n3b]                          # [3Nb, 7]
    bb2 = bb2 + Q29[:NB, :NB]
    bb2 = 0.5 * (bb2 + bb2.T)
    bf_l2 = bf_l2 + Q29[:NB, NB:] @ Wm_l.T                    # [22, 3Nb]
    ff_l2 = ff_l2 + Wm_l @ Q29[NB:, NB:] @ Wm.T               # [3Nb, 3N]
    ff_l2 = 0.5 * (ff_l2 + _transpose_ff(ff_l2, g))
    return bb2, bf_l2, ff_l2


# --------------------------------------------------------------------------
# Public ops on ShardedFilterState
# --------------------------------------------------------------------------


def sharded_predict(state: ShardedFilterState, cfg: VIOConfig, dt,
                    mesh: DeviceMesh) -> ShardedFilterState:
    """Distributed analog of ``core.filter.predict`` (the vision
    random-walk process): Jacobian blocks whole on every rank (O(N)),
    the covariance propagation on the blocks."""
    dev, dtype = state.bb.device, state.bb.dtype
    dt = state_mod.device_scalar(dt, state.base_mu.dtype, dev)
    Fb, Ffb, Ff = dynamics.process_jacobian_blocks(state.base_mu,
                                                   state.feat_mu, dt)
    Ffb, Ff = dynamics.mask_feature_jacobians(Ffb, Ff, state.active)
    q = dynamics.process_noise_diag(dt, state.n_max, state.active,
                                    cfg).to(dtype)
    bb, bf, ff = _propagate_shard(state.bb, state.bf, state.ff, Fb, Ffb, Ff,
                                  q[:NB], q[NB:], mesh)
    new_feat = dynamics.convolve_features(state.base_mu, state.feat_mu, dt)
    feat_mu = torch.where(state.active[:, None], new_feat, state.feat_mu)
    base_mu = dynamics.convolve_base_state(state.base_mu, dt)
    return state.replace(base_mu=base_mu, feat_mu=feat_mu, bb=bb, bf=bf,
                         ff=ff, t=state.t + dt)


def sharded_update(state: ShardedFilterState, cfg: VIOConfig, measured_uv,
                   meas_cov, passed, mesh: DeviceMesh,
                   budget: int | None = None) -> ShardedFilterState:
    """Distributed analog of ``core.update.update_with_feature_positions``.

    ``budget`` compacts the measured subset before the gain solve, as the
    dense path does: the replicated Cholesky, the serial term of the
    distributed update, shrinks from [2N, 2N] to [2·budget, 2·budget]."""
    meas = passed & state.active
    args = (state.bb, state.bf, state.ff, state.base_mu, state.feat_mu,
            state.klt_ref, measured_uv, meas_cov, meas)
    if budget is not None and budget < state.n_max:
        # stable sort of ~meas: measured slots first, in slot order
        idx_c = torch.argsort((~meas).to(torch.int8), stable=True)[:budget]
        out = _update_shard_compact(*args, idx_c, cfg, mesh)
    else:
        out = _update_shard(*args, cfg, mesh)
    bb, bf, ff, base_mu, feat_mu, klt_ref = out
    return state.replace(bb=bb, bf=bf, ff=ff, base_mu=base_mu,
                         feat_mu=feat_mu, klt_ref=klt_ref)


def sigma_slot_reset(state: ShardedFilterState, wipe3, diag3,
                     mesh: DeviceMesh) -> ShardedFilterState:
    """Σ side of slot (re)allocation: wipe3 [3N] feature-state rows/cols
    to clear, diag3 [3N] (or [N, 3]) new diagonal values (also the IMU
    depth re-init, which wipes only ρ rows)."""
    bf, ff = _slot_reset_shard(state.bf, state.ff, wipe3, diag3.reshape(-1),
                               mesh)
    return state.replace(bf=bf, ff=ff)


def sharded_add_features(state: ShardedFilterState, cfg: VIOConfig, new_uv,
                         valid, mesh: DeviceMesh, depths=None,
                         depth_vars=None) -> ShardedFilterState:
    """Distributed analog of ``core.state.add_features`` (the same slot
    plan and per-candidate depth priors)."""
    n = state.n_max
    dev, dtype = state.bb.device, state.bb.dtype
    take, src = state_mod.plan_insertion(state.active, valid)
    if depths is None:
        rho = torch.full((n, 1), 1.0 / cfg.default_point_depth,
                         dtype=state.feat_mu.dtype, device=dev)
    else:
        rho = (1.0 / torch.clamp(depths[src], 1e-3, 1e3))[:, None]
    uv_src = new_uv[src]
    feat_mu = torch.where(take[:, None], torch.cat([uv_src, rho], -1),
                          state.feat_mu)
    klt_ref = torch.where(take[:, None], uv_src, state.klt_ref)
    active = state.active | take
    age = torch.where(take, 0, state.age)

    if depth_vars is None:
        dvar = torch.full((n,), cfg.default_point_depth_variance,
                          dtype=dtype, device=dev)
    else:
        dvar = torch.clamp(depth_vars[src], 1e-8,
                           cfg.default_point_depth_variance)
    hv = torch.full((n,), cfg.default_point_homogenous_variance,
                    dtype=dtype, device=dev)
    prior = torch.where(take[:, None], torch.stack([hv, hv, dvar], -1), 0.0)
    state = sigma_slot_reset(state, take.repeat_interleave(3), prior, mesh)
    return state.replace(feat_mu=feat_mu, klt_ref=klt_ref, active=active,
                         age=age)


def sharded_drop_features(state: ShardedFilterState, drop,
                          mesh: DeviceMesh) -> ShardedFilterState:
    drop = drop & state.active
    state = sigma_slot_reset(
        state, drop.repeat_interleave(3),
        torch.zeros(3 * state.n_max, dtype=state.bb.dtype,
                    device=state.bb.device), mesh)
    return state.replace(active=state.active & ~drop)


def sharded_propagate_imu_batch(state: ShardedFilterState, cfg: VIOConfig,
                                batch, gravity_w, mesh: DeviceMesh,
                                lin_base=None):
    """Distributed analog of ``imu.propagate_imu_batch_with_motion``: the
    29-dim mean / Jacobian chain whole on every rank (tiny), the [D, D]
    covariance algebra on the blocks.  Returns (state, qt).
    ``lin_base`` selects first-estimate Jacobians as in the dense path."""
    dtype = state.bb.dtype
    base_mu, qt, qt_lin, J, Q29, total_dt = imu_mod.compound_interval(
        state.base_mu, cfg, batch, gravity_w, lin_base=lin_base)

    # the dense path's FEJ coverage: transport Jacobians at the lin chain's
    # compound motion, mean transport at the posterior's
    Fb = J[:NB, :NB]
    new_feat = imu_mod.compound_transport(state.feat_mu, qt)
    _, Ff, W = dynamics.transport_jacobians(state.feat_mu, qt_lin)
    Ffb = torch.einsum("nij,jb->nib", W, J[NB:, :NB])
    Ffb, Ff = dynamics.mask_feature_jacobians(Ffb, Ff, state.active)
    W = torch.where(state.active[:, None, None], W, 0.0)
    q_feat = (torch.where(state.active[:, None], cfg.q_feature, 0.0)
              * torch.ones(state.n_max, 3, dtype=dtype,
                           device=state.bb.device) * total_dt).reshape(-1)

    bb, bf, ff = _imu_cov_shard(state.bb, state.bf, state.ff, Fb, Ffb, Ff,
                                q_feat, Q29, W, mesh)
    feat_mu = torch.where(state.active[:, None], new_feat, state.feat_mu)
    return state.replace(base_mu=base_mu, feat_mu=feat_mu, bb=bb, bf=bf,
                         ff=ff, t=state.t + total_dt), qt
