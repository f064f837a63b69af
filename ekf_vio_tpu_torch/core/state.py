"""FilterState: the whole EKF state as a fixed-capacity set of tensors.

Port of ``ekf_vio_tpu/core/state.py``.  ``N_max`` feature slots with an
``active`` mask stand in for the reference's dynamic feature list
(TightlyCoupledEKF.h:29-34); Σ is a dense f32 ``[D, D]`` matrix with
``D = 22 + 3·N_max``.  Shapes never change, so a step runs without host
syncs.  Feature i's block sits at rows ``22+3i .. 22+3i+2``; ``uv_rows``
and ``uv_cols`` reach it through reshaped views of the feature tail.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch

from ekf_vio_tpu_torch.config import BASE_STATE_SIZE, VIOConfig


@dataclasses.dataclass
class FilterState:
    base_mu: torch.Tensor  # [22]
    feat_mu: torch.Tensor  # [N_max, 3]  (u, v, 1/depth)
    active: torch.Tensor   # [N_max] bool
    klt_ref: torch.Tensor  # [N_max, 2]  last tracker result (metric), Feature.h:43
    Sigma: torch.Tensor    # [D, D] dense covariance
    t: torch.Tensor        # scalar f32 time (seconds)
    age: torch.Tensor      # [N_max] int32 — frames since slot allocation

    @property
    def n_max(self) -> int:
        return self.feat_mu.shape[-2]

    @property
    def state_dim(self) -> int:
        return BASE_STATE_SIZE + 3 * self.n_max

    @property
    def device(self) -> torch.device:
        return self.base_mu.device

    def num_active(self) -> torch.Tensor:
        return torch.sum(self.active.to(torch.int32), dim=-1, dtype=torch.int32)

    def mu_flat(self) -> torch.Tensor:
        """[base | features] as the single state vector of the update."""
        return torch.cat([self.base_mu, self.feat_mu.reshape(-1)], dim=-1)

    def replace(self, **kw) -> "FilterState":
        return dataclasses.replace(self, **kw)


def device_constant(values, dtype=torch.float32, device=None
                    ) -> torch.Tensor:
    """A 1-D tensor of Python numbers made on ``device`` by fills (one
    ``torch.full`` per run of equal values), bitwise what ``torch.tensor``
    gives: ``torch.tensor(values, device=...)`` copies from host memory,
    which a capturing CUDA stream refuses."""
    return torch.cat([torch.full((len(list(run)),), v, dtype=dtype,
                                 device=device)
                      for v, run in itertools.groupby(values)])


def device_scalar(x, dtype, device) -> torch.Tensor:
    """``x`` (a Python number or a tensor) as a 0-d tensor on ``device``;
    a number by a fill, not a host copy (see ``device_constant``)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    return torch.full((), x, dtype=dtype, device=device)


def register_dataclass_pytree(cls) -> None:
    """Make a dataclass of tensors a pytree, so ``torch.func.vmap`` maps
    over its fields (idempotent)."""
    from torch.utils import _pytree

    if cls in _pytree.SUPPORTED_NODES:
        return
    names = [f.name for f in dataclasses.fields(cls)]
    _pytree.register_pytree_node(
        cls, lambda x: ([getattr(x, k) for k in names], None),
        lambda values, _: cls(**dict(zip(names, values))),
        serialized_type_name=f"{cls.__module__}.{cls.__qualname__}")


register_dataclass_pytree(FilterState)


def init_state(cfg: VIOConfig, t0: float = 0.0, device=None,
               dtype=torch.float32) -> FilterState:
    """Initial state (TightlyCoupledEKF.cpp:23-56): unit quaternion, pose
    variance 0, kinematic variance 30, bias variance 0.5, every slot
    inactive at the default-depth prior."""
    n = cfg.max_features
    kw = dict(device=device, dtype=dtype)
    base_mu = torch.zeros(BASE_STATE_SIZE, **kw)
    base_mu[3] = 1.0
    sig_diag = torch.cat([
        torch.full((7,), cfg.init_pose_variance, **kw),
        torch.full((9,), cfg.init_kinematic_variance, **kw),
        torch.full((6,), cfg.init_bias_variance, **kw),
        torch.zeros(3 * n, **kw),
    ])
    feat_mu = torch.zeros(n, 3, **kw)
    feat_mu[:, 2] = 1.0 / cfg.default_point_depth
    return FilterState(
        base_mu=base_mu,
        feat_mu=feat_mu,
        active=torch.zeros(n, dtype=torch.bool, device=device),
        klt_ref=torch.zeros(n, 2, **kw),
        Sigma=torch.diag(sig_diag),
        t=torch.full((), t0, **kw),
        age=torch.zeros(n, dtype=torch.int32, device=device),
    )


def plan_insertion(active: torch.Tensor, valid: torch.Tensor):
    """Slot assignment: candidate j goes to the j-th free slot.

    Returns (take [N] bool — slots that get filled, src [N] int64 — the
    candidate index each slot receives), with static shapes."""
    k = valid.shape[0]
    free = ~active
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    cand_rank = torch.cumsum(valid.to(torch.int32), 0) - 1
    n_insert = torch.minimum(free.sum(), valid.sum())
    take = free & (free_rank < n_insert)
    # scatter each valid candidate to its rank; invalid ones land in a
    # spill entry k that is sliced off (JAX's mode="drop")
    dest = torch.where(valid, cand_rank.long(), k)
    idx_of_rank = torch.zeros(k + 1, dtype=torch.long,
                              device=valid.device).scatter(
        0, dest, torch.arange(k, device=valid.device))
    src = idx_of_rank[:k][free_rank.clamp(0, k - 1).long()]
    return take, src


def uv_cols(M: torch.Tensor) -> torch.Tensor:
    """[D, 2N] = M[:, uv_idx]: the (u, v) columns of every slot."""
    tail = M[:, BASE_STATE_SIZE:]
    return tail.reshape(M.shape[0], -1, 3)[:, :, :2].reshape(M.shape[0], -1)


def uv_rows(M: torch.Tensor) -> torch.Tensor:
    """[2N, ...] = M[uv_idx]: the (u, v) rows of every slot."""
    tail = M[BASE_STATE_SIZE:]
    blk = tail.reshape((-1, 3) + tail.shape[1:])[:, :2]
    return blk.reshape((-1,) + M.shape[1:])


def block_diag(B: torch.Tensor) -> torch.Tensor:
    """[N, k, k] blocks → [kN, kN] block-diagonal matrix."""
    n, k, _ = B.shape
    eye = torch.eye(n, dtype=B.dtype, device=B.device)
    return (B[:, :, None, :] * eye[:, None, :, None]).reshape(n * k, n * k)


def slot_keep(mask: torch.Tensor, dtype) -> torch.Tensor:
    """[D] multiplicative keep vector: 0 on the rows of masked slots."""
    head = torch.ones(BASE_STATE_SIZE, dtype=dtype, device=mask.device)
    return torch.cat([head, 1.0 - mask.repeat_interleave(3).to(dtype)])


def add_features(state: FilterState, cfg: VIOConfig, new_uv: torch.Tensor,
                 valid: torch.Tensor, depths: torch.Tensor | None = None,
                 depth_vars: torch.Tensor | None = None) -> FilterState:
    """Insert up to K candidates into free slots (addNewFeatures,
    TightlyCoupledEKF.cpp:58-94): default-depth prior, diagonal variance
    [σ_uv, σ_uv, σ_ρ], rows/cols of the reused slot wiped first.

    new_uv: [K, 2] normalized-metric positions; valid: [K] bool;
    depths / depth_vars: optional [K] per-candidate priors."""
    n = state.n_max
    dtype = state.Sigma.dtype
    take, src = plan_insertion(state.active, valid)

    if depths is None:
        rho = torch.full((n, 1), 1.0 / cfg.default_point_depth,
                         dtype=state.feat_mu.dtype, device=state.device)
    else:
        rho = (1.0 / torch.clamp(depths[src], 1e-3, 1e3))[:, None]
    uv_src = new_uv[src]
    new_mu = torch.cat([uv_src, rho], dim=-1)
    feat_mu = torch.where(take[:, None], new_mu, state.feat_mu)
    klt_ref = torch.where(take[:, None], uv_src, state.klt_ref)
    active = state.active | take

    keep = slot_keep(take, dtype)
    Sigma = state.Sigma * (keep[:, None] * keep[None, :])
    if depth_vars is None:
        dvar = torch.full((n,), cfg.default_point_depth_variance,
                          dtype=dtype, device=state.device)
    else:
        dvar = torch.clamp(depth_vars[src], 1e-8,
                           cfg.default_point_depth_variance)
    hv = torch.full((n,), cfg.default_point_homogenous_variance,
                    dtype=dtype, device=state.device)
    prior = torch.where(take[:, None], torch.stack([hv, hv, dvar], -1), 0.0)
    # taken rows were just wiped, so adding the prior sets it exactly
    diag = torch.diagonal(Sigma)
    diag[BASE_STATE_SIZE:] += prior.reshape(-1)

    age = torch.where(take, 0, state.age)
    return state.replace(feat_mu=feat_mu, active=active, klt_ref=klt_ref,
                         Sigma=Sigma, age=age)


def drop_features(state: FilterState, drop: torch.Tensor) -> FilterState:
    """Free slots; their Σ rows/cols are zeroed so they cannot
    re-correlate (the cleanup the reference never performs)."""
    drop = drop & state.active
    keep = slot_keep(drop, state.Sigma.dtype)
    Sigma = state.Sigma * (keep[:, None] * keep[None, :])
    return state.replace(active=state.active & ~drop, Sigma=Sigma)


def check_sigma(state: FilterState):
    """Invariant audit (checkSigma, TightlyCoupledEKF.cpp:699-714):
    returns (min diagonal, max asymmetry)."""
    diag = torch.diagonal(state.Sigma)
    asym = torch.max(torch.abs(state.Sigma - state.Sigma.T))
    return torch.min(diag), asym
