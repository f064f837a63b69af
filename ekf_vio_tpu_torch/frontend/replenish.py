"""Feature replenishment: one best corner per free grid cell.

Port of ``ekf_vio_tpu/frontend/replenish.py`` (replenishFeatures,
EKFVIO.cpp:224-311, re-expressed as grid-cell binning): the frame is tiled
into cells of ``min_new_feature_dist``, a cell is blocked when an existing
feature lies within that distance of its best corner, and the free cells'
corners are ranked by response.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.frontend import fast, fast_cuda


def select_candidates(
    score_map: torch.Tensor,       # [H, W] NMS'd corner response
    existing_px: torch.Tensor,     # [N, 2] current feature positions (px)
    existing_valid: torch.Tensor,  # [N] bool
    needed: torch.Tensor,          # scalar int — how many to add
    cfg: VIOConfig,
    k_max: int,
):
    """Returns (cand_px [k_max, 2], cand_valid [k_max]): the top corners,
    one per free cell, ranked by response."""
    h, w = score_map.shape
    dev = score_map.device
    cell = max(int(cfg.min_new_feature_dist), 1)
    ch, cw = -(-h // cell), -(-w // cell)

    # kill-pad border rejection (EKFVIO.cpp:289, Frame.cpp:44-55)
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    pad = float(cfg.kill_pad)
    inbox = (xs >= pad) & (ys >= pad) & (w - xs >= pad) & (h - ys >= pad)
    score = torch.where(inbox, score_map, 0.0)

    score_p = F.pad(score, (0, cw * cell - w, 0, ch * cell - h))
    cells = score_p.reshape(ch, cell, cw, cell).permute(0, 2, 1, 3).reshape(
        ch, cw, cell * cell)
    cell_best, cell_arg = torch.max(cells, dim=-1)  # first index among ties
    cy = cell_arg // cell + torch.arange(ch, device=dev)[:, None] * cell
    cx = cell_arg % cell + torch.arange(cw, device=dev)[None, :] * cell

    bx = cx.reshape(-1).to(torch.float32)
    by = cy.reshape(-1).to(torch.float32)
    d2 = ((bx[None] - existing_px[:, 0:1]) ** 2
          + (by[None] - existing_px[:, 1:2]) ** 2)          # [N, C]
    near = torch.any((d2 < cfg.min_new_feature_dist ** 2)
                     & existing_valid[:, None], dim=0)
    cand_score = torch.where(near, 0.0, cell_best.reshape(-1))

    # stable descending sort: equal scores keep the lower cell index
    # first, as lax.top_k does
    k = min(k_max, cand_score.shape[0])
    top_score, top_idx = torch.sort(cand_score, descending=True, stable=True)
    top_score, top_idx = top_score[:k], top_idx[:k]
    rank = torch.arange(k, device=dev)
    valid = (top_score > 0.0) & (rank < needed)
    px = torch.stack([bx[top_idx], by[top_idx]], dim=-1)
    if k < k_max:
        px = torch.cat([px, px.new_zeros(k_max - k, 2)])
        valid = torch.cat([valid, valid.new_zeros(k_max - k)])
    return px, valid


def replenish(img: torch.Tensor, existing_px: torch.Tensor,
              existing_valid: torch.Tensor, cfg: VIOConfig, k_max: int):
    """Blur → FAST-9 + NMS → cell selection; needed = num_features −
    #active (EKFVIO.cpp:236-244)."""
    work = fast.gaussian_blur(img, cfg.fast_blur_sigma)
    score = fast_cuda.detect(work, float(cfg.fast_threshold))
    needed = cfg.num_features - existing_valid.sum()
    return select_candidates(score, existing_px, existing_valid, needed, cfg,
                             k_max)
