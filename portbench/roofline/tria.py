"""The least time of the QR triangularizations of one replayed
square-root-form step.

A mono-inertial step in factor form (``core/sqrt_filter.py``) factors five
pre-arrays [m, n], every one of them in every replayed step (a captured
graph runs each, whatever the frame holds), with D = 22 + 3 N state rows
and 2 N measurement rows at N slots:

* ``imu``: [(F L)ᵀ; (T C29)ᵀ; diag √q] — (2 D + 29) × D;
* ``update``: the array [[√R, H L], [0, L]]ᵀ — (2 N + D) × (2 N + D);
* ``posterior``: [((I − K H) L)ᵀ; (K √R)ᵀ] — (D + 2 N) × D;
* ``wipe`` twice, the depth re-prime and the slot add: [(P L)ᵀ; diag √v]
  — 2 D × D.

A Householder QR of an m × n array (m ≥ n) needs 2 m n² − ⅔ n³ operations
and must read the array once and write its triangle: m n + n² / 2 words of
4 bytes.  Each QR's least time is the larger of its bytes over the HBM
rate and its operations over the f32 rate; the step's is their sum, as
each QR waits for the one before it.  Nothing else of the step is
counted, so a share of it cannot pass 100 %.
"""
from __future__ import annotations

import json
from pathlib import Path

NB = 22
WORD = 4


def shapes(n_slots: int) -> dict:
    """role -> the [m, n] shapes of the pre-arrays a replayed mono-inertial
    step in factor form triangularizes, at ``n_slots`` slots."""
    d, two_n = NB + 3 * n_slots, 2 * n_slots
    return {"imu": [(2 * d + 29, d)], "update": [(two_n + d, two_n + d)],
            "posterior": [(d + two_n, d)], "wipe": [(2 * d, d), (2 * d, d)]}


def qr_work(m: int, n: int) -> tuple:
    """(bytes, flops) of the Householder QR of an m × n array, m ≥ n."""
    if m < n:
        raise ValueError(f"a {m} x {n} array is wider than tall")
    return WORD * (m * n + n * n / 2), 2 * m * n * n - 2 * n ** 3 / 3


def peaks(kind: str) -> dict:
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    if kind not in table:
        raise KeyError(f"no published peaks for {kind!r} in peaks.json")
    return table[kind]


def bound_s(n_slots: int, kind: str) -> float:
    """Seconds the card needs at least for one step's QRs."""
    p = peaks(kind)
    return sum(max(b / p["hbm_bytes_per_s"], f / p["f32_flops_per_s"])
               for arrays in shapes(n_slots).values()
               for b, f in (qr_work(m, n) for m, n in arrays))


def run_bound_ms() -> float | None:
    """The bound of the benchmark run this process makes (its cell's
    configuration, the card it runs on), in ms; None outside a run, for a
    configuration not in factor form, or on a card without published
    peaks."""
    import torch

    from portbench import spans
    from portbench.harness import HERE, load_json

    run = spans._run_args()
    if run is None or not torch.cuda.is_available():
        return None
    cell = load_json(HERE / "workloads" / f"{run[0]}.json")
    vio = load_json(HERE / "configs" / f"{cell['config']}.json")["vio"]
    if not (vio.get("square_root_form") and vio.get("use_imu")):
        return None
    try:
        return 1e3 * bound_s(int(vio["max_features"]),
                             torch.cuda.get_device_name())
    except KeyError:
        return None
