"""What every driver shares: the cell's files, the device, set-up and
window timing, the trace reduction and the result line.

A run is ``Harness(args).run()``: it reads ``BENCHMARK.json`` and the
cell's files (``workloads/<cell>.json`` names the configuration
``configs/<config>.json`` and the traffic ``traffic/<traffic>.json``,
whose ``driver`` names ``drivers/<driver>.py``), refuses to run without
the chips the cell asks for, hands itself to the driver, and prints the
result: the end-to-end metrics with ``--trace 0``, the per-layer metrics
(each read by ``metrics/<metric>.py`` from the trace) with ``--trace 1``.
"""
from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ekf_vio_tpu")


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache of the run at a fixed path inside the
    checkout (the port builds its kernels into ``ekf_vio_tpu_torch/_build``
    beside its sources)."""
    cache = root / ".portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole (``ekf_vio_tpu_torch`` is not
    ``ekf_vio_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Harness:
    """One run of one cell."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool,
                 t0: float, require_card: bool = True, patch=None):
        self.t0 = t0
        self.workload = workload
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.require_card = require_card
        bench = load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = dict(cells[workload], **load_json(HERE / "workloads" / f"{workload}.json"))
        self.config = load_json(HERE / "configs" / f"{self.cell['config']}.json")
        self.traffic = load_json(HERE / "traffic" / f"{self.cell['traffic']}.json")
        if patch is not None:  # tests shrink a cell to a CPU-sized one
            patch(self)
        self.e2e = [m for m in bench["end_to_end"]
                    if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.setup_s = None
        self.checks = []          # (name, value, limit)
        self.phases = []          # (set-up phase, seconds since start)

    # ------------------------------------------------------------ device
    def device(self):
        import torch

        want = int(self.cell.get("chips", 1))
        if not self.require_card:
            return torch.device("cpu")
        if not torch.cuda.is_available() or torch.cuda.device_count() < want:
            raise SystemExit(
                f"needs {want} CUDA device(s); torch.cuda.is_available() = "
                f"{torch.cuda.is_available()}, device_count = "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return torch.device("cuda", 0)

    def device_info(self, dev) -> dict:
        import torch

        if dev.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": int(self.cell.get("chips", 1)),
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}

    def sync(self, dev):
        import torch

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def phase(self, name: str) -> None:
        self.phases.append((name, time.perf_counter() - self.t0))

    def setup_done(self, dev) -> None:
        self.sync(dev)
        self.setup_s = time.perf_counter() - self.t0
        self.phases.append(("set-up done", self.setup_s))

    # ------------------------------------------------------------ program
    def vio_config(self):
        from ekf_vio_tpu_torch.config import VIOConfig

        return VIOConfig(**self.config["vio"])

    def camera(self):
        from ekf_vio_tpu_torch.frontend.camera import Camera

        c = self.config["camera"]
        return Camera(float(c["fx"]), float(c["fy"]), float(c["cx"]),
                      float(c["cy"]), int(c["width"]), int(c["height"]))

    def ref_camera(self) -> dict:
        return {k: self.config["camera"][k]
                for k in ("fx", "fy", "cx", "cy", "width", "height")}

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    def hold(self, gaps: list, control_gaps: list, **counts) -> None:
        """Hold the worst of the compared frames' gaps against the cell's
        limits, and keep them with ``counts`` as ``readings`` for
        ``control.py``.  In a control run (``self.control``) the control's
        gaps take the program's place in the check, so ``correct`` says
        whether the control passes; the program's are kept beside them."""
        from portbench.reference import compare

        lim = self.cell["limits"]
        w = compare.worst(gaps)
        self.readings = dict(program=w, **counts, program_correct=all(
            w[k] <= lim[k] for k in ("sigma_gap", "mean_gap")))
        judged = w
        if getattr(self, "control", False):
            judged = self.readings["control"] = compare.worst(control_gaps)
            print("control run: the reference in TF32 stands in the "
                  "program's place; the program's own gaps: "
                  + ", ".join(f"{k} {w[k]!r}" for k in ("sigma_gap", "mean_gap")),
                  file=sys.stderr)
        for k in ("sigma_gap", "mean_gap"):
            self.check(k, judged[k], lim[k])

    # ------------------------------------------------------------ output
    def run(self) -> int:
        import torch

        dev = self.device()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        driver = _load_module(HERE / "drivers" / f"{self.traffic['driver']}.py",
                              f"portbench_driver_{self.traffic['driver']}")
        res = driver.run(self, dev)
        found = forbidden_modules()
        if found:
            print(f"forbidden modules loaded: {found}", file=sys.stderr)
            return 3
        correct = bool(self.checks) and all(v <= lim for _, v, lim in self.checks)
        line = {"correct": correct, "attempted": res["attempted"],
                "failed": res["failed"], "metrics": {}, "device": res["device"]}
        if self.trace:
            summary = res["trace"]
            for m in self.per_layer:
                reader = _load_module(HERE / "metrics" / f"{m['name']}.py",
                                      "portbench_metric_" + m["name"].replace(".", "_"))
                v = reader.read(summary)
                if v is not None:
                    line["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
            line["device"]["busy_s"] = summary["busy_s"]
            line["device"]["window_s"] = summary["window_s"]
            line["breakdown"] = summary["breakdown"]
        else:
            values = dict(res["metrics"], setup_s=self.setup_s)
            for m in self.e2e:
                line["metrics"][m["name"]] = {"value": values[m["name"]],
                                              "unit": m["unit"]}
        line["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in self.checks}
        print("phases: " + ", ".join(f"{n} {t:.2f} s" for n, t in self.phases),
              file=sys.stderr)
        if self.trace and "traced_frame_ms" in res["trace"]:
            t = res["trace"]
            print(f"frame ms: traced {t['traced_frame_ms']!r}, untraced "
                  f"{t['untraced_frame_ms']!r}", file=sys.stderr)
        for n, v, lim in self.checks:
            print(f"compared {n} = {v!r} limit {lim!r} "
                  f"{'ok' if v <= lim else 'OVER'}", file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(line))
        return 0


def p95(values) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive method)."""
    return statistics.quantiles(values, n=20)[-1]
