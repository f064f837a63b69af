"""The readers of the program's spans (``portbench/spans.py`` and the 13
``*_replay_ms``, ``graphed_host_ms``, ``replay_idle_pct`` and ``init_ms``
readers): each on a synthetic summary, None where its key is missing; no
slice without a benchmark run, a card or a recorder; the reduction of a
flush on synthetic spans; and the slices themselves at a tiny size on the
CPU, with a stand-in for the CUDA graph."""
import importlib.util
import json
import sys

import pytest
import torch

from portbench import spans
from portbench.tests._tiny import ROOT, SEED, patch

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ["imu_replay_ms.stream", "imu_replay_ms.offline",
       "predict_replay_ms.stream", "predict_replay_ms.offline",
       "track_replay_ms.stream", "track_replay_ms.offline",
       "update_replay_ms.stream", "update_replay_ms.offline",
       "replenish_replay_ms.stream", "replenish_replay_ms.offline",
       "graphed_host_ms", "replay_idle_pct", "init_ms"]
SUMMARY = {"span_slice": "stream",
           "replay_spans_ms": {"vio.step": 9.0, "vio.imu": 1.5,
                               "vio.predict": 2.0, "vio.pyramid": 0.125,
                               "vio.track": 0.25, "vio.gates": 0.0625,
                               "vio.update": 3.0, "vio.replenish": 0.5},
           "graphed_host_ms": 0.2, "replay_idle_pct": 9.5, "init_ms": 150.0}
EXPECT = {"imu": 1.5, "predict": 2.0, "track": 0.4375, "update": 3.0,
          "replenish": 0.5, "graphed_host_ms": 0.2, "replay_idle_pct": 9.5,
          "init_ms": 150.0}


def reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "test_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_new_metrics_are_program_spans_at_the_end():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    assert [m["name"] for m in BENCH["per_layer"][-len(NEW):]] == NEW
    for name in NEW:
        assert entries[name]["source"] == "program_span"
        cells = entries[name]["workloads"]
        offline = name.endswith(".offline")
        assert entries[name]["moves"] == (
            "offline_fps" if offline else "frame_p95_ms"
            if name == "graphed_host_ms" else "stream_fps")
        assert set(cells) <= ({"insight_fleet11", "mi_replay"} if offline
                              else {"mi_stream", "insight_stream"})


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_its_key(name):
    key = name.split("_replay_ms")[0] if "_replay_ms" in name else name
    assert reader(name).read(dict(SUMMARY, replay_spans_ms=dict(
        SUMMARY["replay_spans_ms"]))) == pytest.approx(EXPECT[key])


@pytest.mark.parametrize("name", NEW)
def test_each_reader_gives_none_where_its_key_is_missing(name):
    assert reader(name).read({"span_slice": "no recorder"}) is None
    # an empty summary in a process that is no benchmark run: no slice
    s = {}
    assert reader(name).read(s) is None
    assert set(s) == {"span_slice"}


def test_no_slice_without_a_card_or_a_recorder(monkeypatch):
    from ekf_vio_tpu_torch.utils import profiling

    monkeypatch.setattr(sys, "argv", ["portbench/run.py", "--workload",
                                      "mi_stream", "--seed", "5"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = spans.fill({})
    assert set(s) == {"span_slice"}
    monkeypatch.delattr(profiling, "recording")   # a program without one
    s = spans.fill({})
    assert s == {"span_slice": "no benchmark run, or no recorder"}


def test_a_slice_that_fails_adds_no_number(monkeypatch):
    """The slice's process finds no card here and exits with an error:
    the summary gets no number, and ``fill`` raises with the slice's
    stderr, so a traced run fails rather than leave its metrics out."""
    monkeypatch.setattr(sys, "argv", ["portbench/run.py", "--workload",
                                      "insight_stream", "--seed", "5"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    s = {}
    with pytest.raises(RuntimeError, match="span slice failed.*stderr"):
        spans.fill(s)
    assert set(s) == {"span_slice"}


def _trace():
    """Two replayed stream frames of 1000 ns each: the call at 100 (or
    2100), copy-in 100-200, launch 200-300, the replay 250-650 on the
    card (vio.update 300-500 inside), copy-out 700-900."""
    from ekf_vio_tpu_torch.utils.profiling import Span as S
    from ekf_vio_tpu_torch.utils.profiling import Trace

    host, dev = [S("vio.init", 0, 10, -1, 1)], [S("vio.init", 5, 60, -1, 1)]
    for k, f in ((0, 2), (1, 3)):
        o = 2000 * k
        c = len(host)
        host += [S("graphed.call", o + 100, o + 900, -1, f),
                 S("graphed.copy_in", o + 100, o + 200, c, f),
                 S("graphed.launch", o + 200, o + 300, c, f),
                 S("graphed.copy_out", o + 700, o + 900, c, f)]
        d = len(dev)
        dev += [S("vio.step", o + 250, o + 650, -1, f),
                S("vio.update", o + 300, o + 500, d, f)]
    return Trace(host, dev, [], 0)


def test_stream_numbers_of_a_flush():
    got = spans.stream_numbers(_trace(), [(0, 1000), (2000, 3000)])
    assert got["span_frames"] == 2
    assert got["replay_spans_ms"] == pytest.approx({"vio.step": 4e-4,
                                                    "vio.update": 2e-4})
    assert got["graphed_host_ms"] == pytest.approx(8e-4)
    assert got["graphed_host_split_ms"] == pytest.approx(
        {"graphed.copy_in": 1e-4, "graphed.launch": 1e-4,
         "graphed.copy_out": 2e-4})
    assert got["replay_idle_pct"] == pytest.approx(60.0)
    assert got["span_frame_ms"] == pytest.approx(1e-3)
    assert got["init_ms"] == pytest.approx(6e-5)
    idle = got["span_idle_us"]
    # 0-250 idle before: copy-in 0.1 us, launch 0.05 (200-250), rest 0.1
    assert idle["before the first stamp"] == pytest.approx(
        {"graphed.copy_in": 0.1, "graphed.launch": 0.05,
         "graphed.copy_out": 0.0, "outside the program": 0.1})
    assert idle["after the last stamp"] == pytest.approx(
        {"graphed.copy_in": 0.0, "graphed.launch": 0.0,
         "graphed.copy_out": 0.2, "outside the program": 0.15})


def test_offline_numbers_leave_out_the_eager_step():
    tr = _trace()
    got = spans.offline_numbers(tr)
    assert got["span_frames"] == 1
    assert got["replay_spans_ms"] == pytest.approx({"vio.step": 4e-4,
                                                    "vio.update": 2e-4})


class StandInGraph:
    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.mark.parametrize("cell", ["mi_stream", "insight_fleet11",
                                  "mi_replay"])
def test_the_slice_runs_at_a_tiny_size(cell, monkeypatch):
    """The slices on the CPU at ``_tiny.py``'s size, ``scan``'s graph
    path taken with a stand-in graph: every number the readers take."""
    from ekf_vio_tpu_torch import scan
    from ekf_vio_tpu_torch.utils import profiling
    from portbench.harness import Harness

    monkeypatch.setattr(scan, "_on_card", lambda tree: True)
    monkeypatch.setattr(scan, "_capture", StandInGraph)
    torch.set_num_threads(2)
    h = Harness(cell, SEED, 1.0, True, 0.0, require_card=False, patch=patch)
    cpu = torch.device("cpu")
    if cell == "mi_stream":
        got = spans._stream(h, cpu, profiling, frames=2, warm=1)
        assert got["span_frames"] == 2 and got["init_ms"] > 0
        assert got["span_frame_ms"] > 0 and got["plain_frame_ms"] > 0
        assert got["graphed_host_ms"] > 0 and 0 < got["replay_idle_pct"] < 100
        assert set(got["graphed_host_split_ms"]) == set(spans.GLUE)
        layers = {"vio.imu", "vio.track", "vio.update", "vio.replenish"}
    else:
        # the call's frames: the initialization's, an eager step, replays
        first = h.vio_config().vi_init_frames if cell == "mi_replay" else 1
        h.traffic["profile_frames"] = first + 3
        got = spans._offline(h, cpu, profiling)
        assert got["span_frames"] == 2
        assert got["span_call_s"] > 0 and got["plain_call_s"] > 0
        layers = {"vio.track", "vio.update", "vio.replenish"}
    assert layers <= set(got["replay_spans_ms"])
    assert all(v > 0 for v in got["replay_spans_ms"].values())
    assert profiling.active() is None
