"""The reduction of the program's own spans (``chap.*``,
h100_bench/program_trace.py) on synthetic device traces, the readers of
the metrics that read it, and their entries in BENCHMARK.json."""
import json
from pathlib import Path

import pytest

from h100_bench import program_trace, trace
from h100_bench.harness import Measurements, reader

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
PHASES = ("draws", "teacher", "nms", "student", "dropout", "vat", "gradsim",
          "backward", "update")


def _x(name, ts, dur, tid=1, cat="user_annotation", corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _bench():
    """One step in a stretch of 100 us on thread 1: four kernels, one
    launched from thread 2 (autograd's), one after the step."""
    return [
        _x("bench.stretch", 0, 100),
        _x("bench.step", 0, 90),
        _x("cudaLaunchKernel", 5, 1, cat="cuda_runtime", corr=1),
        _x("cudaLaunchKernel", 32, 1, cat="cuda_runtime", corr=2),
        _x("cudaLaunchKernel", 52, 1, tid=2, cat="cuda_runtime", corr=3),
        _x("cudaLaunchKernel", 91, 1, cat="cuda_runtime", corr=4),
        _x("cudnn_conv_fwd", 10, 15, tid=7, cat="kernel", corr=1),
        _x("bn_fw_kernel", 35, 10, tid=7, cat="kernel", corr=2),
        _x("elementwise_kernel", 55, 10, tid=7, cat="kernel", corr=3),
        _x("Memcpy DtoH", 92, 3, tid=7, cat="gpu_memcpy", corr=4),
    ]


def _program():
    """The program's spans: the step, three phases on thread 1, a pass in
    the teacher and its recomputation on thread 2, and a span on thread 2
    over an idle stretch of the backward."""
    return [
        _x("chap.step", 2, 86),
        _x("chap.step.teacher", 2, 28),
        _x("chap.model.pass", 4, 16),
        _x("chap.step.nms", 30, 10),
        _x("chap.step.backward", 40, 48),
        _x("chap.model.pass", 50, 10, tid=2),
        _x("chap.step.student", 60, 20, tid=2),
    ]


# busy: [10, 25], [35, 45], [55, 65], [92, 95]: 38 us; idle 62 us:
# [0, 10] = bench.step 2 + teacher 8; [25, 35] = teacher 5 + nms 5 (cut at
# the phases' edge, 30); [45, 55] = backward 10; [65, 92] = backward 23 (the
# span on thread 2 takes none) + bench.step 2 + outside every span 2;
# [95, 100] outside 5
IDLE_US = {"chap.step.teacher": 13, "chap.step.nms": 5, "chap.step.backward": 33,
           "bench.step": 4, "host_other": 7}


def test_idle_is_cut_at_the_edges_of_the_phases_of_the_stretch_thread():
    p = program_trace.reduce_program(_bench() + _program(), units=1)
    assert p.steps == [2e-6]
    # the longest idle piece: the backward's from 65 us
    assert p.gaps[0][0] == "chap.step.backward"
    assert p.gaps[0][1:] == pytest.approx((23e-6, 65e-6))
    assert p.idle_s.keys() == IDLE_US.keys()
    for k, us in IDLE_US.items():
        assert p.idle_s[k] == pytest.approx(us * 1e-6), k
    s = trace.reduce_trace(_bench(), units=1)
    assert sum(p.idle_s.values()) == pytest.approx(s.window_s - s.busy_s)


def test_launches_from_any_thread_inside_the_step_count():
    p = program_trace.reduce_program(_bench() + _program(), units=1)
    # the kernels launched at 5, 32 and 52 (from thread 2); not the copy at 91
    assert p.step_launches == 3
    assert p.launches == {"chap.step.teacher": 1, "chap.step.nms": 1,
                          "chap.step.backward": 1, "host_other": 1}
    assert p.device_s["chap.step.backward"] == pytest.approx(10e-6)


def test_passes_count_on_every_thread():
    p = program_trace.reduce_program(_bench() + _program(), units=1)
    assert p.passes == 2
    # the passes are counted, not places the host can be in
    assert program_trace.PASS not in p.host_s and program_trace.PASS not in p.idle_s
    assert p.host_s["chap.step"] == pytest.approx(86e-6)


@pytest.mark.parametrize("installed", [False, True])
def test_the_existing_reduction_is_unchanged_by_the_program_spans(installed):
    if installed:
        program_trace.install()
    reduce = trace.reduce_trace
    a = reduce(_bench(), units=1)
    b = reduce(_bench() + _program(), units=1)
    for field in ("units", "window_s", "busy_s", "class_s", "span_s", "gaps"):
        assert getattr(a, field) == getattr(b, field), field
    assert trace.breakdown(a) == trace.breakdown(b)


def _measured(events, window_s=1.0, window_units=10):
    program_trace.install()
    stretch = trace.reduce_trace(events, units=1)
    return Measurements("train", 240, window_units, window_s, 20.0, [0.2],
                        1, stretch, None, 1.0, {})


def test_the_idle_metric_is_scaled_to_the_window():
    m = _measured(_bench() + _program())
    # the window's idle a step: (1 s - 10 steps x 38 us busy) / 10 steps
    # = 99.962 ms; the teacher's share of the stretch's idle 13 / 62
    got = reader("step.idle_ms.teacher.slices").read(m)
    assert got == pytest.approx(20.95977, rel=1e-6)
    assert reader("step.idle_ms.nms.slices").read(m) == pytest.approx(8.06145,
                                                                      rel=1e-6)
    # a phase that ran with no idle reads 0; one that never ran, nothing
    m2 = _measured(_bench() + _program() + [_x("chap.step.vat", 56, 2)])
    assert reader("step.idle_ms.vat.slices").read(m2) == 0.0
    assert reader("step.idle_ms.dropout.slices").read(m2) is None
    assert reader("step.launches.slices").read(m) == 3
    assert reader("step.passes.slices").read(m) == 2


def test_a_program_without_spans_reads_nothing():
    m = _measured(_bench())
    names = [e["name"] for e in MANIFEST["per_layer"]
             if e["source"] == "program_span"]
    assert names
    for name in names:
        assert reader(name).read(m) is None, name


def test_the_eval_stages_and_the_host_nms():
    events = [
        _x("bench.stretch", 0, 100),
        _x("bench.finalize", 0, 60),
        _x("chap.sw.copy", 0, 20),
        _x("chap.sw.nms", 20, 40),
        _x("cudaMemcpyAsync", 1, 1, cat="cuda_runtime", corr=1),
        _x("Memcpy DtoH", 2, 8, tid=7, cat="gpu_memcpy", corr=1),
        _x("bench.enqueue", 60, 40),
        _x("chap.sw.upload", 60, 10),
        _x("chap.sw.forward", 70, 30),
        _x("cudaLaunchKernel", 75, 1, cat="cuda_runtime", corr=2),
        _x("conv_kernel", 80, 20, tid=7, cat="kernel", corr=2),
    ]
    m = _measured(events, window_s=1.0, window_units=4)
    # idle: [0, 2] copy, [10, 80] = copy 10 + nms 40 + upload 10 + forward 10
    # (of 72 us); the window's idle a volume (1 s - 4 x 28 us) / 4
    window_idle = (1.0 - 4 * 28e-6) / 4 * 1e3
    for stage, us in (("copy", 12), ("nms", 40), ("upload", 10), ("forward", 10)):
        got = reader(f"eval.idle_ms.{stage}").read(m)
        assert got == pytest.approx(us / 72 * window_idle), stage
    assert reader("eval.nms_ms").read(m) == pytest.approx(40e-3)


def _entry(name, unit, layer, moves, cell):
    return {"name": name, "unit": unit, "better": "lower", "source": "program_span",
            "layer": layer, "moves": moves, "workloads": [cell]}


def test_the_28_entries_as_written():
    want = []
    train = (("slices", "train_slices_per_s", "acdc_chap.train"),
             ("patches", "train_patches_per_s", "la_chap.train"))
    for suffix, moves, cell in train:
        want += [_entry(f"step.idle_ms.{p}.{suffix}", "ms", "step", moves, cell)
                 for p in PHASES]
    for suffix, moves, cell in train + (("supervised", "supervised_slices_per_s",
                                         "acdc_chap.supervised"),):
        want.append(_entry(f"step.launches.{suffix}", "launches", "step", moves, cell))
    for suffix, moves, cell in train:
        want.append(_entry(f"step.passes.{suffix}", "passes", "model passes", moves,
                           cell))
    want += [_entry(f"eval.idle_ms.{s}", "ms", "eval", "eval_mvox_per_s",
                    "la_chap.eval") for s in ("upload", "forward", "copy", "nms")]
    want.append(_entry("eval.nms_ms", "ms", "eval", "eval_mvox_per_s",
                       "la_chap.eval"))
    assert len(want) == 28
    assert MANIFEST["per_layer"][-28:] == want
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
