"""The port's host spans (chap_tpu_torch/utils/spans.py): off and free
without a profiler, changing nothing under one, and recorded where the
train steps' phases, the model passes and the sliding-window stages are
(CPU; no JAX)."""
import contextlib
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chap_tpu_torch.config import Config
from chap_tpu_torch.data.datasets import phantom_batch
from chap_tpu_torch.eval.sliding_window import SlidingWindowEngine
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.train.state import TrainState, make_optimizer
from chap_tpu_torch.train.step_chap import build_chap_train_step, level_channels
from chap_tpu_torch.train.step_supervised import build_supervised_train_step
from chap_tpu_torch.utils import spans

torch.set_num_threads(1)

CHNS = (4, 8, 8, 16, 16)
B, LB, HW, C = 8, 4, 32, 4
PHASES = ("draws", "teacher", "nms", "student", "dropout", "vat", "gradsim",
          "backward", "update")
SUPERVISED_PHASES = ("draws", "forward", "backward", "update")


def _cfg(remat=False):
    cfg = Config()
    cfg.data.num_classes, cfg.data.batch_size = C, B
    cfg.data.labeled_bs, cfg.data.image_size = LB, (HW, HW)
    cfg.model.feature_chns = CHNS
    cfg.semi.dropout = cfg.semi.adv_noise = True
    cfg.optim.remat, cfg.optim.fused_passes = remat, False
    return cfg


def _train(mode, remat=False):
    """(step, state, model) of a small 2D step of ``mode`` from seed 0."""
    cfg = _cfg(remat)
    torch.manual_seed(0)
    model = net_factory("dualdecoder", 1, C, cfg.model, device="cpu")
    opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                         cfg.optim.weight_decay)
    if mode == "chap":
        state = TrainState(0, model, opt, [torch.zeros(c) for c in
                                           level_channels(cfg, 2)])
        step = build_chap_train_step(model, opt, cfg, use_nms=True, device="cpu")
    else:
        state = TrainState(0, model, opt, [])
        step = build_supervised_train_step(model, opt, cfg, device="cpu")
    return step, state, model


def _batches(n):
    out = []
    for i in range(n):
        images, labels = phantom_batch(np.random.RandomState(i), B, HW, C)
        out.append({"image": torch.from_numpy(images),
                    "label": torch.from_numpy(labels)})
    return out


def _run(mode, steps, profiled, remat=False):
    """The metrics of ``steps`` steps, and the model's state after them."""
    step, state, model = _train(mode, remat)
    gen = torch.Generator().manual_seed(3)
    metrics = []
    session = (profile(activities=[ProfilerActivity.CPU]) if profiled
               else contextlib.nullcontext())
    with session:
        for batch in _batches(steps):
            state, m = step(state, batch, gen)
            metrics.append({k: v.clone() for k, v in m.items()})
    return metrics, {k: v.detach().clone() for k, v in model.state_dict().items()}


def _trace(fn, tmp_path):
    """The Chrome trace's events of ``fn()`` under a CPU profiler session."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _spans(events, prefix="chap."):
    return sorted(((e["ts"], e["ts"] + e["dur"], e["name"], e["tid"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix)), key=lambda s: s[0])


def _inside(span, outer):
    return outer[0] <= span[0] and span[1] <= outer[1]


def _step_trace(mode, tmp_path, remat=False):
    step, state, _ = _train(mode, remat)
    batch = _batches(1)[0]
    gen = torch.Generator().manual_seed(3)
    return _trace(lambda: step(state, batch, gen), tmp_path)


def test_a_span_without_a_profiler_is_the_one_null_context():
    assert not torch._C._autograd._profiler_enabled()
    a, b = spans.span("chap.step"), spans.span("chap.step.nms")
    assert a is b is spans._OFF
    assert isinstance(a, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("chap.step") is not spans._OFF


@pytest.mark.parametrize("mode", ["chap", "supervised"])
def test_a_profiled_step_is_bit_identical(mode):
    """Metrics, parameters and BatchNorm statistics (the state dict holds
    both) of two steps, with and without a profiler around them."""
    m_off, s_off = _run(mode, 2, False)
    m_on, s_on = _run(mode, 2, True)
    for a, b in zip(m_off, m_on):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert s_off.keys() == s_on.keys()
    for k in s_off:
        assert torch.equal(s_off[k], s_on[k]), k


@pytest.mark.parametrize("mode,phases", [("chap", PHASES),
                                         ("supervised", SUPERVISED_PHASES)])
def test_the_phases_nest_in_the_step_in_order(mode, phases, tmp_path):
    ev = _step_trace(mode, tmp_path)
    me = threading.get_native_id()
    steps = [s for s in _spans(ev) if s[2] == "chap.step"]
    assert len(steps) == 1 and steps[0][3] == me
    got = [s for s in _spans(ev, "chap.step.")]
    assert [s[2] for s in got] == [f"chap.step.{p}" for p in phases]
    assert all(s[3] == me and _inside(s, steps[0]) for s in got)
    # one after another, none inside another
    assert all(a[1] <= b[0] for a, b in zip(got, got[1:]))


# The step's own top-level ops outside its phases, in order: the label cast
# (aten::to), the zero that stands for a loss left out (aten::zeros), the
# total loss (two products by weights, a sum, a product by the consistency
# weight, a sum), and the metrics dict (six detaches, the consistency weight
# as a tensor). model.train() runs no op.
OUTSIDE = {"chap": ["aten::to", "aten::zeros", "aten::mul", "aten::mul",
                    "aten::add", "aten::mul", "aten::add"]
           + ["aten::detach"] * 6 + ["aten::full"],
           "supervised": ["aten::to", "aten::detach"]}


@pytest.mark.parametrize("mode", ["chap", "supervised"])
def test_every_op_of_the_step_lies_in_a_phase(mode, tmp_path):
    ev = _step_trace(mode, tmp_path)
    me = threading.get_native_id()
    step = [s for s in _spans(ev) if s[2] == "chap.step"][0]
    phases = [s for s in _spans(ev, "chap.step.")]
    ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                 if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                 and e["tid"] == me and _inside((e["ts"], e["ts"] + e["dur"]), step))
    # the top-level ops: inside no other op
    top, end = [], -1.0
    for op in ops:
        if op[0] >= end:
            top.append(op)
            end = op[1]
    outside = [op[2] for op in top if not any(_inside(op, p) for p in phases)]
    assert outside == OUTSIDE[mode]


# Passes a CHAP step records with dropout and VAT on: the teacher, the
# student, the channel-dropout pass, and VAT's two (the power iteration's
# pass and the adversarial one). Under optim.remat every pass that records
# a graph is run again in a backward: the student in each of GradSim's two
# gradients and in the loss's backward (3), the dropout and the adversarial
# pass in the loss's backward (1 + 1), and the power iteration's pass in
# the gradient that gives VAT its direction (1): 5 + 6.
@pytest.mark.parametrize("remat,passes", [(False, 5), (True, 11)])
def test_the_model_passes_of_a_step(remat, passes, tmp_path):
    ev = _step_trace("chap", tmp_path, remat)
    assert sum(s[2] == "chap.model.pass" for s in _spans(ev)) == passes


class _Tiny3d(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv3d(1, 2, 1)

    def forward(self, x):
        return self.conv(x)


def test_the_sliding_window_stages(tmp_path):
    torch.manual_seed(0)
    engine = SlidingWindowEngine(_Tiny3d(), (8, 8, 8), sw_batch=4, device="cpu")
    image = np.random.RandomState(0).rand(12, 12, 10).astype(np.float32)
    ev = _trace(lambda: engine.predict(image, 4, 4, 2, nms=True), tmp_path)
    names = [s[2] for s in _spans(ev, "chap.sw.")]
    # a 2 x 2 x 2 grid of patches: two batches of four
    assert names == ["chap.sw.upload", "chap.sw.forward", "chap.sw.forward",
                     "chap.sw.argmax", "chap.sw.copy", "chap.sw.nms"]
