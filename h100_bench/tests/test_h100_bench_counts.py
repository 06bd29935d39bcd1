"""The yardstick: the kernels' bytes and the FLOP counts against hand
counts at small shapes, and the reduction of a device trace."""
import inspect

import pytest
import torch

from h100_bench.counts import kernel_bytes, peaks
from h100_bench.loops import counted
from h100_bench.trace import kernel_class, reduce_trace


def test_k1_bytes_by_hand():
    # 2 losses of logits [3, 4, 5, 6] in bf16, two label maps each, and 3
    # backward passes: a forward reads 3*4*30*2 + 2*3*30 bytes, a backward
    # reads as much again and writes 3 gradients of 3*4*30*2 bytes
    logits, labels = 3 * 4 * 30 * 2, 2 * 3 * 30
    want = 2 * ((logits + labels) + (logits + labels + 3 * logits))
    assert kernel_bytes.k1_bytes(2, 3, 4, (5, 6), 2, 2, 3) == want


def test_k1_bytes_take_no_label_dtype_or_mask():
    # the count is of what the loss cannot avoid: labels at one byte a pixel
    # whatever dtype the caller holds them in, and no mask (a BCP box)
    params = set(inspect.signature(kernel_bytes.k1_bytes).parameters)
    assert params == {"calls", "rows", "classes", "spatial", "regions",
                      "logit_bytes", "backward_passes"}
    one = kernel_bytes.k1_bytes(1, 2, 2, (4, 4, 4), 1, 4, 1)
    # the logits read twice and the gradient written once; the labels read twice
    assert one == 3 * (2 * 2 * 64 * 4) + 2 * (2 * 64)


def test_k2_and_k3_bytes_by_hand():
    assert kernel_bytes.k2_bytes(24, (256, 256)) == 2 * 24 * 65536
    assert kernel_bytes.k3_bytes(80, 2, 2, (112, 112, 80), 2) == \
        80 * 2 * 2 * 112 * 112 * 80 * 2


def test_peaks():
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.step_peak("bfloat16") == 989e12
    assert peaks.step_peak("float32") == 495e12


def test_flops_of_a_convolution_forward_and_backward():
    conv = torch.nn.Conv2d(3, 5, 3, padding=1, bias=False)
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    forward = 2 * 2 * 5 * 3 * 9 * 64
    _, flops = counted(lambda: conv(x).sum().backward(), True)
    # the backward computes the input's and the kernel's gradients, each as
    # many operations as the forward
    assert flops == 3 * forward
    _, none = counted(lambda: conv(x), False)
    assert none is None


def test_flops_of_the_reference_eval_forward_by_hand():
    from h100_bench.loops import ref_config
    from h100_bench.reference.build import build_model
    cfg = ref_config({"data": {"num_classes": 2}, "model": {"n_filters_3d": 2}})
    model = build_model(cfg, 3, False, "float32", torch.device("cpu")).eval()
    x = torch.randn(1, 1, 16, 16, 16)
    want = []

    def hook(module, inp, out):
        if isinstance(module, torch.nn.Conv3d):
            k = module.weight[0].numel()
            want.append(2 * out.numel() * k)
        elif isinstance(module, torch.nn.ConvTranspose3d):
            want.append(2 * inp[0].numel() * module.weight[0].numel())
    handles = [m.register_forward_hook(hook) for m in model.modules()]
    with torch.no_grad():
        _, flops = counted(lambda: model(x), True)
    for h in handles:
        h.remove()
    assert flops == sum(want)


def _trace():
    """A stretch of 2 steps: two kernels launched in bench.step (one from
    another thread), one in bench.data, a gap while the host was in
    bench.data."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.stretch", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.data", "ts": 0, "dur": 30},
        {"ph": "X", "cat": "user_annotation", "name": "bench.step", "ts": 30, "dur": 60},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5, "dur": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 35, "dur": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 40, "dur": 1,
         "tid": 99, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "index_kernel", "ts": 10, "dur": 10,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "cudnn_conv_fwd", "ts": 40, "dur": 20,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "bn_fw_kernel", "ts": 55, "dur": 25,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "spin_kernel", "ts": -50, "dur": 20,
         "args": {"correlation": 4}},
    ]
    return ev


def test_reduce_trace():
    s = reduce_trace(_trace(), units=2)
    assert s.window_s == pytest.approx(100e-6)
    # union: [10, 20] and [40, 80]
    assert s.busy_s == pytest.approx(50e-6)
    assert s.class_s["conv"] == pytest.approx(20e-6)
    assert s.class_s["batchnorm"] == pytest.approx(25e-6)
    assert "elementwise_other" in s.class_s and "spin_kernel" not in str(s.class_s)
    assert s.span_s["bench.data"] == pytest.approx(10e-6)
    assert s.span_s["bench.step"] == pytest.approx(45e-6)
    # gaps: [0, 10] data, [20, 40] data/step boundary at 30 -> middle 30,
    # [80, 100] step (90 is its end) ... longest first
    assert [round(g * 1e6) for _, g in s.gaps] == [20, 20, 10]
    assert s.gaps[-1][0] == "bench.data"


def test_kernel_classes():
    assert kernel_class("void k1_stats<float, unsigned char, 4>") == "K1_fwd"
    assert kernel_class("k1_grad<__nv_bfloat16>") == "K1_bwd"
    assert kernel_class("(anonymous namespace)::ccl3_local") == "K2_ccl3d"
    assert kernel_class("sw_accumulate<2>") == "K3_sw"
    assert kernel_class("Memcpy DtoH (Device -> Pinned)") == "copy_fill"
    assert kernel_class("sm90_xmma_fprop_implicit_gemm") == "conv"
