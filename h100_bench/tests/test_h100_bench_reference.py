"""The frozen plain reference under h100_bench/reference/ against the
port's CPU path (its kernels' plain versions) at small widths, from the
same parameters, batches and draws: the two CHAP steps, the supervised
step, the sliding-window eval, the batch functions, K1's and K2's
arithmetic. On the CPU both compute alike, so they agree to float32
rounding (bf16 as the port's CPU path rounds it)."""
import numpy as np
import pytest
import torch

from h100_bench import data
from h100_bench.loops import port_config, ref_config

ACDC = {"data": {"image_size": [32, 32], "batch_size": 4, "labeled_bs": 2,
                 "num_classes": 4},
        "model": {"feature_chns": [4, 8, 8, 16, 16]},
        "semi": {"adv_noise": True, "dropout": True}}
LA = {"data": {"patch_size_3d": [16, 16, 16], "batch_size": 4, "labeled_bs": 2,
               "num_classes": 2},
      "model": {"n_filters_3d": 2},
      "semi": {"adv_noise": True, "dropout": True},
      "eval": {"sw_batch": 4, "nms": True}}


def _configs(values, dtype):
    values = {**values, "model": {**values["model"], "dtype": dtype}}
    return port_config(values), ref_config(values)


def _models(cfg, ref_cfg, rank, train=True):
    from chap_tpu_torch.models.factory import net_factory, net_factory_3d
    from h100_bench.reference.build import build_model, load_params
    if rank == 2:
        model = net_factory("dualdecoder", 1, cfg.data.num_classes, cfg.model,
                            device="cpu")
    else:
        model = net_factory_3d("dualdecoder", 1, cfg.data.num_classes,
                               mode="train" if train else "test", cfg=cfg.model,
                               device="cpu")
    params = data.init_params({k: p.shape for k, p in model.named_parameters()},
                              data.generator(torch.device("cpu"), 7, 1))
    load_params(model, params)
    precision = "bfloat16" if cfg.model.dtype == "bfloat16" else "float32"
    ref = build_model(ref_cfg, rank, train, precision, torch.device("cpu"))
    load_params(ref, params)
    return model, ref, params


def _batch(cfg, rank, seed):
    gen = data.generator(torch.device("cpu"), seed, 0)
    b = cfg.data.batch_size
    if rank == 2:
        images, labels = data.slice_pool(b, tuple(cfg.data.image_size), gen,
                                         torch.float32)
        return {"image": images.unsqueeze(1), "label": labels}
    images, labels = data.volumes(b, tuple(cfg.data.patch_size_3d), gen,
                                  torch.float32)
    return {"image": images.unsqueeze(1), "label": labels}


@pytest.mark.parametrize("rank,mode,dtype", [
    (2, "chap", "float32"), (2, "chap", "bfloat16"), (3, "chap", "float32"),
    (3, "chap", "bfloat16"), (2, "supervised", "float32")])
def test_steps_match_the_port(rank, mode, dtype):
    from chap_tpu_torch.semi.gradsim import ENCODER_LEVEL_PATHS, VNET_LEVEL_PATHS
    from chap_tpu_torch.train.state import create_train_state, make_optimizer
    from chap_tpu_torch.train.step_chap import build_chap_train_step, level_channels
    from chap_tpu_torch.train.step_supervised import build_supervised_train_step
    from h100_bench.reference.build import build_train
    from h100_bench.reference.train.step_chap import draw_step_uniforms
    from h100_bench.reference.train.step_supervised import draw_supervised_uniforms

    cfg, ref_cfg = _configs(LA if rank == 3 else ACDC, dtype)
    model, _, params = _models(cfg, ref_cfg, rank)
    opt = make_optimizer(model, cfg.optim.base_lr)
    if mode == "chap":
        state = create_train_state(model, opt, level_channels(cfg, rank))
        step = build_chap_train_step(
            model, opt, cfg, level_paths=ENCODER_LEVEL_PATHS if rank == 2
            else VNET_LEVEL_PATHS, device="cpu")
    else:
        state = create_train_state(model, opt)
        step = build_supervised_train_step(model, opt, cfg, device="cpu")
    ref_state, ref_step = build_train(ref_cfg, rank, mode, dtype if dtype ==
                                      "bfloat16" else "float32",
                                      torch.device("cpu"), params)
    draw = draw_step_uniforms if mode == "chap" else draw_supervised_uniforms
    gen = torch.Generator().manual_seed(3)
    for k in range(2):
        batch = _batch(cfg, rank, k)
        draws = draw(ref_cfg, tuple(batch["image"].shape), gen, "cpu")
        out = step(state, batch, draws=draws)
        ref_out = ref_step(ref_state, batch, draws=draws)
        for name in out.metrics:
            torch.testing.assert_close(out.metrics[name], ref_out.metrics[name],
                                       rtol=1e-5, atol=1e-6)
    for (n, p), (rn, rp) in zip(model.named_parameters(),
                                ref_state.model.named_parameters()):
        assert n == rn
        torch.testing.assert_close(p, rp, rtol=1e-5, atol=1e-6)
    for (n, b), (_, rb) in zip(model.named_buffers(), ref_state.model.named_buffers()):
        torch.testing.assert_close(b, rb, rtol=1e-5, atol=1e-6)


def test_batch_functions_match_the_port():
    from chap_tpu_torch.data import device_data as port
    from h100_bench.reference.data import device_data as ref
    gen = data.generator(torch.device("cpu"), 5, 0)
    images, labels = data.slice_pool(12, (16, 16), gen, torch.float32)
    vols, vlabels = data.volumes(5, (20, 20, 18), gen, torch.float32)
    shapes = torch.tensor([[20, 20, 18]] * 5)
    pairs = [
        (port.build_device_batch_fn(12, 3, 6, 2)(port.DevicePool(images, labels),
                                                   torch.Generator().manual_seed(9)),
         ref.build_device_batch_fn(12, 3, 6, 2)(ref.DevicePool(images, labels),
                                                  torch.Generator().manual_seed(9))),
        (port.build_device_patch_fn(5, 2, 4, 2, (16, 16, 16))(
            port.DeviceVolumePool(vols, vlabels, shapes),
            torch.Generator().manual_seed(9)),
         ref.build_device_patch_fn(5, 2, 4, 2, (16, 16, 16))(
            ref.DeviceVolumePool(vols, vlabels, shapes),
            torch.Generator().manual_seed(9)))]
    for a, b in pairs:
        assert torch.equal(a["image"], b["image"])
        assert torch.equal(a["label"], b["label"])


@pytest.mark.parametrize("shape,classes", [((3, 24, 24), 4), ((2, 12, 10, 8), 2)])
def test_nms_matches_the_port(shape, classes):
    from chap_tpu_torch.semi.nms import largest_cc_batch
    from h100_bench.reference.semi.nms import largest_cc_batch as ref_cc
    gen = torch.Generator().manual_seed(1)
    seg = torch.randint(0, classes, shape, generator=gen, dtype=torch.int32)
    assert torch.equal(largest_cc_batch(seg, classes), ref_cc(seg, classes))


@pytest.mark.parametrize("mask", [True, False])
def test_k1_matches_the_port(mask):
    from chap_tpu_torch.ops.fused_losses import region_dice_ce
    from h100_bench.reference.ops.fused_losses import region_dice_ce as ref_k1
    gen = torch.Generator().manual_seed(2)
    logits = torch.randn((2, 4, 8, 8), generator=gen, requires_grad=True)
    lab = torch.randint(0, 4, (2, 8, 8), generator=gen)
    lab2 = torch.randint(0, 4, (2, 8, 8), generator=gen) if mask else None
    m = (torch.rand((2, 8, 8), generator=gen) > 0.5).float() if mask else None
    a = region_dice_ce(logits, lab, m, lab2)
    b = ref_k1(logits, lab, m, lab2)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y)
    ga = torch.autograd.grad(sum(a), logits)[0]
    gb = torch.autograd.grad(sum(b), logits)[0]
    torch.testing.assert_close(ga, gb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliding_window_matches_the_port(dtype):
    from chap_tpu_torch.eval.sliding_window import SlidingWindowEngine
    from h100_bench.reference.eval.sliding_window import predict_volume
    cfg, ref_cfg = _configs(LA, dtype)
    model, ref, _ = _models(cfg, ref_cfg, 3, train=False)
    vols, _ = data.volumes(2, (24, 22, 20), data.generator(torch.device("cpu"), 3, 0),
                           torch.float32)
    engine = SlidingWindowEngine(model, (16, 16, 16), 4, device="cpu")
    for v in vols:
        got = engine.predict(v.numpy(), 18, 4, 2, nms=True)
        want = predict_volume(ref, v, (16, 16, 16), 18, 4, 2, 4, True)
        assert np.array_equal(got, want)


def test_the_fp8_control_rounds_the_convolution_operands():
    from h100_bench.reference.models.layers import fp8_round
    x = torch.linspace(-3.0, 3.0, 101)
    q = fp8_round(x)
    assert (q - x).abs().max() > 0
    # e4m3 keeps 3 mantissa bits: half a unit is 1/16 of the value, and
    # below the normal range half of the smallest step, 2**-10 scaled
    assert ((q - x).abs() <= x.abs() / 16 + 3.0 / 448.0 * 2 ** -10 + 1e-7).all()
    assert q.abs().max() == pytest.approx(3.0)
