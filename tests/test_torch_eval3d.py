"""The port's sliding-window 3D eval and K3's plain version, held against
chap_tpu's SlidingWindowEngine (same DualDecoder3d weights, nf 4) and the
numpy toy reference of tests/test_sliding_window.py (CPU). K3's CUDA kernel
runs only on the card; chip_smoke.py holds it against this plain version
there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.eval.sliding_window as jax_sw
from chap_tpu_torch.eval import sliding_window as sw
from test_sliding_window import ArgmaxModel, numpy_reference
from test_torch_models3d import flax_model, port_model

torch.set_num_threads(1)

PATCH = (16, 16, 8)
VNET_PATCH = (16, 16, 16)     # the VNet halves every axis four times


class Threshold(torch.nn.Module):
    """ArgmaxModel in the port's layout: logits [B, 2, *patch] from
    thresholded intensity."""

    def __init__(self):
        super().__init__()
        self.unused = torch.nn.Parameter(torch.zeros(()))

    def forward(self, x):
        fg = (x[:, 0] > 0.5).float()
        return torch.stack([(1 - fg) * 10.0, fg * 10.0], dim=1)


@pytest.mark.parametrize("shape,patch,strides", [
    ((40, 40, 20), (16, 16, 8), (12, 6)), ((160, 160, 96), (112, 112, 80), (18, 4)),
    ((112, 112, 96), (112, 112, 80), (18, 4))])
def test_grid_equals_chap_tpu(shape, patch, strides):
    np.testing.assert_array_equal(sw.compute_grid(shape, patch, *strides),
                                  jax_sw.compute_grid(shape, patch, *strides))


def test_engine_matches_numpy_reference():
    image = np.random.RandomState(0).rand(40, 36, 20).astype(np.float32)
    engine = sw.SlidingWindowEngine(Threshold(), PATCH, sw_batch=4, device="cpu")
    got = engine.predict(image, stride_xy=12, stride_z=6, num_classes=2)
    np.testing.assert_array_equal(got, numpy_reference(image, PATCH, 12, 6, 2))


def test_engine_pads_small_volume_and_nms_like_chap_tpu():
    """Pad-to-patch and unpad, and the host largest-CC (--nms): the port's
    label maps equal chap_tpu's."""
    small = np.random.RandomState(1).rand(10, 12, 6).astype(np.float32)
    blobs = np.zeros((20, 20, 10), np.float32)
    blobs[2:10, 2:10, 2:8] = 1.0
    blobs[15:17, 15:17, 8:9] = 1.0
    for image, nms in ((small, False), (blobs, True)):
        got = sw.SlidingWindowEngine(Threshold(), PATCH, sw_batch=2, device="cpu"
                                     ).predict(image, 8, 4, 2, nms=nms)
        want = jax_sw.SlidingWindowEngine(ArgmaxModel(), PATCH, sw_batch=2
                                          ).predict({}, image, 8, 4, 2, nms=nms)
        assert got.shape == image.shape
        np.testing.assert_array_equal(got, want)
    assert got[15, 15, 8] == 0 and got[3, 3, 3] == 1


@pytest.fixture(scope="module")
def vnet_pair():
    jmodel, variables = flax_model("dualdecoder", True, VNET_PATCH, seed=3,
                                   mode="test")
    model = port_model("dualdecoder", variables, mode="test")
    return jmodel, variables, model


@pytest.mark.parametrize("quantize", [False, True])
def test_engine_matches_chap_tpu_dualdecoder3d(vnet_pair, quantize):
    """The mean of the two decoders' logits, softmax, overlap average and
    argmax over a 28 x 24 x 20 volume (8 patches, two batches of 4), with
    and without the uint8 upload: >= 99.9% of voxels agree (argmax near
    ties), and the port's model is left in its mode."""
    jmodel, variables, model = vnet_pair
    image = np.random.RandomState(4).randn(28, 24, 20).astype(np.float32)
    want = jax_sw.SlidingWindowEngine(jmodel, VNET_PATCH, sw_batch=4,
                                      quantize_upload=quantize
                                      ).predict(variables, image, 12, 6, 2)
    model.train()
    got = sw.SlidingWindowEngine(model, VNET_PATCH, sw_batch=4,
                                 quantize_upload=quantize,
                                 device="cpu").predict(image, 12, 6, 2)
    assert model.training
    assert got.shape == want.shape == image.shape
    assert 0 < got.mean() < 1, "a one-class prediction would test little"
    assert float(np.mean(got == want)) >= 0.999


def test_all_case_equals_chap_tpu_on_the_toy_model():
    """test_all_case's per-class metrics (dice, hd95; and the full four) over
    two cases, per-case records included."""
    rs = np.random.RandomState(5)
    cases = []
    for i in range(2):
        image = rs.rand(24, 20, 12).astype(np.float32)
        label = (image > 0.45).astype(np.int32)
        cases.append({"image": image, "label": label, "case": f"c{i}"})
    for full in (False, True):
        ours, theirs = [], []
        got = sw.test_all_case(Threshold(), cases, 2, PATCH, 8, 4, sw_batch=4,
                               full_metrics=full, per_case=ours, device="cpu")
        want = jax_sw.test_all_case(ArgmaxModel(), {}, cases, 2, PATCH, 8, 4,
                                    sw_batch=4, full_metrics=full, per_case=theirs)
        np.testing.assert_allclose(got, want, rtol=1e-12)
        assert [c for c, _ in ours] == [c for c, _ in theirs] == ["c0", "c1"]


def _direct_accumulate(l1, l2, starts, score, cnt):
    """A float64 loop over the patches: softmax of the mean logits added
    into the score and count maps."""
    out = (l1.astype(np.float64) + l2) / 2.0
    e = np.exp(out - out.max(1, keepdims=True))
    probs = e / e.sum(1, keepdims=True)
    p = l1.shape[2:]
    for i, s in enumerate(starts):
        sl = tuple(slice(int(s[d]), int(s[d]) + p[d]) for d in range(3))
        score[(slice(None),) + sl] += probs[i]
        cnt[sl] += 1


# (volume, patch, stride_xy, stride_z): K3 reads 16-byte runs where pz and
# a patch's z-start are multiples of 4, and voxel by voxel elsewhere
K3_GEOMETRIES = {"z6": ((40, 36, 20), (16, 16, 8), 12, 6),
                 "z4_aligned": ((40, 36, 24), (16, 16, 8), 12, 4),
                 "pz10_z3": ((40, 36, 20), (16, 16, 10), 12, 3)}


@pytest.mark.parametrize("num_classes,geometry", [(2, "z6"), (3, "z6"),
                                                  (2, "z4_aligned"),
                                                  (3, "pz10_z3")],
                         ids=["2", "3", "z4_aligned", "pz10_z3"])
def test_k3_plain_matches_a_direct_loop(num_classes, geometry):
    """K3's plain version on one batch of overlapping patches whose box does
    not start at the origin, into maps that already hold earlier batches:
    score and count within 1e-6 relative of a float64 loop, and bit-identical
    on repeat. Geometries: z-starts at stride 6, pz and every z-start a
    multiple of 4 (the kernel's 16-byte loads), pz 10 at z-stride 3."""
    rs = np.random.RandomState(6)
    shape, patch, sxy, sz = K3_GEOMETRIES[geometry]
    starts = sw.compute_grid(shape, patch, sxy, sz)[5:13]
    l1, l2 = (rs.randn(8, num_classes, *patch).astype(np.float32) * 3 for _ in range(2))
    base_s = rs.rand(num_classes, *shape).astype(np.float32)
    base_c = rs.randint(0, 3, shape).astype(np.float32)
    want_s, want_c = base_s.astype(np.float64), base_c.astype(np.float64)
    _direct_accumulate(l1, l2, starts, want_s, want_c)
    got = []
    for _ in range(2):
        score, cnt = torch.from_numpy(base_s.copy()), torch.from_numpy(base_c.copy())
        sw.sw_accumulate(torch.from_numpy(l1), torch.from_numpy(l2), starts, score, cnt)
        got.append((score, cnt))
    np.testing.assert_allclose(got[0][0].numpy(), want_s, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0][1].numpy(), want_c)
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])
    assert sw.sw_accumulate_kernel.launches == 0


def test_k3_dispatch_never_runs_the_plain_version_off_the_cpu(monkeypatch):
    """Maps that are not on the CPU go to K3's wrapper, which launches or
    raises; the plain version runs for CPU maps only."""
    def no_plain(*args):
        raise AssertionError("the plain version ran for a non-CPU tensor")
    monkeypatch.setattr(sw, "sw_accumulate_plain", no_plain)
    logits = torch.zeros(2, 2, 4, 4, 4, device="meta")
    score, cnt = torch.zeros(2, 8, 8, 8, device="meta"), torch.zeros(8, 8, 8, device="meta")
    starts = np.zeros((2, 3), np.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sw.sw_accumulate(logits, logits, starts, score, cnt)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sw.sw_accumulate_kernel(torch.zeros(2, 2, 4, 4, 4), None, starts,
                                torch.zeros(2, 8, 8, 8), torch.zeros(8, 8, 8))
    assert sw.sw_accumulate_kernel.launches == 0


def test_engine_refuses_what_is_not_ported():
    """The engine takes float32 or bf16 patches; chap_tpu's ``mesh`` is
    accepted (the process group deals the patches, here one process)."""
    with pytest.raises(ValueError, match="is not float32 or bfloat16"):
        sw.SlidingWindowEngine(Threshold(), PATCH, compute_dtype=torch.float16,
                               device="cpu")
    sw.SlidingWindowEngine(Threshold(), PATCH, mesh=object(), device="cpu")
