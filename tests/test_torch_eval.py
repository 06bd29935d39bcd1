"""The port's slice-wise 2D evaluation (eval/eval2d.py) against chap_tpu's,
from carried weights at widths (4, 8, 16, 16, 32) on synthetic volumes
(CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import zoom

from chap_tpu.data.datasets import SyntheticVolumeDataset as JaxVolumes
from chap_tpu.eval.eval2d import evaluate_volumes as jax_evaluate_volumes
from chap_tpu.eval.eval2d import make_predictor as jax_make_predictor
from chap_tpu.eval.eval2d import predict_volume as jax_predict_volume
from chap_tpu_torch.eval.eval2d import (MODEL_TYPES, evaluate_volumes,
                                        make_predictor, predict_volume)
from test_torch_models import _flax_model, _port_model

torch.set_num_threads(1)

SLICE_BATCH = 16    # chap_tpu's predict_volume default, padded to it


@pytest.fixture(scope="module")
def models():
    jmodel, variables = _flax_model("mcnet", hw=32)
    return jmodel, variables, _port_model(variables, "mcnet")


class ZoomedVolumes:
    """Two synthetic volumes of 6 slices, optionally resampled to another
    in-plane size, so predict_volume zooms there and back."""

    def __init__(self, hw=None):
        self.base = JaxVolumes((6, 32, 32), 4, length=2)
        self.hw = hw

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        s = dict(self.base[i])
        if self.hw is not None:
            f = (1, self.hw[0] / 32, self.hw[1] / 32)
            s["image"] = zoom(s["image"], f, order=1).astype(np.float32)
            s["label"] = zoom(s["label"], f, order=0)
        return s


@pytest.mark.parametrize("model_type", MODEL_TYPES)
@pytest.mark.parametrize("hw", [None, (40, 36)])
def test_predict_volume_agrees_with_chap_tpu(models, model_type, hw):
    jmodel, variables, model = models
    ds = ZoomedVolumes(hw)
    predict = make_predictor(model, model_type, device="cpu")
    j_predict = jax_make_predictor(jmodel, model_type)
    for i in range(len(ds)):
        image = ds[i]["image"]
        got = predict_volume(predict, image, (32, 32))
        want = jax_predict_volume(j_predict, variables, image, (32, 32))
        assert got.shape == want.shape == image.shape
        assert got.dtype == want.dtype
        agree = float(np.mean(got == want))
        assert agree >= 0.999, f"{model_type} volume {i}: {agree:.5f}"


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("hw", [None, (40, 36)])
def test_evaluate_volumes_equals_chap_tpu_on_its_predictions(models, full, hw):
    """The port's evaluate_volumes fed chap_tpu's predictions gives chap_tpu's
    metrics exactly: the metric code is held apart from argmax near-ties."""
    jmodel, variables, _ = models
    ds = ZoomedVolumes(hw)
    j_predict = jax_make_predictor(jmodel, "logit_ensemble")

    def chap_tpu_predict(x):
        # padded to the slice batch as chap_tpu's predict_volume pads
        pad = SLICE_BATCH - x.shape[0]
        x = np.concatenate([x.numpy(), np.zeros((pad,) + x.shape[1:], np.float32)])
        out = j_predict(variables, jnp.asarray(x.transpose(0, 2, 3, 1)))
        return torch.from_numpy(np.array(out)[:SLICE_BATCH - pad])
    chap_tpu_predict.device = torch.device("cpu")

    got = evaluate_volumes(ds, chap_tpu_predict, 4, (32, 32), full)
    want = jax_evaluate_volumes(ds, j_predict, variables, 4, (32, 32), full)
    assert got.shape == (3, 4 if full else 2)
    np.testing.assert_array_equal(got, want)


class Threshold(torch.nn.Module):
    """A single-output model: class = intensity > 0.5."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, x):
        fg = (x[:, 0] > 0.5).float() * self.w
        return torch.stack([(1 - fg) * 9.0, fg * 9.0], dim=1)


def test_single_output_protocol_matches_the_reference_loop():
    """Zoom to the patch, argmax, zoom back (val_2D.py:54-97), against a
    direct per-slice transcription."""
    image = np.random.RandomState(0).rand(7, 100, 90).astype(np.float32)
    got = predict_volume(make_predictor(Threshold(), device="cpu"), image,
                         (64, 64), slice_batch=4)
    want = np.zeros_like(image, dtype=np.int32)
    for i in range(image.shape[0]):
        sl = zoom(image[i], (64 / 100, 64 / 90), order=0)
        want[i] = zoom((sl > 0.5).astype(np.float32), (100 / 64, 90 / 64), order=0)
    np.testing.assert_array_equal(got, want)


def test_predictor_restores_the_mode_and_leaves_the_buffers(models):
    model = models[2]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 1, 32, 32).astype(np.float32))
    predict = make_predictor(model, "prob_ensemble", device="cpu")
    for training in (True, False):
        model.train(training)
        out = predict(x)
        assert model.training is training
        assert out.dtype == torch.int8 and out.shape == (2, 32, 32)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="model_type"):
        make_predictor(model, "mean", device="cpu")
