"""Slice-wise 2D volume evaluation (port of chap_tpu/eval/eval2d.py:25-104
and :185-199).

The reference's val_2D.test_single_volume (val_2D.py:54-97): zoom each
slice to the network size, forward, argmax, zoom back, per-class Dice+HD95.
Here all slices of a volume are zoomed on the host, copied to the card in
chunks of ``slice_batch`` and forwarded one chunk after another without a
host sync; the argmax runs on the card and only the int8 label map comes
back, in one copy per volume.

Ensemble modes match val_2D.py:66-80: model1 | model2 | logit_ensemble |
prob_ensemble, and single-output models. The split-model (ds, adv) and
polyp predictors wait for the model zoo and ACAL slices (ROADMAP).

With W > 1 ranks (parallel/dist.py) each volume's chunks of ``slice_batch``
slices are dealt to the ranks in turn (chunk k of the whole eval to rank k
mod W), and the int8 label maps are assembled with one all-reduce of a
zero-filled buffer of the volume's shape; the metrics are computed on rank 0
and broadcast. chap_tpu's mesh shards each chunk's rows instead (one SPMD
program, chap_tpu/eval/eval2d.py:57-71); whole chunks keep every forward at
W = 1's shape, so the label maps, and the scores, are the same at every W.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from chap_tpu_torch.data.transforms import resize_slice
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.metrics.surface import (calculate_metric_percase,
                                            calculate_metric_percase_full)
from chap_tpu_torch.models.layers import softmax
from chap_tpu_torch.parallel import dist

MODEL_TYPES = ("model1", "model2", "logit_ensemble", "prob_ensemble")
SLICE_BATCH = 16      # slices a forward


def make_predictor(model: torch.nn.Module, model_type: str = "logit_ensemble",
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Returns predict(x [B,1,H,W]) -> label map [B,H,W] int8 on ``device``
    (the card unless ``device="cpu"``; ``x`` may lie on the host). Each call
    runs the model in eval mode under ``torch.inference_mode()`` and puts
    back the mode it found. ``predict.device`` is the device."""
    device = resolve_device(device)
    if model_type not in MODEL_TYPES:
        raise ValueError(f"model_type {model_type!r} not in {MODEL_TYPES}")
    param_device = next(model.parameters()).device
    if param_device.type != device.type:
        raise ValueError(f"model is on {param_device}, the predictor on {device}")

    def predict(x: torch.Tensor) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                out = model(x.to(device, non_blocking=True))
                if isinstance(out, (tuple, list)):
                    o1, o2 = out[0], out[1]
                    if model_type == "model1":
                        prob = softmax(o1, 1)
                    elif model_type == "model2":
                        prob = softmax(o2, 1)
                    elif model_type == "logit_ensemble":
                        prob = softmax((o1 + o2) / 2.0, 1)
                    else:
                        prob = (softmax(o1, 1)
                                + softmax(o2, 1)) / 2.0
                else:
                    prob = softmax(out, 1)
                return prob.argmax(dim=1).to(torch.int8)
        finally:
            model.train(was_training)

    predict.device = device
    return predict


def predict_volume(predict: Callable, image: np.ndarray,
                   patch_size: Sequence[int] = (256, 256),
                   slice_batch: int = SLICE_BATCH, first_chunk: int = 0
                   ) -> np.ndarray:
    """image: [D,H,W] float -> prediction [D,H,W] (int8, or int32 when the
    slices were zoomed back from ``patch_size``). With W > 1 ranks, this
    rank predicts the volume's chunks k (counted from ``first_chunk``) with
    k mod W equal to its rank, and every rank returns the whole map."""
    d, x, y = image.shape
    world, rank = dist.world_size(), dist.rank()
    starts = [s for k, s in enumerate(range(0, d, slice_batch))
              if (first_chunk + k) % world == rank]
    mine = [i for s in starts for i in range(s, min(s + slice_batch, d))]
    slices = np.zeros((d, *patch_size), np.float32)
    for i in mine:
        slices[i] = resize_slice(image[i], patch_size, order=0)
    host = torch.from_numpy(slices).unsqueeze(1)
    if predict.device.type == "cuda":
        host = host.pin_memory()
    chunks = [predict(host[s:s + slice_batch]) for s in starts]
    if world == 1:
        pred = torch.cat(chunks)
    else:
        pred = torch.zeros((d, *patch_size), dtype=torch.int8,
                           device=predict.device)
        for s, chunk in zip(starts, chunks):
            pred[s:s + slice_batch] = chunk
        dist.all_reduce_(pred)
    pred = pred.cpu().numpy()
    if (x, y) != tuple(patch_size):
        pred = np.stack([resize_slice(pred[i].astype(np.float32), (x, y), order=0)
                         for i in range(d)]).astype(np.int32)
    return pred


def _metrics(prediction: np.ndarray, label: np.ndarray, classes: int,
             full_metrics: bool) -> List[Tuple]:
    metric_fn = calculate_metric_percase_full if full_metrics else calculate_metric_percase
    label = np.asarray(label)
    return [metric_fn(prediction == c, label == c) for c in range(1, classes)]


def test_single_volume(image: np.ndarray, label: np.ndarray, predict: Callable,
                       classes: int, patch_size: Sequence[int] = (256, 256),
                       full_metrics: bool = False) -> List[Tuple]:
    """Per-class (dice, hd95[, asd, jc]) like val_2D.py:93-97 /
    test_2D_fully.py:81-83."""
    prediction = predict_volume(predict, np.asarray(image), patch_size)
    return _metrics(prediction, label, classes, full_metrics)


def evaluate_volumes(dataset, predict: Callable, classes: int,
                     patch_size: Sequence[int] = (256, 256),
                     full_metrics: bool = False) -> np.ndarray:
    """Mean per-class metrics over a volume dataset (train_ours_2D.py:407-415):
    [classes - 1, 2] (dice, hd95), or [classes - 1, 4] with full_metrics.
    With W > 1 ranks every rank predicts its chunks (module docstring) and
    returns rank 0's metrics."""
    total = np.zeros((classes - 1, 4 if full_metrics else 2))
    chunk = 0
    for i in range(len(dataset)):
        sample = dataset[i]
        image = np.asarray(sample["image"])
        prediction = predict_volume(predict, image, patch_size,
                                    first_chunk=chunk)
        chunk += -(-image.shape[0] // SLICE_BATCH)
        if dist.is_main():
            total = total + np.array(_metrics(prediction, sample["label"],
                                              classes, full_metrics))
    return dist.broadcast_array(total / len(dataset), predict.device)
