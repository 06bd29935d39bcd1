"""Confidence / accuracy analysis (port of chap_tpu/eval/analysis.py; the
reference's acc_conf_analysis, train_ours_2D.py:152-193): a batch's
labeled and unlabeled dice and the mean confidence on correct and on
wrong pixels, a row appended to an .npy history; and the NIfTI writer of
test_3D_util.py:111-124, which needs SimpleITK or nibabel.

numpy; probabilities channel-last [B, H, W, C] as chap_tpu's (a port
tensor [B, C, H, W] moves its class axis last first).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


def _avg_dice(pred: np.ndarray, gt: np.ndarray, num_classes: int) -> float:
    scores = []
    for c in range(1, num_classes):
        p, g = pred == c, gt == c
        denom = p.sum() + g.sum()
        scores.append(2.0 * np.logical_and(p, g).sum() / denom if denom else 0.0)
    return float(np.mean(scores))


def acc_conf_analysis(probs: np.ndarray, labels: np.ndarray, labeled_bs: int,
                      filename: str, num_classes: int = 4) -> Dict[str, float]:
    """probs [B, H, W, C] softmax, labels [B, H, W]: appends the row (lab /
    unlab dice, correct-pixel confidence, error-pixel confidence) to
    ``filename`` and returns it by name."""
    probs = np.asarray(probs)
    labels = np.asarray(labels)
    conf = probs.max(axis=-1)
    pred = probs.argmax(axis=-1)
    out: Dict[str, float] = {}
    for name, sl in (("lab", slice(None, labeled_bs)), ("unlab", slice(labeled_bs, None))):
        p, g, cf = pred[sl], labels[sl], conf[sl]
        err = p != g
        corr = ~err
        out[f"{name}_dice"] = _avg_dice(p, g, num_classes)
        out[f"{name}_corr_conf"] = float((cf * corr).sum() / (corr.sum() + 1e-6))
        out[f"{name}_err_conf"] = float((cf * err).sum() / (err.sum() + 1e-6))
    row = np.array(list(out.values()))[None]
    if os.path.exists(filename):
        row = np.vstack([np.load(filename), row])
    np.save(filename, row)
    return out


def save_prediction_nii(prediction: np.ndarray, image: np.ndarray,
                        label: np.ndarray, save_path: str, case: str) -> bool:
    """Write <case>_pred / _img / _lab.nii.gz (test_3D_util.py:111-124)
    with SimpleITK, or else nibabel; returns whether files were written
    (False where neither is installed)."""
    arrays = {"pred": prediction.astype(np.uint8), "img": image.astype(np.float32),
              "lab": label.astype(np.uint8)}
    try:
        import SimpleITK as sitk
    except ImportError:
        try:
            import nibabel as nib
        except ImportError:
            return False
        os.makedirs(save_path, exist_ok=True)
        for part, a in arrays.items():
            nib.save(nib.Nifti1Image(a, np.eye(4)),
                     os.path.join(save_path, f"{case}_{part}.nii.gz"))
        return True
    os.makedirs(save_path, exist_ok=True)
    for part, a in arrays.items():
        sitk.WriteImage(sitk.GetImageFromArray(a),
                        os.path.join(save_path, f"{case}_{part}.nii.gz"))
    return True
