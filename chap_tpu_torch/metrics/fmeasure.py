"""Binary F-measure / IoU metrics for polyp segmentation (a copy of
chap_tpu/metrics/fmeasure.py, numpy only; the reference's val_2D.py:7-40
Fmeasure_calu)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def fmeasure_calu(smap: np.ndarray, gt_map: np.ndarray
                  ) -> Tuple[float, float, float, float, float, float]:
    """(precision, recall, specificity, dice, f-measure, iou) of a binary
    prediction vs. ground truth; all 0 when nothing is found (tp = 0)."""
    pred = np.asarray(smap)
    gt = np.asarray(gt_map)
    num_rec = float(np.sum(pred == 1))          # FP + TP
    num_norec = float(np.sum(pred == 0))        # FN + TN
    tp = float(np.sum(np.logical_and(pred, gt)))
    num_obj = float(np.sum(gt))                 # TP + FN
    num_pred = float(np.sum(pred))              # FP + TP

    fn = num_obj - tp
    fp = num_rec - tp
    tn = num_norec - fn

    if tp == 0:
        return 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
    iou = tp / (fn + num_rec)
    precision = tp / num_rec
    recall = tp / num_obj
    specificity = tn / (tn + fp) if (tn + fp) > 0 else 0.0
    dice = 2 * tp / (num_obj + num_pred)
    fmeasure = (2.0 * precision * recall) / (precision + recall)
    return precision, recall, specificity, dice, fmeasure, iou
