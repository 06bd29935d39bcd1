"""Host-side binary segmentation metrics with medpy-exact semantics (a copy
of chap_tpu/metrics/surface.py, kept here so the port never imports the JAX
package).

The reference evaluates with medpy.metric.binary (dc/hd95 at val_2D.py:43-51,
+asd/jc at test_2D_fully.py:37-51, +ravd at test_3D_util.py:147-152). The
same algorithms are implemented here on scipy: surface distances via binary
erosion borders + euclidean distance transform, exactly medpy's
``__surface_distances`` recipe (connectivity-1 structuring element, one
erosion iteration).
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import binary_erosion, distance_transform_edt, generate_binary_structure


def _as_bool(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x).astype(bool))


def dc(result, reference) -> float:
    """Dice coefficient 2|A∩B| / (|A|+|B|)."""
    result, reference = _as_bool(result), _as_bool(reference)
    intersection = np.count_nonzero(result & reference)
    size_sum = np.count_nonzero(result) + np.count_nonzero(reference)
    if size_sum == 0:
        return 0.0
    return 2.0 * intersection / float(size_sum)


def jc(result, reference) -> float:
    """Jaccard coefficient |A∩B| / |A∪B|."""
    result, reference = _as_bool(result), _as_bool(reference)
    union = np.count_nonzero(result | reference)
    if union == 0:
        return 0.0
    return np.count_nonzero(result & reference) / float(union)


def ravd(result, reference) -> float:
    """Relative volume difference (vol(result)-vol(reference))/vol(reference).

    SIGNED, matching medpy.metric.binary.ravd despite the name: under- and
    over-segmentation cancel when averaged per case (test_3D_util.py:147-152
    relies on this)."""
    result, reference = _as_bool(result), _as_bool(reference)
    vol_ref = np.count_nonzero(reference)
    if vol_ref == 0:
        raise RuntimeError("reference is empty; ravd undefined")
    return (np.count_nonzero(result) - vol_ref) / float(vol_ref)


def _surface_distances(result, reference, voxelspacing=None) -> np.ndarray:
    """Distances from each border voxel of `result` to the border of `reference`."""
    result, reference = _as_bool(result), _as_bool(reference)
    if not np.any(result):
        raise RuntimeError("result is empty; surface distance undefined")
    if not np.any(reference):
        raise RuntimeError("reference is empty; surface distance undefined")
    footprint = generate_binary_structure(result.ndim, 1)
    result_border = result ^ binary_erosion(result, structure=footprint, iterations=1)
    reference_border = reference ^ binary_erosion(reference, structure=footprint, iterations=1)
    dt = distance_transform_edt(~reference_border, sampling=voxelspacing)
    return dt[result_border]


def hd(result, reference, voxelspacing=None) -> float:
    """Symmetric Hausdorff distance (max of directed maxima)."""
    hd1 = _surface_distances(result, reference, voxelspacing).max()
    hd2 = _surface_distances(reference, result, voxelspacing).max()
    return float(max(hd1, hd2))


def hd95(result, reference, voxelspacing=None) -> float:
    """95th percentile of the symmetric surface distance distribution."""
    hd1 = _surface_distances(result, reference, voxelspacing)
    hd2 = _surface_distances(reference, result, voxelspacing)
    return float(np.percentile(np.hstack((hd1, hd2)), 95))


def asd(result, reference, voxelspacing=None) -> float:
    """Average (directed) surface distance from result to reference."""
    return float(_surface_distances(result, reference, voxelspacing).mean())


def assd(result, reference, voxelspacing=None) -> float:
    """Average symmetric surface distance."""
    sds = np.hstack(
        (
            _surface_distances(result, reference, voxelspacing),
            _surface_distances(reference, result, voxelspacing),
        )
    )
    return float(sds.mean())


def calculate_metric_percase(pred, gt):
    """(dice, hd95) with the reference's empty-prediction guard (val_2D.py:43-51)."""
    pred = np.asarray(pred) > 0
    gt = np.asarray(gt) > 0
    if pred.sum() > 0 and gt.sum() > 0:
        return dc(pred, gt), hd95(pred, gt)
    return 0.0, 0.0


def calculate_metric_percase_full(pred, gt):
    """(dice, hd95, asd, jc) per class, matching test_2D_fully.py:37-51."""
    pred = np.asarray(pred) > 0
    gt = np.asarray(gt) > 0
    if pred.sum() > 0 and gt.sum() > 0:
        return dc(pred, gt), hd95(pred, gt), asd(pred, gt), jc(pred, gt)
    return 0.0, 0.0, 0.0, 0.0


def cal_metric_3d(gt, pred):
    """[dice, hd95] or zeros, matching val_3D.py:82-88 guard semantics."""
    pred = np.asarray(pred) > 0
    gt = np.asarray(gt) > 0
    if pred.sum() > 0 and gt.sum() > 0:
        return np.array([dc(pred, gt), hd95(pred, gt)])
    return np.zeros(2)


def cal_metric_3d_full(gt, pred):
    """[dice, ravd, hd95, asd], matching test_3D_util.py:147-152."""
    pred = np.asarray(pred) > 0
    gt = np.asarray(gt) > 0
    if pred.sum() > 0 and gt.sum() > 0:
        return np.array([dc(pred, gt), ravd(pred, gt), hd95(pred, gt), asd(pred, gt)])
    return np.zeros(4)
