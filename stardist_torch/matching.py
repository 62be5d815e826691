"""Instance matching metrics (detection / instance segmentation).

Re-implementation of the reference ``stardist/matching.py`` surface:
``matching``, ``matching_dataset``, ``relabel_sequential``,
``group_matching_labels``. The joint label histogram is computed with a
vectorized ``np.bincount`` instead of the reference's numba kernel
(stardist/matching.py:45-52) — no JIT dependency and comparable speed.
"""
from __future__ import annotations

from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from scipy.ndimage import find_objects
from scipy.optimize import linear_sum_assignment

matching_criteria = dict()


def label_are_sequential(y):
    """True if y contains exactly the labels 1..max (plus optionally 0)."""
    labels = np.unique(y)
    return (set(labels) - {0}) == set(range(1, 1 + int(labels.max(initial=0))))


def is_array_of_integers(y):
    return isinstance(y, np.ndarray) and np.issubdtype(y.dtype, np.integer)


def _raise(e):
    raise e


def _check_label_array(y, name=None, check_sequential=False):
    err = ValueError(
        "{label} must be an array of {integers}.".format(
            label="labels" if name is None else name,
            integers=("sequential " if check_sequential else "") + "non-negative integers",
        )
    )
    if not is_array_of_integers(y):
        raise err
    if len(y) == 0:
        return True
    if check_sequential:
        if not label_are_sequential(y):
            raise err
    else:
        if not y.min() >= 0:
            raise err
    return True


def label_overlap(x, y, check=True):
    """Joint histogram: overlap[i,j] = #pixels with x==i and y==j."""
    if check:
        _check_label_array(x, "x", True)
        _check_label_array(y, "y", True)
        if x.shape != y.shape:
            raise ValueError("x and y must have the same shape")
    return _label_overlap(x, y)


def _label_overlap(x, y):
    x = x.ravel()
    y = y.ravel()
    nx = int(x.max(initial=0)) + 1
    ny = int(y.max(initial=0)) + 1
    counts = np.bincount(x.astype(np.int64) * ny + y.astype(np.int64), minlength=nx * ny)
    return counts.reshape(nx, ny).astype(np.uint64)


def _safe_divide(x, y, eps=1e-10):
    if np.isscalar(x) and np.isscalar(y):
        return x / y if np.abs(y) > eps else 0.0
    out = np.zeros(np.broadcast(x, y).shape, np.float32)
    np.divide(x, y, out=out, where=np.abs(y) > eps)
    return out


def intersection_over_union(overlap):
    _check_label_array(overlap, "overlap")
    if np.sum(overlap) == 0:
        return overlap
    n_pixels_pred = np.sum(overlap, axis=0, keepdims=True)
    n_pixels_true = np.sum(overlap, axis=1, keepdims=True)
    return _safe_divide(overlap, n_pixels_pred + n_pixels_true - overlap)


matching_criteria["iou"] = intersection_over_union


def intersection_over_true(overlap):
    _check_label_array(overlap, "overlap")
    if np.sum(overlap) == 0:
        return overlap
    return _safe_divide(overlap, np.sum(overlap, axis=1, keepdims=True))


matching_criteria["iot"] = intersection_over_true


def intersection_over_pred(overlap):
    _check_label_array(overlap, "overlap")
    if np.sum(overlap) == 0:
        return overlap
    return _safe_divide(overlap, np.sum(overlap, axis=0, keepdims=True))


matching_criteria["iop"] = intersection_over_pred


def precision(tp, fp, fn):
    return tp / (tp + fp) if tp > 0 else 0


def recall(tp, fp, fn):
    return tp / (tp + fn) if tp > 0 else 0


def accuracy(tp, fp, fn):
    # a.k.a. "average precision" in the DSB-2018 sense
    return tp / (tp + fp + fn) if tp > 0 else 0


def f1(tp, fp, fn):
    return (2 * tp) / (2 * tp + fp + fn) if tp > 0 else 0


def matching(y_true, y_pred, thresh=0.5, criterion="iou", report_matches=False):
    """Matching metrics between two label images.

    Objects are greedily matched by an optimal assignment (Hungarian) on the
    criterion scores with the score itself as tie-breaker; pairs with score >=
    thresh count as true positives (reference stardist/matching.py:109-230).

    Returns a namedtuple with fields: criterion, thresh, fp, tp, fn,
    precision, recall, accuracy, f1, n_true, n_pred, mean_true_score,
    mean_matched_score, panoptic_quality (+ matched_* if report_matches).
    """
    _check_label_array(y_true, "y_true")
    _check_label_array(y_pred, "y_pred")
    if y_true.shape != y_pred.shape:
        raise ValueError(
            f"y_true ({y_true.shape}) and y_pred ({y_pred.shape}) have different shapes"
        )
    if criterion not in matching_criteria:
        raise ValueError(f"Matching criterion '{criterion}' not supported.")
    if thresh is None:
        thresh = 0
    thresh = float(thresh) if np.isscalar(thresh) else tuple(map(float, thresh))

    y_true, _, map_rev_true = relabel_sequential(y_true)
    y_pred, _, map_rev_pred = relabel_sequential(y_pred)

    overlap = label_overlap(y_true, y_pred, check=False)
    scores = matching_criteria[criterion](overlap)
    assert 0 <= np.min(scores) <= np.max(scores) <= 1

    # drop background row/column
    scores = scores[1:, 1:]
    n_true, n_pred = scores.shape
    n_matched = min(n_true, n_pred)

    def _single(thr):
        not_trivial = n_matched > 0
        if not_trivial:
            # optimal matching: primary objective = #pairs above threshold,
            # secondary (tie-breaker) = total score
            costs = -(scores >= thr).astype(float) - scores / (2 * n_matched)
            true_ind, pred_ind = linear_sum_assignment(costs)
            assert n_matched == len(true_ind) == len(pred_ind)
            match_ok = scores[true_ind, pred_ind] >= thr
            tp = int(np.count_nonzero(match_ok))
        else:
            tp = 0
        fp = n_pred - tp
        fn = n_true - tp

        sum_matched_score = float(np.sum(scores[true_ind, pred_ind][match_ok])) if not_trivial else 0.0
        mean_matched_score = _safe_divide(sum_matched_score, tp)
        mean_true_score = _safe_divide(sum_matched_score, n_true)
        panoptic_quality = _safe_divide(sum_matched_score, tp + fp / 2 + fn / 2)

        stats_dict = dict(
            criterion=criterion,
            thresh=thr,
            fp=fp,
            tp=tp,
            fn=fn,
            precision=precision(tp, fp, fn),
            recall=recall(tp, fp, fn),
            accuracy=accuracy(tp, fp, fn),
            f1=f1(tp, fp, fn),
            n_true=n_true,
            n_pred=n_pred,
            mean_true_score=mean_true_score,
            mean_matched_score=mean_matched_score,
            panoptic_quality=panoptic_quality,
        )
        if bool(report_matches):
            if not_trivial:
                stats_dict.update(
                    matched_pairs=tuple(
                        (int(map_rev_true[i]), int(map_rev_pred[j]))
                        for i, j in zip(1 + true_ind, 1 + pred_ind)
                    ),
                    matched_scores=tuple(scores[true_ind, pred_ind]),
                    matched_tps=tuple(map(int, np.flatnonzero(match_ok))),
                )
            else:
                stats_dict.update(matched_pairs=(), matched_scores=(), matched_tps=())
        return namedtuple("Matching", stats_dict.keys())(*stats_dict.values())

    return _single(thresh) if np.isscalar(thresh) else tuple(map(_single, thresh))


def matching_dataset(y_true, y_pred, thresh=0.5, criterion="iou", by_image=False,
                     show_progress=True, parallel=False):
    """Matching metrics accumulated over a list of image pairs."""
    if len(y_true) != len(y_pred):
        raise ValueError("y_true and y_pred must have the same length.")
    return matching_dataset_lazy(
        tuple(zip(y_true, y_pred)), thresh=thresh, criterion=criterion,
        by_image=by_image, show_progress=show_progress, parallel=parallel,
    )


def matching_dataset_lazy(y_gen, thresh=0.5, criterion="iou", by_image=False,
                          show_progress=True, parallel=False):
    expected_keys = set((
        "fp", "tp", "fn", "precision", "recall", "accuracy", "f1", "criterion",
        "thresh", "n_true", "n_pred", "mean_true_score", "mean_matched_score",
        "panoptic_quality",
    ))

    single_thresh = False
    if np.isscalar(thresh):
        single_thresh = True
        thresh = (thresh,)

    if parallel:
        fn = lambda pair: matching(*pair, thresh=thresh, criterion=criterion, report_matches=False)
        with ThreadPoolExecutor() as pool:
            stats_all = tuple(pool.map(fn, y_gen))
    else:
        stats_all = tuple(
            matching(y_t, y_p, thresh=thresh, criterion=criterion, report_matches=False)
            for y_t, y_p in y_gen
        )

    # accumulate per threshold
    n_images, n_threshs = len(stats_all), len(thresh)
    accumulate = [{} for _ in range(n_threshs)]
    for stats in stats_all:
        for i, s in enumerate(stats):
            acc = accumulate[i]
            for k, v in s._asdict().items():
                if k == "mean_true_score" and not bool(by_image):
                    # accumulate as "sum_matched_score"
                    acc[k] = acc.setdefault(k, 0) + v * s.n_true
                else:
                    try:
                        acc[k] = acc.setdefault(k, 0) + v
                    except TypeError:
                        pass

    for thr, acc in zip(thresh, accumulate):
        if set(acc.keys()) != expected_keys:
            raise ValueError("unexpected keys")
        acc["criterion"] = criterion
        acc["thresh"] = thr
        acc["by_image"] = bool(by_image)
        if bool(by_image):
            for k in ("precision", "recall", "accuracy", "f1", "mean_true_score",
                      "mean_matched_score", "panoptic_quality"):
                acc[k] /= n_images
        else:
            tp, fp, fn_, n_true = acc["tp"], acc["fp"], acc["fn"], acc["n_true"]
            sum_matched_score = acc["mean_true_score"]
            acc.update(
                precision=precision(tp, fp, fn_),
                recall=recall(tp, fp, fn_),
                accuracy=accuracy(tp, fp, fn_),
                f1=f1(tp, fp, fn_),
                mean_true_score=_safe_divide(sum_matched_score, n_true),
                mean_matched_score=_safe_divide(sum_matched_score, tp),
                panoptic_quality=_safe_divide(sum_matched_score, tp + fp / 2 + fn_ / 2),
            )

    accumulate = tuple(namedtuple("DatasetMatching", acc.keys())(*acc.values()) for acc in accumulate)
    return accumulate[0] if single_thresh else accumulate


def relabel_sequential(label_field, offset=1):
    """Relabel arbitrary non-negative labels to {offset, ..., offset+n-1}.

    Returns (relabeled, forward_map, inverse_map); label 0 is never remapped.
    Same contract as skimage.segmentation.relabel_sequential (which the
    reference vendors at stardist/matching.py:319-405).
    """
    offset = int(offset)
    if offset <= 0:
        raise ValueError("Offset must be strictly positive.")
    if np.min(label_field) < 0:
        raise ValueError("Cannot relabel array that contains negative values.")
    max_label = int(label_field.max())
    if not np.issubdtype(label_field.dtype, np.integer):
        label_field = label_field.astype(np.min_scalar_type(max_label))
    labels = np.unique(label_field)
    labels0 = labels[labels != 0]
    new_max_label = offset - 1 + len(labels0)
    new_labels0 = np.arange(offset, new_max_label + 1)
    output_type = label_field.dtype
    required_type = np.min_scalar_type(new_max_label)
    if np.dtype(required_type).itemsize > np.dtype(label_field.dtype).itemsize:
        output_type = required_type
    forward_map = np.zeros(max_label + 1, dtype=output_type)
    forward_map[labels0] = new_labels0
    inverse_map = np.zeros(new_max_label + 1, dtype=output_type)
    inverse_map[offset:] = labels0
    relabeled = forward_map[label_field]
    return relabeled, forward_map, inverse_map


def group_matching_labels(ys, thresh=1e-10, criterion="iou"):
    """Assign consistent ids to matching objects across consecutive label
    images (e.g. time-lapse frames); see reference stardist/matching.py:409-471."""
    if not len(ys) > 1:
        raise ValueError("'ys' must have 2 or more entries")
    if isinstance(ys, np.ndarray):
        _check_label_array(ys, "ys")
        if not ys.ndim > 1:
            raise ValueError("'ys' must be at least 2-dimensional")
        ys_grouped = np.empty_like(ys, dtype=np.int32)
    else:
        if not all(_check_label_array(y, "ys") for y in ys):
            raise ValueError("'ys' must be a list of label images")
        if not all(y.shape == ys[0].shape for y in ys):
            raise ValueError("all label images must have the same shape")
        ys_grouped = np.empty((len(ys),) + ys[0].shape, dtype=np.int32)

    def _match_single(y_prev, y, next_id):
        y = y.astype(np.int32, copy=False)
        res = matching(y_prev, y, report_matches=True, thresh=thresh, criterion=criterion)
        # map label ids y -> y_prev for true-positive matches
        relabel = dict(reversed(res.matched_pairs[i]) for i in res.matched_tps)
        y_grouped = np.zeros_like(y)
        for i, sl in enumerate(find_objects(y), 1):
            if sl is None:
                continue
            m = y[sl] == i
            if i in relabel:
                y_grouped[sl][m] = relabel[i]
            else:
                y_grouped[sl][m] = next_id
                next_id += 1
        return y_grouped, next_id

    ys_grouped[0] = ys[0]
    next_id = ys_grouped[0].max() + 1
    for i in range(len(ys) - 1):
        ys_grouped[i + 1], next_id = _match_single(ys_grouped[i], ys[i + 1], next_id)
    return ys_grouped
