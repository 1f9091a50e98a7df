"""Key-value pair extraction metrics: exact-string-match micro P/R/F1.

Behavioral parity targets (reference: pipeline/evaluation.py):
- membership-count core                                  :6-95
- ``calculate_kvpe_metric``                              :98-207
- ``calculate_detail_kvpe_metric``                       :210-665
- fname dedup of the count rows                        :149-177, 415-487
  (single process: the cross-process gather waits for the multi-device
  slice)

The port's copy of ``peneo_tpu/pipeline/evaluation.py:27-219``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

TASKS = (
    "kv_pair",
    "line_extraction",
    "ent_linking_head",
    "ent_linking_tail",
    "line_grouping_head",
    "line_grouping_tail",
)


def _prf(num_correct: float, num_pred: float, num_gt: float):
    p = num_correct / num_pred if num_pred > 0 else 0.0
    r = num_correct / num_gt if num_gt > 0 else 0.0
    f = (2 * p * r) / (p + r) if p + r > 0 else 0.0
    return p, r, f


def match_counts(pred: Sequence, gt: Sequence, detail: Optional[List] = None):
    """Membership counts with optional TP/FP/FN detail rows
    (reference: pipeline/evaluation.py:45-95)."""
    n_correct = 0.0
    matched = []
    for p in pred:
        if p in gt:
            n_correct += 1
            matched.append(p)
            if detail is not None:
                detail.append({"status": "TP", "pred": p})
        elif detail is not None:
            detail.append({"status": "FP", "pred": p})
    if detail is not None:
        for g in gt:
            if g not in matched:
                detail.append({"status": "FN", "gt": g})
    return float(len(pred)), float(len(gt)), n_correct


def _pairs(map_or_list) -> List[Tuple]:
    """head→tail dict (scalar or list values) → list of (head, tail) tuples."""
    if isinstance(map_or_list, dict):
        out = []
        for k, v in map_or_list.items():
            if isinstance(v, list):
                out.extend((k, vv) for vv in v)
            else:
                out.append((k, v))
        return out
    return list(map_or_list)


def _sample_task_counts(pred, gt, detail_rows: Optional[List] = None) -> Dict[str, Tuple]:
    """Per-sample (num_pred, num_gt, num_correct) for all six tasks.

    ``pred``/``gt`` are the 7-tuples from decode_sample: (kv_pairs, lines,
    le_map, el_head_map, el_tail_map, lg_head_map, lg_tail_map).
    """
    counts = {}
    counts["kv_pair"] = match_counts(pred[0], gt[0], detail_rows)
    counts["line_extraction"] = match_counts(pred[1], gt[1])
    counts["ent_linking_head"] = match_counts(_pairs(pred[3]), _pairs(gt[3]))
    counts["ent_linking_tail"] = match_counts(_pairs(pred[4]), _pairs(gt[4]))
    counts["line_grouping_head"] = match_counts(_pairs(pred[5]), _pairs(gt[5]))
    counts["line_grouping_tail"] = match_counts(_pairs(pred[6]), _pairs(gt[6]))
    return counts


def calculate_kvpe_metric(
    all_pred: Sequence,
    all_gt: Sequence,
    all_fname: Sequence[str],
):
    """kv-pair micro P/R/F1 with fname dedup (reference:
    pipeline/evaluation.py:98-207). Returns (metrics, detail)."""
    sample_detail, rows = [], []
    for fname, pred, gt in zip(all_fname, all_pred, all_gt):
        det_rows: List = []
        np_, ng, nc = match_counts(pred[0], gt[0], det_rows)
        p, r, f = _prf(nc, np_, ng)
        sample_detail.append({
            "fname": fname, "num_pred": np_, "num_gt": ng, "num_correct": nc,
            "precision": p, "recall": r, "f1": f, "detail": det_rows,
        })
        rows.append([fname, np_, ng, nc])

    seen = set()
    tot = [0.0, 0.0, 0.0]
    n_samples = 0
    for fname, np_, ng, nc in rows:
        if fname in seen:
            continue  # a file counts once
        seen.add(fname)
        tot[0] += np_
        tot[1] += ng
        tot[2] += nc
        n_samples += 1
    p, r, f = _prf(tot[2], tot[0], tot[1])
    detail = {
        "precision": p, "recall": r, "f1": f,
        "num_pred": tot[0], "num_gt": tot[1], "num_correct": tot[2],
        "num_sample_processed": n_samples, "detail": sample_detail,
    }
    return {"precision": p, "recall": r, "f1": f}, detail


def calculate_detail_kvpe_metric(
    all_pred: Sequence,
    all_gt: Sequence,
    all_fname: Sequence[str],
):
    """All six sub-task metrics (reference: pipeline/evaluation.py:210-665).

    Returns (summary, detail): summary has 18 keys — kv-pair
    precision/recall/f1 plus <task>_{precision,recall,f1} for the other five
    tasks; detail nests per-task aggregates and per-sample rows.
    """
    sample_details, rows = [], []
    for fname, pred, gt in zip(all_fname, all_pred, all_gt):
        kv_detail: List = []
        counts = _sample_task_counts(pred, gt, kv_detail)
        entry = {"fname": fname}
        for task in TASKS:
            np_, ng, nc = counts[task]
            p, r, f = _prf(nc, np_, ng)
            entry[task] = {"num_pred": np_, "num_gt": ng, "num_correct": nc,
                           "precision": p, "recall": r, "f1": f}
        entry["detail"] = kv_detail
        sample_details.append(entry)
        row = [fname]
        for task in TASKS:
            row.extend(counts[task])
        rows.append(row)

    seen = set()
    totals = {task: [0.0, 0.0, 0.0] for task in TASKS}
    for row in rows:
        fname = row[0]
        if fname in seen:
            continue
        seen.add(fname)
        for t_idx, task in enumerate(TASKS):
            for j in range(3):
                totals[task][j] += row[1 + 3 * t_idx + j]

    detail: Dict = {}
    summary: Dict = {}
    for task in TASKS:
        np_, ng, nc = totals[task]
        p, r, f = _prf(nc, np_, ng)
        detail[task] = {"precision": p, "recall": r, "f1": f,
                        "num_pred": np_, "num_gt": ng, "num_correct": nc}
        if task == "kv_pair":
            summary["precision"], summary["recall"], summary["f1"] = p, r, f
        else:
            summary[f"{task}_precision"] = p
            summary[f"{task}_recall"] = r
            summary[f"{task}_f1"] = f
    detail["num_sample_processed"] = len(seen)
    detail["detail"] = sample_details
    return summary, detail
