"""Evaluation metrics: the reference's full MISA suite in pure numpy.

The port's own copy of ``msa_tpu/metrics/scores.py`` (it imports nothing of
``msa_tpu``); tests/test_torch_fit.py holds the two equal.

Re-implements score.py (ACC7 bucketing, ACC3, multiclass_acc, the MISA
report: MAE / Pearson corr / Acc-7 / Acc-2 + weighted F1 pos-neg and
non-neg-neg / McNemar) and trainer.py's quick scorers
(test_MSE_score_model, test_CE_score_model) without sklearn/statsmodels.
Parity with sklearn/statsmodels is pinned in tests/test_metrics.py.

Documented deviation: the reference's MISA computes its "binary_truth" from
the PREDICTIONS and "binary_preds" from the LABELS (score.py:89-90 swaps the
names).  Accuracy is symmetric so it matches either way; weighted F1 is not.
We compute F1 with the true labels as truth (the intended semantics of the
upstream MISA codebase); ``swap_binary=True`` reproduces the reference
byte-for-byte.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np


# ---------------------------------------------------------------------------
# Primitive metrics
# ---------------------------------------------------------------------------

def accuracy_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    return float(np.mean(y_true == y_pred)) if len(y_true) else 0.0


def f1_score_weighted(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Weighted-average F1 (sklearn f1_score(average='weighted') semantics)."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    classes = np.unique(y_true)
    if len(y_true) == 0:
        return 0.0
    total = 0.0
    for c in classes:
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        support = np.sum(y_true == c)
        total += f1 * support
    return float(total / len(y_true))


def classification_report_dict(y_true: np.ndarray,
                               y_pred: np.ndarray) -> Dict[str, object]:
    """Per-class precision/recall/F1/support + accuracy + macro/weighted
    averages (sklearn ``classification_report(output_dict=True)``
    semantics; parity pinned in tests/test_metrics.py).

    The reference prints the full sklearn table for its two binary views
    (ref score.py:109,118); this supplies the same numbers dependency-free.
    Class keys are stringified labels, as in sklearn.
    """
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    classes = np.unique(np.concatenate([y_true, y_pred])) if len(y_true) \
        else np.array([])
    out: Dict[str, object] = {}
    rows = []
    for c in classes:
        tp = int(np.sum((y_pred == c) & (y_true == c)))
        fp = int(np.sum((y_pred == c) & (y_true != c)))
        fn = int(np.sum((y_pred != c) & (y_true == c)))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        support = int(np.sum(y_true == c))
        row = {"precision": float(prec), "recall": float(rec),
               "f1-score": float(f1), "support": support}
        out[str(c)] = row
        rows.append(row)
    n = len(y_true)
    out["accuracy"] = accuracy_score(y_true, y_pred)
    for name, weight in (("macro avg", [1.0 / len(rows)] * len(rows) if rows
                          else []),
                         ("weighted avg", [r["support"] / n for r in rows]
                          if n else [])):
        out[name] = {
            k: float(sum(r[k] * w for r, w in zip(rows, weight)))
            for k in ("precision", "recall", "f1-score")
        }
        out[name]["support"] = n
    return out


def format_classification_report(report: Dict[str, object],
                                 digits: int = 3) -> str:
    """Render a classification_report_dict as the familiar sklearn-style
    table (the reference prints ``classification_report(..., digits=3)``)."""
    classes = [k for k in report
               if k not in ("accuracy", "macro avg", "weighted avg")]
    width = max([len(str(c)) for c in classes + ["weighted avg"]] + [7])
    head = ["precision", "recall", "f1-score", "support"]
    lines = ["{:>{w}} ".format("", w=width)
             + " ".join("{:>9}".format(h) for h in head), ""]

    def row(name, r):
        return ("{:>{w}} ".format(name, w=width)
                + " ".join("{:>9.{d}f}".format(r[k], d=digits)
                           for k in head[:3])
                + " {:>9}".format(r["support"]))

    for c in classes:
        lines.append(row(c, report[c]))
    lines.append("")
    total = report.get("weighted avg", {}).get("support", 0)
    lines.append("{:>{w}} ".format("accuracy", w=width)
                 + " " * 20 + "{:>9.{d}f} {:>9}".format(
                     report["accuracy"], total, d=digits))
    for name in ("macro avg", "weighted avg"):
        lines.append(row(name, report[name]))
    return "\n".join(lines)


def pearson_corr(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    if len(a) < 2:
        return 0.0
    am, bm = a - a.mean(), b - b.mean()
    denom = np.sqrt((am ** 2).sum() * (bm ** 2).sum())
    return float((am * bm).sum() / denom) if denom else 0.0


def mcnemar_test(tt: int, tf: int, ft: int, ff: int) -> Dict[str, float]:
    """Continuity-corrected McNemar chi-square on the 2x2 agreement table
    [[tt, tf], [ft, ff]] (statsmodels mcnemar(exact=False) semantics,
    ref score.py:97-100).  Off-diagonals are tf and ft.
    """
    b, c = tf, ft
    if b + c == 0:
        return {"statistic": 0.0, "pvalue": 1.0}
    stat = (abs(b - c) - 1.0) ** 2 / (b + c)
    # chi2 survival function with 1 dof: sf(x) = erfc(sqrt(x/2))
    p = math.erfc(math.sqrt(stat / 2.0))
    return {"statistic": float(stat), "pvalue": float(p)}


# ---------------------------------------------------------------------------
# Reference metric functions (score.py)
# ---------------------------------------------------------------------------

def _bucket7(x: np.ndarray) -> np.ndarray:
    """The ACC7 bucketing of ref score.py:7-42 (non-mutating).

    Note the reference buckets are asymmetric around 0 by construction:
    [-1,0) -> -1 but (0,1] -> 1, v==0 -> 0.
    """
    x = np.asarray(x, np.float64).reshape(-1)
    out = np.empty_like(x)
    out[x < -2] = -3
    out[(-2 <= x) & (x < -1)] = -2
    out[(-1 <= x) & (x < 0)] = -1
    out[x == 0] = 0
    out[(0 < x) & (x <= 1)] = 1
    out[(1 < x) & (x <= 2)] = 2
    out[x > 2] = 3
    return out


def ACC7(preds: np.ndarray, truth: np.ndarray) -> float:
    return float(np.mean(_bucket7(preds) == _bucket7(truth)))


def ACC3(preds: np.ndarray, y_test: np.ndarray):
    """Ref score.py:44-64: collapse to pos/neg over nonzero labels.

    Preserves the reference's output convention (its newPreds are derived
    from the LABELS and newYtest from the predictions).
    """
    new_preds, new_ytest = [], []
    for p, y in zip(np.asarray(preds).reshape(-1), np.asarray(y_test).reshape(-1)):
        if y > 0:
            new_preds.append(1)
            new_ytest.append(1 if p > 0 else 0)
        elif y < 0:
            new_preds.append(0)
            new_ytest.append(1 if p > 0 else 0)
    return np.array(new_preds), np.array(new_ytest)


def multiclass_acc(preds: np.ndarray, truths: np.ndarray) -> float:
    """Ref score.py:66-73: accuracy after np.round."""
    preds = np.asarray(preds).reshape(-1)
    truths = np.asarray(truths).reshape(-1)
    return float(np.sum(np.round(preds) == np.round(truths)) / float(len(truths)))


def misa_report(
    test_truth: np.ndarray,
    test_preds: np.ndarray,
    swap_binary: bool = False,
    verbose: bool = False,
) -> Dict[str, float]:
    """Full MISA evaluation (ref score.py:75-119) as a dict.

    Returns MAE / corr / mult_acc7 / acc7 / acc2 + F1 (pos-neg, zeros
    excluded) / acc2 + F1 (non-neg vs neg) / McNemar stat+p, plus the two
    per-class classification reports (``report_posneg``/``report_nonneg``,
    sklearn output_dict layout) the reference prints with
    ``classification_report(digits=3)`` (ref score.py:109,118);
    ``verbose=True`` prints them as the familiar tables.
    """
    truth = np.asarray(test_truth, np.float64).reshape(-1)
    preds = np.asarray(test_preds, np.float64).reshape(-1)
    non_zeros = truth != 0

    preds_a7 = np.clip(preds, -3.0, 3.0)
    truth_a7 = np.clip(truth, -3.0, 3.0)

    mae = float(np.mean(np.abs(preds_a7 - truth_a7)))
    corr = pearson_corr(preds_a7, truth_a7)
    mult_a7 = multiclass_acc(preds_a7, truth_a7)
    acc7 = ACC7(preds, truth)

    # pos/neg with zeros excluded
    bt = truth_a7[non_zeros] > 0
    bp = preds_a7[non_zeros] > 0
    if swap_binary:  # reference's literal computation (score.py:89-90)
        bt, bp = bp, bt
    tt = int(np.sum(bp & bt))
    ft = int(np.sum(bp & ~bt))
    tf = int(np.sum(~bp & bt))
    ff = int(np.sum(~bp & ~bt))
    mcn = mcnemar_test(tt, tf, ft, ff)
    acc2 = accuracy_score(bt, bp)
    f1_2 = f1_score_weighted(bt, bp)

    # non-neg vs neg (zeros included)
    bt_n = truth_a7 >= 0
    bp_n = preds_a7 >= 0
    if swap_binary:
        bt_n, bp_n = bp_n, bt_n
    acc2_nn = accuracy_score(bt_n, bp_n)
    f1_nn = f1_score_weighted(bt_n, bp_n)

    out = {
        "mae": mae,
        "corr": corr,
        "mult_acc7": mult_a7,
        "acc7": acc7,
        "acc2_posneg": acc2,
        "f1_posneg": f1_2,
        "acc2_nonneg": acc2_nn,
        "f1_nonneg": f1_nn,
        "mcnemar_stat": mcn["statistic"],
        "mcnemar_p": mcn["pvalue"],
        # The reference's printed classification_report tables (score.py:
        # 109 pos/neg zeros-excluded, 118 non-neg/neg), 0/1-labelled like
        # its bool->int arrays.
        "report_posneg": classification_report_dict(bt.astype(int),
                                                    bp.astype(int)),
        "report_nonneg": classification_report_dict(bt_n.astype(int),
                                                    bp_n.astype(int)),
    }
    if verbose:
        for k, v in out.items():
            if not k.startswith("report_"):
                print(f"{k}: {v}")
        print("\nClassification Report (pos/neg) :")
        print(format_classification_report(out["report_posneg"]))
        print("\nClassification Report (non-neg/neg) :")
        print(format_classification_report(out["report_nonneg"]))
    return out


# ---------------------------------------------------------------------------
# Trainer quick scorers (ref trainer.py:196-228)
# ---------------------------------------------------------------------------

def test_mse_score(preds: np.ndarray, y_test: np.ndarray):
    """MAE + sign-binarized acc / weighted F1 (ref trainer.py:212-228)."""
    preds = np.asarray(preds, np.float64).reshape(-1)
    y_test = np.asarray(y_test, np.float64).reshape(-1)
    mae = float(np.mean(np.abs(preds - y_test)))
    pb = preds >= 0
    yb = y_test >= 0
    return accuracy_score(yb, pb), mae, f1_score_weighted(yb, pb)


def test_ce_score(preds: np.ndarray, y_test: np.ndarray):
    """Acc + MAE + weighted F1 on class ids (ref trainer.py:196-210)."""
    preds = np.asarray(preds).reshape(-1)
    y_test = np.asarray(y_test).reshape(-1)
    mae = float(np.mean(np.abs(preds - y_test)))
    return accuracy_score(y_test, preds), mae, f1_score_weighted(y_test, preds)
