"""Pseudo-label engine for self-training.

A copy of ``doda_tpu/utils/pseudo_labels.py``. Reference counterpart:
util/pseudo_labels_util.py. Two improvements over the reference pipeline
(SURVEY §7):

* per-class thresholds from confidence *histograms* (1024 bins + cumsum
  quantile), instead of all-gathering sorted Python
  lists of every point's confidence (ref :93-119 — the reference's known
  scalability hot spot),
* labels stored as int16 ``.npy`` arrays (with optional txt mirroring for
  byte-level parity with ref ``save_results``,
  util/common_utils.py:304-313).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

N_BINS = 1024


def accumulate_confidence_histogram(preds, confidence, valid, n_classes,
                                    hist=None):
    """Per-class histogram of max-softmax confidences over predicted
    class (the distribution ref :93-119 builds as sorted lists)."""
    if hist is None:
        hist = np.zeros((n_classes, N_BINS), np.int64)
    p = np.asarray(preds).reshape(-1)
    c = np.asarray(confidence).reshape(-1)
    v = np.asarray(valid).reshape(-1)
    bins = np.clip((c * N_BINS).astype(np.int64), 0, N_BINS - 1)
    np.add.at(hist, (p[v], bins[v]), 1)
    return hist


def thresholds_from_histogram(hist, thres_ratio):
    """Per-class confidence threshold keeping the top ``ratio`` fraction
    (ref get_thres_per_class_on_thres_ratio, :128-144): the threshold is
    the confidence of the (ratio * n_c)-th highest-confidence point."""
    n_classes = hist.shape[0]
    if len(thres_ratio) == 1:
        thres_ratio = list(thres_ratio) * n_classes
    out = []
    for c in range(n_classes):
        total = hist[c].sum()
        if total == 0:  # no point predicted as this class (ref :142-143)
            out.append(0.0)
            continue
        want = max(1, int(thres_ratio[c] * total))
        # walk from the top bin down until `want` points are covered
        csum = np.cumsum(hist[c][::-1])
        bin_from_top = int(np.searchsorted(csum, want))
        bin_idx = N_BINS - 1 - min(bin_from_top, N_BINS - 1)
        out.append(bin_idx / N_BINS)
    return out


def get_perclass_thres(cfg, collect_hist_fn):
    """(ref: get_perclass_thres, :147-154). ``collect_hist_fn`` runs the
    inference sweep and returns the confidence histogram."""
    n_classes = cfg.COMMON_CLASSES.n_classes
    if cfg.SELF_TRAIN.get('global_thres', False):
        thres = list(cfg.SELF_TRAIN.thres)
        if len(thres) == 1:
            thres = thres * n_classes
        return thres
    hist = collect_hist_fn()
    return thresholds_from_histogram(hist, cfg.SELF_TRAIN.thres_ratio)


def save_scene_labels(pseudo_labels_dir, name, labels, txt_mirror=True):
    """int labels for one scene -> npy (+ optional reference-format txt)."""
    pseudo_labels_dir = Path(pseudo_labels_dir)
    (pseudo_labels_dir / 'npy').mkdir(parents=True, exist_ok=True)
    np.save(pseudo_labels_dir / 'npy' / f'{name}.npy',
            labels.astype(np.int16))
    if txt_mirror:
        (pseudo_labels_dir / 'txt').mkdir(parents=True, exist_ok=True)
        path = pseudo_labels_dir / 'txt' / f'{name}.txt'
        if not path.exists():
            np.savetxt(path, labels.astype(np.uint8), fmt='%d')


def save_scene_soft_labels(pseudo_labels_dir, name, softmax, hard_mask):
    """Soft pseudo labels for one scene -> fp16 npy (N, C).

    Rows passing the confidence threshold (``hard_mask``) are stored
    one-hot (top-1 confidence == 1 marks them as hard labels downstream,
    matching the split rule of ref model/unet.py:176-178); the rest keep
    the softmax distribution. The reference declares this SOFT_LABEL
    surface but ships no producer at all."""
    pseudo_labels_dir = Path(pseudo_labels_dir)
    (pseudo_labels_dir / 'soft').mkdir(parents=True, exist_ok=True)
    soft = np.asarray(softmax, np.float32)
    top1 = soft.argmax(-1)
    onehot = np.eye(soft.shape[-1], dtype=np.float32)[top1]
    out = np.where(np.asarray(hard_mask)[..., None], onehot, soft)
    np.save(pseudo_labels_dir / 'soft' / f'{name}.npy',
            out.astype(np.float16))


def load_scene_soft_labels(pseudo_labels_dir, name):
    return np.load(Path(pseudo_labels_dir) / 'soft' / f'{name}.npy')


def generation_done(pseudo_labels_dir, need_soft=False):
    """done.txt sentinel (ref: util/pseudo_labels_util.py:162).

    With ``need_soft`` the store only counts as complete if the soft/
    distributions exist too — a resumed SOFT_LABEL run over a store
    written before soft mode was enabled must regenerate, or loader
    workers die on FileNotFoundError mid-epoch."""
    done = os.path.exists(Path(pseudo_labels_dir) / 'done.txt')
    if done and need_soft:
        soft_dir = Path(pseudo_labels_dir) / 'soft'
        return soft_dir.is_dir() and any(soft_dir.iterdir())
    return done


def mark_done(pseudo_labels_dir):
    """(ref :71-73 done.txt sentinel)"""
    np.savetxt(Path(pseudo_labels_dir) / 'done.txt', np.array([1]))


def save_class_ratio(pseudo_labels_dir, class_ratio):
    np.savetxt(Path(pseudo_labels_dir) / 'class_ratio.txt', class_ratio)


def load_class_ratio(pseudo_labels_dir):
    return np.loadtxt(Path(pseudo_labels_dir) / 'class_ratio.txt')
