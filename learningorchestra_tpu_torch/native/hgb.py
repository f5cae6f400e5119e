"""Full-data histogram gradient boosting over pre-binned features, the
port's copy of the JAX package's ``native/hgb.py``.

The Builder's streaming GB trains on every row, as the reference's
Spark GBTClassifier does: features are binned to uint8 codes (edges
from a sampled quantile sketch: sampling the bin boundaries is not
training on a sample; every row contributes gradients to every
iteration), the codes live in memory at one byte per value, and the
boosting loop runs in the port's C++ core (``csrc/hgb_core.cpp``,
:mod:`learningorchestra_tpu_torch.native`) with the numpy fallback below
where no compiler exists. Both paths give the JAX package's results:
the core is the JAX core's source and the fallback is its code.

Memory: rows x nfeats bytes of codes + one float64 raw score per row
(per class beyond binary): 10M rows x 5 features ~ 50 MB + 80 MB.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from learningorchestra_tpu_torch import native

MAX_BINS = 256

DEFAULT_ITERS = int(os.environ.get("LO_HGB_ITERS", "60"))
DEFAULT_DEPTH = int(os.environ.get("LO_HGB_DEPTH", "6"))
DEFAULT_LR = float(os.environ.get("LO_HGB_LR", "0.2"))


def quantile_edges(sample: np.ndarray, max_bins: int = MAX_BINS,
                   ) -> List[np.ndarray]:
    """Per-feature cut points (at most ``max_bins - 1``) from a sample
    of rows; duplicates collapse for low-cardinality features."""
    edges = []
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    for f in range(sample.shape[1]):
        col = sample[:, f]
        col = col[np.isfinite(col)]
        if col.size == 0:
            edges.append(np.empty((0,), np.float64))
            continue
        e = np.unique(np.quantile(col, qs))
        edges.append(np.asarray(e, np.float64))
    return edges


def bin_codes(x: np.ndarray, edges: List[np.ndarray]) -> np.ndarray:
    """uint8 bin codes for a feature batch (NaN -> bin 0; +/-inf sort
    correctly through searchsorted and keep their extreme bins)."""
    out = np.empty(x.shape, np.uint8)
    for f, e in enumerate(edges):
        col = x[:, f]
        codes = np.searchsorted(e, col, side="left")
        codes = np.where(np.isnan(col), 0, codes)
        out[:, f] = codes.astype(np.uint8)
    return out


class HistGB:
    """sklearn-shaped binary/multiclass classifier over binned codes."""

    def __init__(self, n_iter: int = DEFAULT_ITERS,
                 max_depth: int = DEFAULT_DEPTH,
                 learning_rate: float = DEFAULT_LR,
                 l2: float = 1.0, min_samples_leaf: int = 20):
        self.n_iter = n_iter
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.l2 = l2
        self.min_samples_leaf = min_samples_leaf
        self.classes_: Optional[np.ndarray] = None
        self._model = None       # ctypes ptr (native path)
        self._py = None          # python model (fallback path)
        self._lib = None

    # ------------------------------------------------------------------
    def fit_binned(self, codes: np.ndarray, y: np.ndarray) -> "HistGB":
        if self._model is not None and self._lib is not None:
            # refit: release the previous native model's tree arrays
            self._lib.lo_hgb_free(self._model)
            self._model = None
        self._py = None
        codes = np.ascontiguousarray(codes, np.uint8)
        self.classes_, y_idx = np.unique(y, return_inverse=True)
        y_idx = np.ascontiguousarray(y_idx, np.int32)
        nclass = len(self.classes_)
        if nclass < 2:
            raise ValueError("need at least 2 classes")
        lib = native.get_lib()
        if lib is not None:
            self._lib = lib
            ptr = lib.lo_hgb_train(
                codes.ctypes.data, codes.shape[0], codes.shape[1],
                y_idx.ctypes.data, nclass, self.n_iter, self.max_depth,
                MAX_BINS, self.learning_rate, self.l2,
                self.min_samples_leaf)
            if ptr:
                self._model = ptr
                return self
        self._py = _py_train(codes, y_idx, nclass, self.n_iter,
                             self.max_depth, self.learning_rate,
                             self.l2, self.min_samples_leaf)
        return self

    def predict_binned(self, codes: np.ndarray) -> np.ndarray:
        codes = np.ascontiguousarray(codes, np.uint8)
        nclass = len(self.classes_)
        k = 1 if nclass == 2 else nclass
        if self._model is not None:
            out = np.empty((codes.shape[0], k), np.float64)
            self._lib.lo_hgb_predict(self._model, codes.ctypes.data,
                                     codes.shape[0], out.ctypes.data)
        else:
            out = _py_predict(self._py, codes)
        if nclass == 2:
            idx = (out[:, 0] > 0).astype(np.int64)
        else:
            idx = np.argmax(out, axis=1)
        return self.classes_[idx]

    def __del__(self):
        if self._model is not None and self._lib is not None:
            try:
                self._lib.lo_hgb_free(self._model)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass


# ----------------------------------------------------------------------
# numpy fallback — same algorithm (depth-wise, heap layout); per-node
# boolean masks + per-feature bincounts keep it vectorized enough for
# toolchain-less images (the C++ path is the performance one)
# ----------------------------------------------------------------------
def _py_build_tree(codes, g, h, max_depth, lr, l2, min_leaf):
    nrows, nfeats = codes.shape
    slots = (1 << (max_depth + 1)) - 1
    tfeat = np.full(slots, -2, np.int64)
    tbin = np.zeros(slots, np.uint8)
    tval = np.zeros(slots, np.float64)
    assign = np.zeros(nrows, np.int64)
    tfeat[0] = -1
    for depth in range(max_depth):
        first, count = (1 << depth) - 1, 1 << depth
        active = [n for n in range(first, first + count)
                  if tfeat[n] == -1]
        if not active:
            break
        any_split = False
        for n in active:
            rows = assign == n
            G, H, C = g[rows].sum(), h[rows].sum(), int(rows.sum())
            parent_obj = G * G / (H + l2 + 1e-12)
            best = (1e-7, -1, -1)
            for f in range(nfeats):
                b = codes[rows, f].astype(np.int64)
                fg = np.bincount(b, weights=g[rows], minlength=MAX_BINS)
                fh = np.bincount(b, weights=h[rows], minlength=MAX_BINS)
                fc = np.bincount(b, minlength=MAX_BINS)
                GL = np.cumsum(fg)[:-1]
                HL = np.cumsum(fh)[:-1]
                CL = np.cumsum(fc)[:-1]
                CR = C - CL
                ok = (CL >= min_leaf) & (CR >= min_leaf)
                HR, GR = H - HL, G - GL
                gain = np.where(
                    ok,
                    GL * GL / (HL + l2 + 1e-12) +
                    GR * GR / (HR + l2 + 1e-12) - parent_obj,
                    -np.inf)
                bi = int(np.argmax(gain))
                if gain[bi] > best[0]:
                    best = (float(gain[bi]), f, bi)
            if best[1] < 0:
                tval[n] = -lr * G / (H + l2 + 1e-12)
                continue
            tfeat[n] = best[1]
            tbin[n] = best[2]
            left = 2 * n + 1
            if left < slots:
                tfeat[left] = -1
                tfeat[left + 1] = -1
            any_split = True
            go_left = rows & (codes[:, best[1]] <= best[2])
            assign[go_left] = left
            assign[rows & ~go_left] = left + 1
        if not any_split:
            break
    # finalize remaining provisional leaves
    for n in range(slots):
        if tfeat[n] == -1 and tval[n] == 0.0:
            rows = assign == n
            if rows.any():
                tval[n] = (-lr * g[rows].sum() /
                           (h[rows].sum() + l2 + 1e-12))
            tfeat[n] = -1
    # resolve each row's final leaf (callers update their score slice)
    node = assign.copy()
    internal = tfeat[node] >= 0
    while internal.any():
        f = tfeat[node[internal]]
        c = codes[np.nonzero(internal)[0], f]
        node[internal] = np.where(c <= tbin[node[internal]],
                                  2 * node[internal] + 1,
                                  2 * node[internal] + 2)
        internal = tfeat[node] >= 0
    return tfeat, tbin, tval, node


def _py_train(codes, y_idx, nclass, n_iter, max_depth, lr, l2,
              min_leaf):
    nrows = codes.shape[0]
    k = 1 if nclass == 2 else nclass
    counts = np.bincount(y_idx, minlength=nclass) / nrows
    if nclass == 2:
        p = min(max(counts[1], 1e-9), 1 - 1e-9)
        bases = np.array([np.log(p / (1 - p))])
    else:
        bases = np.log(np.maximum(counts, 1e-9))
    scores = np.tile(bases, (nrows, 1))
    trees = []
    for _ in range(n_iter):
        if nclass == 2:
            p = 1.0 / (1.0 + np.exp(-scores[:, 0]))
            g = p - y_idx
            h = np.maximum(p * (1 - p), 1e-12)
            tfeat, tbin, tval, leaf = _py_build_tree(
                codes, g, h, max_depth, lr, l2, min_leaf)
            scores[:, 0] += tval[leaf]
            trees.append((0, tfeat, tbin, tval))
        else:
            mx = scores.max(axis=1, keepdims=True)
            e = np.exp(scores - mx)
            probs = e / e.sum(axis=1, keepdims=True)
            for kk in range(nclass):
                g = probs[:, kk] - (y_idx == kk)
                h = np.maximum(probs[:, kk] * (1 - probs[:, kk]), 1e-12)
                tfeat, tbin, tval, leaf = _py_build_tree(
                    codes, g, h, max_depth, lr, l2, min_leaf)
                scores[:, kk] += tval[leaf]
                trees.append((kk, tfeat, tbin, tval))
    return {"bases": bases, "trees": trees, "k": k}


def _py_predict(model, codes):
    nrows = codes.shape[0]
    out = np.tile(model["bases"], (nrows, 1))
    for kk, tfeat, tbin, tval in model["trees"]:
        node = np.zeros(nrows, np.int64)
        internal = tfeat[node] >= 0
        while internal.any():
            f = tfeat[node[internal]]
            c = codes[np.nonzero(internal)[0], f]
            node[internal] = np.where(c <= tbin[node[internal]],
                                      2 * node[internal] + 1,
                                      2 * node[internal] + 2)
            internal = tfeat[node] >= 0
        out[:, kk] += tval[node]
    return out
