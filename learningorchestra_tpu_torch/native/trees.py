"""One exact best-split tree (CART) through the port's C++ tree core
(``csrc/tree_core.cpp``, the ``tree_core`` library of
:mod:`learningorchestra_tpu_torch.native`), with its plain Python version
beside it. :mod:`learningorchestra_tpu_torch.models.trees` builds the
Builder's decision tree, random forest and gradient boosting on it.

The tree is scikit-learn 1.9's depth-first builder over its best
splitter, down to the order it keeps a node's rows in and sums them in
(the core's header lists the rules), so a seed gives sklearn's tree bit
for bit. The Python version is the core's loop line for line, so both
build the same nodes; :func:`fit_tree`, :func:`apply` and
:func:`gb_residuals` count their calls and rows by path (``native`` or
``python``) in :func:`native.counts`.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from learningorchestra_tpu_torch import native

EPSILON = np.finfo(np.float64).eps
FEATURE_THRESHOLD = np.float32(1e-7)
RAND_R_MAX = 0x7FFFFFFF
UNDEFINED = -2
LEAF = -1


@dataclass
class Tree:
    """A fitted tree's nodes in depth-first order (node 0 the root): a
    leaf has ``feature`` -2 and children -1; ``value`` is a node's
    weighted class counts, or its weighted mean target (one column)."""
    feature: np.ndarray
    threshold: np.ndarray
    left: np.ndarray
    right: np.ndarray
    value: np.ndarray

    @property
    def node_count(self) -> int:
        return len(self.feature)


def core() -> Optional[ctypes.CDLL]:
    """The loaded ``tree_core``, or None (``LO_NATIVE=0``, no ``g++``)."""
    return native.get_lib(native.TREE)


def rand_r_state(seed: int) -> int:
    """The splitter's generator state that scikit-learn draws from
    ``random_state=seed`` (the first draw of its ``RandomState``)."""
    return int(np.random.RandomState(seed).randint(0, RAND_R_MAX))


def _ptr(a: Optional[np.ndarray]) -> Optional[int]:
    return None if a is None else a.ctypes.data


def fit_tree(x: np.ndarray, y: np.ndarray, *, n_classes: int,
             sample_weight: Optional[np.ndarray] = None,
             max_depth: Optional[int] = None, min_samples_leaf: int = 1,
             max_features: Optional[int] = None, seed: int = 0) -> Tree:
    """One tree over float32 rows ``x``: gini over class ids ``y`` in
    ``[0, n_classes)``, or squared error over float64 targets ``y`` where
    ``n_classes`` is 0. A row of weight 0 takes no part. ``seed`` is the
    splitter's xorshift state (:func:`rand_r_state`)."""
    x = np.ascontiguousarray(x, np.float32)
    n, f = x.shape
    y = np.ascontiguousarray(y, np.int32 if n_classes else np.float64)
    w = None if sample_weight is None else \
        np.ascontiguousarray(sample_weight, np.float64)
    if y.shape != (n,) or (w is not None and w.shape != (n,)):
        raise ValueError(f"{n} rows, {y.shape} targets, "
                         f"{None if w is None else w.shape} weights")
    if n_classes and n and (y.min() < 0 or y.max() >= n_classes):
        raise ValueError(f"class ids outside [0, {n_classes})")
    if w is not None and not (w >= 0).all():
        raise ValueError("sample weights must be non-negative")
    depth = -1 if max_depth is None else int(max_depth)
    features = f if max_features is None else int(max_features)
    if not 1 <= features <= f or min_samples_leaf < 1:
        raise ValueError(f"max_features {features} of {f} features, "
                         f"min_samples_leaf {min_samples_leaf}")
    lib = core()
    if lib is None:
        native.count("tree_fit", "python", n)
        return _py_fit_tree(x, y, n_classes, w, depth, min_samples_leaf,
                            features, seed)
    handle = lib.lo_tree_fit(
        x.ctypes.data, n, f, _ptr(w), _ptr(y) if n_classes else None,
        None if n_classes else _ptr(y), n_classes, depth, min_samples_leaf,
        features, seed & 0xFFFFFFFF)
    if not handle:
        raise MemoryError("tree_core: out of memory fitting a tree")
    try:
        count = lib.lo_tree_node_count(handle)
        tree = Tree(np.empty(count, np.int32), np.empty(count),
                    np.empty(count, np.int64), np.empty(count, np.int64),
                    np.empty((count, max(n_classes, 1))))
        lib.lo_tree_export(handle, *(_ptr(a) for a in (
            tree.feature, tree.threshold, tree.left, tree.right,
            tree.value)))
    finally:
        lib.lo_tree_free(handle)
    native.count("tree_fit", "native", n)
    return tree


def apply(tree: Tree, x: np.ndarray) -> np.ndarray:
    """The leaf (node index) of each float32 row of ``x``."""
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 2 or x.shape[1] <= tree.feature.max(initial=-1):
        raise ValueError(f"rows of shape {x.shape} for a tree that splits "
                         f"feature {tree.feature.max(initial=-1)}")
    lib = core()
    if lib is None:
        native.count("tree_predict", "python", len(x))
        return _py_apply(tree, x)
    leaf = np.empty(len(x), np.int64)
    lib.lo_tree_predict(tree.feature.ctypes.data, tree.threshold.ctypes.data,
                        tree.left.ctypes.data, tree.right.ctypes.data,
                        x.ctypes.data, x.shape[0], x.shape[1],
                        leaf.ctypes.data)
    native.count("tree_predict", "native", len(x))
    return leaf


def gb_residuals(raw: np.ndarray, y_idx: np.ndarray) -> np.ndarray:
    """Gradient boosting's residuals y - p for raw scores ``raw`` (n x 1:
    the binomial loss, ``y_idx`` in {0, 1}; n x K: the softmax, ``y_idx``
    the class ids): sklearn's loss gradients negated, bit for bit."""
    raw = np.ascontiguousarray(raw, np.float64)
    y_idx = np.ascontiguousarray(y_idx, np.int32)
    if raw.ndim != 2 or y_idx.shape != raw.shape[:1]:
        raise ValueError(f"raw scores {raw.shape}, labels {y_idx.shape}")
    out = np.empty_like(raw)
    lib = core()
    if lib is None:
        native.count("gb_residuals", "python", len(raw))
        _py_gb_residuals(raw, y_idx, out)
        return out
    lib.lo_gb_residuals(raw.ctypes.data, raw.shape[0], raw.shape[1],
                        y_idx.ctypes.data, out.ctypes.data)
    native.count("gb_residuals", "native", len(raw))
    return out


# ----------------------------------------------------------------------
# the plain Python version: the core's loops line for line
# ----------------------------------------------------------------------
def _our_rand_r(state: list) -> int:
    s = state[0] or 1
    s ^= (s << 13) & 0xFFFFFFFF
    s ^= s >> 17
    s ^= (s << 5) & 0xFFFFFFFF
    state[0] = s
    return s % (RAND_R_MAX + 1)


def _rand_int(low: int, high: int, state: list) -> int:
    return low + _our_rand_r(state) % (high - low)


def _simultaneous_sort(v: list, idx: list, lo: int, n: int) -> None:
    """sklearn's introsort with its 3-way partition over v[lo:lo + n]
    and idx beside it (float32 values as Python floats compare alike)."""
    if n:
        _introsort(v, idx, lo, n, 2 * int(math.log2(n)))


def _swap(v, idx, i, j):
    v[i], v[j] = v[j], v[i]
    idx[i], idx[j] = idx[j], idx[i]


def _median3(v, lo, n):
    a, b, c = v[lo], v[lo + n // 2], v[lo + n - 1]
    if a < b:
        return b if b < c else (c if a < c else a)
    if b < c:
        return a if a < c else c
    return b


def _sift_down(v, idx, lo, start, end):
    root = start
    while True:
        child, maxind = root * 2 + 1, root
        if child < end and v[lo + maxind] < v[lo + child]:
            maxind = child
        if child + 1 < end and v[lo + maxind] < v[lo + child + 1]:
            maxind = child + 1
        if maxind == root:
            return
        _swap(v, idx, lo + root, lo + maxind)
        root = maxind


def _heapsort(v, idx, lo, n):
    start = (n - 2) // 2
    while True:
        _sift_down(v, idx, lo, start, n)
        if start == 0:
            break
        start -= 1
    for end in range(n - 1, 0, -1):
        _swap(v, idx, lo, lo + end)
        _sift_down(v, idx, lo, 0, end)


def _introsort(v, idx, lo, n, maxd):
    while n > 15:
        if maxd <= 0:
            _heapsort(v, idx, lo, n)
            return
        maxd -= 1
        pivot = _median3(v, lo, n)
        i = l = 0
        r = n
        while i < r:
            if v[lo + i] < pivot:
                _swap(v, idx, lo + i, lo + l)
                i += 1
                l += 1
            elif v[lo + i] > pivot:
                r -= 1
                _swap(v, idx, lo + i, lo + r)
            else:
                i += 1
        _introsort(v, idx, lo, l, maxd)
        lo += r
        n -= r
    for i in range(lo + 1, lo + n):  # insertion sort
        tv, ti = v[i], idx[i]
        j = i
        while j > lo and v[j - 1] > tv:
            v[j], idx[j] = v[j - 1], idx[j - 1]
            j -= 1
        v[j], idx[j] = tv, ti


def _f32_plus_threshold(value: float) -> float:
    """value + FEATURE_THRESHOLD in float32 arithmetic."""
    return float(np.float32(value) + FEATURE_THRESHOLD)


class _PyBuilder:
    def __init__(self, x, y, n_classes, w, max_depth, min_leaf,
                 max_features, seed):
        n = len(x)
        self.cols = x.T.tolist()  # float32 values as Python floats
        self.k = n_classes
        self.y = y.tolist()
        self.w = [1.0] * n if w is None else w.tolist()
        self.max_depth = math.inf if max_depth < 0 else max_depth
        self.min_leaf = min_leaf
        self.max_features = max_features
        self.state = [seed & 0xFFFFFFFF]
        self.samples = [i for i in range(n) if w is None or self.w[i] != 0]
        self.fv = [0.0] * len(self.samples)
        self.weighted_n_samples = 0.0
        for wi in self.w:
            self.weighted_n_samples += wi
        self.features = list(range(x.shape[1]))
        self.constant_features = [0] * x.shape[1]

    # the criterion: the node's sums, the left part's up to pos
    def node_init(self, start, end):
        self.start, self.end = start, end
        self.total = [0.0] * max(self.k, 1)
        self.wn = self.sq_total = 0.0
        for p in range(start, end):
            i = self.samples[p]
            wi = self.w[i]
            if self.k:
                self.total[self.y[i]] += wi
            else:
                wy = wi * self.y[i]
                self.total[0] += wy
                self.sq_total += wy * self.y[i]
            self.wn += wi
        self.reset()

    def reset(self):
        self.pos = self.start
        self.sum_left = [0.0] * len(self.total)
        self.wl = 0.0

    def update(self, new_pos):
        k, y, w, samples, left = self.k, self.y, self.w, self.samples, \
            self.sum_left
        if new_pos - self.pos <= self.end - new_pos:
            for p in range(self.pos, new_pos):
                i = samples[p]
                left[y[i] if k else 0] += w[i] if k else w[i] * y[i]
                self.wl += w[i]
        else:
            left[:] = self.total
            self.wl = self.wn
            for p in range(self.end - 1, new_pos - 1, -1):
                i = samples[p]
                left[y[i] if k else 0] -= w[i] if k else w[i] * y[i]
                self.wl -= w[i]
        self.pos = new_pos

    def node_impurity(self):
        if self.k:
            sq = 0.0
            for c in range(self.k):
                sq += self.total[c] * self.total[c]
            return 1.0 - sq / (self.wn * self.wn)
        mean = self.total[0] / self.wn
        return self.sq_total / self.wn - mean * mean

    def children_impurity(self):
        wl, wr = self.wl, self.wn - self.wl
        if self.k:
            sq_l = sq_r = 0.0
            for c in range(self.k):
                r = self.total[c] - self.sum_left[c]
                sq_l += self.sum_left[c] * self.sum_left[c]
                sq_r += r * r
            return 1.0 - sq_l / (wl * wl), 1.0 - sq_r / (wr * wr)
        sq_left = 0.0
        for p in range(self.start, self.pos):
            i = self.samples[p]
            sq_left += self.w[i] * self.y[i] * self.y[i]
        ml = self.sum_left[0] / wl
        mr = (self.total[0] - self.sum_left[0]) / wr
        return (sq_left / wl - ml * ml,
                (self.sq_total - sq_left) / wr - mr * mr)

    def proxy(self):
        wl, wr = self.wl, self.wn - self.wl
        if self.k:
            il, ir = self.children_impurity()
            return -wr * ir - wl * il
        sl = self.sum_left[0]
        sr = self.total[0] - sl
        return sl * sl / wl + sr * sr / wr

    def node_split(self, impurity, n_known):
        start, end, samples, fv = self.start, self.end, self.samples, \
            self.fv
        features, constants = self.features, self.constant_features
        best = None
        best_proxy = -math.inf
        f_i, n_visited, n_found, n_drawn = len(features), 0, 0, 0
        n_total = n_known
        while f_i > n_total and (n_visited < self.max_features or
                                 n_visited <= n_found + n_drawn):
            n_visited += 1
            f_j = _rand_int(n_drawn, f_i - n_found, self.state)
            if f_j < n_known:
                features[n_drawn], features[f_j] = \
                    features[f_j], features[n_drawn]
                n_drawn += 1
                continue
            f_j += n_found
            f = features[f_j]
            col = self.cols[f]
            for p in range(start, end):
                fv[p] = col[samples[p]]
            _simultaneous_sort(fv, samples, start, end - start)
            if fv[end - 1] <= _f32_plus_threshold(fv[start]):
                features[f_j], features[n_total] = \
                    features[n_total], features[f_j]
                n_found += 1
                n_total += 1
                continue
            f_i -= 1
            features[f_i], features[f_j] = features[f_j], features[f_i]
            self.reset()
            p = start
            while p < end:
                p += 1
                while p < end and fv[p] <= _f32_plus_threshold(fv[p - 1]):
                    p += 1
                if p == end:
                    continue
                if p - start < self.min_leaf or end - p < self.min_leaf:
                    continue
                self.update(p)
                current = self.proxy()
                if current > best_proxy:
                    best_proxy = current
                    best = [p, f, fv[p - 1] / 2.0 + fv[p] / 2.0]
        if best is not None:
            pos, f, threshold = best
            col = self.cols[f]
            ps, pe = start, end
            while ps < pe:
                if col[samples[ps]] <= threshold:
                    ps += 1
                else:
                    pe -= 1
                    samples[ps], samples[pe] = samples[pe], samples[ps]
            self.reset()
            self.update(pos)
            imp_l, imp_r = self.children_impurity()
            wn, wl = self.wn, self.wl
            wr = wn - wl
            improvement = (wn / self.weighted_n_samples) * (
                impurity - wr / wn * imp_r - wl / wn * imp_l)
            best += [imp_l, imp_r, improvement]
        features[:n_known] = constants[:n_known]
        constants[n_known:n_known + n_found] = \
            features[n_known:n_known + n_found]
        return best, n_total

    def build(self) -> Tree:
        nodes, left, right = [], [], []
        stack = [(0, len(self.samples), 0, -1, False, math.inf, 0)]
        first = True
        while stack:
            start, end, depth, parent, is_left, impurity, n_const = \
                stack.pop()
            m = end - start
            self.node_init(start, end)
            wn, value = self.wn, list(self.total)
            is_leaf = depth >= self.max_depth or m < 2 or \
                m < 2 * self.min_leaf
            if first:
                impurity = self.node_impurity()
                first = False
            is_leaf = is_leaf or impurity <= EPSILON
            best = None
            if not is_leaf:
                best, n_const = self.node_split(impurity, n_const)
                is_leaf = best is None or best[5] + EPSILON < 0.0
            node = len(nodes)
            if parent >= 0:
                (left if is_left else right)[parent] = node
            nodes.append((UNDEFINED if is_leaf else best[1],
                          float(UNDEFINED) if is_leaf else best[2],
                          value if self.k else [value[0] / wn]))
            left.append(LEAF)
            right.append(LEAF)
            if not is_leaf:
                pos, _, _, imp_l, imp_r, _ = best
                stack.append((pos, end, depth + 1, node, False, imp_r,
                              n_const))
                stack.append((start, pos, depth + 1, node, True, imp_l,
                              n_const))
        feature, threshold, value = zip(*nodes)
        return Tree(np.array(feature, np.int32), np.array(threshold),
                    np.array(left, np.int64), np.array(right, np.int64),
                    np.array(value, np.float64))


def _py_fit_tree(x, y, n_classes, w, max_depth, min_leaf, max_features,
                 seed) -> Tree:
    return _PyBuilder(x, y, n_classes, w, max_depth, min_leaf,
                      max_features, seed).build()


def _py_apply(tree: Tree, x: np.ndarray) -> np.ndarray:
    node = np.zeros(len(x), np.int64)
    inner = np.nonzero(tree.left[node] != LEAF)[0]
    while len(inner):
        at = node[inner]
        go_left = x[inner, tree.feature[at]].astype(np.float64) <= \
            tree.threshold[at]
        node[inner] = np.where(go_left, tree.left[at], tree.right[at])
        inner = inner[tree.left[node[inner]] != LEAF]
    return node


def _half_binomial_gradient(y: float, raw: float) -> float:
    if raw > -37.0:
        e = math.exp(-raw)
        return ((1.0 - y) - y * e) / (1.0 + e)
    return math.exp(raw) - y


def _py_gb_residuals(raw, y_idx, out) -> None:
    rows, labels = raw.tolist(), y_idx.tolist()
    for i, (r, label) in enumerate(zip(rows, labels)):
        if len(r) == 1:
            out[i, 0] = -_half_binomial_gradient(float(label), r[0])
            continue
        top = r[0]
        for v in r[1:]:
            if top < v:
                top = v
        p = [math.exp(v - top) for v in r]
        total = 0.0
        for v in p:
            total += v
        out[i] = [-(v / total - (1.0 if label == k else 0.0))
                  for k, v in enumerate(p)]
