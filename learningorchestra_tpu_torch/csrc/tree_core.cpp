// tree_core — exact best-split decision trees (CART) for the port's Builder:
// one tree per call, the decision tree, every tree of the random forest and
// every stage of gradient boosting. Host code: the card has no part in it
// (data-dependent branching has no accelerator mapping worth forcing).
//
// The tree is scikit-learn 1.9's DepthFirstTreeBuilder over its
// BestSplitter, so that the port's trees make the JAX package's sklearn
// trees:
//   - rows are float32 (sklearn's tree DTYPE); a row whose weight is 0 takes
//     no part; the weights are float64 (a forest's bootstrap counts);
//   - gini (class ids) or squared error (float64 targets), sklearn's
//     impurity, proxy and improvement formulas;
//   - the features of a node are drawn by sklearn's Fisher-Yates loop over
//     its xorshift generator (our_rand_r) with the same bookkeeping of
//     constant features, so a seed fixes which of two equal splits wins;
//   - a node's candidate positions skip float32 values within 1e-7 of their
//     predecessor (FEATURE_THRESHOLD, in float32 arithmetic); the threshold
//     is the float64 midpoint of the two float32 values; the first strictly
//     best proxy wins;
//   - a node is a leaf at max_depth, below 2 rows or 2 * min_samples_leaf,
//     at impurity <= DBL_EPSILON, or when no position is valid.
// The rows of a node are reordered as sklearn reorders them (its introsort
// of each feature in turn, its partition by swaps) and every sum runs in
// sklearn's order (its criterion's update from whichever end is nearer),
// so equal gains tie as sklearn's do and a seed gives sklearn's tree bit
// for bit; native/trees.py's Python version builds the same nodes.
// lo_gb_residuals gives gradient boosting sklearn's residuals bit for bit
// (libm's exp, sklearn's loss formulas).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (learningorchestra_tpu_torch/native
// builds it at first use into build/native/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <new>
#include <numeric>
#include <vector>

namespace {

constexpr double kEpsilon = 2.220446049250313e-16;  // DBL_EPSILON
constexpr float kFeatureThreshold = 1e-7f;
constexpr uint32_t kRandRMax = 0x7FFFFFFFu;
constexpr int32_t kUndefined = -2;
constexpr int64_t kLeaf = -1;

uint32_t our_rand_r(uint32_t* seed) {
  if (*seed == 0) *seed = 1;
  *seed ^= *seed << 13;
  *seed ^= *seed >> 17;
  *seed ^= *seed << 5;
  return *seed % (kRandRMax + 1u);
}

int64_t rand_int(int64_t low, int64_t high, uint32_t* seed) {
  return low + static_cast<int64_t>(our_rand_r(seed)) % (high - low);
}

struct Tree {
  int n_values = 1;  // classes, or 1 for a regression tree
  std::vector<int32_t> feature;
  std::vector<double> threshold;
  std::vector<int64_t> left, right;
  std::vector<double> value;  // nodes x n_values
};

struct Record {
  int64_t start, end, depth, parent;
  bool is_left;
  double impurity;
  int64_t n_constant_features;
};

// sklearn's simultaneous_sort (utils/_sorting.pyx) with its 3-way
// partition: the order it leaves equal values in decides the order of
// every later sum, so it is reproduced, not replaced by std::sort
void swap2(float* v, int64_t* idx, int64_t i, int64_t j) {
  std::swap(v[i], v[j]);
  std::swap(idx[i], idx[j]);
}

float median3(const float* v, int64_t n) {
  float a = v[0], b = v[n / 2], c = v[n - 1];
  if (a < b) {
    if (b < c) return b;
    if (a < c) return c;
    return a;
  }
  if (b < c) {
    if (a < c) return a;
    return c;
  }
  return b;
}

void sift_down(float* v, int64_t* idx, int64_t start, int64_t end) {
  int64_t root = start;
  while (true) {
    int64_t child = root * 2 + 1, maxind = root;
    if (child < end && v[maxind] < v[child]) maxind = child;
    if (child + 1 < end && v[maxind] < v[child + 1]) maxind = child + 1;
    if (maxind == root) return;
    swap2(v, idx, root, maxind);
    root = maxind;
  }
}

void heapsort(float* v, int64_t* idx, int64_t n) {
  int64_t start = (n - 2) / 2, end = n;
  while (true) {
    sift_down(v, idx, start, end);
    if (start == 0) break;
    --start;
  }
  for (end = n - 1; end > 0; --end) {
    swap2(v, idx, 0, end);
    sift_down(v, idx, 0, end);
  }
}

void insertion_sort(float* v, int64_t* idx, int64_t n) {
  for (int64_t i = 1; i < n; ++i) {
    float tv = v[i];
    int64_t ti = idx[i];
    int64_t j = i;
    while (j > 0 && v[j - 1] > tv) {
      v[j] = v[j - 1];
      idx[j] = idx[j - 1];
      --j;
    }
    v[j] = tv;
    idx[j] = ti;
  }
}

void introsort_3way(float* v, int64_t* idx, int64_t n, int64_t maxd) {
  while (n > 15) {
    if (maxd <= 0) {
      heapsort(v, idx, n);
      return;
    }
    --maxd;
    float pivot = median3(v, n);
    int64_t i = 0, l = 0, r = n;
    while (i < r) {
      if (v[i] < pivot) {
        swap2(v, idx, i, l);
        ++i;
        ++l;
      } else if (v[i] > pivot) {
        --r;
        swap2(v, idx, i, r);
      } else {
        ++i;
      }
    }
    introsort_3way(v, idx, l, maxd);
    v += r;
    idx += r;
    n -= r;
  }
  insertion_sort(v, idx, n);
}

void simultaneous_sort(float* v, int64_t* idx, int64_t n) {
  if (n == 0) return;
  introsort_3way(v, idx, n,
                 2 * static_cast<int64_t>(std::log2(static_cast<double>(n))));
}

struct Builder {
  const float* X;
  int64_t n_features;
  const double* w;   // per row, or nullptr for 1.0
  const int32_t* yc;  // class ids (gini), or nullptr
  const double* yr;   // targets (squared error), or nullptr
  int n_classes;      // 0: regression
  int64_t max_depth, min_samples_leaf, max_features;
  uint32_t rand_state;

  // sklearn's splitter state: the rows of the nodes (each node a slice,
  // reordered in place by every sort and partition), one feature's
  // values beside them, the features' permutation and known constants
  std::vector<int64_t> samples;
  std::vector<float> fv;
  std::vector<int64_t> features, constant_features;
  double weighted_n_samples = 0.0;
  // sklearn's criterion state over samples[start:end]: the node's weight
  // and sums, and the left part's up to pos
  int64_t start = 0, end = 0, pos = 0;
  double wn = 0.0, wl = 0.0, sq_total = 0.0;
  std::vector<double> total, sum_left;

  double weight(int64_t i) const { return w ? w[i] : 1.0; }
  float x(int64_t i, int64_t f) const { return X[i * n_features + f]; }

  void add_left(int64_t i) {
    double wi = weight(i);
    if (n_classes)
      sum_left[yc[i]] += wi;
    else
      sum_left[0] += wi * yr[i];
    wl += wi;
  }

  void remove_left(int64_t i) {
    double wi = weight(i);
    if (n_classes)
      sum_left[yc[i]] -= wi;
    else
      sum_left[0] -= wi * yr[i];
    wl -= wi;
  }

  void node_init(int64_t s, int64_t e) {
    start = s;
    end = e;
    std::fill(total.begin(), total.end(), 0.0);
    wn = 0.0;
    sq_total = 0.0;
    for (int64_t p = start; p < end; ++p) {
      int64_t i = samples[p];
      double wi = weight(i);
      if (n_classes) {
        total[yc[i]] += wi;
      } else {
        double wy = wi * yr[i];
        total[0] += wy;
        sq_total += wy * yr[i];
      }
      wn += wi;
    }
    reset();
  }

  void reset() {
    pos = start;
    std::fill(sum_left.begin(), sum_left.end(), 0.0);
    wl = 0.0;
  }

  // sklearn's update: moves samples[pos:new_pos] to the left part, from
  // whichever end needs fewer steps
  void update(int64_t new_pos) {
    if (new_pos - pos <= end - new_pos) {
      for (int64_t p = pos; p < new_pos; ++p) add_left(samples[p]);
    } else {
      std::copy(total.begin(), total.end(), sum_left.begin());
      wl = wn;
      for (int64_t p = end - 1; p >= new_pos; --p) remove_left(samples[p]);
    }
    pos = new_pos;
  }

  double node_impurity() const {
    if (n_classes) {
      double sq = 0.0;
      for (int c = 0; c < n_classes; ++c) sq += total[c] * total[c];
      return 1.0 - sq / (wn * wn);
    }
    double mean = total[0] / wn;
    return sq_total / wn - mean * mean;
  }

  void children_impurity(double* left, double* right) const {
    double wr = wn - wl;
    if (n_classes) {
      double sq_l = 0.0, sq_r = 0.0;
      for (int c = 0; c < n_classes; ++c) {
        double r = total[c] - sum_left[c];
        sq_l += sum_left[c] * sum_left[c];
        sq_r += r * r;
      }
      *left = 1.0 - sq_l / (wl * wl);
      *right = 1.0 - sq_r / (wr * wr);
      return;
    }
    double sq_left = 0.0;
    for (int64_t p = start; p < pos; ++p) {
      int64_t i = samples[p];
      sq_left += weight(i) * yr[i] * yr[i];
    }
    double ml = sum_left[0] / wl, mr = (total[0] - sum_left[0]) / wr;
    *left = sq_left / wl - ml * ml;
    *right = (sq_total - sq_left) / wr - mr * mr;
  }

  double proxy() const {
    double wr = wn - wl;
    if (n_classes) {
      double il, ir;
      children_impurity(&il, &ir);
      return -wr * ir - wl * il;
    }
    double sl = sum_left[0];
    double sr = total[0] - sl;
    return sl * sl / wl + sr * sr / wr;
  }

  struct Split {
    int64_t pos;  // the left child's end
    int64_t feature = 0;
    double threshold = 0.0;
    double impurity_left = 0.0, impurity_right = 0.0, improvement = 0.0;
  };

  // sklearn's node_split_best (no missing values): split.pos == end where
  // no position is valid
  Split node_split(double impurity, int64_t* n_constant) {
    Split best;
    best.pos = end;
    double best_proxy = -std::numeric_limits<double>::infinity();
    int64_t f_i = n_features, n_visited = 0, n_found_constants = 0;
    int64_t n_drawn_constants = 0, n_known_constants = *n_constant;
    int64_t n_total_constants = n_known_constants;

    while (f_i > n_total_constants &&
           (n_visited < max_features ||
            n_visited <= n_found_constants + n_drawn_constants)) {
      ++n_visited;
      int64_t f_j = rand_int(n_drawn_constants, f_i - n_found_constants,
                             &rand_state);
      if (f_j < n_known_constants) {
        std::swap(features[n_drawn_constants], features[f_j]);
        ++n_drawn_constants;
        continue;
      }
      f_j += n_found_constants;
      const int64_t f = features[f_j];
      for (int64_t p = start; p < end; ++p) fv[p] = x(samples[p], f);
      simultaneous_sort(&fv[start], &samples[start], end - start);
      if (fv[end - 1] <= fv[start] + kFeatureThreshold) {
        std::swap(features[f_j], features[n_total_constants]);
        ++n_found_constants;
        ++n_total_constants;
        continue;
      }
      --f_i;
      std::swap(features[f_i], features[f_j]);

      reset();
      int64_t p = start;
      while (p < end) {
        ++p;
        while (p < end && fv[p] <= fv[p - 1] + kFeatureThreshold) ++p;
        if (p == end) continue;
        if (p - start < min_samples_leaf || end - p < min_samples_leaf)
          continue;
        update(p);
        double current = proxy();
        if (current > best_proxy) {
          best_proxy = current;
          best.pos = p;
          best.feature = f;
          best.threshold = static_cast<double>(fv[p - 1]) / 2.0 +
                           static_cast<double>(fv[p]) / 2.0;
        }
      }
    }

    if (best.pos < end) {
      // sklearn's partition_samples_final: swaps from both ends
      int64_t ps = start, pe = end;
      while (ps < pe) {
        if (static_cast<double>(x(samples[ps], best.feature)) <=
            best.threshold) {
          ++ps;
        } else {
          --pe;
          std::swap(samples[ps], samples[pe]);
        }
      }
      reset();
      update(best.pos);
      children_impurity(&best.impurity_left, &best.impurity_right);
      double wr = wn - wl;
      best.improvement =
          (wn / weighted_n_samples) *
          (impurity - wr / wn * best.impurity_right -
           wl / wn * best.impurity_left);
    }
    // sklearn's invariant: known constants first, in their former order,
    // for the siblings and children; the newly found ones after them
    std::copy(constant_features.begin(),
              constant_features.begin() + n_known_constants,
              features.begin());
    std::copy(features.begin() + n_known_constants,
              features.begin() + n_known_constants + n_found_constants,
              constant_features.begin() + n_known_constants);
    *n_constant = n_total_constants;
    return best;
  }

  Tree* build(int64_t n_rows) {
    auto tree = new Tree();
    tree->n_values = n_classes ? n_classes : 1;
    total.assign(tree->n_values, 0.0);
    sum_left.assign(tree->n_values, 0.0);
    for (int64_t i = 0; i < n_rows; ++i) {
      if (!w || w[i] != 0.0) samples.push_back(i);
      weighted_n_samples += weight(i);
    }
    fv.assign(samples.size(), 0.0f);
    features.resize(n_features);
    std::iota(features.begin(), features.end(), 0);
    constant_features.assign(n_features, 0);

    std::vector<Record> stack;
    stack.push_back({0, static_cast<int64_t>(samples.size()), 0, -1, false,
                     std::numeric_limits<double>::infinity(), 0});
    bool first = true;
    while (!stack.empty()) {
      Record rec = stack.back();
      stack.pop_back();
      const int64_t m = rec.end - rec.start;
      node_init(rec.start, rec.end);
      const double node_wn = wn;
      std::vector<double> value(total);
      bool is_leaf = rec.depth >= max_depth || m < 2 ||
                     m < 2 * min_samples_leaf;
      if (first) {
        rec.impurity = node_impurity();
        first = false;
      }
      is_leaf = is_leaf || rec.impurity <= kEpsilon;
      Split split;
      split.pos = rec.end;
      int64_t n_constant = rec.n_constant_features;
      if (!is_leaf) {
        split = node_split(rec.impurity, &n_constant);
        is_leaf = split.pos >= rec.end || split.improvement + kEpsilon < 0.0;
      }
      const int64_t id = static_cast<int64_t>(tree->feature.size());
      if (rec.parent >= 0) {
        if (rec.is_left)
          tree->left[rec.parent] = id;
        else
          tree->right[rec.parent] = id;
      }
      tree->feature.push_back(is_leaf ? kUndefined
                                      : static_cast<int32_t>(split.feature));
      tree->threshold.push_back(is_leaf ? static_cast<double>(kUndefined)
                                        : split.threshold);
      tree->left.push_back(kLeaf);
      tree->right.push_back(kLeaf);
      if (n_classes) {
        tree->value.insert(tree->value.end(), value.begin(), value.end());
      } else {
        tree->value.push_back(value[0] / node_wn);
      }
      if (!is_leaf) {
        stack.push_back({split.pos, rec.end, rec.depth + 1, id, false,
                         split.impurity_right, n_constant});
        stack.push_back({rec.start, split.pos, rec.depth + 1, id, true,
                         split.impurity_left, n_constant});
      }
    }
    return tree;
  }
};

double half_binomial_gradient(double y, double raw) {
  if (raw > -37.0) {
    double e = std::exp(-raw);
    return ((1.0 - y) - y * e) / (1.0 + e);
  }
  return std::exp(raw) - y;
}

}  // namespace

extern "C" {

int32_t lo_tree_abi_version() { return 1; }

// One tree over rows X (n_rows x n_features, float32, row-major). w: the
// rows' weights (nullptr: 1.0 each). Exactly one of y_class (class ids in
// [0, n_classes), gini) and y_reg (squared error, n_classes 0) is given.
// max_depth < 0: no limit. Returns nullptr where memory runs out.
void* lo_tree_fit(const float* X, int64_t n_rows, int64_t n_features,
                  const double* w, const int32_t* y_class,
                  const double* y_reg, int32_t n_classes, int64_t max_depth,
                  int64_t min_samples_leaf, int64_t max_features,
                  uint32_t seed) {
  try {
    Builder b{X,
              n_features,
              w,
              y_class,
              y_reg,
              n_classes,
              max_depth < 0 ? std::numeric_limits<int64_t>::max() : max_depth,
              min_samples_leaf,
              max_features,
              seed};
    return b.build(n_rows);
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

int64_t lo_tree_node_count(const void* handle) {
  const Tree* t = static_cast<const Tree*>(handle);
  return static_cast<int64_t>(t->feature.size());
}

// Copies the nodes out: value is node_count x (n_classes or 1): a node's
// weighted class counts, or its weighted mean target.
void lo_tree_export(const void* handle, int32_t* feature, double* threshold,
                    int64_t* left, int64_t* right, double* value) {
  const Tree* t = static_cast<const Tree*>(handle);
  std::copy(t->feature.begin(), t->feature.end(), feature);
  std::copy(t->threshold.begin(), t->threshold.end(), threshold);
  std::copy(t->left.begin(), t->left.end(), left);
  std::copy(t->right.begin(), t->right.end(), right);
  std::copy(t->value.begin(), t->value.end(), value);
}

void lo_tree_free(void* handle) { delete static_cast<Tree*>(handle); }

// Gradient boosting's residuals y - p, sklearn's gradients negated, with
// libm's exp as sklearn's loss module takes it: raw is n_rows x n_raw
// (one column: the half binomial loss, y in {0, 1}; more: the softmax,
// y the class id), out the same shape.
void lo_gb_residuals(const double* raw, int64_t n_rows, int64_t n_raw,
                     const int32_t* y, double* out) {
  if (n_raw == 1) {
    for (int64_t i = 0; i < n_rows; ++i)
      out[i] = -half_binomial_gradient(static_cast<double>(y[i]), raw[i]);
    return;
  }
  for (int64_t i = 0; i < n_rows; ++i) {
    const double* r = raw + i * n_raw;
    double* o = out + i * n_raw;
    double top = r[0], sum = 0.0;
    for (int64_t k = 1; k < n_raw; ++k)
      if (top < r[k]) top = r[k];
    for (int64_t k = 0; k < n_raw; ++k) {
      o[k] = std::exp(r[k] - top);
      sum += o[k];
    }
    for (int64_t k = 0; k < n_raw; ++k)
      o[k] = -(o[k] / sum - (y[i] == k ? 1.0 : 0.0));
  }
}

// The leaf of each row of X (float32, row-major) in the exported nodes: a
// row goes left where its value, as float64, is at most the threshold.
void lo_tree_predict(const int32_t* feature, const double* threshold,
                     const int64_t* left, const int64_t* right,
                     const float* X, int64_t n_rows, int64_t n_features,
                     int64_t* leaf) {
  for (int64_t i = 0; i < n_rows; ++i) {
    const float* row = X + i * n_features;
    int64_t node = 0;
    while (left[node] != kLeaf) {
      node = static_cast<double>(row[feature[node]]) <= threshold[node]
                 ? left[node]
                 : right[node];
    }
    leaf[i] = node;
  }
}

}  // extern "C"
