// hgb_core — the PyTorch package's copy of the histogram gradient
// boosting core (the HgbModel / lo_hgb_* section of the JAX package's
// csrc/locore.cpp, unchanged), built on its own.
//
// The Builder's streaming GB (BASELINE config 4: a GBT classifier on 10M
// rows) trains on every row: features are binned to uint8 codes, and
// this core grows depth-wise trees in an implicit heap layout with a
// logistic (binary) or softmax (multiclass) objective. Host code: the
// card has no part in it.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC
// (learningorchestra_tpu_torch/native builds it at first use into
// build/native/; every caller keeps the numpy fallback of native/hgb.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Histogram gradient boosting over pre-binned uint8 feature codes — the
// full-data replacement for the reference's Spark GBTClassifier path
// (builder_image/builder.py:118): every row contributes gradients on every
// iteration (no reservoir), memory stays rows x nfeats bytes + one raw
// score per row/class. Depth-wise growth in an implicit heap layout; one
// pass over the data builds the histograms of every node of a level
// (hist indexed by the row''s current node), logistic / softmax objective.
// ---------------------------------------------------------------------------

struct HgbModel {
  int nfeats = 0;
  int nclass = 0;        // 2 => single sigmoid tree per iter
  int max_depth = 0;
  double base = 0.0;     // binary: log-odds; multiclass: per-class in bases
  std::vector<double> bases;
  // trees laid out iteration-major; each tree is a full implicit heap of
  // (2^(max_depth+1) - 1) slots: feat[i] >= 0 -> internal (go left if
  // code <= bin[i]); feat[i] == -1 -> leaf with value val[i];
  // feat[i] == -2 -> dead slot (under a leaf ancestor)
  std::vector<int> feat;
  std::vector<uint8_t> bin;
  std::vector<double> val;
  int slots_per_tree = 0;
  int n_trees = 0;
};

static inline double hgb_leaf(double g, double h, double l2, double lr) {
  return -lr * g / (h + l2 + 1e-12);
}

// one histogram cell, array-of-structs so a row's (g, h, count)
// update touches one cache line instead of three far-apart arrays
struct HistCell {
  double g, h;
  int64_t c;
};

// shared by the binary and multiclass gradient passes: one row's
// (g, h) lands in the tree's root histogram as the gradients are
// computed, so no separate root-accumulation scan exists
static inline void hgb_root_add(HistCell* root, const uint8_t* row,
                                int nfeats, int max_bins, double gi,
                                double hi) {
  for (int f = 0; f < nfeats; ++f) {
    HistCell& cell = root[f * max_bins + row[f]];
    cell.g += gi;
    cell.h += hi;
    cell.c += 1;
  }
}

// builds ONE regression tree on (g, h); updates scores in place.
// Histograms use the LightGBM sibling-subtraction trick: after level
// 0, only the SMALLER child of each split is accumulated from rows;
// the larger child is parent - sibling (counts exact; g/h differ from
// direct accumulation only by float summation order). This roughly
// halves the dominant per-level accumulate work.
static void hgb_build_tree(const uint8_t* codes, int64_t nrows, int nfeats,
                           const double* g, const double* h,
                           double* scores, int64_t score_stride,
                           int max_depth, int max_bins, double lr,
                           double l2, int64_t min_leaf,
                           std::vector<int>& feat_out,
                           std::vector<uint8_t>& bin_out,
                           std::vector<double>& val_out,
                           std::vector<int32_t>& assign,
                           std::vector<HistCell>& root_hist) {
  const int slots = (1 << (max_depth + 1)) - 1;
  const int base_slot = (int)feat_out.size();
  feat_out.insert(feat_out.end(), slots, -2);
  bin_out.insert(bin_out.end(), slots, 0);
  val_out.insert(val_out.end(), slots, 0.0);
  int* tfeat = feat_out.data() + base_slot;
  uint8_t* tbin = bin_out.data() + base_slot;
  double* tval = val_out.data() + base_slot;

  std::fill(assign.begin(), assign.end(), 0);
  tfeat[0] = -1;  // provisional leaf (filled from level-0 totals below)

  const size_t fb = (size_t)nfeats * max_bins;  // cells per node hist

  // Pass structure (single-core: passes over rows dominate, so each
  // level costs ONE fused pass): level 0's root histogram is built by
  // a plain scan; every later level's build-marked histograms are
  // accumulated DURING the routing pass that moves rows down through
  // the parents' splits. The smaller child of each split is known at
  // split time (CL vs C-CL), so the build marks exist before routing;
  // larger siblings are derived parent - sibling before selection.
  std::vector<int> active(1, 0);        // nodes of the current level
  std::vector<int> id_in_level(1, 0);   // in-level -> hist idx (-1 none)
  std::vector<char> build_flag(1, 1);   // accumulated from rows?
  // the root histogram arrives pre-filled: the caller accumulates it
  // during its gradient pass, saving one full scan of the rows
  std::vector<HistCell> hist = std::move(root_hist);
  std::vector<HistCell> parent_hist;
  std::vector<int> parent_id;
  std::vector<double> leaf_g, leaf_h;   // deepest-level totals

  for (int depth = 0; depth < max_depth; ++depth) {
    const int first = (1 << depth) - 1;
    if (active.empty()) break;

    // complete the level: derive non-built siblings from parents
    if (depth > 0) {
      const int pfirst = (1 << (depth - 1)) - 1;
      for (size_t a = 0; a < active.size(); ++a) {
        const int node = active[a];
        const int in_level = node - first;
        if (build_flag[in_level]) continue;
        const int parent = (node - 1) / 2;
        // left children sit at EVEN in-level offsets (left = 2p+1 =
        // first + 2j)
        const int sib = (in_level % 2 == 0) ? in_level + 1
                                            : in_level - 1;
        const HistCell* pp = parent_hist.data() +
            (size_t)parent_id[parent - pfirst] * fb;
        const HistCell* sp = hist.data() +
            (size_t)id_in_level[sib] * fb;
        HistCell* dp = hist.data() +
            (size_t)id_in_level[in_level] * fb;
        for (size_t cix = 0; cix < fb; ++cix) {
          dp[cix].g = pp[cix].g - sp[cix].g;
          dp[cix].h = pp[cix].h - sp[cix].h;
          dp[cix].c = pp[cix].c - sp[cix].c;
        }
      }
    }

    // split selection; build marks for the next level come straight
    // from each winning split's left/right row counts
    const int next_first = (1 << (depth + 1)) - 1;
    const int next_count = 1 << (depth + 1);
    std::vector<char> next_build(next_count, 0);
    std::vector<int> next_active;
    bool any_split = false;
    for (size_t a = 0; a < active.size(); ++a) {
      const int node = active[a];
      const HistCell* hp = hist.data() +
          (size_t)id_in_level[node - first] * fb;
      double G = 0.0, H = 0.0;
      int64_t C = 0;
      for (int b = 0; b < max_bins; ++b) {
        G += hp[b].g; H += hp[b].h; C += hp[b].c;
      }
      // (feature 0 totals == node totals; every feature sums the same rows)
      const double parent_obj = G * G / (H + l2 + 1e-12);
      double best_gain = 1e-7;
      int best_f = -1, best_b = -1;
      int64_t best_cl = 0;
      for (int f = 0; f < nfeats; ++f) {
        double GL = 0.0, HL = 0.0;
        int64_t CL = 0;
        const HistCell* fp = hp + (size_t)f * max_bins;
        for (int b = 0; b < max_bins - 1; ++b) {
          GL += fp[b].g; HL += fp[b].h; CL += fp[b].c;
          const int64_t CR = C - CL;
          if (CL < min_leaf || CR < min_leaf) continue;
          const double HR = H - HL, GR = G - GL;
          const double gain = GL * GL / (HL + l2 + 1e-12) +
                              GR * GR / (HR + l2 + 1e-12) - parent_obj;
          if (gain > best_gain) {
            best_gain = gain; best_f = f; best_b = b; best_cl = CL;
          }
        }
      }
      if (best_f < 0 || depth + 1 >= max_depth + 1) {
        tval[node] = hgb_leaf(G, H, l2, lr);  // stays a leaf
        continue;
      }
      tfeat[node] = best_f;
      tbin[node] = (uint8_t)best_b;
      const int left = 2 * node + 1, right = 2 * node + 2;
      if (left < slots) {
        tfeat[left] = -1;
        tfeat[right] = -1;
        next_active.push_back(left);
        next_active.push_back(right);
        // accumulate only the smaller child; the other subtracts
        const int small = (best_cl <= C - best_cl) ? left : right;
        next_build[small - next_first] = 1;
      }
      any_split = true;
    }
    if (!any_split) break;

    // prepare next-level storage
    std::vector<int> next_id(next_count, -1);
    for (size_t a = 0; a < next_active.size(); ++a)
      next_id[next_active[a] - next_first] = (int)a;
    std::vector<HistCell> next_hist;
    const bool last_level = (depth + 1 == max_depth);
    if (!last_level) {
      next_hist.assign(next_active.size() * fb, HistCell{0.0, 0.0, 0});
    } else {
      leaf_g.assign(next_count, 0.0);
      leaf_h.assign(next_count, 0.0);
    }

    // ONE fused pass: route each row through its node's new split and
    // accumulate it into its child's histogram (or, at the deepest
    // level, into the child leaf's g/h totals)
    const int count = 1 << depth;
    for (int64_t i = 0; i < nrows; ++i) {
      const int32_t node = assign[i];
      if (node < first || node >= first + count) continue;
      if (tfeat[node] < 0) continue;
      const uint8_t* row = codes + i * nfeats;
      const uint8_t c = row[tfeat[node]];
      const int child = (c <= tbin[node]) ? 2 * node + 1 : 2 * node + 2;
      assign[i] = child;
      const int child_in = child - next_first;
      if (last_level) {
        leaf_g[child_in] += g[i];
        leaf_h[child_in] += h[i];
      } else if (next_build[child_in]) {
        hgb_root_add(next_hist.data() + (size_t)next_id[child_in] * fb,
                     row, nfeats, max_bins, g[i], h[i]);
      }
    }

    if (last_level) {
      // next_first + next_count - 1 == slots - 1 at the last level,
      // so every slot index here is in bounds by construction
      for (int n = 0; n < next_count; ++n)
        if (tfeat[next_first + n] == -1)
          tval[next_first + n] = hgb_leaf(leaf_g[n], leaf_h[n], l2, lr);
      break;
    }
    parent_hist = std::move(hist);
    parent_id = std::move(id_in_level);
    hist = std::move(next_hist);
    id_in_level = std::move(next_id);
    build_flag = std::move(next_build);
    active = std::move(next_active);
  }

  // update scores: every row adds its leaf''s value
  for (int64_t i = 0; i < nrows; ++i) {
    int node = assign[i];
    // walk down if the row stopped on an internal node (can''t happen in
    // this layout, but cheap to guard), walk up never needed
    while (tfeat[node] >= 0) {
      const uint8_t c = codes[i * nfeats + tfeat[node]];
      node = (c <= tbin[node]) ? 2 * node + 1 : 2 * node + 2;
    }
    scores[i * score_stride] += tval[node];
  }
}

void* lo_hgb_train(const uint8_t* codes, int64_t nrows, int nfeats,
                   const int32_t* y, int nclass, int n_iter, int max_depth,
                   int max_bins, double lr, double l2,
                   int64_t min_samples_leaf) {
  if (nrows <= 0 || nfeats <= 0 || nclass < 2 || max_bins > 256)
    return nullptr;
  HgbModel* m = new HgbModel();
  m->nfeats = nfeats;
  m->nclass = nclass;
  m->max_depth = max_depth;
  m->slots_per_tree = (1 << (max_depth + 1)) - 1;

  const int K = (nclass == 2) ? 1 : nclass;
  std::vector<double> scores((size_t)nrows * K, 0.0);
  std::vector<int64_t> class_count(nclass, 0);
  for (int64_t i = 0; i < nrows; ++i) ++class_count[y[i]];
  m->bases.assign(K, 0.0);
  if (nclass == 2) {
    const double p = std::max(
        1e-9, std::min(1.0 - 1e-9,
                       (double)class_count[1] / (double)nrows));
    m->bases[0] = std::log(p / (1.0 - p));
  } else {
    for (int k = 0; k < K; ++k)
      m->bases[k] = std::log(std::max(
          1e-9, (double)class_count[k] / (double)nrows));
  }
  for (int64_t i = 0; i < nrows; ++i)
    for (int k = 0; k < K; ++k) scores[i * K + k] = m->bases[k];

  std::vector<double> g(nrows), h(nrows);
  std::vector<int32_t> assign(nrows);
  std::vector<double> probs;  // multiclass: nrows x K, one softmax/iter
  if (nclass > 2) probs.resize((size_t)nrows * K);
  const size_t fb = (size_t)nfeats * max_bins;
  std::vector<HistCell> root_hist;

  for (int it = 0; it < n_iter; ++it) {
    if (nclass == 2) {
      root_hist.assign(fb, HistCell{0.0, 0.0, 0});
      for (int64_t i = 0; i < nrows; ++i) {
        const double p = 1.0 / (1.0 + std::exp(-scores[i]));
        const double gi = p - (double)y[i];
        const double hi = std::max(p * (1.0 - p), 1e-12);
        g[i] = gi;
        h[i] = hi;
        hgb_root_add(root_hist.data(), codes + i * nfeats, nfeats,
                     max_bins, gi, hi);
      }
      hgb_build_tree(codes, nrows, nfeats, g.data(), h.data(),
                     scores.data(), 1, max_depth, max_bins, lr, l2,
                     min_samples_leaf, m->feat, m->bin, m->val, assign,
                     root_hist);
      ++m->n_trees;
    } else {
      // standard softmax boosting: ONE softmax per iteration drives
      // all K trees (matching the numpy fallback — per-class
      // recomputation would make the two paths diverge)
      for (int64_t i = 0; i < nrows; ++i) {
        const double* s = scores.data() + i * K;
        double mx = s[0];
        for (int j = 1; j < K; ++j) mx = std::max(mx, s[j]);
        double denom = 0.0;
        double* p = probs.data() + i * K;
        for (int j = 0; j < K; ++j) {
          p[j] = std::exp(s[j] - mx);
          denom += p[j];
        }
        for (int j = 0; j < K; ++j) p[j] /= denom;
      }
      for (int k = 0; k < K; ++k) {
        root_hist.assign(fb, HistCell{0.0, 0.0, 0});
        for (int64_t i = 0; i < nrows; ++i) {
          const double pk = probs[i * K + k];
          const double gi = pk - (y[i] == k ? 1.0 : 0.0);
          const double hi = std::max(pk * (1.0 - pk), 1e-12);
          g[i] = gi;
          h[i] = hi;
          hgb_root_add(root_hist.data(), codes + i * nfeats, nfeats,
                       max_bins, gi, hi);
        }
        hgb_build_tree(codes, nrows, nfeats, g.data(), h.data(),
                       scores.data() + k, K, max_depth, max_bins, lr, l2,
                       min_samples_leaf, m->feat, m->bin, m->val, assign,
                       root_hist);
        ++m->n_trees;
      }
    }
  }
  return m;
}

// raw scores: out has nrows x K (K = 1 for binary)
void lo_hgb_predict(void* model, const uint8_t* codes, int64_t nrows,
                    double* out) {
  HgbModel* m = (HgbModel*)model;
  const int K = (m->nclass == 2) ? 1 : m->nclass;
  const int slots = m->slots_per_tree;
  // tree-outer on purpose: the serially-dependent node walk dominates
  // (codes re-streaming is ~30 ms for 2M x 5 rows), and per-tree
  // branch patterns predict far better when one tree processes all
  // rows before the next (row-outer measured 40% SLOWER here)
  for (int64_t i = 0; i < nrows; ++i)
    for (int k = 0; k < K; ++k) out[i * K + k] = m->bases[k];
  for (int t = 0; t < m->n_trees; ++t) {
    const int* tfeat = m->feat.data() + (size_t)t * slots;
    const uint8_t* tbin = m->bin.data() + (size_t)t * slots;
    const double* tval = m->val.data() + (size_t)t * slots;
    const int k = t % K;
    for (int64_t i = 0; i < nrows; ++i) {
      const uint8_t* row = codes + i * m->nfeats;
      int node = 0;
      while (tfeat[node] >= 0)
        node = (row[tfeat[node]] <= tbin[node]) ? 2 * node + 1
                                                : 2 * node + 2;
      out[i * K + k] += tval[node];
    }
  }
}

int32_t lo_hgb_nclass(void* model) { return ((HgbModel*)model)->nclass; }
void lo_hgb_free(void* model) { delete (HgbModel*)model; }

int32_t lo_hgb_abi_version() { return 1; }

}  // extern "C"
