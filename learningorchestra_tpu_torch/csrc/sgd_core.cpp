// sgd_core — the per-row loop of stochastic gradient descent on the log
// loss, for the Builder's streaming LR (the port's SGDClassifier). A
// sequential update per row is a host loop by nature; in Python it would
// take minutes over a streamed dataset's rows.
//
// One call is scikit-learn 1.9's _plain_sgd64 for one binary problem and
// one epoch, at the SGDClassifier(loss="log_loss") settings: L2 penalty,
// the "optimal" learning rate, unit sample and class weights, a dense
// intercept (decay 1), no averaging and no early stopping:
//   eta_t = 1 / (alpha * (optimal_init + t - 1)), with
//   optimal_init = 1 / (typw * alpha), typw = sqrt(1 / sqrt(alpha));
//   the weights kept as w * wscale: the penalty scales wscale by
//   max(0, 1 - eta * alpha), reset into w below 1e-9; a row adds
//   x * (update / wscale) with update = -eta * dloss, dloss the half
//   binomial gradient (expit(p) - y, y in {0, 1}) clipped at 1e12.
// Every operation is sklearn's, in its order, so native/sgd.py's Python
// version computes the same weights bit for bit.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (learningorchestra_tpu_torch/native
// builds it at first use into build/native/).

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

double half_binomial_gradient(double y, double raw) {
  if (raw > -37.0) {
    double e = std::exp(-raw);
    return ((1.0 - y) - y * e) / (1.0 + e);
  }
  return std::exp(raw) - y;
}

}  // namespace

extern "C" {

int32_t lo_sgd_abi_version() { return 1; }

// One epoch over the rows of X (n_rows x n_features, float64, row-major) in
// the order `order` (n_rows indices). y: each row's target in {0, 1}.
// w (n_features) and *intercept are updated in place; t is the step count
// the epoch starts at (the estimator's t_). Returns 0, or 1 where a weight
// or the intercept is no longer finite.
int32_t lo_sgd_partial_fit(const double* X, const double* y,
                           const int64_t* order, int64_t n_rows,
                           int64_t n_features, double* w, double* intercept,
                           double alpha, double t) {
  const double max_dloss = 1e12;
  double typw = std::sqrt(1.0 / std::sqrt(alpha));
  double initial_eta0 =
      typw / std::max(1.0, half_binomial_gradient(1.0, -typw));
  double optimal_init = 1.0 / (initial_eta0 * alpha);
  double wscale = 1.0;
  double b = *intercept;
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t i = order[r];
    const double* x = X + i * n_features;
    double inner = 0.0;
    for (int64_t j = 0; j < n_features; ++j) inner += w[j] * x[j];
    inner *= wscale;
    double p = inner + b;
    double eta = 1.0 / (alpha * (optimal_init + t - 1.0));
    double dloss = half_binomial_gradient(y[i], p);
    if (dloss < -max_dloss)
      dloss = -max_dloss;
    else if (dloss > max_dloss)
      dloss = max_dloss;
    double update = -eta * dloss;
    double shrink = 1.0 - eta * alpha;
    wscale *= shrink > 0.0 ? shrink : 0.0;
    if (wscale < 1e-9) {
      for (int64_t j = 0; j < n_features; ++j) w[j] *= wscale;
      wscale = 1.0;
    }
    if (update != 0.0) {
      double step = update / wscale;
      for (int64_t j = 0; j < n_features; ++j) w[j] += x[j] * step;
      b += update;
    }
    t += 1.0;
  }
  for (int64_t j = 0; j < n_features; ++j) w[j] *= wscale;
  *intercept = b;
  if (!std::isfinite(b)) return 1;
  for (int64_t j = 0; j < n_features; ++j)
    if (!std::isfinite(w[j])) return 1;
  return 0;
}

}  // extern "C"
