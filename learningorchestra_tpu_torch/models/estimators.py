"""The Builder's linear-algebra families on the card: the port's
``LogisticRegressionJAX`` and ``GaussianNBJAX`` (the JAX package's class
names, which users pass as ``class``).

- Logistic regression is a softmax regression trained by the port's
  :class:`~learningorchestra_tpu_torch.runtime.engine.Engine`: minibatch
  softmax cross-entropy computed in bfloat16 over float32 master params
  (the engine's default, which the JAX class keeps whatever
  ``LO_COMPUTE_DTYPE`` says), optax's ``adam`` through
  :func:`~learningorchestra_tpu_torch.models.neural.build_optimizer`,
  and batches drawn by ``ArrayBatcher(shuffle=True, seed)``, whose order
  is the JAX per-step feed's (``default_rng(seed + epoch)``).
- Gaussian naive Bayes takes the three one-hot sums (counts, sums and
  squared sums per class) on the device over float32 data centred on the
  host (a raw ``E[x^2] - mean^2`` cancels where ``|mean| >> std``), in
  float32 blocks of 8192 rows, and finishes the statistics in float64 on
  the host.

Both predict on the host with the JAX package's numpy formulas, and both
speak the sklearn surface the Builder consumes (``fit``, ``predict``,
``predict_proba``, ``score``). ``set_device`` places the next fit, as
``set_mesh`` does in the JAX package. A fitted JAX estimator carries
across with :func:`~learningorchestra_tpu_torch.models.weights.
estimator_from_jax`; a pickle of one (the JAX package stores them with
``dill``) loads as the port's class, placed by the artifact store.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from learningorchestra_tpu_torch.config import resolve_device


# rows of one float32 partial sum of the naive Bayes statistics
_BLOCK = 8192


def _resolve(device):
    # None: not placed yet (a JAX estimator read from its pickle); the
    # artifact store or set_device places it, and a fit takes the card
    return None if device is None else resolve_device(device)


class LogisticRegressionJAX:
    """Multinomial logistic regression trained by the port's engine on
    ``device`` (the card unless ``"cpu"`` is asked for)."""

    def __init__(self, epochs: int = 12, batch_size: int = 4096,
                 learning_rate: float = 0.05, seed: int = 0,
                 device="cuda"):
        self.epochs = int(epochs)
        self.batch_size = int(batch_size)
        self.learning_rate = float(learning_rate)
        self.seed = int(seed)
        self.classes_: Optional[np.ndarray] = None
        self.params: Optional[Dict[str, np.ndarray]] = None
        self.history: list = []
        self.device = _resolve(device)
        # the content identity of the (x, y) the next fit gets (the
        # Builder's token: dataset versions and the modeling code) and
        # its collections: with it the staged fit keeps its tensors in
        # the device arena between jobs
        self.feature_token = None
        self.feature_tags: tuple = ()

    def set_device(self, device) -> None:
        self.device = resolve_device(device)

    def __setstate__(self, state: Dict[str, Any]) -> None:
        if "device" not in state:  # a JAX estimator's pickled attributes
            from learningorchestra_tpu_torch.models import weights

            state = weights.estimator_from_jax(state, device=None).__dict__
        self.__dict__.update(state)

    @staticmethod
    def _apply(params, batch, train, rng):
        w = params["w"]
        return batch["x"].to(w.dtype) @ w + params["b"]

    def fit(self, x, y) -> "LogisticRegressionJAX":
        import torch

        from learningorchestra_tpu_torch.models.neural import \
            build_optimizer
        from learningorchestra_tpu_torch.runtime import data as data_lib
        from learningorchestra_tpu_torch.runtime import engine as engine_lib

        x = np.asarray(x, np.float32)
        y = np.asarray(y)
        self.classes_, y_idx = np.unique(y, return_inverse=True)
        device = self.device or resolve_device("cuda")
        # the engine's default bfloat16 compute, whatever
        # LO_COMPUTE_DTYPE says, as the JAX class builds its engine
        eng = engine_lib.Engine(
            apply_fn=self._apply, loss_fn=engine_lib.sparse_softmax_loss,
            optimizer=build_optimizer({"kind": "adam",
                                       "learning_rate": self.learning_rate}),
            metrics={"accuracy": engine_lib.accuracy_metric})
        shape = {"w": (x.shape[1], len(self.classes_)),
                 "b": (len(self.classes_),)}
        params = {k: torch.zeros(s, dtype=torch.float32, device=device,
                                 requires_grad=True)
                  for k, s in shape.items()}
        batcher = data_lib.ArrayBatcher(
            {"x": x, "y": y_idx.astype(np.int32)},
            min(self.batch_size, len(x)), shuffle=True, seed=self.seed,
            # getattr: an estimator pickled before the token existed
            cache_token=getattr(self, "feature_token", None),
            cache_tags=getattr(self, "feature_tags", ()))
        state, history = eng.fit(eng.init_state(params), batcher,
                                 epochs=self.epochs, seed=self.seed)
        self.params = {k: engine_lib.to_host(v)
                       for k, v in state.params.items()}
        self.history = history
        return self

    def _check_fitted(self) -> None:
        if self.params is None:
            raise RuntimeError("not fitted — call fit(X, y) first")

    def decision_function(self, x) -> np.ndarray:
        self._check_fitted()
        x = np.asarray(x, np.float32)
        return x @ self.params["w"] + self.params["b"]

    def predict_proba(self, x) -> np.ndarray:
        z = self.decision_function(x)
        z = z - z.max(axis=1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=1, keepdims=True)

    def predict(self, x) -> np.ndarray:
        return self.classes_[np.argmax(self.decision_function(x), axis=1)]

    def score(self, x, y) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))


class GaussianNBJAX:
    """Gaussian naive Bayes from three one-hot sums on ``device``:
    ``onehot.T @ [1, x, x^2]`` in one pass over the data, no per-class
    loop."""

    def __init__(self, var_smoothing: float = 1e-9, device="cuda"):
        self.var_smoothing = float(var_smoothing)
        self.classes_: Optional[np.ndarray] = None
        self.theta_: Optional[np.ndarray] = None  # (C, d) means
        self.var_: Optional[np.ndarray] = None    # (C, d) variances
        self.class_prior_: Optional[np.ndarray] = None
        self.device = _resolve(device)
        # as LogisticRegressionJAX.feature_token: the centred x and the
        # one-hot labels stay in the device arena between jobs
        self.feature_token = None
        self.feature_tags: tuple = ()

    def set_device(self, device) -> None:
        self.device = resolve_device(device)

    def __setstate__(self, state: Dict[str, Any]) -> None:
        if "device" not in state:  # a JAX estimator's pickled attributes
            from learningorchestra_tpu_torch.models import weights

            state = weights.estimator_from_jax(state, device=None).__dict__
        self.__dict__.update(state)

    @staticmethod
    def _sufficient_stats(x, onehot):
        """Per-block counts, sums and squared sums, ``(blocks, C)`` and
        ``(blocks, C, d)``: each float32 sum runs over ``_BLOCK`` rows,
        and the host adds the blocks in float64. Summed whole, a float32
        sum over a million rows carries a relative error of ~1e-7 that
        depends on the order the library adds in, and the card's and the
        CPU's fits would differ by that much."""
        import torch

        pad = (-x.shape[0]) % _BLOCK
        xb = torch.nn.functional.pad(x, (0, 0, 0, pad)).view(
            -1, _BLOCK, x.shape[1])
        # zero-padded rows have an all-zero one-hot: they add nothing
        hb = torch.nn.functional.pad(onehot, (0, 0, 0, pad)).view(
            -1, _BLOCK, onehot.shape[1])
        ht = hb.transpose(1, 2)
        return hb.sum(dim=1), ht @ xb, ht @ (xb * xb)

    def fit(self, x, y) -> "GaussianNBJAX":
        import torch

        x = np.asarray(x, np.float32)
        y = np.asarray(y)
        self.classes_, y_idx = np.unique(y, return_inverse=True)
        # centre on the global per-feature mean (float64, host) before
        # the float32 device sums: on centred data E[x^2] and mean^2 are
        # both of the order of the variance
        shift = np.mean(x, axis=0, dtype=np.float64).astype(np.float32)
        device = self.device or resolve_device("cuda")

        def stage():
            return {"x": torch.from_numpy(x - shift[None, :]).to(device),
                    "onehot": torch.nn.functional.one_hot(
                        torch.from_numpy(y_idx.astype(np.int64)).to(device),
                        len(self.classes_)).to(torch.float32)}

        token = getattr(self, "feature_token", None)
        entry = None
        if token is not None:
            # the centred x and the one-hot are functions of the (x, y)
            # the token identifies: a repeat fit reuses the resident ones
            from learningorchestra_tpu_torch.runtime import arena

            entry = arena.get_default_arena().get_or_put(
                ("nb_stats", token, str(device)), stage,
                tags=getattr(self, "feature_tags", ()))
            staged = entry.arrays
        else:
            staged = stage()
        try:
            with torch.no_grad():
                counts, sums, sq_sums = (
                    t.cpu().numpy().astype(np.float64).sum(axis=0)
                    for t in self._sufficient_stats(staged["x"],
                                                    staged["onehot"]))
        finally:
            if entry is not None:
                entry.release()
        del staged
        n = np.maximum(counts, 1.0)[:, None]
        theta_c = sums / n          # class means of the centred data
        self.theta_ = theta_c + shift[None, :].astype(np.float64)
        var = sq_sums / n - theta_c ** 2
        eps = self.var_smoothing * float(np.var(x, axis=0).max())
        self.var_ = np.maximum(var, 0.0) + max(eps, 1e-12)
        self.class_prior_ = counts / counts.sum()
        return self

    def _joint_log_likelihood(self, x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        # (n, C): sum_d log N(x_d | theta_cd, var_cd) + log prior_c
        ll = -0.5 * (np.log(2.0 * np.pi * self.var_)[None, :, :]
                     + (x[:, None, :] - self.theta_[None, :, :]) ** 2
                     / self.var_[None, :, :]).sum(axis=2)
        return ll + np.log(self.class_prior_)[None, :]

    def predict(self, x) -> np.ndarray:
        if self.classes_ is None:
            raise RuntimeError("not fitted — call fit(X, y) first")
        return self.classes_[
            np.argmax(self._joint_log_likelihood(x), axis=1)]

    def predict_proba(self, x) -> np.ndarray:
        ll = self._joint_log_likelihood(x)
        ll = ll - ll.max(axis=1, keepdims=True)
        e = np.exp(ll)
        return e / e.sum(axis=1, keepdims=True)

    def score(self, x, y) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))
