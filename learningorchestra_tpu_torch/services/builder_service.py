"""Builder service: the whole train-compare-predict pipeline in one
call, as the JAX package's ``services/builder_service.py`` runs it.

``POST /builder/sparkml`` takes ``trainDatasetName``,
``testDatasetName``, ``modelingCode`` and ``classifiersList`` (a subset
of LR, DT, RF, GB and NB). The modeling code runs in the sandbox with
``training_df``/``testing_df`` (pandas DataFrames where the jailed child
can import pandas, else the catalog's ``Table``s) and must define
``features_training``, ``features_testing`` and optionally
``features_evaluation``: ``(X, y)`` tuples, frames with a ``label``
column, or plain arrays (test features need no label). Each classifier
is fitted, scored on the evaluation set (accuracy and weighted F1,
computed here without sklearn), run over the test set, and its per-row
predictions stored as the collection ``{testDatasetName}{classifier}``
with ``classifier`` and ``fitTime`` on its metadata. A classifier that
fails documents its own output and the others still run.

- Without ``meshParallel`` every family is the port's host counterpart
  of the sklearn estimator the JAX package builds, fitted on a host
  thread (``engine: "host"``; the JAX package writes ``"sklearn"``): DT,
  RF and GB over the port's C++ tree core
  (:mod:`~learningorchestra_tpu_torch.models.trees`), LR and NB on numpy
  and scipy (:mod:`~learningorchestra_tpu_torch.models.linear`). Nothing
  imports sklearn.
- ``meshParallel: true``: LR and NB are the port's torch estimators
  (:mod:`~learningorchestra_tpu_torch.models.estimators`) fitted on the
  context's device (the card) one after the other, under the card lease
  (``engine: "torch"``, ``meshDevices: 1``); DT, RF and GB stay the host
  counterparts, on host threads.
- ``streaming: true`` (exclusive with ``meshParallel``; no
  ``modelingCode``): one pass per classifier over the catalog's
  ``iter_batches`` (``labelColumn``, ``featureColumns``, ``batchSize``).
  LR (log-loss SGD in the port's C++ core) and NB take every row through
  ``partial_fit``, DT and RF a bounded reservoir sample; GB is the
  full-data histogram booster
  (:mod:`~learningorchestra_tpu_torch.native.hgb`, the port's C++ core):
  pass 1 samples rows for the bin edges, pass 2 bins every row to uint8
  codes, and every row contributes gradients to every iteration
  (``trainedRows``, ``trainedOnSample: false``). The predictions are
  written batch by batch, through a writer that keeps them in memory
  until it closes.

Both datasets are read through the feature cache (``ctx.features``), so
a repeated job on the same dataset versions reads no table from the
catalog. The job's feature token (both datasets' versions and the sha256
of the modeling code) and tags (both dataset names) go to the card's
families: LR's staged fit and NB's statistics take their tensors from the
device arena on a repeat, and a write to either dataset makes the next
run miss and stage again.
"""

from __future__ import annotations

import hashlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from learningorchestra_tpu_torch import analysis as A
from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.models import linear, trees
from learningorchestra_tpu_torch.services import sandbox
from learningorchestra_tpu_torch.services import validators as V

TRAIN_FIELD = "trainDatasetName"
TEST_FIELD = "testDatasetName"
MODELING_CODE_FIELD = "modelingCode"
CLASSIFIERS_FIELD = "classifiersList"
STREAMING_FIELD = "streaming"
MESH_PARALLEL_FIELD = "meshParallel"
LABEL_FIELD = "labelColumn"
FEATURES_FIELD = "featureColumns"
EVAL_DATASET_FIELD = "evaluationDatasetName"
BATCH_SIZE_FIELD = "batchSize"
LABEL_COLUMN = "label"

CLASSIFIER_NAMES = ("LR", "DT", "RF", "GB", "NB")

# families with a torch estimator on the card under meshParallel=true
# (the linear-algebra ones; the trees stay on the host, as the JAX
# package's do: data-dependent branching has no accelerator mapping worth
# forcing)
_TORCH_FAMILIES = ("LR", "NB")
# streaming families that see every row through partial_fit; the others
# train on the reservoir (GB on its own full-data pass)
_INCREMENTAL = ("LR", "NB")

# the bounded sample of the non-incremental streaming families
_RESERVOIR_CAP = 500_000


def _make_classifier(name: str):
    """The host counterpart of the sklearn estimator the JAX package's
    Builder builds for the family."""
    return {
        "LR": linear.LogisticRegression,  # sklearn's at max_iter=1000
        "DT": trees.DecisionTreeClassifier,
        "RF": trees.RandomForestClassifier,
        "GB": trees.GradientBoostingClassifier,
        "NB": linear.GaussianNB,
    }[name]()


def _make_torch_classifier(name: str, device):
    from learningorchestra_tpu_torch.models import estimators

    return {"LR": estimators.LogisticRegressionJAX,
            "NB": estimators.GaussianNBJAX}[name](device=device)


def _make_streaming_classifier(name: str):
    """The streaming estimator of a family other than GB (the full-data
    booster): incremental twins for ``_INCREMENTAL``, the tree families
    for the bounded reservoir."""
    return {
        "LR": linear.SGDClassifier,  # sklearn's at loss="log_loss"
        "NB": linear.GaussianNB,
        "RF": trees.RandomForestClassifier,
        "DT": trees.DecisionTreeClassifier,
    }[name]()


def _reservoir_update(res_x, res_y, x, y, seen: int, cap: int, rng):
    """Reservoir sampling over batches: keeps a uniform sample of at
    most ``cap`` rows in O(cap) memory. Grows until the cap is reached,
    then replaces at random."""
    if res_x is None:
        res_x = np.empty((0,) + x.shape[1:], dtype=np.float64)
        res_y = np.empty((0,), dtype=np.asarray(y).dtype)
    fill = min(cap - len(res_x), len(x))
    if fill > 0:
        res_x = np.concatenate([res_x, x[:fill]])
        res_y = np.concatenate([res_y, y[:fill]])
        seen += fill
        x, y = x[fill:], y[fill:]
    n = len(x)
    if n:
        idx = seen + np.arange(n)
        pos = (rng.random(n) * (idx + 1)).astype(np.int64)
        replace = pos < cap
        res_x[pos[replace]] = x[replace]
        res_y[pos[replace]] = y[replace]
        seen += n
    return res_x, res_y, seen


def _confusion_metrics(confusion: np.ndarray) -> Dict[str, float]:
    """accuracy and weighted F1 from a confusion matrix (rows: true
    class, columns: predicted)."""
    total = confusion.sum()
    if total == 0:
        return {}
    tp = np.diag(confusion).astype(np.float64)
    support = confusion.sum(axis=1).astype(np.float64)
    pred_c = confusion.sum(axis=0).astype(np.float64)
    f1 = np.where(2 * tp + (pred_c - tp) + (support - tp) > 0,
                  2 * tp / np.maximum(2 * tp + (pred_c - tp) +
                                      (support - tp), 1e-12), 0.0)
    return {"accuracy": float(tp.sum() / total),
            "f1": float((f1 * support).sum() / max(support.sum(), 1e-12))}


def _classification_metrics(y_true, y_pred) -> Dict[str, float]:
    """accuracy and weighted F1 of two label arrays over the union of
    their labels (what ``sklearn.metrics.accuracy_score`` and
    ``f1_score(average="weighted")`` give)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels, codes = np.unique(np.concatenate([y_true, y_pred]),
                              return_inverse=True)
    confusion = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(confusion, (codes[:len(y_true)], codes[len(y_true):]), 1)
    return _confusion_metrics(confusion)


def _matrix(frame, names: List[str]) -> np.ndarray:
    """``frame[names]`` as one 2-D array: a DataFrame's own
    ``to_numpy``, else the named columns stacked (a catalog Table)."""
    try:
        return frame[names].to_numpy()
    except (TypeError, KeyError, AttributeError):
        return np.column_stack([np.asarray(frame[c]) for c in names])


def _split_xy(features: Any, needs_label: bool,
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A ``features_*`` value as (X, y); duck-typed, so it takes a
    pandas DataFrame or a catalog Table without importing pandas."""
    if features is None:
        return None, None
    if isinstance(features, tuple) and len(features) == 2:
        x, y = features
        return np.asarray(x), np.asarray(y)
    if hasattr(features, "columns"):  # a DataFrame or a Table
        cols = [c for c in features.columns if c != "_id"]
        if LABEL_COLUMN in cols:
            y = np.asarray(features[LABEL_COLUMN])
            x = _matrix(features, [c for c in cols if c != LABEL_COLUMN])
            return x, y
        if needs_label:
            raise ValueError(
                f"features need a {LABEL_COLUMN!r} column or (X, y) tuple")
        return _matrix(features, cols), None
    arr = np.asarray(features)
    if needs_label:
        raise ValueError(
            f"labeled features must be (X, y) or have {LABEL_COLUMN!r}")
    return arr, None


def _output_columns(frame, predictions) -> Dict[str, Any]:
    """The rows of ``frame`` (a Table, a DataFrame or a batch's dict of
    columns; ``_id`` dropped) with a ``prediction`` column, as columns
    for the dataset writer. A float column's NaN is written as a null,
    as a DataFrame's is."""
    out: Dict[str, Any] = {}
    for c in list(frame):
        if c == "_id":
            continue
        values = np.asarray(frame[c])
        if values.dtype.kind == "f":
            values = np.ma.MaskedArray(values, mask=np.isnan(values))
        out[c] = values
    out["prediction"] = np.asarray(predictions)
    return out


class BuilderService:
    def __init__(self, context):
        self._ctx = context
        self._validator = V.RequestValidator(context)

    def create(self, body: Dict[str, Any], tool: str = "sparkml",
               ) -> Tuple[int, Dict[str, Any]]:
        streaming = bool(body.get(STREAMING_FIELD))
        mesh_parallel = bool(body.get(MESH_PARALLEL_FIELD))
        if streaming and mesh_parallel:
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                "streaming and meshParallel are exclusive: the "
                "out-of-core path is host-native (C++/sklearn), the "
                "mesh path trains in-memory per sub-slice")
        required = [TRAIN_FIELD, TEST_FIELD, CLASSIFIERS_FIELD]
        if not streaming:
            required.append(MODELING_CODE_FIELD)
        self._validator.required_fields(body, required)
        train_name = body[TRAIN_FIELD]
        test_name = body[TEST_FIELD]
        code = body.get(MODELING_CODE_FIELD, "")
        classifiers = body[CLASSIFIERS_FIELD]
        self._validator.existing_finished(train_name)
        self._validator.existing_finished(test_name)
        eval_name = body.get(EVAL_DATASET_FIELD)
        if eval_name:
            self._validator.existing_finished(eval_name)
        if not isinstance(classifiers, list) or not classifiers:
            raise V.HttpError(V.HTTP_NOT_ACCEPTABLE, "invalid classifier")
        if code and self._ctx.config.preflight:
            # modelingCode runs in the sandbox: screened once at submit
            V.run_preflight(A.check_builder(
                code, mode=self._ctx.config.sandbox_mode))
        for c in classifiers:
            if c not in CLASSIFIER_NAMES:
                raise V.HttpError(V.HTTP_NOT_ACCEPTABLE,
                                  f"invalid classifier name: {c}")
        # one output collection per classifier; a stale one is replaced
        outputs = {}
        for c in classifiers:
            out = f"{test_name}{c}"
            if self._ctx.catalog.exists(out):
                self._ctx.catalog.delete_collection(out)
            self._ctx.catalog.create_collection(
                out, D.BUILDER_SPARKML_TYPE, {
                    "classifier": c,
                    D.PARENT_NAME_FIELD: train_name,
                    "testDatasetName": test_name})
            outputs[c] = out
        first = outputs[classifiers[0]]
        if streaming:
            label_col = body.get(LABEL_FIELD, LABEL_COLUMN)
            feat_cols = body.get(FEATURES_FIELD)
            batch_size = int(body.get(BATCH_SIZE_FIELD, 65536))
            run = lambda: self._run_streaming(  # noqa: E731
                train_name, test_name, eval_name, outputs, label_col,
                feat_cols, batch_size)
        else:
            run = lambda: self._run(  # noqa: E731
                train_name, test_name, code, outputs,
                mesh_parallel=mesh_parallel)
        self._ctx.jobs.submit(
            first, run,
            description="builder pipeline",
            parameters={CLASSIFIERS_FIELD: classifiers,
                        STREAMING_FIELD: streaming,
                        MESH_PARALLEL_FIELD: mesh_parallel},
            # the card lease only when a torch family fits there; tree
            # lists must not hold it for host fits
            needs_card=mesh_parallel and any(
                c in _TORCH_FAMILIES for c in classifiers),
            pool="builder",
            # a terminal failure documents EVERY output, or pollers of
            # the other classifiers would wait forever
            failure_names=list(outputs.values()),
            mark_finished=False)  # each classifier marks its own output
        return V.HTTP_CREATED, {"result": [
            f"/api/learningOrchestra/v1/builder/{tool}/{out}"
            for out in outputs.values()]}

    # ------------------------------------------------------------------
    def _record_failure(self, out_name: str, exception: Exception) -> None:
        self._ctx.catalog.append_document(out_name, D.execution_document(
            "builder classifier", None, exception=repr(exception)))

    def _run(self, train_name: str, test_name: str, code: str,
             outputs: Dict[str, str], mesh_parallel: bool = False,
             ) -> None:
        features = self._ctx.features
        config = self._ctx.config
        training_df = features.table(train_name)
        testing_df = features.table(test_name)
        # the content identity of the derived (x, y): both datasets'
        # versions and the code that derives them; a repeat job with the
        # same inputs reuses the arena's staged tensors, and a write to
        # either dataset changes the token
        feature_token = ("builder",
                         train_name, features.version(train_name),
                         test_name, features.version(test_name),
                         hashlib.sha256(code.encode()).hexdigest())
        feature_tags = (train_name, test_name)
        # the sandbox hands the code copies of the cached columns
        ctx_vars, _ = sandbox.run_user_code(
            code, {"training_df": training_df, "testing_df": testing_df},
            mode=config.sandbox_mode, config=config, dataframes=True)
        try:
            features_training = ctx_vars["features_training"]
            features_testing = ctx_vars["features_testing"]
            features_evaluation = ctx_vars.get("features_evaluation")
        except KeyError as missing:
            raise sandbox.missing_variable_error(
                ctx_vars, missing.args[0],
                f"modelingCode must define {missing.args[0]}")
        x_train, y_train = _split_xy(features_training, needs_label=True)
        x_test, _ = _split_xy(features_testing, needs_label=False)
        x_eval, y_eval = _split_xy(features_evaluation, needs_label=True) \
            if features_evaluation is not None else (None, None)

        devices: Dict[str, Any] = {}
        sequential: List[str] = []
        errors: Dict[str, Exception] = {}
        if mesh_parallel:
            devices, sequential = self._mesh_slices(outputs)
        fit = dict(x_train=x_train, y_train=y_train, x_test=x_test,
                   x_eval=x_eval, y_eval=y_eval, testing_df=testing_df,
                   feature_token=feature_token, feature_tags=feature_tags)
        # the card's families one after the other, then the host pool;
        # a failure documents its own output and the others still run
        for c in sequential:
            try:
                self._fit_one(c, out_name=outputs[c], device=devices[c],
                              **fit)
            except Exception as e:  # noqa: BLE001
                errors[c] = e
                self._record_failure(outputs[c], e)
        pooled = [c for c in outputs if c not in sequential]
        with ThreadPoolExecutor(max_workers=max(1, len(pooled))) as pool:
            futures = {c: pool.submit(self._fit_one, c,
                                      out_name=outputs[c], **fit)
                       for c in pooled}
            for c, fut in futures.items():
                try:
                    fut.result()
                except Exception as e:  # noqa: BLE001
                    errors[c] = e
                    self._record_failure(outputs[c], e)
        if errors:
            raise RuntimeError(f"classifier failures: {errors}")

    def _mesh_slices(self, outputs: Dict[str, str]):
        """({classifier: device}, classifiers to fit one after the other).
        One card is one slice: the torch families share it and run in
        sorted order, before the host families."""
        families = sorted(c for c in outputs if c in _TORCH_FAMILIES)
        return {c: self._ctx.device for c in families}, families

    # ------------------------------------------------------------------
    # the out-of-core path (BASELINE config 4: a GBT classifier on 10M
    # rows). One pass per classifier over the catalog's batches: memory
    # stays bounded by the batch and the reservoir cap
    # ------------------------------------------------------------------
    def _run_streaming(self, train_name: str, test_name: str,
                       eval_name: Optional[str], outputs: Dict[str, str],
                       label_col: str, feat_cols: Optional[List[str]],
                       batch_size: int) -> None:
        cat = self._ctx.catalog
        fields = cat.dataset_fields(train_name)
        if label_col not in fields:
            raise ValueError(
                f"streaming builder needs a {label_col!r} column in "
                f"{train_name} (or pass {LABEL_FIELD!r})")
        feats = [c for c in (feat_cols or fields)
                 if c not in ("_id", label_col)]
        # partial_fit must know the classes before its first batch: one
        # pass over the label column, skipped when no incremental family
        # is asked for (GB finds its classes on its own pass)
        classes_arr = np.empty((0,))
        if any(c in _INCREMENTAL for c in outputs):
            classes: set = set()
            for batch in cat.iter_batches(train_name, columns=[label_col],
                                          batch_size=batch_size):
                classes.update(np.unique(batch[label_col]).tolist())
            classes_arr = np.array(sorted(classes))

        with ThreadPoolExecutor(max_workers=len(outputs)) as pool:
            futures = {
                c: pool.submit(self._fit_one_streaming, c, train_name,
                               test_name, eval_name, outputs[c],
                               label_col, feats, classes_arr, batch_size)
                for c in outputs}
            errors = {}
            for c, fut in futures.items():
                try:
                    fut.result()
                except Exception as e:  # noqa: BLE001
                    errors[c] = e
                    self._record_failure(outputs[c], e)
        if errors:
            raise RuntimeError(f"classifier failures: {errors}")

    def _batches_xy(self, name: str, label_col: str, feats: List[str],
                    batch_size: int, with_label: bool = True):
        cols = feats + ([label_col] if with_label else [])
        for batch in self._ctx.catalog.iter_batches(
                name, columns=cols, batch_size=batch_size):
            x = np.column_stack([np.asarray(batch[c], dtype=np.float64)
                                 for c in feats])
            y = batch[label_col] if with_label else None
            yield x, y, batch

    def _fit_one_streaming(self, classifier_name: str, train_name: str,
                           test_name: str, eval_name: Optional[str],
                           out_name: str, label_col: str,
                           feats: List[str], classes: np.ndarray,
                           batch_size: int) -> None:
        if classifier_name == "GB":
            # every row trains the booster, as Spark's GBT does
            self._fit_gb_fulldata(train_name, test_name, eval_name,
                                  out_name, label_col, feats,
                                  batch_size)
            return
        clf = _make_streaming_classifier(classifier_name)
        incremental = classifier_name in _INCREMENTAL
        rng = np.random.default_rng(17)
        res_x = res_y = None
        seen = 0
        t0 = time.perf_counter()
        for x, y, _ in self._batches_xy(train_name, label_col, feats,
                                        batch_size):
            if incremental:
                clf.partial_fit(x, y, classes=classes)
            else:
                res_x, res_y, seen = _reservoir_update(
                    res_x, res_y, x, y, seen, _RESERVOIR_CAP, rng)
        if not incremental:
            clf.fit(res_x, res_y)
        fit_time = time.perf_counter() - t0
        metrics: Dict[str, Any] = {
            "classifier": classifier_name,
            "fitTime": round(fit_time, 6),
            "streaming": True,
            "trainedOnSample": (not incremental
                               and seen > _RESERVOIR_CAP)}

        self._eval_and_write_streaming(
            clf.predict, classes, metrics, test_name, eval_name,
            out_name, label_col, feats, batch_size,
            f"builder {classifier_name} (streaming)")

    def _eval_and_write_streaming(self, predict, classes, metrics,
                                  test_name: str,
                                  eval_name: Optional[str],
                                  out_name: str, label_col: str,
                                  feats: List[str], batch_size: int,
                                  description: str) -> None:
        """The streaming tail of every classifier: the evaluation
        confusion matrix accumulated batch by batch, the per-row
        predictions written batch by batch, then the metrics and
        finished."""
        if eval_name:
            c = len(classes)
            cls_index = {v: i for i, v in enumerate(classes)}
            confusion = np.zeros((c, c), np.int64)
            for x, y, _ in self._batches_xy(eval_name, label_col, feats,
                                            batch_size):
                pred = predict(x)
                ti = np.array([cls_index.get(v, -1) for v in y])
                pi = np.array([cls_index.get(v, -1) for v in pred])
                ok = (ti >= 0) & (pi >= 0)
                np.add.at(confusion, (ti[ok], pi[ok]), 1)
            metrics.update(_confusion_metrics(confusion))

        with self._ctx.catalog.dataset_writer(out_name) as w:
            for x, _, batch in self._batches_xy(test_name, label_col,
                                                feats, batch_size,
                                                with_label=False):
                w.write_batch(_output_columns(batch, predict(x)))
        self._ctx.catalog.update_metadata(out_name, metrics)
        self._ctx.catalog.mark_finished(out_name)
        self._ctx.catalog.append_document(out_name, D.execution_document(
            description, None, extra=metrics))

    def _fit_gb_fulldata(self, train_name: str, test_name: str,
                         eval_name: Optional[str], out_name: str,
                         label_col: str, feats: List[str],
                         batch_size: int) -> None:
        """Histogram gradient boosting over ALL rows. Pass 1 samples rows
        for the quantile bin edges only (boundaries, not training) and
        collects the classes; pass 2 bins every row to uint8 codes and
        its label to its class index, both into arrays allocated once;
        the boosting loop runs in the port's C++ core (numpy fallback)
        with every row contributing gradients to every iteration. Memory:
        rows x (nfeats + 4) bytes, one float64 score per row, and the
        booster's own class pass."""
        from learningorchestra_tpu_torch.native import hgb

        rng = np.random.default_rng(17)
        t0 = time.perf_counter()
        # pass 1: bin edges from a uniform row sample, and the classes
        res_x = res_y = None
        seen = 0
        classes: set = set()
        for x, y, _ in self._batches_xy(train_name, label_col, feats,
                                        batch_size):
            res_x, res_y, seen = _reservoir_update(
                res_x, res_y, x, y, seen, _RESERVOIR_CAP, rng)
            classes.update(np.unique(y).tolist())
        edges = hgb.quantile_edges(res_x)
        del res_x, res_y
        labels = np.array(sorted(classes))
        # pass 2: every row's codes (uint8) and class index (int32)
        codes = np.empty((seen, len(feats)), np.uint8)
        y_idx = np.empty((seen,), np.int32)
        n_rows = 0
        for x, y, _ in self._batches_xy(train_name, label_col, feats,
                                        batch_size):
            stop = n_rows + len(x)
            codes[n_rows:stop] = hgb.bin_codes(x, edges)
            y_idx[n_rows:stop] = np.searchsorted(labels, y)
            n_rows = stop
        # the booster's classes are the indices 0..C-1, each present;
        # its predictions map back through the labels
        clf = hgb.HistGB().fit_binned(codes[:n_rows], y_idx[:n_rows])
        clf.classes_ = labels
        del codes, y_idx
        fit_time = time.perf_counter() - t0
        metrics: Dict[str, Any] = {
            "classifier": "GB",
            "fitTime": round(fit_time, 6),
            "streaming": True,
            "trainedOnSample": False,
            "trainedRows": int(n_rows),
            "booster": {"iterations": clf.n_iter,
                        "maxDepth": clf.max_depth,
                        "learningRate": clf.learning_rate}}

        def predict(x: np.ndarray) -> np.ndarray:
            return clf.predict_binned(hgb.bin_codes(x, edges))

        self._eval_and_write_streaming(
            predict, clf.classes_, metrics, test_name, eval_name,
            out_name, label_col, feats, batch_size,
            "builder GB (streaming, full data)")

    def _fit_one(self, classifier_name: str, x_train, y_train, x_test,
                 x_eval, y_eval, testing_df, out_name: str,
                 device=None, feature_token=None,
                 feature_tags: tuple = ()) -> None:
        metrics: Dict[str, Any] = {"classifier": classifier_name}
        if device is not None and classifier_name in _TORCH_FAMILIES:
            clf = _make_torch_classifier(classifier_name, device)
            # the content identity of (x_train, y_train): a repeat job
            # on the same versions reuses the arena's staged tensors
            clf.feature_token = feature_token
            clf.feature_tags = feature_tags
            metrics["engine"] = "torch"
            metrics["meshDevices"] = 1
        else:
            clf = _make_classifier(classifier_name)
            metrics["engine"] = "host"
        t0 = time.perf_counter()
        clf.fit(x_train, y_train)
        fit_time = time.perf_counter() - t0
        metrics["fitTime"] = round(fit_time, 6)
        if x_eval is not None and y_eval is not None:
            metrics.update(_classification_metrics(y_eval,
                                                   clf.predict(x_eval)))
        predictions = clf.predict(x_test)
        with self._ctx.catalog.dataset_writer(out_name) as w:
            w.write_batch(_output_columns(testing_df, predictions))
        self._ctx.catalog.update_metadata(out_name, metrics)
        self._ctx.catalog.mark_finished(out_name)
        self._ctx.catalog.append_document(out_name, D.execution_document(
            f"builder {classifier_name}", None, extra=metrics))
