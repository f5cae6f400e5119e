"""Document schemas and field names of the catalog, as the JAX package's
``catalog/documents.py`` writes them, so REST bodies have the same shape.

Every collection has a reserved metadata document ``_id: 0`` that
carries the ``finished`` flag clients poll; each run appends an
execution document with the next integer ``_id``.
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, List, Optional

# --- field names ---
ID = "_id"
METADATA_ID = 0

TYPE_FIELD = "type"
NAME_FIELD = "name"
FINISHED_FIELD = "finished"
TIME_CREATED_FIELD = "timeCreated"
PARENT_NAME_FIELD = "parentName"
PARENT_DATASET_NAME_FIELD = "parentDatasetName"
MODULE_PATH_FIELD = "modulePath"
CLASS_FIELD = "class"
CLASS_PARAMETERS_FIELD = "classParameters"
METHOD_FIELD = "method"
METHOD_PARAMETERS_FIELD = "methodParameters"
FIELDS_FIELD = "fields"
DESCRIPTION_FIELD = "description"
EXCEPTION_FIELD = "exception"
FUNCTION_FIELD = "function"
FUNCTION_PARAMETERS_FIELD = "functionParameters"
FUNCTION_MESSAGE_FIELD = "functionMessage"

# --- job lifecycle: the metadata ``status`` field narrates
# queued -> running -> a terminal state
STATUS_FIELD = "status"
PROGRESS_FIELD = "progress"
STATUS_QUEUED = "queued"
STATUS_RUNNING = "running"
STATUS_FINISHED = "finished"
STATUS_TIMED_OUT = "timedOut"
STATUS_CANCELLED = "cancelled"
STATUS_STALLED = "stalled"
STATUS_DEAD_LETTERED = "deadLettered"
STATUS_SHUTDOWN_ABORTED = "shutdownAborted"
STATUS_WORKER_LOST = "workerLost"

# --- artifact type strings ---
DATASET_CSV_TYPE = "dataset/csv"
DATASET_GENERIC_TYPE = "dataset/generic"
MODEL_TENSORFLOW_TYPE = "model/tensorflow"
MODEL_SCIKITLEARN_TYPE = "model/scikitlearn"
TRAIN_TENSORFLOW_TYPE = "train/tensorflow"
TRAIN_SCIKITLEARN_TYPE = "train/scikitlearn"
TUNE_TENSORFLOW_TYPE = "tune/tensorflow"
TUNE_SCIKITLEARN_TYPE = "tune/scikitlearn"
EVALUATE_TENSORFLOW_TYPE = "evaluate/tensorflow"
EVALUATE_SCIKITLEARN_TYPE = "evaluate/scikitlearn"
# the reference gateway spells the evaluate backend "sckitlearn";
# accepted as an alias
EVALUATE_SCIKITLEARN_TYPO = "evaluate/sckitlearn"
PREDICT_TENSORFLOW_TYPE = "predict/tensorflow"
PREDICT_SCIKITLEARN_TYPE = "predict/scikitlearn"
EXPLORE_TENSORFLOW_TYPE = "explore/tensorflow"
EXPLORE_SCIKITLEARN_TYPE = "explore/scikitlearn"
EXPLORE_HISTOGRAM_TYPE = "explore/histogram"
TRANSFORM_TENSORFLOW_TYPE = "transform/tensorflow"
TRANSFORM_SCIKITLEARN_TYPE = "transform/scikitlearn"
TRANSFORM_PROJECTION_TYPE = "transform/projection"
TRANSFORM_DATATYPE_TYPE = "transform/dataType"
FUNCTION_PYTHON_TYPE = "function/python"
BUILDER_SPARKML_TYPE = "builder/sparkml"
# the "jax" tool is an alias of "tensorflow" with the same semantics
MODEL_JAX_TYPE = "model/jax"
TRAIN_JAX_TYPE = "train/jax"
TUNE_JAX_TYPE = "tune/jax"
EVALUATE_JAX_TYPE = "evaluate/jax"
PREDICT_JAX_TYPE = "predict/jax"
EXPLORE_JAX_TYPE = "explore/jax"
TRANSFORM_JAX_TYPE = "transform/jax"

DATASET_TYPES = (DATASET_CSV_TYPE, DATASET_GENERIC_TYPE)

TABULAR_OUTPUT_TYPES = (
    TRANSFORM_PROJECTION_TYPE,
    TRANSFORM_DATATYPE_TYPE,
    EXPLORE_HISTOGRAM_TYPE,
    BUILDER_SPARKML_TYPE,
)


def normalize_type(type_string: str) -> str:
    """Map the reference's typos and aliases onto canonical type
    strings."""
    if type_string == EVALUATE_SCIKITLEARN_TYPO:
        return EVALUATE_SCIKITLEARN_TYPE
    return type_string


def now_iso() -> str:
    """A fresh timestamp for each document."""
    return datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")


def metadata_document(name: str, type_string: str,
                      extra: Optional[Dict[str, Any]] = None,
                      ) -> Dict[str, Any]:
    """The reserved ``_id: 0`` metadata document."""
    doc: Dict[str, Any] = {
        ID: METADATA_ID,
        NAME_FIELD: name,
        TYPE_FIELD: normalize_type(type_string),
        FINISHED_FIELD: False,
        TIME_CREATED_FIELD: now_iso(),
    }
    if extra:
        doc.update(extra)
    return doc


def execution_document(description: str,
                       parameters: Optional[Dict[str, Any]] = None,
                       exception: Optional[str] = None,
                       extra: Optional[Dict[str, Any]] = None,
                       ) -> Dict[str, Any]:
    """An append-only run-history document."""
    doc: Dict[str, Any] = {
        DESCRIPTION_FIELD: description,
        METHOD_PARAMETERS_FIELD: parameters,
        EXCEPTION_FIELD: exception,
        TIME_CREATED_FIELD: now_iso(),
    }
    if extra:
        doc.update(extra)
    return doc


_QUERY_OPS = ("$eq", "$gt", "$gte", "$lt", "$lte", "$ne", "$in")


def matches_query(doc: Dict[str, Any],
                  query: Optional[Dict[str, Any]]) -> bool:
    """A Mongo-style filter: equality and ``{$eq, $gt, $gte, $lt, $lte,
    $ne, $in}``; a comparison of unorderable values does not match."""
    if not query:
        return True
    for key, cond in query.items():
        value = doc.get(key)
        if isinstance(cond, dict):
            for op, rhs in cond.items():
                if op not in _QUERY_OPS:
                    raise ValueError(f"unsupported query operator: {op}")
                try:
                    if op == "$eq" and not value == rhs:
                        return False
                    elif op == "$gt" and not value > rhs:
                        return False
                    elif op == "$gte" and not value >= rhs:
                        return False
                    elif op == "$lt" and not value < rhs:
                        return False
                    elif op == "$lte" and not value <= rhs:
                        return False
                    elif op == "$ne" and not value != rhs:
                        return False
                    elif op == "$in" and value not in rhs:
                        return False
                except TypeError:
                    return False
        elif value != cond:
            return False
    return True


def project_fields(doc: Dict[str, Any],
                   fields: Optional[List[str]]) -> Dict[str, Any]:
    if not fields:
        return doc
    return {k: v for k, v in doc.items() if k in fields or k == ID}
