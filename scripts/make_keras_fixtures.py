#!/usr/bin/env python3
"""Writes ``tests/fixtures/keras/``: real keras artifacts for the port's
keras readers, made with TensorFlow's own libraries on a machine that
has them (tf_keras for the SavedModel directories and the legacy
whole-model ``.h5`` files, keras 3 for the ``.keras`` archives).

    python3 scripts/make_keras_fixtures.py [--out DIR]

Each model's folder holds its artifacts, the inputs (``x.npy``, drawn
with numpy from the seed in ``meta.json``) and TensorFlow's predictions
on them (``want.npy``, from the tf_keras model; the keras 3 twin, given
the same weights, must agree within 1e-5 or the script fails):

- ``cnn``: the tutorial's MNIST CNN at full width (docs/TUTORIAL.md
  workflow 2: reshape 28x28x1, conv 32 3x3 relu, max pool, flatten,
  dense 128 relu, dense 10 softmax), as a SavedModel directory only:
  its 693,962 float32 weights are 2.8 MB a copy, and the folder stays
  under 4 MB;
- ``cnn_narrow``: the same layer kinds at conv 8 and dense 16, as a
  ``.keras`` archive and a legacy ``.h5``;
- ``rnn``: a narrow recurrent stack (embedding, bidirectional LSTM with
  sequences, GRU, batch norm, dense softmax) in all three formats.

The SavedModel directories are written with ``save_traces=False`` (no
traced functions in ``saved_model.pb``; keras rebuilds such a model from
its config, as the port's reader does). Weights are TensorFlow's
initializers under a fixed seed, and each batch
norm's moving statistics are drawn from the seed, so inference
normalizes by statistics that are not the identity. Nothing is fetched.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tutorial_cnn(kl, conv: int, dense: int, input_layer):
    return [input_layer((784,)), kl.Reshape((28, 28, 1)),
            kl.Conv2D(conv, (3, 3), activation="relu"),
            kl.MaxPooling2D(), kl.Flatten(),
            kl.Dense(dense, activation="relu"),
            kl.Dense(10, activation="softmax")]


def _rnn_stack(kl, input_layer):
    return [input_layer((9,)), kl.Embedding(30, 5),
            kl.Bidirectional(kl.LSTM(4, return_sequences=True)),
            kl.GRU(3), kl.BatchNormalization(),
            kl.Dense(2, activation="softmax")]


MODELS = {
    # name: (layers of (keras layers module, input factory), formats,
    #        input maker from a numpy Generator)
    "cnn": (lambda kl, inp: _tutorial_cnn(kl, 32, 128, inp),
            ("savedmodel",),
            lambda rng: (np.floor(rng.random((16, 784)) * 256) / 256)
            .astype(np.float32)),
    "cnn_narrow": (lambda kl, inp: _tutorial_cnn(kl, 8, 16, inp),
                   ("keras", "h5"),
                   lambda rng: (np.floor(rng.random((16, 784)) * 256)
                                / 256).astype(np.float32)),
    "rnn": (_rnn_stack, ("savedmodel", "keras", "h5"),
            lambda rng: rng.integers(0, 30, size=(8, 9)).astype(np.int32)),
}
FILES = {"savedmodel": "savedmodel", "keras": "model.keras",
         "h5": "legacy.h5"}
SEED = 19


def _moving_stats(model, rng) -> None:
    """Batch norm's moving mean and variance drawn from ``rng``."""
    for layer in model.layers:
        if type(layer).__name__ == "BatchNormalization":
            gamma, beta, mean, var = layer.get_weights()
            layer.set_weights([
                gamma, beta,
                rng.normal(0.0, 0.5, mean.shape).astype(np.float32),
                rng.uniform(0.5, 2.0, var.shape).astype(np.float32)])


def make(out: str) -> dict:
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
    import keras
    import tensorflow as tf
    import tf_keras

    if os.path.isdir(out):
        shutil.rmtree(out)
    summary = {}
    for i, (name, (build, formats, inputs)) in enumerate(MODELS.items()):
        folder = os.path.join(out, name)
        os.makedirs(folder)
        seed = SEED + i
        tf.keras.utils.set_random_seed(seed)
        tf_keras.utils.set_random_seed(seed)
        tfk = tf_keras.Sequential(build(
            tf_keras.layers, lambda s: tf_keras.layers.InputLayer(s)))
        rng = np.random.default_rng(seed)
        _moving_stats(tfk, rng)
        x = inputs(rng)
        want = np.asarray(tfk(x, training=False))
        k3 = keras.Sequential(build(keras.layers, keras.Input))
        k3.set_weights(tfk.get_weights())
        k3_out = np.asarray(k3(x, training=False))
        gap = float(np.abs(k3_out - want).max())
        if gap > 1e-5:
            raise AssertionError(f"{name}: keras 3 and tf_keras differ by "
                                 f"{gap}")
        for fmt in formats:
            path = os.path.join(folder, FILES[fmt])
            if fmt == "savedmodel":
                # without traced functions (keras's save_traces=False):
                # the RNN's graph alone is 2.5 MB, and the readers take
                # the layers from keras_metadata.pb
                tfk.save(path, save_format="tf", save_traces=False)
            elif fmt == "h5":
                tfk.save(path, save_format="h5")
            else:
                k3.save(path)
        np.save(os.path.join(folder, "x.npy"), x)
        np.save(os.path.join(folder, "want.npy"), want)
        meta = {"seed": seed, "x": "x.npy", "want": "want.npy",
                "wantFrom": "tf_keras", "keras3MaxAbsGap": gap,
                "formats": {fmt: FILES[fmt] for fmt in formats},
                "params": int(tfk.count_params()),
                "layers": [type(layer).__name__ for layer in tfk.layers],
                "tensorflow": tf.__version__, "tf_keras":
                tf_keras.__version__, "keras": keras.__version__}
        with open(os.path.join(folder, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        summary[name] = meta
    return summary


def _bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join(
        ROOT, "tests", "fixtures", "keras"))
    args = parser.parse_args()
    summary = make(args.out)
    total = _bytes(args.out)
    print(json.dumps({"out": args.out, "bytes": total, "models": {
        k: {"params": v["params"], "bytes": _bytes(os.path.join(
            args.out, k))} for k, v in summary.items()}}))
    if total >= 4 << 20:
        print(f"fixtures take {total} bytes, over 4 MiB", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
