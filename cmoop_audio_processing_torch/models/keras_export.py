"""Realize a trained genome as a concrete Keras model (and TFLite).

The paper's end goal is deployment on resource-constrained devices; the
reference's deployable artifact is a Keras model (build_model,
nsga_penalty.py:225-334 / sa_nsga_penalty.py:137-177), but its search
discards every trained instance. This module takes the trained parameters
of ONE genome, as a saved model directory holds them (engine/export.py:
numpy arrays in the JAX package's layout, conv kernels HWIO, which is also
Keras's), and transplants them into an equivalent concrete Keras graph — no
masking, no supernet — so the standard TinyML path (SavedModel/H5 -> TFLite
int8/fp) applies unchanged. A copy of
cmoop_audio_processing_tpu/models/keras_export.py.

The Keras graph mirrors the supernet's forward exactly (models/supernet.py
apply_model semantics, which follow the reference architecture with its
documented deviations, e.g. SAME pooling): transplant parity is therefore
bit-level up to f32 op-reassociation, and is pinned by
tests/test_torch_export.py against ``engine.export.predict``.

TensorFlow is an optional dependency here: import errors surface only when
these functions are called.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.genome import Genome, validate
from .supernet import FC_WIDTHS


def build_keras_model(genome: Genome, num_classes: int, input_hw,
                      template: str = "A", dropout_rate: float = 0.3):
    """Concrete (mask-free) Keras graph for one genome, layer-named for
    ``transplant_weights``. Returns an uncompiled tf.keras.Model.
    Templates A and B only: template D (depthwise-separable blocks) is
    refused, since its ``DepthwiseConv2D`` transplant could not be tested
    without TensorFlow; ``engine.export.predict`` runs a saved D model."""
    if template not in ("A", "B"):
        raise ValueError(
            f"build_keras_model realizes templates 'A' and 'B', not "
            f"{template!r}: template 'D' (depthwise-separable) has no "
            f"Keras graph here")
    from tensorflow.keras import Input, Model, layers

    validate(genome)
    f = int(genome["filters"])
    k = int(genome["kernel_size"])
    bn = bool(genome["use_bn"])
    do = bool(genome["use_dropout"])
    n_blocks = int(genome["residual_blocks"])
    n_fc = int(genome["fc_layers"])

    x = Input(shape=(input_hw[0], input_hw[1], 1), name="mfcc")
    h = layers.Conv2D(f, k, padding="same", name="stem1")(x)
    if template == "A":
        # conv -> BN? -> relu, twice (nsga_penalty.py:255-263)
        if bn:
            h = layers.BatchNormalization(epsilon=1e-3, name="stem1_bn")(h)
        h = layers.ReLU()(h)
        h = layers.Conv2D(f, k, padding="same", name="stem2")(h)
        if bn:
            h = layers.BatchNormalization(epsilon=1e-3, name="stem2_bn")(h)
        h = layers.ReLU()(h)
    else:
        # conv(relu) -> BN? (sa_nsga_penalty.py:151-152)
        h = layers.ReLU()(h)
        if bn:
            h = layers.BatchNormalization(epsilon=1e-3, name="stem1_bn")(h)
    h = layers.MaxPooling2D(2, padding="same")(h)

    c = f
    for i in range(n_blocks):
        c2 = 2 * c
        skip = layers.Conv2D(c2, 1, strides=2, padding="same",
                             name=f"block{i}_skip")(h)
        y = layers.Conv2D(c2, k, padding="same", name=f"block{i}_conv1")(h)
        if template == "A":
            if bn:
                y = layers.BatchNormalization(
                    epsilon=1e-3, name=f"block{i}_conv1_bn")(y)
            y = layers.ReLU()(y)
            y = layers.Conv2D(c2, k, padding="same",
                              name=f"block{i}_conv2")(y)
            if bn:
                y = layers.BatchNormalization(
                    epsilon=1e-3, name=f"block{i}_conv2_bn")(y)
        else:
            y = layers.ReLU()(y)
            if bn:
                y = layers.BatchNormalization(
                    epsilon=1e-3, name=f"block{i}_conv1_bn")(y)
        y = layers.MaxPooling2D(2, padding="same")(y)
        h = layers.ReLU()(layers.Add()([y, skip]))
        c = c2

    h = layers.GlobalAveragePooling2D()(h)
    for li in range(5 - n_fc, 5):
        h = layers.Dense(FC_WIDTHS[li - 1], activation="relu",
                         name=f"fc{li}")(h)
        if do:
            h = layers.Dropout(dropout_rate)(h)
    out = layers.Dense(num_classes, activation="softmax", name="out")(h)
    return Model(x, out, name=f"cmoop_{template}")


def transplant_weights(model, genome: Genome, params: Dict,
                       state: Dict) -> None:
    """Copy the supernet's trained active slices into the concrete Keras
    model (in place). ``params``/``state`` are a single model's trees in
    the JAX package's layout as numpy arrays (no pop axis), as
    engine/export.load_jax_layout returns them."""
    f = int(genome["filters"])
    bn = bool(genome["use_bn"])
    n_blocks = int(genome["residual_blocks"])
    entry = 5 - int(genome["fc_layers"])
    active_gap = f * 2 ** n_blocks

    def set_conv(name, p):
        model.get_layer(name).set_weights(
            [np.asarray(p["w"]), np.asarray(p["b"])]
        )

    def set_bn(name, p, st):
        model.get_layer(name).set_weights([
            np.asarray(p["gamma"]), np.asarray(p["beta"]),
            np.asarray(st["mean"]), np.asarray(st["var"]),
        ])

    set_conv("stem1", params["stem1"])
    if bn:
        set_bn("stem1_bn", params["stem1_bn"], state["stem1_bn"])
    if "stem2" in (l.name for l in model.layers):
        set_conv("stem2", params["stem2"])
        if bn:
            set_bn("stem2_bn", params["stem2_bn"], state["stem2_bn"])

    for i in range(n_blocks):
        blk = params[f"block{i}"]
        set_conv(f"block{i}_skip", blk["skip"])
        set_conv(f"block{i}_conv1", blk["conv1"])
        if bn:
            set_bn(f"block{i}_conv1_bn", blk["conv1_bn"],
                   state[f"block{i}_conv1_bn"])
        if f"block{i}_conv2" in (l.name for l in model.layers):
            set_conv(f"block{i}_conv2", blk["conv2"])
            if bn:
                set_bn(f"block{i}_conv2_bn", blk["conv2_bn"],
                       state[f"block{i}_conv2_bn"])

    for li in range(entry, 5):
        layer = params["fc"][f"fc{li}"]
        if li == entry:
            # the entry layer reads the GAP vector through its own
            # (active-sliced) weight matrix (models/supernet.py fc chain)
            kernel = np.asarray(layer["wg"])[:active_gap]
        else:
            kernel = np.asarray(layer["wp"])
        model.get_layer(f"fc{li}").set_weights(
            [kernel, np.asarray(layer["b"])]
        )
    model.get_layer("out").set_weights(
        [np.asarray(params["out"]["w"]), np.asarray(params["out"]["b"])]
    )


def export_keras(model_dir: str, keras_path: str):
    """Load an engine/export model dir, realize it in Keras, save (.h5 or
    SavedModel by extension). Returns the Keras model."""
    from ..engine.export import load_jax_layout

    meta, params, state = load_jax_layout(model_dir)
    genome = meta["genome"]
    hw = meta.get("input_hw")
    if hw is None:
        raise ValueError(
            "meta.json lacks input_hw (re-export with a current "
            "cli.train_final)"
        )
    model = build_keras_model(
        genome, int(meta["num_classes"]), hw, meta["template"],
        float(meta.get("dropout_rate", 0.3)),
    )
    transplant_weights(model, genome, params, state)
    if keras_path:
        model.save(keras_path)
    return model


def export_tflite(model, tflite_path: str, rep_data=None) -> int:
    """TFLite conversion; returns the flatbuffer size.

    Float32 by default. Passing ``rep_data`` (an array of feature maps,
    e.g. a slice of the training set) enables full-integer post-training
    quantization — the format TinyML runtimes (micro, int8 NPUs) actually
    deploy; weights AND activations become int8, shrinking the flatbuffer
    ~4x below even the paper's fp32 size objective."""
    import tensorflow as tf

    conv = tf.lite.TFLiteConverter.from_keras_model(model)
    if rep_data is not None:
        rep = np.asarray(rep_data, np.float32)

        def gen():
            for i in range(min(len(rep), 128)):
                yield [rep[i : i + 1]]

        conv.optimizations = [tf.lite.Optimize.DEFAULT]
        conv.representative_dataset = gen
        conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
        conv.inference_input_type = tf.int8
        conv.inference_output_type = tf.int8
    flat = conv.convert()
    with open(tflite_path, "wb") as fh:
        fh.write(flat)
    return len(flat)
