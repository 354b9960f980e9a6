"""Analytic architecture accounting for the CNN templates.

The reference computes the model-size objective as
``count_params() * 4 bytes / 2**20`` MB (reference: nsga_penalty.py:337-344).
Keras ``count_params`` counts trainable *and* non-trainable parameters, so a
BatchNormalization layer contributes 4*C (gamma, beta, moving_mean,
moving_var). We reproduce that count analytically from the genome alone, so
the size objective never needs to materialize parameters.

Two templates exist in the reference:

* Template A ("2-conv stem", reference: nsga_penalty.py:225-334): two
  Conv-BN?-ReLU stem convs, then residual blocks with TWO convs each.
* Template B ("1-conv stem", reference: sa_nsga_penalty.py:137-177): one
  Conv-ReLU (+BN?) stem, then residual blocks with ONE conv each.

Both share: 1x1 stride-2 skip projection per block, filter doubling per
block, MaxPool downsampling, GlobalAveragePooling, an FC stack from
FC_CONFIGS, and a softmax output layer.

Template D is the depthwise-separable block of DS-CNN ("Hello Edge:
Keyword Spotting on Microcontrollers", Zhang et al., arXiv:1711.07128;
MLPerf Tiny's keyword-spotting reference) in that residual frame. With k
the kernel size, f the filters, BN only where ``use_bn``, every conv with
a bias and SAME padding as TF/Keras defines it:

* stem: ``h = ReLU(BN(Conv_kxk,stride 2(x; 1 -> f)))``, no pool: the maps
  come out at ceil(H/2) x ceil(W/2), as A's and B's do after their pool;
* block i, c -> 2c:
  ``u = ReLU(BN(DW_kxk(h; c)))`` (depthwise, depth multiplier 1),
  ``y = BN(PW_1x1(u; c -> 2c))``,
  ``h' = ReLU(MaxPool2(y) + Skip_1x1,stride 2(h; c -> 2c))``;
* head: A's and B's multi-exit GAP, FC stack and softmax output.

Its departures from the published DS-CNN: a k x k stem (not 10 x 4), a
k x k depthwise kernel with k in {3, 5} (not 3), widths doubling each of
1-3 blocks (not one width over 4-5 layers), the residual frame and FC
head of the reference's templates, dropout in the FC head only. Keras
counts a depthwise conv as k*k*c + c parameters.
"""

from __future__ import annotations

from typing import Dict

from ..core.genome import FC_CONFIGS, Genome

TEMPLATE_A = "A"  # 2-conv stem, 2 convs per residual block
TEMPLATE_B = "B"  # 1-conv stem, 1 conv per residual block
TEMPLATE_D = "D"  # stride-2 stem, depthwise + pointwise per residual block

BN_PARAMS_PER_CHANNEL = 4  # gamma, beta, moving_mean, moving_var


def conv_params(k: int, c_in: int, c_out: int) -> int:
    return k * k * c_in * c_out + c_out


def dense_params(d_in: int, d_out: int) -> int:
    return d_in * d_out + d_out


def depthwise_params(k: int, c: int) -> int:
    return k * k * c + c


def count_params(genome: Genome, num_classes: int, template: str = TEMPLATE_A) -> int:
    """Total parameter count (trainable + BN moving stats), matching Keras
    ``count_params`` for the reference ``build_model`` implementations."""
    f = int(genome["filters"])
    k = int(genome["kernel_size"])
    use_bn = bool(genome["use_bn"])
    n_blocks = int(genome["residual_blocks"])
    n_fc = int(genome["fc_layers"])

    total = 0
    if template == TEMPLATE_A:
        # Stem: two convs (nsga_penalty.py:255-263)
        total += conv_params(k, 1, f)
        if use_bn:
            total += BN_PARAMS_PER_CHANNEL * f
        total += conv_params(k, f, f)
        if use_bn:
            total += BN_PARAMS_PER_CHANNEL * f
    elif template in (TEMPLATE_B, TEMPLATE_D):
        # Stem: one conv (sa_nsga_penalty.py:151-152; D's at stride 2)
        total += conv_params(k, 1, f)
        if use_bn:
            total += BN_PARAMS_PER_CHANNEL * f
    else:
        raise ValueError(f"unknown template {template!r}")

    c = f
    for _ in range(n_blocks):
        c2 = 2 * c
        total += conv_params(1, c, c2)  # 1x1 stride-2 skip projection
        if template == TEMPLATE_D:
            total += depthwise_params(k, c) + conv_params(1, c, c2)
            if use_bn:
                total += BN_PARAMS_PER_CHANNEL * (c + c2)
            c = c2
            continue
        total += conv_params(k, c, c2)  # first block conv
        if use_bn:
            total += BN_PARAMS_PER_CHANNEL * c2
        if template == TEMPLATE_A:
            total += conv_params(k, c2, c2)  # second block conv (A only)
            if use_bn:
                total += BN_PARAMS_PER_CHANNEL * c2
        c = c2

    d = c  # GAP output width
    for units in FC_CONFIGS[n_fc]:
        total += dense_params(d, units)
        d = units
    total += dense_params(d, num_classes)  # softmax output layer
    return total


def model_size_mb(genome: Genome, num_classes: int, template: str = TEMPLATE_A) -> float:
    """Model size objective in MB: params * 4 bytes / 2**20
    (reference: nsga_penalty.py:337-344)."""
    return count_params(genome, num_classes, template) * 4 / (1024 ** 2)


def _ceil_half(n: int) -> int:
    return (n + 1) // 2  # SAME-padded stride-2 output length


def count_fwd_flops(
    genome: Genome,
    input_hw: tuple,
    num_classes: int,
    template: str = TEMPLATE_A,
) -> int:
    """Matmul/conv FLOPs (2*MACs) of ONE forward pass per sample.

    Standard MFU accounting: only the MXU work (convs + dense layers) is
    counted; BN/ReLU/pool elementwise traffic is excluded. Spatial dims
    follow the reference templates exactly (SAME padding, stride-2 pools
    after the stem and inside every block; template D's stem at stride 2,
    a depthwise conv 2*k*k FLOPs an output element)."""
    if template not in (TEMPLATE_A, TEMPLATE_B, TEMPLATE_D):
        raise ValueError(f"unknown template {template!r}")
    f = int(genome["filters"])
    k = int(genome["kernel_size"])
    n_blocks = int(genome["residual_blocks"])
    h, w = int(input_hw[0]), int(input_hw[1])

    def conv_flops(k_, cin, cout, hh, ww):
        return 2 * k_ * k_ * cin * cout * hh * ww

    if template == TEMPLATE_D:
        h, w = _ceil_half(h), _ceil_half(w)  # stride-2 stem
        total = conv_flops(k, 1, f, h, w)
    else:
        total = conv_flops(k, 1, f, h, w)  # stem conv 1
        if template == TEMPLATE_A:
            total += conv_flops(k, f, f, h, w)  # stem conv 2
        h, w = _ceil_half(h), _ceil_half(w)  # stem pool

    c = f
    for _ in range(n_blocks):
        c2 = 2 * c
        h2, w2 = _ceil_half(h), _ceil_half(w)
        total += conv_flops(1, c, c2, h2, w2)  # stride-2 skip projection
        if template == TEMPLATE_D:
            total += 2 * k * k * c * h * w  # depthwise
            total += conv_flops(1, c, c2, h, w)  # pointwise (pre-pool)
            c, h, w = c2, h2, w2
            continue
        total += conv_flops(k, c, c2, h, w)  # block conv (pre-pool)
        if template == TEMPLATE_A:
            total += conv_flops(k, c2, c2, h, w)  # second block conv
        c, h, w = c2, h2, w2

    d = c  # GAP output width
    for units in FC_CONFIGS[int(genome["fc_layers"])]:
        total += 2 * d * units
        d = units
    total += 2 * d * num_classes
    return total


def count_train_flops_per_sample(
    genome: Genome,
    input_hw: tuple,
    num_classes: int,
    template: str = TEMPLATE_A,
) -> int:
    """One training step's FLOPs per sample: forward + backward ~= 3x the
    forward pass (activation grads + weight grads each cost ~1 forward)."""
    return 3 * count_fwd_flops(genome, input_hw, num_classes, template)


def describe(genome: Genome, num_classes: int, template: str = TEMPLATE_A) -> Dict:
    """Human/debug summary of the concrete architecture a genome induces."""
    f = int(genome["filters"])
    n_blocks = int(genome["residual_blocks"])
    widths = [f * 2 ** (b + 1) for b in range(n_blocks)]
    return {
        "template": template,
        "stem_filters": f,
        "kernel": int(genome["kernel_size"]),
        "block_widths": widths,
        "gap_width": widths[-1] if widths else f,
        "fc_stack": list(FC_CONFIGS[int(genome["fc_layers"])]),
        "use_bn": bool(genome["use_bn"]),
        "use_dropout": bool(genome["use_dropout"]),
        "params": count_params(genome, num_classes, template),
        "size_mb": model_size_mb(genome, num_classes, template),
    }
