"""AMP op lists.

Counterpart: ``paddle_tpu/amp/amp_lists.py``: the reference's white and
black lists, name for name, and ``white_list()`` / ``black_list()``.
Each registered op also carries its own category (``OpDef.amp``); these
lists, and ``auto_cast``'s ``custom_white_list`` / ``custom_black_list``,
name ops by their registered names.
"""
from __future__ import annotations

__all__ = ["BLACK_LIST", "WHITE_LIST", "black_list", "white_list"]

# ops that run in the low dtype under O1 and O2
WHITE_LIST = {
    "matmul", "bmm", "mv", "addmm", "multi_dot", "tensordot", "inner",
    "einsum", "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "sdpa_ref", "flash_attention",
    "flash_attention_masked",
    # the fused norms: low-dtype I/O, f32 statistics inside the kernels
    # (the dense layer_norm / batch_norm_* stay black: f32 I/O)
    "fused_layer_norm", "fused_bias_dropout_residual_ln", "fused_bn_train",
}

# numerically sensitive ops: float32
BLACK_LIST = {
    "exp", "expm1", "log", "log2", "log10", "log1p", "logsumexp", "softmax",
    "log_softmax", "cross_entropy", "nll_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "ctc_loss", "layer_norm",
    "batch_norm_train", "batch_norm_infer", "instance_norm", "group_norm",
    "rms_norm", "local_response_norm", "norm", "vector_norm", "matrix_norm",
    "cosine_similarity", "dist", "erf", "erfinv", "asin", "acos", "atan",
    "asinh", "acosh", "atanh", "cumprod", "det", "slogdet", "cholesky",
    "cholesky_solve", "inverse", "pinv", "solve", "qr", "svd", "eig", "eigh",
    "eigvals", "eigvalsh", "lstsq", "matrix_power", "matrix_exp",
    "sigmoid_focal_loss", "softplus", "log_sigmoid", "stft",
}


def white_list():
    return {"float16": {"O1": set(WHITE_LIST), "O2": set(WHITE_LIST)},
            "bfloat16": {"O1": set(WHITE_LIST), "O2": set(WHITE_LIST)}}


def black_list():
    return {"float16": {"O1": set(BLACK_LIST), "O2": set(BLACK_LIST)},
            "bfloat16": {"O1": set(BLACK_LIST), "O2": set(BLACK_LIST)}}
