"""Runtime flag registry.

Counterpart: ``paddle_tpu/core/flags.py``. Same contract: every flag is
settable programmatically (``set_flags``, with or without the
``FLAGS_`` prefix) or via an environment variable ``FLAGS_<name>`` read
at first access. Only the flags the ported serving and training paths
read are registered, with the reference's names and defaults.
``FLAGS_kernel_tuning`` is registered because the reference's block
picks key its dropout masks by the tile they give
(``kernels/flash_attention.py`` ``_auto_blocks``, ``norm_fusion.py``
``_auto_block_r``, ``mlp_fusion.py`` ``mlp_blocks``): in the port it
keys the masks and nothing else, the CUDA kernels' tiles being their
own. The TPU's block-size sweep flags (``FLAGS_flash_block*``,
``FLAGS_mlp_block_*``) and the interpret-mode flags are not ported: they
tune or test Pallas kernels. ``FLAGS_check_nan_inf``,
``FLAGS_check_nan_inf_level`` and ``FLAGS_check_nan_inf_flush`` (the
reference's :79-80, :206) arm the eager nan/inf check of every
registered op's outputs (``core/dispatch.py``, ``amp/debugging.py``).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

_lock = threading.Lock()
_registry: Dict[str, "_Flag"] = {}


class _Flag:
    __slots__ = ("name", "value", "type", "help", "env_read")

    def __init__(self, name, default, typ, help_):
        self.name = name
        self.value = default
        self.type = typ
        self.help = help_
        self.env_read = False


def _coerce(typ, raw):
    if typ is bool:
        if isinstance(raw, str):
            return raw.strip().lower() in ("1", "true", "yes", "on")
        return bool(raw)
    return typ(raw)


def define_flag(name: str, default: Any, help: str = ""):
    with _lock:
        if name not in _registry:
            _registry[name] = _Flag(name, default, type(default), help)
    return _registry[name]


def get_flag(name: str):
    name = name[6:] if name.startswith("FLAGS_") else name
    f = _registry.get(name)
    if f is None:
        raise KeyError(f"flag {name!r} is not registered")
    if not f.env_read:
        env = os.environ.get(f"FLAGS_{name}")
        if env is not None:
            f.value = _coerce(f.type, env)
        f.env_read = True
    return f.value


def set_flags(flags: Dict[str, Any]):
    for name, value in flags.items():
        name = name[6:] if name.startswith("FLAGS_") else name
        f = _registry.get(name)
        if f is None:
            raise KeyError(f"flag {name!r} is not registered")
        f.value = _coerce(f.type, value)
        f.env_read = True


define_flag("serving_decode_kernel", False,
            "B=1 GPT serving decode runs attention over the paged cache "
            "and the output projection as one hand-written CUDA kernel per "
            "layer (kernels/mlp_fusion.py decode_attn_proj). B>1 decode "
            "steps keep the composite path with a once-per-process "
            "warning. CPU tensors take the kernel's plain PyTorch version")
define_flag("serving_device_loop", True,
            "serving decode samples on the device and (with "
            "ServingEngine(device_loop_k=k)) runs k decode steps per "
            "window with ONE host read of the [B, k] token matrix "
            "(inference/device_loop.py). Sampled lanes draw from "
            "counter-derived threefry keys (fold_in(PRNGKey(seed), "
            "token_count)), bitwise the reference's streams. Off: host "
            "numpy sampling, one step per dispatch")
define_flag("fused_norm", True,
            "route LayerNorm (nn.functional.layer_norm, nn.LayerNorm), "
            "the bias→residual-add→LN sublayer close "
            "(fused_bias_dropout_residual_layer_norm) and train-mode "
            "BatchNorm with its residual-add→ReLU epilogue "
            "(nn.functional.batch_norm / batch_norm_act, the BatchNorm "
            "layers) through the fused kernels (kernels/norm_fusion.py, "
            "TPU kernels 13-18): the hand-written CUDA kernels on a card, "
            "their plain PyTorch versions for CPU tensors. Off: the dense "
            "norms. Shapes and dtypes the fused kernels do not take go "
            "dense with a once-per-process warning")
define_flag("fused_mlp", True,
            "route the transformer MLP sublayer (matmul→GeLU→matmul) of the "
            "GPT training step and of nn.functional.fused_mlp, the SwiGLU "
            "variant (fused_swiglu) and the attention output-projection→"
            "add→LN epilogue (fused_attn_proj_residual_layer_norm) through "
            "the fused kernels (kernels/mlp_fusion.py, TPU kernels 4-11): "
            "the hand-written CUDA kernels on a card, their plain PyTorch "
            "versions for CPU tensors. Off: the dense chains")
define_flag("kernel_tuning", True,
            "consult the tuning table's entries (analysis/autotune.py, the "
            "reference's winners) in the block picks before their "
            "heuristics. In the port the picks key the dropout masks "
            "only: the masks then equal the reference's at its default "
            "flags")
define_flag("check_nan_inf", False, "check outputs of every op for NaN/Inf")
define_flag("check_nan_inf_level", 0,
            "0: abort on nan/inf; 3: print stats only")
define_flag("check_nan_inf_flush", 64,
            "eager nan/inf checker flush window (ops per device read). The "
            "batched checker (amp/debugging.py) folds every op's badness "
            "count into ONE device accumulator and syncs once per window, "
            "never per tensor. 1 reads after every op, for pinpoint "
            "debugging")
