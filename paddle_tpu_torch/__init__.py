"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

Counterpart: ``paddle_tpu/__init__.py`` (its namespace, :44-128). The
port mirrors the JAX package's paths and names module by module; each
module's docstring names its counterpart. It imports ``torch`` and never
``jax`` or ``paddle_tpu`` (tests/test_torch_isolation.py holds that). Every TPU
(Pallas) kernel on a ported path is a hand-written Hopper kernel under
``kernels/csrc/``, built at first use; its plain PyTorch version runs
only for tensors on the CPU.

Ported so far: GPT serving through the paged-KV engine, the GPT
training step on one device with flash attention and the fused GeLU
MLP, LLaMA training through the Layer model and AdamW with the fused
SwiGLU MLP, BERT pretraining through the Layer model and AdamW with
the fused LayerNorm, projection-LayerNorm and key-padding flash kernels,
and ResNet training through ``vision.models`` and Momentum with the fused
BatchNorm kernels, mixed precision (``amp``: ``auto_cast`` O1 / O2,
``decorate``, ``GradScaler``) on the op registry of ``core/dispatch.py``
with the learning-rate schedulers (``optimizer.lr``) and gradient
clipping (``nn.clip``), and the operator surface: the 281 registered ops
of ``ops/``, the ``Tensor`` facade (``core/tensor.py``), places
(``core/place.py``), the error taxonomy (``core/errors.py``),
``framework``, ``base.ParamAttr`` and ``core/strings.py``, and the rest
of the eager core: ``nn.Layer`` and its containers, ``autograd`` (grad
mode, ``grad``, ``PyLayer``, the functional transforms), ``save`` /
``load`` and ``device`` (streams, events, memory statistics), with all
fourteen optimizers, and the rest of ``nn`` (the transformer and
recurrent layers, the losses, the initializers, ``nn.utils``),
``metric``, ``incubate.optimizer`` and ``amp.debugging``'s tensor
checker. The names below are the user's entry points, as
``paddle_tpu``'s are (``import paddle_tpu_torch as paddle``:
``paddle.to_tensor``, ``paddle.nn.Layer``, ``paddle.optimizer.AdamW``,
``paddle.save``, ``paddle.no_grad`` ...). A name of the reference's
namespace that is not ported yet (``jit``, ``static``, ``distributed``,
``io``, ``hapi`` ...) raises AttributeError naming its ROADMAP item
(``hasattr`` is False). Importing the package builds no kernel.
"""
from ._device import resolve_device
from .core.dtype import (bfloat16, bool_, complex64, complex128, float16,
                         float32, float64, get_default_dtype, int8, int16,
                         int32, int64, set_default_dtype, uint8)
from .core.flags import get_flag, set_flags
from .core.generator import Generator, get_rng_state, seed, set_rng_state
from .core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace,
                         Place, TPUPlace, XPUPlace, get_device,
                         is_compiled_with_cuda, set_device)
from .core.tensor import Parameter, Tensor, is_tensor
from . import ops
from .ops import *  # noqa: F401,F403
from .ops import matmul as mm
from .ops import tensor_unfold as unfold
from . import base, framework
from .base.param_attr import ParamAttr
from .framework import in_dynamic_mode
from .autograd_api import (enable_grad, grad, is_grad_enabled, no_grad,
                           set_grad_enabled)
from . import autograd_api as autograd
from . import (amp, device, incubate, inference, metric, models, nn,
               optimizer, profiler, utils, vision)
from .framework.io_api import load, save
from .core.generator import (get_rng_state as get_cuda_rng_state,
                             set_rng_state as set_cuda_rng_state)

bool = bool_  # noqa: A001


class LazyGuard:
    """Parity: paddle.LazyGuard, a transparent context (the layers
    allocate their parameters when built)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def disable_signal_handler():
    pass


# names of the reference's namespace still to be ported, with the ROADMAP
# item that ports them
_NOT_PORTED = {
    **dict.fromkeys(("jit", "static", "disable_static", "enable_static"),
                    "A9"),
    **dict.fromkeys(("distributed", "DataParallel"), "A10"),
    **dict.fromkeys(("io", "hapi", "Model", "summary", "flops", "audio",
                     "text", "sparse", "quantization", "distribution",
                     "fft", "linalg", "signal", "stft", "istft", "version",
                     "set_printoptions", "batch", "check_shape",
                     "get_default_place", "in_dynamic_or_pir_mode",
                     "is_compiled_with_rocm", "is_compiled_with_xpu",
                     "is_compiled_with_cinn", "is_compiled_with_tpu",
                     "is_compiled_with_custom_device"), "A11"),
}


def __getattr__(name):
    item = _NOT_PORTED.get(name)
    if item is not None:
        raise AttributeError(f"paddle_tpu_torch.{name} is not ported yet "
                             f"(ROADMAP {item})")
    raise AttributeError(f"module 'paddle_tpu_torch' has no attribute "
                         f"{name!r}")


__all__ = ["CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "CustomPlace",
           "Generator", "ParamAttr", "Parameter", "Place", "TPUPlace",
           "Tensor", "XPUPlace", "base", "bfloat16", "bool", "complex64",
           "complex128", "float16", "float32", "float64", "framework",
           "get_default_dtype", "get_device", "get_flag", "get_rng_state",
           "in_dynamic_mode", "int8", "int16", "int32", "int64",
           "is_compiled_with_cuda", "is_tensor", "mm", "ops",
           "resolve_device", "seed", "set_default_dtype", "set_device",
           "set_flags", "set_rng_state", "uint8", "unfold", "LazyGuard",
           "amp", "autograd", "device", "disable_signal_handler",
           "enable_grad", "get_cuda_rng_state", "grad", "incubate",
           "inference", "is_grad_enabled", "load", "metric", "models", "nn",
           "no_grad",
           "optimizer", "profiler", "save", "set_cuda_rng_state",
           "set_grad_enabled", "utils", "vision"] + ops.__all__
