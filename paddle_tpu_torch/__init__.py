"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

Counterpart: ``paddle_tpu/__init__.py``. The port mirrors the JAX
package's paths and names module by module; each module's docstring
names its counterpart. It imports ``torch`` and never ``jax`` or
``paddle_tpu`` (tests/test_torch_isolation.py holds that). Every TPU
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
``framework``, ``base.ParamAttr`` and ``core/strings.py``. The names below
are the user's entry points, as ``paddle_tpu``'s are
(``paddle_tpu_torch.to_tensor``, ``.matmul``, ``.where``, ...); see
ROADMAP.md for what is still to come.
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

bool = bool_  # noqa: A001

__all__ = ["CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "CustomPlace",
           "Generator", "ParamAttr", "Parameter", "Place", "TPUPlace",
           "Tensor", "XPUPlace", "base", "bfloat16", "bool", "complex64",
           "complex128", "float16", "float32", "float64", "framework",
           "get_default_dtype", "get_device", "get_flag", "get_rng_state",
           "in_dynamic_mode", "int8", "int16", "int32", "int64",
           "is_compiled_with_cuda", "is_tensor", "mm", "ops",
           "resolve_device", "seed", "set_default_dtype", "set_device",
           "set_flags", "set_rng_state", "uint8", "unfold"] + ops.__all__
