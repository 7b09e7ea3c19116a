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
BatchNorm kernels, and mixed precision (``amp``: ``auto_cast`` O1 / O2,
``decorate``, ``GradScaler``) on the op registry of ``core/dispatch.py``
with the learning-rate schedulers (``optimizer.lr``) and gradient
clipping (``nn.clip``) (see ROADMAP.md for what is still to come).
"""
from ._device import resolve_device
from .core.flags import get_flag, set_flags
from .core.generator import seed

__all__ = ["get_flag", "resolve_device", "seed", "set_flags"]
