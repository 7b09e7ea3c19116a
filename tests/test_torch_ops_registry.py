"""The port's op registry against the reference's, op for op.

Every op that the reference registers from ``paddle_tpu/ops/`` (281:
219 promote, 54 black, 8 white) is registered by the port under the same
name, AMP category, ``multi_out`` and ``differentiable`` flag, by the
module of the same name under ``paddle_tpu_torch/ops/``, and no other
module of the port registers the name over it (the whole package is
imported first). Every registered op is reachable from the package's top
level or from ``paddle_tpu_torch.ops`` as the reference's is. The same
holds for the 121 ops the reference registers under ``nn/``,
``metric/``, ``incubate/optimizer/`` and ``amp/``; and every public name
of ``paddle_tpu.nn``, ``nn.functional``, ``nn.initializer``,
``nn.utils``, ``metric``, ``incubate.optimizer`` and ``amp.debugging``
is a name of the port's module too, those of ``LATER`` raising
NotImplementedError naming their ROADMAP item when used.
"""
import collections
import importlib
import pkgutil

import pytest

import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu  # noqa: F401  (registers the reference's ops)
from paddle_tpu.core.dispatch import OP_REGISTRY as JREG

import paddle_tpu_torch
from paddle_tpu_torch.core.dispatch import OP_REGISTRY as PREG


def _import_the_port():
    for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                   "paddle_tpu_torch."):
        importlib.import_module(m.name)


def _reference_ops():
    return {n: o for n, o in JREG.items()
            if o.fn.__module__.startswith("paddle_tpu.ops.")}


def test_every_reference_op_is_registered_alike():
    _import_the_port()
    ref = _reference_ops()
    assert len(ref) == 281
    cats = collections.Counter(o.amp for o in ref.values())
    assert cats == {"promote": 219, "black": 54, "white": 8}
    missing, differ = [], []
    for name, jop in sorted(ref.items()):
        pop = PREG.get(name)
        if pop is None:
            missing.append(name)
            continue
        want = (jop.amp, jop.multi_out, jop.differentiable,
                jop.fn.__module__.replace("paddle_tpu.", "paddle_tpu_torch."))
        got = (pop.amp, pop.multi_out, pop.differentiable, pop.fn.__module__)
        if got != want:
            differ.append((name, got, want))
    assert missing == [] and differ == []
    print(f"{len(ref)} ops of paddle_tpu/ops/ registered alike in the port")


# the reference's public names that the port does not carry, and why
LEFT_OUT = {
    "binomial": "draws through distribution/, not ported yet",
    "builtins_slice": "a helper of manipulation.py leaked by its star "
                      "import, not an op",
    "builtins_slice_all": "the same",
}


def test_the_public_names_are_the_reference_names():
    """Every function of ``paddle_tpu.ops`` that ``paddle_tpu`` exports at
    its top level is exported by ``paddle_tpu_torch`` too."""
    import paddle_tpu as paddle
    def from_ops(v):
        fn = v.opdef.fn if hasattr(v, "opdef") else v
        return (getattr(fn, "__module__", "") or "").startswith(
            "paddle_tpu.ops")

    names = [n for n in dir(paddle) if not n.startswith("_")
             and callable(getattr(paddle, n))
             and not isinstance(getattr(paddle, n), type)
             and from_ops(getattr(paddle, n))]
    missing = sorted(n for n in names
                     if not hasattr(paddle_tpu_torch, n) and n not in LEFT_OUT)
    assert missing == []
    print(f"{len(names)} public names of paddle_tpu.ops at the top level")


_OUTSIDE_OPS = ("paddle_tpu.nn.", "paddle_tpu.metric", "paddle_tpu.amp",
                "paddle_tpu.incubate.optimizer")


def test_every_reference_nn_op_is_registered_alike():
    _import_the_port()
    ref = {n: o for n, o in JREG.items()
           if o.fn.__module__.startswith(_OUTSIDE_OPS)}
    assert len(ref) == 121
    missing, differ = [], []
    for name, jop in sorted(ref.items()):
        pop = PREG.get(name)
        if pop is None:
            missing.append(name)
            continue
        want = (jop.amp, jop.multi_out, jop.differentiable,
                jop.fn.__module__.replace("paddle_tpu.", "paddle_tpu_torch."))
        got = (pop.amp, pop.multi_out, pop.differentiable, pop.fn.__module__)
        if got != want:
            differ.append((name, got, want))
    assert missing == [] and differ == []


# the reference's names that wait for a later item: each raises
# NotImplementedError naming it when called (a layer: when constructed)
LATER = {
    **dict.fromkeys(
        ("nn.AdaptiveAvgPool1D", "nn.AdaptiveMaxPool1D",
         "nn.AdaptiveMaxPool2D", "nn.AvgPool1D", "nn.AvgPool2D",
         "nn.AvgPool3D", "nn.MaxPool1D", "nn.MaxPool3D", "nn.Conv1D",
         "nn.Conv1DTranspose", "nn.Conv2DTranspose", "nn.Conv3D",
         "nn.Conv3DTranspose", "nn.functional.adaptive_avg_pool1d",
         "nn.functional.adaptive_max_pool1d",
         "nn.functional.adaptive_max_pool2d", "nn.functional.avg_pool1d",
         "nn.functional.avg_pool2d", "nn.functional.avg_pool3d",
         "nn.functional.max_pool1d", "nn.functional.max_pool3d",
         "nn.functional.conv1d", "nn.functional.conv1d_transpose",
         "nn.functional.conv2d_transpose", "nn.functional.conv3d",
         "nn.functional.conv3d_transpose",
         "nn.functional.sparse_attention"), "A11"),
    "nn.SyncBatchNorm": "A10",
}


def _public(module):
    """The reference module's own public names: not the modules, the
    typing and numpy names or the core helpers its star imports carry."""
    import types
    out = []
    for n in dir(module):
        v = getattr(module, n)
        if n.startswith("_") or n == "annotations" or \
                isinstance(v, types.ModuleType):
            continue
        owner = getattr(v, "__module__", "") or ""
        if hasattr(v, "opdef"):
            owner = v.opdef.fn.__module__
        if not owner.startswith("paddle_tpu") or (
                owner.startswith("paddle_tpu.core") and n != "Parameter"):
            continue
        out.append(n)
    return out


@pytest.mark.parametrize("path", ["nn", "nn.functional", "nn.initializer",
                                  "nn.utils", "metric", "incubate.optimizer",
                                  "amp.debugging"])
def test_the_namespaces_carry_the_reference_names(path):
    ref = importlib.import_module("paddle_tpu." + path)
    port = importlib.import_module("paddle_tpu_torch." + path)
    names = _public(ref)
    assert names
    assert sorted(n for n in names if not hasattr(port, n)) == []
    for key, item in LATER.items():
        where, _, name = key.rpartition(".")
        if where != path:
            continue
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            getattr(port, name)(*([None] * 5))
