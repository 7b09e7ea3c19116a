"""The port's op registry against the reference's, op for op.

Every op that the reference registers from ``paddle_tpu/ops/`` (281:
219 promote, 54 black, 8 white) is registered by the port under the same
name, AMP category, ``multi_out`` and ``differentiable`` flag, by the
module of the same name under ``paddle_tpu_torch/ops/``, and no other
module of the port registers the name over it (the whole package is
imported first). Every registered op is reachable from the package's top
level or from ``paddle_tpu_torch.ops`` as the reference's is.
"""
import collections
import importlib
import pkgutil

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
    "create_parameter": "resolves nn.initializer classes and static-mode "
                        "programs, not ported",
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
