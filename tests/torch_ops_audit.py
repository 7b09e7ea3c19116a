"""The op audit's specs driven through both packages' op registries.

For one spec of ``tests/op_audit`` (the numpy inputs it builds, its
literal arguments and attributes) ``check_forward`` runs the reference's
registered op (``paddle_tpu``, its Pallas-free bodies, eager) and the
port's registered op of the same name (``paddle_tpu_torch``, on the CPU)
and holds every output of the port to the reference's: the same shape;
integer and bool values equal; float values within ``tolerance(spec)``;
and the dtype of ``want_dtypes``. The reference runs with x64 off, which
narrows every 64-bit dtype to 32 bits on its platform; the port keeps
Paddle's int64 and float64 where the caller or the op asks for them
(ROADMAP C, "64-bit dtypes"). So the reference runs once more with
``jax_enable_x64`` on, and its op says where that is: an integer result
takes the dtype of that run (int64 from argmax, from an int64 input,
int32 where the op or the caller asks for int32); a float or complex
result takes it only where the call asks for a 64-bit float (a float64
tensor or dtype argument), and is otherwise the dtype of the run with
x64 off, since with x64 on JAX's default float is float64 where Paddle's
is float32. The inputs reach the port as the harness gives them to the
reference, through ``to_tensor``'s rule: float64 host data become the
default dtype, float32, in both packages; int64 stays int64 in the port.
``check_grad`` takes one seeded cotangent per float output,
back-propagates ``sum(out * cotangent)`` through both packages and holds
the input gradients to each other.

The threefry key of the random specs (``jax.random.PRNGKey``) reaches the
port as its two words.
"""
from __future__ import annotations

import zlib

import jax
import numpy as np
import torch

import paddle_tpu as paddle
from op_audit import all_specs
from op_audit.harness import L, T, make_dispatcher
from paddle_tpu.core.dispatch import OP_REGISTRY as JREG
from paddle_tpu.core.tensor import Tensor as JTensor

import paddle_tpu_torch.ops  # noqa: F401  (registers the port's ops)
from paddle_tpu_torch.core.dispatch import OP_REGISTRY as PREG
from paddle_tpu_torch.core.dispatch import apply as papply

def specs_for(module: str):
    """The audit's specs whose op the reference registers in
    ``paddle_tpu/ops/<module>.py``."""
    return [s for s in all_specs()
            if JREG[s.op].fn.__module__ == f"paddle_tpu.ops.{module}"]


def registered_in(module: str):
    return sorted(n for n, o in JREG.items()
                  if o.fn.__module__ == f"paddle_tpu.ops.{module}")


def _is_key(a):
    return hasattr(a, "dtype") and str(a.dtype) == "uint32" and \
        tuple(getattr(a, "shape", ())) == (2,) and not isinstance(a, np.ndarray)


def _port_value(spec_arg, v, requires_grad):
    def one(item, x):
        x = np.array(x, copy=True)
        if x.dtype.name == "bfloat16":
            t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(x)
        if t.dtype == torch.float64:     # to_tensor: the default dtype
            t = t.float()
        if requires_grad and item.grad and t.is_floating_point():
            t.requires_grad_(True)
        return t

    if isinstance(spec_arg, T):
        return one(spec_arg, v)
    if isinstance(spec_arg, L):
        built = [one(it, x) for it, x in zip(spec_arg.items, v)]
        return tuple(built) if spec_arg.as_tuple else built
    if _is_key(v):
        return tuple(int(w) for w in np.asarray(v))
    return v


def port_args(spec, np_in, requires_grad=False):
    return [_port_value(a, v, requires_grad) for a, v in zip(spec.args, np_in)]


def _as_list(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _np_ref(x):
    return np.asarray(x._value) if isinstance(x, JTensor) else np.asarray(x)


def _np_port(x):
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy()


_WIDE_FLOATS = ("float64", "complex128")


def asks_f64(values) -> bool:
    """Whether a call's literal arguments (dtype names, numpy or torch
    dtypes, nested lists) ask for a 64-bit float."""
    stack = list(values)
    while stack:
        v = stack.pop()
        if isinstance(v, (list, tuple)):
            stack.extend(v)
        elif str(v).replace("torch.", "") in _WIDE_FLOATS or \
                getattr(v, "__name__", None) in _WIDE_FLOATS:
            return True
    return False


def want_dtypes(outs, fn, f64=False):
    """The dtype names the port must return for the reference's call
    ``fn()``, whose outputs with x64 off are ``outs`` (module docstring):
    each output's dtype with x64 on where it is an integer or ``f64`` (the
    call asks for a 64-bit float), else its dtype in ``outs``."""
    narrow = [str(_np_ref(o).dtype) for o in _as_list(outs)]
    with jax.enable_x64(True):
        wide = [str(_np_ref(o).dtype) for o in _as_list(fn())]
    return [w if f64 or w.startswith(("int", "uint")) else n
            for n, w in zip(narrow, wide)]


def port_dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


# forward tolerances (rtol, atol) by op; the default is rtol 1e-5, atol
# 1e-6 (both packages compute in f32; sums in other orders)
TOL = {}
DEFAULT_TOL = (1e-5, 1e-6)


def tolerance(spec):
    return TOL.get(spec.id, TOL.get(spec.op, DEFAULT_TOL))


def run_both(spec):
    """The reference's outputs (numpy), the dtypes the port must return,
    and the port's outputs, of one spec."""
    np_in = spec.build_inputs()

    def ref():
        return make_dispatcher(spec.op)(*spec.tensor_args(np_in),
                                        **spec.attrs)

    jouts = [_np_ref(o) for o in _as_list(ref())]
    f64 = asks_f64(list(spec.attrs.values()) + [
        v for a, v in zip(spec.args, np_in) if not isinstance(a, (T, L))])
    pouts = _as_list(papply(PREG[spec.op], *port_args(spec, np_in),
                            **spec.attrs))
    return jouts, want_dtypes(jouts, ref, f64), pouts


# outputs whose columns are singular or eigen vectors: defined up to sign,
# and the LAPACK routines of the two packages pick different signs; each of
# the port's columns is compared after taking the reference's sign
SIGN_FREE = {"svd": (0, 2), "eigh": (1,)}


def _align_columns(got, want):
    sign = np.sign(np.sum(got * want, axis=-2, keepdims=True))
    return got * np.where(sign == 0, 1, sign)


def compare(spec, jouts, want_dtypes, pouts, tol=None):
    rtol, atol = tol or tolerance(spec)
    assert len(pouts) == len(jouts), \
        f"{spec.id}: {len(pouts)} outputs, the reference {len(jouts)}"
    for i, (p, j, wd) in enumerate(zip(pouts, jouts, want_dtypes)):
        assert port_dtype(p) == wd, \
            f"{spec.id}[{i}]: dtype {port_dtype(p)}, the reference {wd}"
        assert tuple(p.shape) == tuple(j.shape), \
            f"{spec.id}[{i}]: shape {tuple(p.shape)}, the reference {j.shape}"
        got = _np_port(p)
        if i in SIGN_FREE.get(spec.op, ()):
            got = _align_columns(got, j)
        if j.dtype.kind in "fc":
            np.testing.assert_allclose(got, j.astype(got.dtype), rtol=rtol,
                                       atol=atol, err_msg=f"{spec.id}[{i}]")
        else:
            np.testing.assert_array_equal(got, j.astype(got.dtype),
                                          err_msg=f"{spec.id}[{i}]")


def check_forward(spec, tol=None):
    compare(spec, *run_both(spec), tol)


def _projections(spec, outs):
    rng = np.random.default_rng(zlib.adler32((spec.id + "/cot").encode()))
    projs = []
    for o in outs:
        if o.dtype.kind == "f":
            projs.append((rng.standard_normal(o.shape).astype(np.float32),))
        elif o.dtype.kind == "c":
            projs.append((rng.standard_normal(o.shape).astype(np.float32),
                          rng.standard_normal(o.shape).astype(np.float32)))
        else:
            projs.append(None)
    return projs


def _grad_slots(spec, np_in):
    slots = []
    for pos, a in enumerate(spec.args):
        items = [(None, a)] if isinstance(a, T) else (
            list(enumerate(a.items)) if isinstance(a, L) else [])
        for sub, it in items:
            v = np.asarray(np_in[pos] if sub is None else np_in[pos][sub])
            if it.grad and v.dtype.kind == "f":
                slots.append((pos, sub))
    return slots


def check_grad(spec, rtol=1e-4, atol=1e-5):
    """The input gradients of sum(out * cotangent) in both packages."""
    np_in = spec.build_inputs()
    jts = spec.tensor_args(np_in, stop_gradient=False)
    jouts = _as_list(make_dispatcher(spec.op)(*jts, **spec.attrs))
    projs = _projections(spec, [_np_ref(o) for o in jouts])
    loss = None
    for o, p in zip(jouts, projs):
        if p is None:
            continue
        if _np_ref(o).dtype.kind == "c":
            term = (paddle.real(o) * paddle.to_tensor(p[0])).sum() + \
                (paddle.imag(o) * paddle.to_tensor(p[1])).sum()
        else:
            term = (o * paddle.to_tensor(p[0].astype(_np_ref(o).dtype))).sum()
        loss = term if loss is None else loss + term
    if loss is None:
        return          # no float output to differentiate
    loss.backward()

    pts = port_args(spec, np_in, requires_grad=True)
    pouts = _as_list(papply(PREG[spec.op], *pts, **spec.attrs))
    ploss = 0
    for o, p in zip(pouts, projs):
        if p is None:
            continue
        if o.is_complex():
            ploss = ploss + (o.real * torch.from_numpy(p[0])).sum() + \
                (o.imag * torch.from_numpy(p[1])).sum()
        else:
            ploss = ploss + (o * torch.from_numpy(p[0]).to(o.dtype)).sum()
    if isinstance(ploss, torch.Tensor) and ploss.requires_grad:
        ploss.backward()
    for pos, sub in _grad_slots(spec, np_in):
        jt = jts[pos] if sub is None else jts[pos][sub]
        pt = pts[pos] if sub is None else pts[pos][sub]
        want = np.asarray(jt.grad._value)
        # an input the output does not depend on: torch leaves no
        # gradient, the reference holds zeros
        got = np.zeros_like(want) if pt.grad is None else pt.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=atol,
                                   err_msg=f"{spec.id}: gradient {pos}/{sub}")


def cpu_place():
    """A pytest fixture body: the port's creation and random ops make CPU
    tensors while a test module runs (the default place is the card).
    The reference's place is put back too: its ``set_device`` (and its
    ``Layer.to``) leave an explicit one-device place behind in the worker
    process, which the later tests of its sharded models refuse."""
    from paddle_tpu.core import place as jplace
    from paddle_tpu_torch.core import place as pplace
    prev = pplace._CURRENT_PLACE[0]
    jprev = (jplace._CURRENT_PLACE[0], jplace._PLACE_EXPLICIT[0])
    pplace.set_device("cpu")
    yield
    pplace._CURRENT_PLACE[0] = prev
    jplace._CURRENT_PLACE[0], jplace._PLACE_EXPLICIT[0] = jprev


def ids(specs):
    return [s.id for s in specs]


def uncovered(module, specs, left_out=()):
    """Ops registered in the reference's ops/<module>.py with neither a
    spec here nor an entry in ``left_out``."""
    return sorted(set(registered_in(module)) - {s.op for s in specs}
                  - set(left_out))
