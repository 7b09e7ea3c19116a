"""The port's autograd API (``paddle_tpu_torch.autograd_api``,
``core/engine.py``) against the JAX reference.

Each case is a function of the package (``paddle_tpu`` or
``paddle_tpu_torch``, imported as ``paddle``) that runs the reference's
own autograd cases (``tests/test_autograd.py``: diamond, shared
intermediate, stop_gradient, detach, hooks, retain_graph, ``paddle.grad``
of leaf and non-leaf inputs, ``no_grad_vars``, ``allow_unused``, PyLayer,
vjp / jvp) and ``tests/test_higher_order_grad.py``'s ``create_graph``
cases, and returns its numbers; both packages run it on the same inputs
(a numpy seed) and must agree to rtol 1e-5 / atol 1e-6 (f32, the same
arithmetic in other kernels). Errors are held to the reference's type and
message. Through the fused kernels (LayerNorm, BatchNorm, flash
attention, the fused MLPs, projection-LN) a second derivative raises
naming the kernel's backward op, and so does ``jvp``: the reference
raises there too (its Pallas kernels have no derivative of their own).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as jpaddle
import paddle_tpu_torch as ppaddle
import torch_ops_audit as A

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def cpu_place():
    yield from A.cpu_place()


def _np(t):
    if t is None or isinstance(t, np.ndarray):
        return t
    return np.asarray(t.numpy(), np.float64)


def _t(paddle, a, sg=False):
    return paddle.to_tensor(np.asarray(a, np.float32), stop_gradient=sg)


# ---------------------------------------------------------------------------
# the cases: paddle → numbers
# ---------------------------------------------------------------------------

def c_simple_backward(paddle):
    x = _t(paddle, [1.0, 2.0, 3.0])
    (x * x).sum().backward()
    return [x.grad]


def c_accumulation(paddle):
    x = _t(paddle, [1.0])
    (x * 2).backward()
    (x * 3).backward()
    g = _np(x.grad)
    x.clear_grad()
    assert x.grad is None
    return [g]


def c_diamond(paddle):
    x = _t(paddle, [3.0])
    a, b = x * 2, x * 5
    (a + b).backward()
    return [x.grad]


def c_shared_intermediate(paddle):
    x = _t(paddle, [2.0])
    a = x * x
    (a * a).backward()
    return [x.grad]


def c_stop_gradient(paddle):
    x, y = _t(paddle, [1.0]), _t(paddle, [2.0], sg=True)
    (x * y).backward()
    assert y.grad is None
    return [x.grad]


def c_detach(paddle):
    x = _t(paddle, [1.0])
    out = (x * 3).detach() * 5
    assert out.stop_gradient
    return [out]


def c_no_grad(paddle):
    x = _t(paddle, [1.0])
    with paddle.no_grad():
        y = x * 2
    assert y.stop_gradient

    @paddle.no_grad()
    def f(t):
        return t * 2

    assert f(x).stop_gradient
    assert paddle.is_grad_enabled()
    with paddle.set_grad_enabled(False):
        assert not paddle.is_grad_enabled()
        with paddle.enable_grad():
            z = x * 4
        assert not z.stop_gradient
    return [y, z]


def c_non_scalar_backward(paddle):
    x = _t(paddle, [1.0, 2.0])
    with pytest.raises(RuntimeError):
        (x * 2).backward()
    (x * 2).backward(paddle.to_tensor([1.0, 10.0]))
    return [x.grad]


def c_grad_leaf(paddle):
    x = _t(paddle, [1.0, 2.0])
    (gx,) = paddle.grad((x ** 3).sum(), [x])
    assert x.grad is None
    return [gx]


def c_grad_non_leaf(paddle):
    x = _t(paddle, [2.0])
    a = x * 3
    (ga,) = paddle.grad(a * a, [a])
    return [ga]


def c_grad_outputs(paddle):
    rng = np.random.default_rng(0)
    x = _t(paddle, rng.standard_normal(4))
    y = x * x
    (g,) = paddle.grad([y], [x], grad_outputs=[
        paddle.to_tensor(rng.standard_normal(4).astype(np.float32))])
    return [g]


def c_retain_graph(paddle):
    x = _t(paddle, [1.0])
    y = x * x
    y.backward(retain_graph=True)
    y.backward()
    return [x.grad]


def c_register_hook(paddle):
    x = _t(paddle, [1.0])
    seen = []

    def hook(g):
        seen.append(np.asarray(g, np.float64))
        return g * 10

    x.register_hook(hook)
    (x * 2).backward()
    assert len(seen) == 1
    return [x.grad, seen[0]]


def c_multi_output(paddle):
    x = _t(paddle, [[5.0, 1.0, 3.0]])
    v, _ = paddle.topk(x, 2)
    v.sum().backward()
    return [x.grad]


def c_matmul_broadcast(paddle):
    rng = np.random.default_rng(1)
    a = _t(paddle, rng.standard_normal((3, 4)))
    b = _t(paddle, rng.standard_normal((4, 5)))
    c = _t(paddle, rng.standard_normal(5))
    (paddle.matmul(a, b) + c).sum().backward()
    return [a.grad, b.grad, c.grad]


def c_no_grad_vars(paddle):
    x = _t(paddle, [2.0])
    h = x * x
    (g,) = paddle.grad((h * x).sum(), x, no_grad_vars=[h])
    return [g]


def c_no_grad_vars_diamond(paddle):
    """A diamond: x → a, b → c; cutting a leaves only b's path; an input
    reached only through the cut is unreached (None)."""
    rng = np.random.default_rng(2)
    x = _t(paddle, rng.standard_normal(3))
    w = _t(paddle, rng.standard_normal(3))
    a = paddle.tanh(x) * w
    b = x * x
    c = (a * b).sum() + (b * 3).sum()
    gx, gw = paddle.grad(c, [x, w], no_grad_vars=[a], allow_unused=True,
                         retain_graph=True)
    assert gw is None
    return [gx]


def c_allow_unused(paddle):
    x, u = _t(paddle, [1.0, 2.0]), _t(paddle, [5.0])
    y = (x * 2).sum()
    gx, gu = paddle.grad(y, [x, u], allow_unused=True, retain_graph=True)
    assert gu is None
    with pytest.raises(ValueError) as unreached:
        paddle.grad(y, [x, u], retain_graph=True)
    with pytest.raises(ValueError) as stopped:
        paddle.grad(y, [x, _t(paddle, [1.0], sg=True)])
    return [gx, unreached.value.args[0], stopped.value.args[0]]


def _double(paddle):
    class Double(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale=2.0):
            ctx.save_for_backward(x)
            ctx.scale = scale
            return x * scale

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * ctx.scale

    return Double


def c_pylayer(paddle):
    x = _t(paddle, [3.0, -1.0])
    y = _double(paddle).apply(x, scale=3.0)
    (y * y).sum().backward()
    return [y, x.grad]


def c_pylayer_two_inputs(paddle):
    class Mul(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            ctx.mark_non_differentiable()
            ctx.set_materialize_grads(False)
            return a * b, a + b

        @staticmethod
        def backward(ctx, gp, gs):
            a, b = ctx.saved_tensor()
            return gp * b + gs, gp * a + gs

    rng = np.random.default_rng(3)
    a, b = (_t(paddle, rng.standard_normal(3)) for _ in range(2))
    p, s = Mul.apply(a, b)
    (p * 2 + s * s).sum().backward()
    return [p, s, a.grad, b.grad]


def c_vjp_jvp(paddle):
    def f(x):
        return (x ** 2).sum()

    x = _t(paddle, [1.0, 2.0])
    out, g = paddle.autograd.vjp(f, x)
    out2, jv = paddle.autograd.jvp(f, x)
    rng = np.random.default_rng(4)
    xs = [_t(paddle, rng.standard_normal(3)) for _ in range(2)]
    v = paddle.to_tensor(rng.standard_normal(3).astype(np.float32))
    o3, gs = paddle.autograd.vjp(lambda a, b: paddle.tanh(a) * b, xs, v)
    _, jv3 = paddle.autograd.jvp(lambda a, b: paddle.tanh(a) * b, xs,
                                 [v, v])
    return [out, g, out2, jv, o3, gs[0], gs[1], jv3]


def c_functional_jacobian_hessian(paddle):
    x = _t(paddle, [0.5, -1.0, 2.0])
    jac = paddle.autograd.functional_jacobian(lambda v: paddle.sin(v) * v, x)
    hess = paddle.autograd.functional_hessian(
        lambda v: (paddle.exp(v) * v).sum(), x)
    for name in ("jacobian", "hessian"):
        with pytest.raises(NotImplementedError):
            getattr(paddle.autograd, name)(x, x)
    return [jac, hess]


_HIGHER = [
    lambda p, x: (x * x * x).sum(),
    lambda p, x: p.exp(x).sum(),
    lambda p, x: p.sin(x).sum(),
    lambda p, x: (p.tanh(x) * x).sum(),
    lambda p, x: p.log(x * x + 1.0).sum(),
]


def c_grad_of_grad(paddle):
    out = []
    for fn in _HIGHER:
        x = _t(paddle, [0.3, -0.7, 1.2])
        (g1,) = paddle.grad(fn(paddle, x), x, create_graph=True)
        (g2,) = paddle.grad(g1.sum(), x)
        out += [g1, g2]
    return out


def c_third_order(paddle):
    x = _t(paddle, [0.5, 1.5])
    (g1,) = paddle.grad((x ** 4).sum(), x, create_graph=True)
    (g2,) = paddle.grad(g1.sum(), x, create_graph=True)
    (g3,) = paddle.grad(g2.sum(), x)
    return [g1, g2, g3]


def c_gradient_penalty(paddle):
    w = _t(paddle, np.random.default_rng(0).standard_normal((4, 1)) * 0.5)
    x = _t(paddle, np.random.default_rng(1).standard_normal((8, 4)))
    (gx,) = paddle.grad(paddle.matmul(x, w).sum(), x, create_graph=True)
    (((gx * gx).sum() - 1.0) ** 2).backward()
    return [gx, w.grad]


def c_create_graph_matmul(paddle):
    x = _t(paddle, np.random.default_rng(3).standard_normal((3, 3)))
    (g1,) = paddle.grad(paddle.matmul(x, x).sum(), x, create_graph=True)
    (g2,) = paddle.grad((g1 * g1).sum(), x)
    return [g1, g2]


def c_create_graph_unused_and_nonleaf(paddle):
    x, z, u = _t(paddle, [1.0, 2.0]), _t(paddle, [3.0, 4.0]), _t(paddle, [5.0])
    gx, gz, gu = paddle.grad((x * z).sum(), [x, z, u], create_graph=True,
                             allow_unused=True)
    assert gu is None
    (g2z,) = paddle.grad((gx * gx).sum(), z)
    h = x * 2.0
    (gh,) = paddle.grad((h ** 3).sum(), h, create_graph=True)
    (g2x,) = paddle.grad(gh.sum(), x)
    with pytest.raises(ValueError) as unreached:
        paddle.grad((x * 2).sum(), [x, u], create_graph=True)
    with pytest.raises(ValueError) as stopped:
        paddle.grad((x * 2).sum(), [_t(paddle, [1.0], sg=True)],
                    create_graph=True)
    return [gx, gz, g2z, gh, g2x, unreached.value.args[0],
            stopped.value.args[0]]


def c_create_graph_network(paddle):
    rng = np.random.default_rng(5)
    w = _t(paddle, rng.standard_normal((4, 4)) * 0.5)
    b = _t(paddle, rng.standard_normal(4) * 0.1)
    x = _t(paddle, rng.standard_normal((2, 4)))
    y = paddle.nn.functional.gelu(paddle.matmul(x, w) + b).sum()
    (gx,) = paddle.grad(y, x, create_graph=True)
    (ggx,) = paddle.grad((gx ** 2).sum(), x)
    return [gx, ggx]


def c_create_graph_no_grad_vars(paddle):
    x = _t(paddle, [2.0])
    h = x * x
    (g,) = paddle.grad((h * x).sum(), x, create_graph=True, no_grad_vars=[h])
    x2 = _t(paddle, [2.0])
    top = paddle.topk(paddle.concat([x2 * 3, x2 * 2]), k=2)
    (g2,) = paddle.grad((top[0] * x2).sum(), x2, create_graph=True,
                        no_grad_vars=[top[0]])
    return [g, g2]


def c_deep_chain(paddle):
    x = _t(paddle, [1.0001])
    y = x
    for _ in range(300):
        y = y * 1.001
    (g,) = paddle.grad(y.sum(), x, create_graph=True)
    return [g]


def c_pylayer_create_graph(paddle):
    x = _t(paddle, [1.0, 2.0])
    y = _double(paddle).apply(x).sum()
    with pytest.raises(NotImplementedError, match="replayable forward"):
        paddle.grad(y, x, create_graph=True)
    return []


CASES = {name[2:]: fn for name, fn in list(globals().items())
         if name.startswith("c_")}


def _flat(vals):
    return [v if isinstance(v, str) else _np(v) for v in vals]


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_the_reference(case):
    want = _flat(CASES[case](jpaddle))
    got = _flat(CASES[case](ppaddle))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, str):
            assert g == w, (case, i)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case}[{i}]")


def test_grad_mode_is_torch_grad_mode_and_thread_local():
    from paddle_tpu_torch.core import engine
    import threading
    assert engine.is_grad_enabled() and torch.is_grad_enabled()
    with engine.no_grad_guard():
        assert not torch.is_grad_enabled()
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            engine.is_grad_enabled()))
        t.start()
        t.join()
        assert seen == [True]
        with engine.enable_grad_guard():
            assert torch.is_grad_enabled()
        assert not ppaddle.is_grad_enabled()
    assert ppaddle.is_grad_enabled()


def test_no_grad_vars_hooks_are_removed():
    """The cut holds for that call only: the next backward through the
    same tensor sees its cotangent again."""
    x = _t(ppaddle, [2.0])
    h = x * x
    y = (h * x).sum()
    (g,) = ppaddle.grad(y, x, no_grad_vars=[h], retain_graph=True)
    (g_full,) = ppaddle.grad(y, x, retain_graph=True)
    assert float(g) == 4.0 and float(g_full) == 12.0
    # an input reached only through the cut is unreached, not zero
    with pytest.raises(ValueError, match="input 0 is not reachable"):
        ppaddle.grad(y, h, no_grad_vars=[h])


# ---------------------------------------------------------------------------
# the fused kernels: first derivatives go through, second ones raise
# ---------------------------------------------------------------------------

def _fused_cases():
    """op → (the fused function of x, with its other operands drawn once,
    x's shape)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    from paddle_tpu_torch.kernels import norm_fusion as nf
    rng = np.random.default_rng(6)

    def r(*s, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(s) * scale).astype(np.float32))

    w, b, k, v = r(64), r(64), r(1, 16, 2, 32), r(1, 16, 2, 32)
    g8, b8 = r(8), r(8)
    w1, b1, w2, b2 = r(64, 128, scale=0.1), r(128), r(128, 64, scale=0.1), \
        r(64)
    wg, wu = r(64, 128, scale=0.1), r(64, 128, scale=0.1)
    wp, bp, res = r(64, 64, scale=0.1), r(64), r(8, 64)
    return {
        "fused_ln_bwd": (lambda x: nf.fused_layer_norm_2d(x, w, b), (8, 64)),
        "fused_bn_bwd": (lambda x: nf.fused_batch_norm_train(
            x, g8, b8, fuse_relu=True)[0], (2, 8, 4, 4)),
        "flash_bwd": (lambda x: fa.flash_attention_bshd(x, k, v),
                      (1, 16, 2, 32)),
        "fused_mlp_bwd": (lambda x: mf.fused_mlp_2d(x, w1, b1, w2, b2),
                          (8, 64)),
        "fused_swiglu_bwd": (lambda x: mf.fused_swiglu_2d(x, wg, wu, w2),
                             (8, 64)),
        "fused_proj_ln_grads": (lambda x: mf.fused_proj_ln_2d(
            x, wp, bp, res, w, b), (8, 64)),
    }


FUSED = ["fused_ln_bwd", "fused_bn_bwd", "flash_bwd", "fused_mlp_bwd",
         "fused_swiglu_bwd", "fused_proj_ln_grads"]


@pytest.mark.parametrize("op", FUSED)
def test_second_derivative_through_a_fused_kernel_raises(op):
    fn, shape = _fused_cases()[op]
    rng = np.random.default_rng(7)
    # the kernels' wrappers take plain tensors (the functionals unwrap)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x.requires_grad_(True)
    y = fn(x)
    c = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(
        np.float32))

    def plain(t):
        return torch.Tensor.as_subclass(t, torch.Tensor).detach()

    (g,) = ppaddle.grad((y * y * c).sum(), x, create_graph=True)
    (g_ref,) = torch.autograd.grad((fn(x) * fn(x) * c).sum(), x)
    torch.testing.assert_close(plain(g), g_ref)
    with pytest.raises(RuntimeError, match=f"{op}.*no autograd formula"):
        ppaddle.grad((plain(g) * 0 + g * g).sum(), x)
    def f(v):
        return (fn(torch.Tensor.as_subclass(v, torch.Tensor)) * c).sum()

    with pytest.raises(RuntimeError, match=f"{op}.*no autograd formula"):
        ppaddle.autograd.jvp(f, x)
    (g1,) = torch.autograd.grad((fn(x) * c).sum(), x)
    _, gv = ppaddle.autograd.vjp(f, x)
    torch.testing.assert_close(plain(gv), g1)


def test_the_reference_fails_there_too():
    """The reference's interpret-mode LayerNorm kernel: its create_graph
    replay and its jvp both fail (a Pallas kernel has no JVP rule)."""
    jF = jpaddle.nn.functional
    old = (jpaddle.get_flags("FLAGS_fused_norm")["FLAGS_fused_norm"],
           jpaddle.get_flags("FLAGS_fused_norm_interpret")[
               "FLAGS_fused_norm_interpret"])
    jpaddle.set_flags({"FLAGS_fused_norm": True,
                       "FLAGS_fused_norm_interpret": True})
    try:
        rng = np.random.default_rng(8)
        x = _t(jpaddle, rng.standard_normal((8, 128)))
        w = _t(jpaddle, np.ones(128))
        b = _t(jpaddle, np.zeros(128))
        y = jF.layer_norm(x, 128, w, b)
        with pytest.raises(Exception):
            jpaddle.grad((y * y).sum(), x, create_graph=True)
        with pytest.raises(Exception):
            jpaddle.autograd.jvp(lambda v: jF.layer_norm(v, 128, w, b).sum(),
                                 x)
    finally:
        jpaddle.set_flags({"FLAGS_fused_norm": old[0],
                           "FLAGS_fused_norm_interpret": old[1]})
