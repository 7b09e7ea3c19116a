"""The port's Tensor facade (``core/tensor.py`` with the methods and
operators of ``ops/__init__.py``) against the reference's ``Tensor``.

The same numpy inputs go through both packages' user surface:
- operators (arithmetic with tensors and Python numbers on either side,
  comparisons, logical and bitwise, ``@``, unary), methods under Paddle's
  names and signatures (``sum(axis=)``, ``transpose(perm)``,
  ``split``, ``max``, ``gather``, ``astype`` ...), in-place methods,
  ``x[idx]`` and ``x[idx] = v``: values (floats at rtol 1e-6, atol 1e-7;
  the rest exact), dtypes (the 64-bit rule of ROADMAP C) and shapes;
- ``stop_gradient``, ``.grad`` after ``backward``, ``clear_grad``,
  ``register_hook``, ``detach``, ``place``, ``numpy``, ``item``;
- a facade passes through the op registry as a plain tensor and comes
  back as a facade; a plain tensor stays plain;
- each ported model's entry point (BERT, GPT, LLaMA, ResNet, PP-YOLOE at
  small sizes on the CPU) gives the same result for facade inputs as for
  plain ones, and an optimizer steps facade parameters.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as paddle
import paddle_tpu_torch as pt
import torch_ops_audit as A
from paddle_tpu_torch.core import dispatch as pdispatch


@pytest.fixture(scope="module", autouse=True)
def cpu_place():
    yield from A.cpu_place()


RNG = np.random.default_rng(7)
X = RNG.standard_normal((3, 4)).astype(np.float32)
Y = (RNG.standard_normal((3, 4)).astype(np.float32) + 0.1)
I = RNG.integers(-6, 7, (3, 4)).astype(np.int32)
J = np.where(RNG.random((3, 4)) < 0.5, -1, 1).astype(np.int32) * \
    RNG.integers(1, 5, (3, 4)).astype(np.int32)
B = RNG.random((3, 4)) < 0.5


def _both(fn):
    """The reference's result of ``fn``, the port's, and the dtypes the
    port must return (``torch_ops_audit.want_dtypes``)."""
    def ref():
        return fn(paddle, lambda a: paddle.to_tensor(a))

    j = ref()
    p = fn(pt, lambda a: pt.to_tensor(a))
    return j, p, A.want_dtypes(j, ref)


def _check(j, p, want=None, exact=False):
    """``p`` holds the reference's ``j``: shapes, values, and the dtypes
    ``want`` (default: the reference's own)."""
    js = j if isinstance(j, (list, tuple)) else [j]
    ps = p if isinstance(p, (list, tuple)) else [p]
    want = want or [str(np.asarray(jj.numpy()).dtype) for jj in js]
    assert len(js) == len(ps) == len(want)
    for jj, pp, wd in zip(js, ps, want):
        assert isinstance(pp, pt.Tensor), type(pp)
        w = np.asarray(jj.numpy())
        assert pp.shape == list(w.shape)
        assert A.port_dtype(pp) == wd, (pp.dtype, wd)
        g = pp.numpy()
        if w.dtype.kind in "fc" and not exact:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype))


OPERATORS = [
    ("add", lambda m, t: t(X) + t(Y)),
    ("radd-scalar", lambda m, t: 2.5 + t(X)),
    ("sub", lambda m, t: t(X) - t(Y)),
    ("rsub-scalar", lambda m, t: 1.0 - t(X)),
    ("mul-scalar", lambda m, t: t(X) * -3.0),
    ("rmul-scalar", lambda m, t: 0.5 * t(X)),
    ("truediv", lambda m, t: t(X) / t(Y)),
    ("rtruediv", lambda m, t: 2.0 / t(Y)),
    ("int-truediv", lambda m, t: t(I) / t(J)),
    ("floordiv", lambda m, t: t(I) // t(J)),
    ("mod", lambda m, t: t(I) % t(J)),
    ("float-mod", lambda m, t: t(X) % 0.7),
    ("pow", lambda m, t: t(Y).abs() ** 1.5),
    ("rpow", lambda m, t: 2.0 ** t(X)),
    ("matmul", lambda m, t: t(X) @ t(Y).transpose([1, 0])),
    ("neg", lambda m, t: -t(X)),
    ("abs", lambda m, t: abs(t(X))),
    ("eq", lambda m, t: t(I) == t(J)),
    ("ne-scalar", lambda m, t: t(I) != 2),
    ("lt", lambda m, t: t(X) < t(Y)),
    ("le", lambda m, t: t(X) <= 0.0),
    ("gt", lambda m, t: t(X) > t(Y)),
    ("ge", lambda m, t: t(I) >= 0.5),
    ("invert-bool", lambda m, t: ~t(B)),
    ("and-bool", lambda m, t: t(B) & t(~B)),
    ("or-int", lambda m, t: t(I) | t(J)),
    ("xor-int", lambda m, t: t(I) ^ t(J)),
    ("iadd", lambda m, t: _iadd(t(X), t(Y))),
]


def _iadd(a, b):
    a += b
    return a


@pytest.mark.parametrize("case", OPERATORS, ids=[c[0] for c in OPERATORS])
def test_operator_matches_the_reference(case):
    _check(*_both(case[1]))


METHODS = [
    ("sum-axis", lambda m, t: t(X).sum(axis=1)),
    ("sum-keepdim", lambda m, t: t(X).sum(axis=[0, 1], keepdim=True)),
    ("mean", lambda m, t: t(X).mean()),
    ("max", lambda m, t: t(X).max()),
    ("max-axis", lambda m, t: t(X).max(axis=0)),
    ("argmax", lambda m, t: t(X).argmax(axis=1)),
    ("transpose", lambda m, t: t(X).transpose([1, 0])),
    ("reshape", lambda m, t: t(X).reshape([2, 6])),
    ("flatten", lambda m, t: t(X).reshape([3, 2, 2]).flatten(1)),
    ("split", lambda m, t: t(X).split(2, axis=1)),
    ("split-sections", lambda m, t: t(X).split([1, -1], axis=1)),
    ("chunk", lambda m, t: t(X).chunk(3, axis=0)),
    ("unbind", lambda m, t: t(X).unbind(1)),
    ("gather", lambda m, t: t(X).gather(t(np.array([2, 0], np.int64)))),
    ("index_select", lambda m, t: t(X).index_select(
        t(np.array([3, 1], np.int64)), axis=1)),
    ("astype", lambda m, t: t(X).astype("int32")),
    ("cast-bf16", lambda m, t: t(X).cast("bfloat16").astype("float32")),
    ("unsqueeze", lambda m, t: t(X).unsqueeze([0, 2])),
    ("squeeze", lambda m, t: t(X).reshape([3, 1, 4]).squeeze(1)),
    ("expand", lambda m, t: t(X[:1]).expand([2, 3, 4])),
    ("tile", lambda m, t: t(X).tile([2, 1])),
    ("topk", lambda m, t: t(X).topk(2)),
    ("sort", lambda m, t: t(X).sort(axis=0, descending=True)),
    ("argsort", lambda m, t: t(X).argsort(axis=1)),
    ("norm", lambda m, t: t(X).norm()),
    ("numel", lambda m, t: t(X).numel()),
    ("clip", lambda m, t: t(X).clip(-0.5, 0.5)),
    ("where", lambda m, t: m.where(t(B), t(X), t(Y))),
    ("cumsum", lambda m, t: t(X).cumsum(axis=1)),
    ("matmul-method", lambda m, t: t(X).matmul(t(Y), transpose_y=True)),
    ("exp", lambda m, t: t(X).exp()),
    ("logsumexp", lambda m, t: t(X).logsumexp(axis=1)),
    ("equal_all", lambda m, t: t(X).equal_all(t(X))),
    ("clone", lambda m, t: t(X).clone()),
    ("masked_select", lambda m, t: t(X).masked_select(t(B))),
    ("nonzero", lambda m, t: t(B).nonzero()),
    ("unique", lambda m, t: t(I).unique()),
    ("diff", lambda m, t: t(X).diff()),
    ("kron", lambda m, t: t(X[:2, :2]).kron(t(Y[:2, :2]))),
]


@pytest.mark.parametrize("case", METHODS, ids=[c[0] for c in METHODS])
def test_method_matches_the_reference(case):
    _check(*_both(case[1]))


INPLACE = [
    ("add_", lambda x, m, t: x.add_(t(Y))),
    ("subtract_", lambda x, m, t: x.subtract_(t(Y))),
    ("scale_", lambda x, m, t: x.scale_(2.0, 1.0)),
    ("clip_", lambda x, m, t: x.clip_(-0.2, 0.3)),
    ("floor_", lambda x, m, t: m.floor_(x)),
    ("tanh_", lambda x, m, t: x.tanh_()),
    ("exp_", lambda x, m, t: x.exp_()),
    ("zero_", lambda x, m, t: x.zero_()),
    ("fill_", lambda x, m, t: x.fill_(3.5)),
    ("reshape_", lambda x, m, t: x.reshape_([4, 3])),
    ("unsqueeze_", lambda x, m, t: x.unsqueeze_(0)),
    ("cast_", lambda x, m, t: x.cast_("int32")),
    ("square_", lambda x, m, t: x.square_()),
    ("masked_fill_", lambda x, m, t: x.masked_fill_(t(B), -1.0)),
    ("increment", lambda x, m, t: m.increment(x[0:1, 0:1].reshape([1]),
                                              2.0)),
]


@pytest.mark.parametrize("case", INPLACE, ids=[c[0] for c in INPLACE])
def test_inplace_matches_the_reference(case):
    _, fn = case
    jx, px = paddle.to_tensor(X), pt.to_tensor(X)
    jout = fn(jx, paddle, paddle.to_tensor)
    pout = fn(px, pt, pt.to_tensor)
    if case[0] != "increment":
        assert pout is px
        _check(jx, px)
    _check(jout, pout)


def test_inplace_refuses_a_leaf_that_requires_grad():
    x = pt.to_tensor(X, stop_gradient=False)
    with pytest.raises(RuntimeError):
        x.add_(pt.to_tensor(Y))
    with pytest.raises(RuntimeError):
        x.reshape_([12])


INDEXING = [
    ("slices", (slice(1, 3), slice(None, None, 2))),
    ("int", (1,)),
    ("negative-step", (slice(None, None, -1), slice(3, 0, -2))),
    ("int-array", (np.array([2, 0]),)),
    ("bool-mask", (B,)),
    ("none-ellipsis", (None, Ellipsis, 1)),
]


@pytest.mark.parametrize("case", INDEXING, ids=[c[0] for c in INDEXING])
def test_getitem_and_setitem_match_the_reference(case):
    _, idx = case

    def conv(m, t):
        return tuple(t(i) if isinstance(i, np.ndarray) else i for i in idx)

    jx, px = paddle.to_tensor(X), pt.to_tensor(X)
    _check(jx[conv(paddle, paddle.to_tensor)], px[conv(pt, pt.to_tensor)])
    jx[conv(paddle, paddle.to_tensor)] = 9.0
    px[conv(pt, pt.to_tensor)] = 9.0
    _check(jx, px)


def test_setitem_with_a_tensor_and_the_gradient_through_getitem():
    jx, px = paddle.to_tensor(X), pt.to_tensor(X)
    jx[1:3] = paddle.to_tensor(Y[:2])
    px[1:3] = pt.to_tensor(Y[:2])
    _check(jx, px)
    jx = paddle.to_tensor(X, stop_gradient=False)
    px = pt.to_tensor(X, stop_gradient=False)
    (jx[:, 1:3] * 2.0).sum().backward()
    (px[:, 1:3] * 2.0).sum().backward()
    _check(jx.grad, px.grad)


def test_autograd_attributes_match_the_reference():
    jx = paddle.to_tensor(X, stop_gradient=False)
    px = pt.to_tensor(X, stop_gradient=False)
    assert px.stop_gradient is False and jx.stop_gradient is False
    seen = []
    handle = px.register_hook(lambda g: seen.append(type(g)) or g * 2.0)
    jhandle = jx.register_hook(lambda g: g * 2.0)
    ((jx * jx).sum() + jx.mean()).backward()
    ((px * px).sum() + px.mean()).backward()
    assert seen == [pt.Tensor]
    _check(jx.grad, px.grad)
    handle.remove()
    jhandle.remove()
    px.clear_grad()
    jx.clear_grad()
    assert px.grad is None
    (px * 3.0).sum().backward()
    (jx * 3.0).sum().backward()
    _check(jx.grad, px.grad)
    px.clear_grad(set_to_zero=True)
    assert float(px.grad.abs().sum()) == 0.0
    d = px.detach()
    assert isinstance(d, pt.Tensor) and d.stop_gradient
    assert d.data_ptr() == px.data_ptr()
    y = px * 2.0
    assert not y.stop_gradient and not y.is_leaf
    y.stop_gradient = True
    assert y.stop_gradient and y.is_leaf
    i = pt.to_tensor(I, stop_gradient=False)
    assert i.stop_gradient is False and not i.requires_grad
    p = pt.Parameter(np.ones(3, np.float32), name="w")
    assert p.trainable and not p.stop_gradient and p.persistable
    assert p.name == "w"


def test_meta_and_conversions():
    px = pt.to_tensor(X)
    assert px.shape == [3, 4] and px.size == 12 and px.ndim == 2
    assert px.place == pt.CPUPlace() and str(pt.get_device()) == "cpu"
    assert px.numpy().dtype == np.float32
    assert pt.to_tensor(X).astype("bfloat16").numpy().dtype == np.float32
    assert pt.to_tensor(2.5).item() == 2.5
    assert px.to("float16").dtype == torch.float16
    assert isinstance(px.cpu(), pt.Tensor)
    assert repr(px).startswith("Tensor(shape=[3, 4], dtype=float32, "
                               "place=Place(cpu:0), stop_gradient=True")
    import copy
    c = copy.deepcopy(px)
    assert isinstance(c, pt.Tensor) and c.data_ptr() != px.data_ptr()


def test_the_registry_unwraps_facades_and_wraps_the_outputs_back():
    seen = []
    op = pdispatch.OpDef("t_facade", lambda a, bs: seen.append(
        (type(a), [type(b) for b in bs])) or (a + bs[0], a - bs[1]),
        multi_out=True)
    f, g = pt.to_tensor(X), pt.to_tensor(Y)
    out = pdispatch.apply(op, f, [g, torch.from_numpy(Y)])
    assert seen[-1] == (torch.Tensor, [torch.Tensor, torch.Tensor])
    assert all(type(o) is pt.Tensor for o in out)
    plain = pdispatch.apply(op, torch.from_numpy(X), [torch.from_numpy(Y),
                                                      torch.from_numpy(Y)])
    assert all(type(o) is torch.Tensor for o in plain)
    kw = pt.matmul(torch.from_numpy(X), y=pt.to_tensor(Y), transpose_y=True)
    assert type(kw) is pt.Tensor


# ---------------------------------------------------------------------------
# the models' entry points take facades
# ---------------------------------------------------------------------------

def _same_outputs(a, b):
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    for x, y in zip(a, b):
        assert type(x) is torch.Tensor and type(y) is torch.Tensor
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_model_entry_points_take_facades():
    from paddle_tpu_torch.models import bert, gpt, llama, ppyoloe
    from paddle_tpu_torch.vision.models import resnet18
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 64, (2, 8)).astype(np.int64)

    def run(call, *arrays):
        plain = [torch.from_numpy(a) for a in arrays]
        pt.seed(5)
        want = call(*plain)
        pt.seed(5)
        got = call(*[pt.to_tensor(a) for a in arrays])
        _same_outputs(want, got)

    bcfg = bert.CONFIGS["tiny"]._replace(vocab_size=64)
    bm = bert.BertForPretraining(bcfg, device="cpu", dtype=torch.float32)
    lab = np.where(rng.random((2, 8)) < 0.5, ids, -100)
    run(lambda i, l, n, m: bm.loss(i, l, n, attention_mask=m), ids, lab,
        np.array([0, 1], np.int64), np.ones((2, 8), np.int64))
    bm.eval()
    run(lambda i: bm(i), ids)
    g = gpt.GPTForCausalLM(gpt.GPTConfig(vocab_size=64, hidden_size=32,
                                         num_layers=1, num_heads=2,
                                         max_seq_len=16,
                                         dtype=torch.float32), device="cpu")
    run(lambda i: g.loss(i, i), ids)
    lm = llama.LlamaForCausalLM(llama.CONFIGS["tiny"]._replace(
        vocab_size=64), device="cpu", dtype=torch.float32)
    run(lambda i: lm.loss(i, i), ids)
    net = resnet18(num_classes=4, device="cpu")
    run(lambda x: net(x), rng.standard_normal((2, 3, 16, 16)).astype(
        np.float32))
    det = ppyoloe.PPYOLOE(ppyoloe.CONFIGS["tiny"], device="cpu",
                          dtype=torch.float32)
    det.eval()
    run(lambda x: det(x), rng.standard_normal((1, 3, 64, 64)).astype(
        np.float32))


def test_an_optimizer_steps_facade_parameters():
    from paddle_tpu_torch import optimizer as popt
    w = pt.Parameter(np.ones(3, np.float32))
    opt = popt.Momentum(learning_rate=0.1, momentum=0.9, parameters=[w])
    for _ in range(2):
        (w * pt.to_tensor(np.array([1.0, 2.0, 3.0], np.float32))).sum() \
            .backward()
        opt.step()
        opt.clear_grad()
    assert isinstance(w, pt.Tensor)
    np.testing.assert_allclose(w.numpy(), 1 - np.array([1, 2, 3]) * 0.1 *
                               (1 + 1.9), rtol=1e-6)


def test_flags_set_on_a_plain_parameter_take_effect_in_an_optimizer():
    """``stop_gradient`` / ``trainable`` set on a model's ``nn.Parameter``
    before it has a name hold once an optimizer names it."""
    from paddle_tpu_torch import optimizer as popt
    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(3))
    a.stop_gradient = True
    b.trainable = False
    popt.Momentum(learning_rate=0.1, momentum=0.9, parameters=[a, b])
    assert a.stop_gradient and not a.requires_grad
    assert not b.trainable and b.requires_grad and not b.stop_gradient
