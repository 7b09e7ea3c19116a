"""The port's PP-YOLOE functionals and matrix NMS against the JAX
reference: ``sigmoid``, ``silu``, ``softplus``, ``interpolate`` /
``upsample`` (nearest), ``binary_cross_entropy``, ``one_hot`` and
``vision.ops.matrix_nms``.

The same numpy inputs go through both packages in fp32. Tolerances:
- sigmoid, silu, softplus and their gradients: atol 1e-6 / rtol 1e-6
  (the same f32 formulas, other libm); softplus's branch taken exactly
  (the values past the threshold are x itself, bit for bit);
- interpolate (nearest): exact, bit for bit (a gather of the same pixels);
- binary_cross_entropy: atol 1e-6 / rtol 1e-6, values and gradients, at
  saturated probabilities too (0, 1e-13, 1: the 1e-12 floor gives 27.63);
- one_hot: exact;
- matrix_nms: the count equal, the rows' classes equal, scores and boxes
  within 1e-6 (atol; the boxes' coordinates lie in [0, 1]) of the
  reference's rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as paddle
from paddle_tpu.core.dispatch import unwrap
from paddle_tpu.nn import functional as JF
from paddle_tpu.vision.ops import _matrix_nms as j_matrix_nms
from paddle_tpu_torch import vision as pvision
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision.ops import matrix_nms


def _rand(shape, seed, scale=1.0):
    return np.asarray(np.random.default_rng(seed).normal(size=shape) * scale,
                      np.float32)


def _value_and_grad(jfn, pfn, x, seed):
    """(port value, reference value, port dx, reference dx) for a random
    cotangent."""
    jout, vjp = jax.vjp(lambda a: unwrap(jfn(a)), jnp.asarray(x))
    g = _rand(jout.shape, seed)
    (jdx,) = vjp(jnp.asarray(g))
    px = torch.from_numpy(x).requires_grad_(True)
    pout = pfn(px)
    pout.backward(torch.from_numpy(g))
    return (pout.detach().numpy(), np.asarray(jout), px.grad.numpy(),
            np.asarray(jdx))


def _close(*pairs, atol=1e-6, rtol=1e-6):
    for got, ref in pairs:
        np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)


# --- activations -----------------------------------------------------------

ACT_X = np.concatenate([_rand((200,), 1, 6.0),
                        np.array([0.0, -90.0, 90.0, 1e-8, -1e-8, 20.0, 25.0],
                                 np.float32)])


@pytest.mark.parametrize("name", ["sigmoid", "silu"])
def test_sigmoid_silu_match_reference(name):
    got, ref, gdx, rdx = _value_and_grad(getattr(JF, name),
                                         getattr(PF, name), ACT_X, 2)
    _close((got, ref), (gdx, rdx))


@pytest.mark.parametrize("beta,threshold", [(1, 20), (2, 20), (0.5, 5.0),
                                            (3, 1.5)])
def test_softplus_matches_reference(beta, threshold):
    # the tie x·beta == threshold (the log branch), just past it (x) and a
    # spread of values
    tie = np.float32(threshold) / np.float32(beta)
    x = np.concatenate([ACT_X, np.array([tie, np.nextafter(tie, np.inf),
                                         np.nextafter(tie, -np.inf)],
                                        np.float32)]).astype(np.float32)
    jfn = lambda a: JF.softplus(a, beta=beta, threshold=threshold)  # noqa
    pfn = lambda a: PF.softplus(a, beta=beta, threshold=threshold)  # noqa
    got, ref, gdx, rdx = _value_and_grad(jfn, pfn, x, 3)
    _close((got, ref), (gdx, rdx))
    past = x * beta > threshold
    assert np.array_equal(got[past], x[past])
    assert (x * np.float32(beta) == np.float32(threshold)).any()


# --- interpolate -----------------------------------------------------------

INTERP_CASES = [
    # x shape (NCHW), size, scale_factor
    ((1, 3, 5, 7), None, 2),
    ((2, 4, 20, 20), None, 2),
    ((1, 3, 5, 7), [3, 4], None),
    ((1, 2, 7, 9), [11, 13], None),
    ((1, 2, 9, 9), [6, 6], None),
    ((1, 2, 6, 6), None, 1.5),
    ((1, 2, 5, 6), None, [2, 3]),
    ((1, 2, 13, 17), None, 0.5),
]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", INTERP_CASES,
                         ids=[f"c{i}" for i in range(len(INTERP_CASES))])
def test_interpolate_nearest_matches_reference(case, fmt):
    shape, size, scale = case
    x = _rand(shape, 4)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    ref = np.asarray(JF.interpolate(paddle.to_tensor(x), size=size,
                                    scale_factor=scale, mode="nearest",
                                    data_format=fmt).numpy())
    got = PF.interpolate(torch.from_numpy(x), size=size, scale_factor=scale,
                         mode="nearest", data_format=fmt).numpy()
    assert got.shape == ref.shape
    assert np.array_equal(got, ref)
    again = PF.upsample(torch.from_numpy(x), size=size, scale_factor=scale,
                        data_format=fmt).numpy()
    assert np.array_equal(again, got)


def test_interpolate_nearest_gradient_matches_reference():
    x = _rand((1, 2, 5, 7), 5)
    jfn = lambda a: JF.interpolate(a, size=[8, 11], mode="nearest")  # noqa
    pfn = lambda a: PF.interpolate(a, size=[8, 11], mode="nearest")  # noqa
    got, ref, gdx, rdx = _value_and_grad(jfn, pfn, x, 6)
    assert np.array_equal(got, ref)
    _close((gdx, rdx))


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "linear", "area"])
def test_interpolate_other_modes_raise_naming_a11(mode):
    with pytest.raises(NotImplementedError, match="A11"):
        PF.interpolate(torch.zeros(1, 1, 4, 4), scale_factor=2, mode=mode)


def test_interpolate_1d_raises_as_the_reference():
    x = np.zeros((1, 2, 6), np.float32)
    with pytest.raises(NotImplementedError, match="1-D interpolate"):
        JF.interpolate(paddle.to_tensor(x), scale_factor=2)
    with pytest.raises(NotImplementedError, match="1-D interpolate"):
        PF.interpolate(torch.from_numpy(x), scale_factor=2)


# --- binary_cross_entropy, one_hot -----------------------------------------

BCE_P = np.array([0.0, 1e-13, 1.0, 1e-12 * 0.5, 0.3, 0.5, 0.999, 1 - 1e-7,
                  0.01, 0.7, 0.2, 0.9], np.float32)
BCE_Y = np.array([1.0, 1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.3, 1.0, 0.0,
                  0.5], np.float32)


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["noweight", "weight"])
def test_binary_cross_entropy_matches_reference(reduction, weighted):
    w = (np.linspace(0.5, 2.0, BCE_P.size).astype(np.float32) if weighted
         else None)

    def jfn(a):
        return JF.binary_cross_entropy(
            a, jnp.asarray(BCE_Y), weight=None if w is None else
            jnp.asarray(w), reduction=reduction)

    def pfn(a):
        return PF.binary_cross_entropy(
            a, torch.from_numpy(BCE_Y), weight=None if w is None else
            torch.from_numpy(w), reduction=reduction)

    got, ref, gdx, rdx = _value_and_grad(jfn, pfn, BCE_P, 7)
    _close((got, ref), (gdx, rdx))
    if reduction == "none" and not weighted:
        # a saturated probability costs -log(1e-12), not torch's 100
        assert abs(float(got[0]) - 27.631021) < 1e-4
        assert abs(float(got[2]) - 27.631021) < 1e-4
        torch_bce = torch.nn.functional.binary_cross_entropy(
            torch.from_numpy(BCE_P), torch.from_numpy(BCE_Y),
            reduction="none")
        assert float(torch_bce[0]) == 100.0


def test_one_hot_matches_reference():
    x = np.array([[0, 3, -1], [4, 2, 1]], np.int64)   # -1 and 4: zero rows
    ref = np.asarray(JF.one_hot(paddle.to_tensor(x), 4).numpy())
    got = PF.one_hot(torch.from_numpy(x), 4)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref)
    assert got[0, 2].sum() == 0 and got[1, 0].sum() == 0


# --- matrix NMS ------------------------------------------------------------

def _nms_inputs(m, c, seed, ties=False):
    """m boxes in [0, 1] (clustered so that many overlap) and [c, m]
    scores; with ``ties`` whole groups of equal best scores."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(0.2, 0.8, (m, 2)) + rng.normal(0, 0.05, (m, 2))
    wh = rng.uniform(0.05, 0.3, (m, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)
    scores = rng.uniform(0.0, 1.0, (c, m)).astype(np.float32)
    if ties:
        scores[:, ::3] = 0.625                 # many boxes tie at 0.625
        scores[:, 1::7] = 0.25
    return boxes, scores


NMS_CASES = [
    # m, c, seed, ties, kwargs
    (60, 4, 0, False, dict(score_threshold=0.3, post_threshold=0.3)),
    (60, 4, 1, True, dict(score_threshold=0.3, post_threshold=0.3)),
    (60, 4, 1, True, dict(score_threshold=0.3, post_threshold=0.3,
                          use_gaussian=True, gaussian_sigma=2.0)),
    (80, 3, 2, False, dict(score_threshold=0.5, post_threshold=0.1,
                           use_gaussian=True, gaussian_sigma=0.5)),
    (80, 3, 3, True, dict(score_threshold=0.2, post_threshold=0.2,
                          nms_top_k=25)),
    (80, 3, 4, False, dict(score_threshold=0.2, post_threshold=0.0,
                           nms_top_k=30, keep_top_k=10)),
    (50, 5, 5, True, dict(score_threshold=0.95, post_threshold=0.0,
                          keep_top_k=40)),        # most boxes below
    (40, 2, 6, True, dict()),                     # the defaults
]


@pytest.mark.parametrize("case", NMS_CASES,
                         ids=[f"c{i}" for i in range(len(NMS_CASES))])
def test_matrix_nms_matches_reference(case):
    m, c, seed, ties, kw = case
    boxes, scores = _nms_inputs(m, c, seed, ties)
    full = dict(score_threshold=0.05, post_threshold=0.0, nms_top_k=-1,
                keep_top_k=-1, use_gaussian=False, gaussian_sigma=2.0)
    full.update(kw)
    rrows, rn = j_matrix_nms(jnp.asarray(boxes), jnp.asarray(scores),
                             full["score_threshold"], full["post_threshold"],
                             full["nms_top_k"], full["keep_top_k"],
                             full["use_gaussian"], full["gaussian_sigma"])
    rrows, rn = np.asarray(unwrap(rrows)), int(np.asarray(unwrap(rn)))
    rows, n = matrix_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         **kw)
    rows = rows.numpy()
    assert n.dtype == torch.int32 and int(n) == rn
    assert rows.shape == rrows.shape
    assert np.array_equal(rows[:, 0], rrows[:, 0])
    np.testing.assert_allclose(rows[:, 1:], rrows[:, 1:], atol=1e-6, rtol=0)
    assert 0 < rn
    if kw.get("keep_top_k", -1) > 0:
        assert rows.shape[0] <= kw["keep_top_k"]


def test_matrix_nms_return_rois_num_and_export():
    boxes, scores = _nms_inputs(20, 2, 7)
    rows, n = pvision.ops.matrix_nms(torch.from_numpy(boxes),
                                     torch.from_numpy(scores))
    only = matrix_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      return_rois_num=False, return_index=True)
    assert torch.equal(only, rows) and int(n) > 0


def test_matrix_nms_stable_order_of_equal_scores():
    # five identical scores on disjoint boxes: the reference keeps their
    # index order; so must the port's stable sorts
    boxes = np.array([[i, 0, i + 0.5, 0.5] for i in range(5)], np.float32)
    scores = np.full((1, 5), 0.75, np.float32)
    rows, n = matrix_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         score_threshold=0.1)
    assert int(n) == 5
    assert np.array_equal(rows[:, 2].numpy(), np.arange(5, dtype=np.float32))
