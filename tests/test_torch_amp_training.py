"""Training under AMP in the port against the JAX reference: the casts'
values, not only their dtypes.

- One BottleneckBlock with a downsample under ``auto_cast(level="O2",
  dtype="bfloat16")`` with f32 parameters, the dense route and the fused
  route (the reference's BatchNorm kernels in interpret mode, the port's
  plain versions), its weights carried across: the bf16 output, the input's
  and every parameter's f32 gradient, the running statistics, then three
  Momentum(0.1, 0.9) steps.
- The tiny BERT (2 layers, H 64, 4 heads) at its default dropout 0.1 /
  0.1 under ``auto_cast(level="O1")``, both generators seeded alike
  before each step, on the fused route: the loss and every gradient, then
  three AdamW steps.
- The fused BatchNorm op's plain version with bf16 weight and bias against
  the reference's kernels in interpret mode: y, the statistics, dx, dres,
  and dw and db, which come back bf16 in both.

Tolerances. Both packages round to bf16 at the same points; where an f32
accumulation in another order lands on the other side of a bf16 rounding
boundary the two differ by one bf16 unit (2^-8 relative), and that
propagates. So the tight tolerances of the f32 BottleneckBlock tests
(``test_torch_resnet_training.py``: output atol 1e-5 / rtol 1e-4,
gradients within 1e-4 of each leaf's largest entry) are scaled by the
bf16 reading:
- the block: every output and gradient within ``BF16_UNITS`` bf16 units
  of the compared tensor's largest entry; the running statistics and the
  op's f32 statistics at those tests' f32 tolerances (rtol 1e-5 / atol
  1e-6); after each of the three Momentum steps a parameter within lr x
  the velocity's weights so far x the steps x ``BF16_UNITS`` bf16 units
  of the leaf's largest gradient (a flipped unit in a later step's
  forward moves one gradient entry), and all but 1% of each leaf's
  entries (at least one) within 1e-5;
- BERT under O1 (its LayerNorm, softmax statistics and loss in f32, its
  GEMMs in bf16): the loss within one bf16 unit (rtol 2^-8); gradients
  within 8 bf16 units of each leaf's largest entry (an embedding row's
  gradient sums many bf16-rounded contributions in another order: 5
  units measured); after three AdamW steps the first moments within 0.1
  x 8 bf16 units of the leaf's largest gradient entries summed over the
  steps (m = Σ 0.1·0.9^j g), and the parameters within 2·lr·steps entry
  by entry: Adam divides each gradient by its own root-mean-square, so an
  entry whose gradient is near its rounding moves by up to lr a step in
  either package (5% of the tied word-embedding table's entries move by
  more than lr·steps·4 bf16 units);
- the BN op: every output within one bf16 unit of its largest entry.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.flags import get_flag as jax_get_flag
from paddle_tpu.kernels import norm_fusion as jnf
from paddle_tpu.models import bert as jbert
from paddle_tpu.nn.functional import norm as jnorm
from paddle_tpu.vision.models import resnet as jresnet
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import get_flag as pt_get_flag
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.kernels import norm_fusion as pnf
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision.models import resnet as presnet

BF16_UNIT = 2.0 ** -8
BF16_UNITS = 4
_FLAGS = ("flash_attention_interpret", "fused_norm", "fused_norm_interpret",
          "fused_mlp", "fused_mlp_interpret")


@pytest.fixture(scope="module", autouse=True)
def restore_flags():
    old = {n: jax_get_flag(n) for n in _FLAGS}
    old_pt = {n: pt_get_flag(n) for n in ("fused_norm", "fused_mlp")}
    try:
        paddle.set_flags({"FLAGS_flash_attention_interpret": True})
        yield
    finally:
        paddle.set_flags({f"FLAGS_{n}": v for n, v in old.items()})
        pt_set_flags({f"FLAGS_{n}": v for n, v in old_pt.items()})


@pytest.fixture(params=[False, True], ids=["dense", "fused"])
def fused(request):
    on = request.param
    paddle.set_flags({"FLAGS_fused_norm": on, "FLAGS_fused_norm_interpret": on,
                      "FLAGS_fused_mlp": on, "FLAGS_fused_mlp_interpret": on})
    pt_set_flags({"FLAGS_fused_norm": on, "FLAGS_fused_mlp": on})
    yield on


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _close_to_units(got, want, units, what):
    """|got − want| ≤ units bf16 units of want's largest entry."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = units * BF16_UNIT * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


# ---------------------------------------------------------------------------
# one BottleneckBlock under O2
# ---------------------------------------------------------------------------

def _blocks(seed):
    paddle.seed(seed)
    jds = jnn.Sequential(jnn.Conv2D(32, 64, 1, stride=2, bias_attr=False),
                         jnn.BatchNorm2D(64))
    pds = torch.nn.Sequential(
        pnn.Conv2D(32, 64, 1, stride=2, bias_attr=False, device="cpu"),
        pnn.BatchNorm2D(64, device="cpu"))
    jblk = jresnet.BottleneckBlock(32, 16, 2, jds)
    pblk = presnet.BottleneckBlock(32, 16, 2, pds, device="cpu")
    state = {k: _np(v) for k, v in jblk.state_dict().items()}
    mine = {**dict(pblk.named_parameters()), **dict(pblk.named_buffers())}
    assert set(mine) == set(state)
    with torch.no_grad():
        for k, t in mine.items():
            t.copy_(torch.from_numpy(state[k]))
    return jblk, pblk


def test_bottleneck_block_under_o2_matches_the_reference(fused):
    jblk, pblk = _blocks(7)
    rng = np.random.default_rng(8)
    jnamed = dict(jblk.named_parameters())
    pnamed = dict(pblk.named_parameters())
    jopt = paddle.optimizer.Momentum(0.1, momentum=0.9,
                                     parameters=list(jnamed.values()))
    opt = popt.Momentum(0.1, momentum=0.9, parameters=list(pnamed.values()))
    gmax = {}
    for step in range(3):
        x = rng.normal(size=(4, 32, 8, 8)).astype(np.float32)
        gy = rng.normal(size=(4, 64, 4, 4)).astype(np.float32)
        jx = paddle.to_tensor(x)
        jx.stop_gradient = False
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            jy = jblk(jx)
        (jy.astype("float32") * paddle.to_tensor(gy)).sum().backward()
        px = torch.from_numpy(x).requires_grad_(True)
        with pamp.auto_cast(level="O2", dtype="bfloat16"):
            py = pblk(px)
        (py.float() * torch.from_numpy(gy)).sum().backward()
        assert py.dtype == torch.bfloat16 and str(jy.dtype) == "bfloat16"
        assert PF.last_norm_path() == ("fused_bn/plain" if fused else "dense")
        assert jnorm.last_norm_path() == ("fused_bn/interpret" if fused
                                          else "dense")
        if step == 0:
            _close_to_units(py.detach().float().numpy(),
                            _np(jy.astype("float32")), BF16_UNITS, "y")
            _close_to_units(px.grad.numpy(), _np(jx.grad), BF16_UNITS, "dx")
            for k in jnamed:
                assert pnamed[k].grad.dtype == torch.float32, k
                _close_to_units(pnamed[k].grad.numpy(),
                                _np(jnamed[k].grad), BF16_UNITS, k)
            jbuf = dict(jblk.named_buffers())
            for k, b in pblk.named_buffers():
                np.testing.assert_allclose(b.numpy(), _np(jbuf[k]),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
        for k in jnamed:
            gmax[k] = max(gmax.get(k, 0.0), float(np.abs(_np(
                jnamed[k].grad)).max()))
        jopt.step()
        opt.step()
        jopt.clear_grad()
        opt.clear_grad()
        for k in jnamed:
            assert pnamed[k].dtype == torch.float32
            diff = np.abs(pnamed[k].detach().numpy() - _np(jnamed[k]))
            # lr x the velocity's weights so far x the gradients' reading
            bound = 0.1 * sum(0.9 ** i for i in range(step + 1)) * (
                step + 1) * BF16_UNITS * BF16_UNIT * gmax[k]
            assert float(diff.max()) <= bound, (k, float(diff.max()), bound)
            assert int((diff > 1e-5).sum()) <= max(1, diff.size // 100), k


# ---------------------------------------------------------------------------
# the tiny BERT under O1 at dropout 0.1 / 0.1
# ---------------------------------------------------------------------------

def _batch(seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    vocab = jbert.CONFIGS["tiny"].vocab_size
    ids = rng.integers(0, vocab, (B, S)).astype(np.int64)
    mlm = np.where(rng.random((B, S)) < 0.3, ids, -100).astype(np.int64)
    mlm[0, 0] = ids[0, 0]
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    return ids, mlm, nsp


def test_bert_under_o1_at_dropout_matches_the_reference():
    """The bench's route: the fused kernels (the reference's in interpret
    mode; the dense routes' casts are held by test_torch_amp.py's operator
    statistics)."""
    paddle.set_flags({"FLAGS_fused_norm": True,
                      "FLAGS_fused_norm_interpret": True,
                      "FLAGS_fused_mlp": True, "FLAGS_fused_mlp_interpret": True})
    pt_set_flags({"FLAGS_fused_norm": True, "FLAGS_fused_mlp": True})
    paddle.seed(5)
    jmodel = jbert.BertForPretraining(jbert.CONFIGS["tiny"])
    state = {k: _np(v) for k, v in jmodel.state_dict().items()}
    model = pbert.BertForPretraining(pbert.CONFIGS["tiny"], device="cpu",
                                     dtype=torch.float32).load_numpy(state)
    lr, steps = 1e-3, 3
    jopt = paddle.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                  parameters=jmodel.parameters())
    opt = popt.AdamW(learning_rate=lr, weight_decay=0.01,
                     parameters=model.parameters())
    jnamed = dict(jmodel.named_parameters())
    pnamed = dict(model.named_parameters())
    jl, pl, gsum = [], [], {}
    for step in range(steps):
        batch = _batch(11 + step)
        paddle.seed(100 + step)
        pt_seed(100 + step)
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            jloss = jmodel.loss(*map(paddle.to_tensor, batch))
        jloss.backward()
        with pamp.auto_cast(level="O1", dtype="bfloat16"):
            ploss = model.loss(*map(torch.from_numpy, batch))
        ploss.backward()
        assert ploss.dtype == torch.float32 and str(jloss.dtype) == "float32"
        jl.append(float(jloss.numpy()))
        pl.append(ploss.item())
        if step == 0:
            for k in jnamed:
                assert pnamed[k].grad.dtype == torch.float32, k
                _close_to_units(pnamed[k].grad.numpy(), _np(jnamed[k].grad),
                                8, k)
        for k in jnamed:
            gsum[k] = gsum.get(k, 0.0) + float(np.abs(_np(
                jnamed[k].grad)).max())
        jopt.step()
        opt.step()
        jopt.clear_grad()
        opt.clear_grad()
    assert PF.last_norm_path() == "fused_ln/plain"   # the MLM transform
    np.testing.assert_allclose(pl, jl, rtol=BF16_UNIT)
    for k in jnamed:
        diff = np.abs(pnamed[k].detach().numpy() - _np(jnamed[k]))
        assert float(diff.max()) <= 2 * lr * steps, k
        dm = np.abs(opt._accumulators["moment1"][id(pnamed[k])].numpy()
                    - _np(jopt._accumulators["moment1"][id(jnamed[k])]))
        # the gradients' bound, through m = Σ 0.1·0.9^j g
        assert float(dm.max()) <= 0.1 * 8 * BF16_UNIT * gsum[k], k


# ---------------------------------------------------------------------------
# the fused BatchNorm op with bf16 weight and bias
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("relu,res", [(True, True), (False, False)])
def test_fused_bn_plain_with_bf16_vectors_matches_interpret_mode(relu, res):
    rng = np.random.default_rng(21)
    n, c, hw = 4, 16, 20
    x = rng.normal(size=(n, c, hw)).astype(np.float32)
    r = rng.normal(size=(n, c, hw)).astype(np.float32) if res else None
    w = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    b = (0.1 * rng.normal(size=c)).astype(np.float32)
    g = rng.normal(size=(n, c, hw)).astype(np.float32)

    def jbf(a):
        return jnp.asarray(a).astype(jnp.bfloat16)

    def jfn(xx, rr, ww, bb):
        return jnf.fused_batch_norm_train(xx, ww, bb, residual=rr, eps=1e-5,
                                          fuse_relu=relu, interpret=True)

    jargs = (jbf(x), None if r is None else jbf(r), jbf(w), jbf(b))
    (jy, jmean, jvar), vjp = jax.vjp(jfn, *jargs)
    jdx, jdres, jdw, jdb = vjp((jbf(g), jnp.zeros(c), jnp.zeros(c)))

    def pbf(a):
        return torch.from_numpy(a).bfloat16()

    px = pbf(x).requires_grad_(True)
    pr = None if r is None else pbf(r).requires_grad_(True)
    pw, pb = pbf(w).requires_grad_(True), pbf(b).requires_grad_(True)
    py, pmean, pvar = pnf.fused_batch_norm_train(px, pw, pb, residual=pr,
                                                 eps=1e-5, fuse_relu=relu)
    py.backward(pbf(g))
    assert pw.grad.dtype == pb.grad.dtype == torch.bfloat16
    assert jdw.dtype == jdb.dtype == jnp.bfloat16
    np.testing.assert_allclose(pmean.detach().numpy(), np.asarray(jmean),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pvar.detach().numpy(), np.asarray(jvar),
                               rtol=1e-5, atol=1e-6)
    for got, want, what in ((py, jy, "y"), (px.grad, jdx, "dx"),
                            (pw.grad, jdw, "dw"), (pb.grad, jdb, "db")) + (
            ((pr.grad, jdres, "dres"),) if res else ()):
        _close_to_units(got.detach().float().numpy(),
                        np.asarray(want.astype(jnp.float32)), 1, what)
