"""The port's transformer layers against the JAX reference.

``MultiHeadAttention``, ``TransformerEncoder[Layer]``,
``TransformerDecoder[Layer]`` and ``Transformer`` (``nn/layer/
transformer.py``) at tiny sizes (d_model 32, 4 heads, ffn 64, 2 layers,
S ≤ 10, f32, on the CPU). Each case builds the reference's layer after
``paddle.seed`` and carries its weights across (``state_dict`` →
``load_numpy``); both framework generators are seeded alike before a
forward, so at dropout 0.1 every site (the attention's in-kernel mask,
``dropout1``, the FFN's ``dropout``, ``dropout2``, ``dropout3``) draws
the reference's mask. The reference runs as its own tests run it: with
``FLAGS_flash_attention_interpret`` on, so its attention without a mask
or with a [B, 1, 1, Sk] mask reaches the Pallas flash kernels in
interpret mode (the dense path otherwise); the port takes the flash
kernels' plain versions on the CPU, and the dense route for the [S, S]
masks.

Tolerances (fp32): outputs atol 2e-5 (the same f32 arithmetic in other
GEMM and reduction orders, 2 layers); gradients within 1e-4 of each
leaf's largest entry, or of a thousandth of the largest entry of any
leaf where that is larger: the key projection's bias has a zero gradient
in exact arithmetic (it adds one constant to every score of a row, which
the softmax cancels), so both packages give it rounding noise. The
backward takes a seeded random cotangent (a plain sum through a final
LayerNorm has a zero gradient). With dropout the masks are bitwise the
reference's: a wrong mask moves an output by O(1), far past those
tolerances.
"""
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)
from torch_ops_audit import cpu_place

import paddle_tpu as paddle
from paddle_tpu.core.flags import get_flag as jget_flag
from paddle_tpu.core.flags import set_flags as jset_flags

import paddle_tpu_torch as pt
from paddle_tpu_torch.nn.layer.layers import load_numpy

E, H, FF = 32, 4, 64


@pytest.fixture(autouse=True)
def _interpret_and_cpu():
    old = jget_flag("flash_attention_interpret")
    jset_flags({"flash_attention_interpret": True})
    yield from cpu_place()
    jset_flags({"flash_attention_interpret": old})


def _np(t):
    return np.asarray(t.numpy()) if hasattr(t, "numpy") and not \
        isinstance(t, torch.Tensor) else t.detach().numpy()


def _state(jlayer):
    return {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}


def _pair(jcls, pcls, *args, **kw):
    paddle.seed(0)
    jl = jcls(*args, **kw)
    pl = load_numpy(pcls(*args, **kw), _state(jl))
    return jl, pl


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _seed(s):
    paddle.seed(s)
    pt.seed(s)


def _close(got, want, atol=2e-5):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _backward(jo, po, seed=99):
    """Back-propagate sum(out · w) with one seeded w through both."""
    w = _rand(tuple(po.shape), seed)
    (jo * paddle.to_tensor(w)).sum().backward()
    (po * torch.from_numpy(w)).sum().backward()


def _grads_close(jlayer, player, tol=1e-4):
    jg = {n: np.asarray(p.grad.numpy()) for n, p in
          jlayer.named_parameters() if p.grad is not None}
    pg = {n: p.grad.numpy() for n, p in player.named_parameters()
          if p.grad is not None}
    assert sorted(jg) == sorted(pg)
    top = max(float(np.abs(g).max()) for g in jg.values())
    for n, ref in jg.items():
        scale = max(float(np.abs(ref).max()), 1e-3 * top)
        assert float(np.abs(pg[n] - ref).max()) <= tol * scale, n


# ---------------------------------------------------------------------------
# MultiHeadAttention
# ---------------------------------------------------------------------------

def _masks(kind, b, sq, sk):
    if kind is None:
        return None
    if kind == "bool_kp":
        m = np.ones((b, 1, 1, sk), bool)
        m[-1, ..., sk - 3:] = False
        return m
    if kind == "add_kp":
        m = np.zeros((b, 1, 1, sk), np.float32)
        m[0, ..., :2] = -1e9
        return m
    m = np.triu(np.full((sq, sk), -np.inf, np.float32), 1)     # [S, S]
    return m


@pytest.mark.parametrize("sq, sk, mask, dropout", [
    (10, 10, None, 0.0), (10, 10, "bool_kp", 0.1), (6, 6, "square", 0.0),
    (6, 10, "add_kp", 0.1), (6, 10, None, 0.1)])
def test_multi_head_attention(sq, sk, mask, dropout):
    jl, pl = _pair(paddle.nn.MultiHeadAttention,
                   pt.nn.MultiHeadAttention, E, H, dropout=dropout)
    q, kv = _rand((2, sq, E), 1), _rand((2, sk, E), 2)
    m = _masks(mask, 2, sq, sk)
    jm = None if m is None else paddle.to_tensor(m)
    pm = None if m is None else torch.from_numpy(m)
    _seed(7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jo = jl(paddle.to_tensor(q), paddle.to_tensor(kv),
                paddle.to_tensor(kv), jm)
        po = pl(torch.from_numpy(q), torch.from_numpy(kv),
                torch.from_numpy(kv), pm)
    _close(po, jo)
    _backward(jo, po)
    _grads_close(jl, pl)
    want = "ref" if mask == "square" else "flash_masked/plain" \
        if (mask or dropout) else "flash/plain"
    assert pt.nn.functional.last_attn_path() == want


def test_attention_caches():
    """The incremental ``Cache`` grows by each step's keys and values; the
    ``StaticCache`` holds the projected memory; both match the
    reference's step by step."""
    jl, pl = _pair(paddle.nn.MultiHeadAttention,
                   pt.nn.MultiHeadAttention, E, H)
    jl.eval()
    pl.eval()
    mem = _rand((2, 10, E), 3)
    jc = jl.gen_cache(paddle.to_tensor(mem), type=jl.Cache)
    pc = pl.gen_cache(torch.from_numpy(mem), type=pl.Cache)
    assert tuple(pc.k.shape) == tuple(jc.k.shape) == (2, 0, H, E // H)
    for step in range(3):
        x = _rand((2, 1, E), 10 + step)
        jo, jc = jl(paddle.to_tensor(x), cache=jc)
        po, pc = pl(torch.from_numpy(x), cache=pc)
        _close(po, jo)
        _close(pc.k, jc.k)
    js = jl.gen_cache(paddle.to_tensor(mem), paddle.to_tensor(mem),
                      type=jl.StaticCache)
    ps = pl.gen_cache(torch.from_numpy(mem), torch.from_numpy(mem),
                      type=pl.StaticCache)
    _close(ps.v, js.v)
    x = _rand((2, 4, E), 20)
    _close(pl(torch.from_numpy(x), cache=ps),
           jl(paddle.to_tensor(x), cache=js))


# ---------------------------------------------------------------------------
# encoder and decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normalize_before, dropout", [
    (False, 0.0), (False, 0.1), (True, 0.1)])
def test_encoder(normalize_before, dropout):
    paddle.seed(0)
    jl = paddle.nn.TransformerEncoderLayer(
        E, H, FF, dropout=dropout, activation="gelu",
        normalize_before=normalize_before)
    je = paddle.nn.TransformerEncoder(jl, 2, norm=paddle.nn.LayerNorm(E)
                                      if normalize_before else None)
    pl = pt.nn.TransformerEncoderLayer(
        E, H, FF, dropout=dropout, activation="gelu",
        normalize_before=normalize_before)
    pe = load_numpy(pt.nn.TransformerEncoder(
        pl, 2, norm=pt.nn.LayerNorm(E) if normalize_before else None),
        _state(je))
    x = _rand((2, 10, E), 4)
    m = _masks("bool_kp", 2, 10, 10)
    _seed(11)
    jo = je(paddle.to_tensor(x), src_mask=paddle.to_tensor(m))
    po = pe(torch.from_numpy(x), src_mask=torch.from_numpy(m))
    _close(po, jo)
    _backward(jo, po)
    _grads_close(je, pe)
    assert pt.nn.functional.last_attn_path() == "flash_masked/plain"
    assert pt.nn.functional.last_norm_path() == "fused_ln/plain"


@pytest.mark.parametrize("normalize_before, dropout", [(False, 0.1),
                                                       (True, 0.0)])
def test_transformer(normalize_before, dropout):
    """``nn.Transformer`` at Sq ≠ Sk: the decoder's self-attention under
    ``generate_square_subsequent_mask`` (the dense route), its
    cross-attention under a memory key-padding mask (the flash kernels'
    masked variant)."""
    kw = dict(d_model=E, nhead=H, num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=FF, dropout=dropout,
              normalize_before=normalize_before)
    jt, ptm = _pair(paddle.nn.Transformer, pt.nn.Transformer, **kw)
    src, tgt = _rand((2, 10, E), 5), _rand((2, 6, E), 6)
    mem_mask = _masks("bool_kp", 2, 6, 10)
    jsq = jt.generate_square_subsequent_mask(6)
    psq = ptm.generate_square_subsequent_mask(6)
    _close(psq, jsq, atol=0)
    _seed(13)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jo = jt(paddle.to_tensor(src), paddle.to_tensor(tgt), tgt_mask=jsq,
                memory_mask=paddle.to_tensor(mem_mask))
        po = ptm(torch.from_numpy(src), torch.from_numpy(tgt), tgt_mask=psq,
                 memory_mask=torch.from_numpy(mem_mask))
    _close(po, jo)
    _backward(jo, po)
    _grads_close(jt, ptm)


def test_decoder_caches():
    """One cached decoder step (the self-attention's ``Cache`` and the
    cross-attention's ``StaticCache``) matches the reference's. The
    reference's layer returns ``(incremental_cache,)`` as its new cache,
    without the static one, so a second cached step fails the same way
    in both packages (ROADMAP C, "Found in the reference, kept by the
    port")."""
    paddle.seed(0)
    jd = paddle.nn.TransformerDecoder(
        paddle.nn.TransformerDecoderLayer(E, H, FF, dropout=0.0), 2)
    pd = load_numpy(pt.nn.TransformerDecoder(
        pt.nn.TransformerDecoderLayer(E, H, FF, dropout=0.0), 2), _state(jd))
    mem = _rand((2, 7, E), 8)
    jc = jd.gen_cache(paddle.to_tensor(mem))
    pc = pd.gen_cache(torch.from_numpy(mem))
    x = _rand((2, 1, E), 30)
    jo, jc = jd(paddle.to_tensor(x), paddle.to_tensor(mem), cache=jc)
    po, pc = pd(torch.from_numpy(x), torch.from_numpy(mem), cache=pc)
    _close(po, jo)
    _close(pc[0][0].k, jc[0][0].k)
    with pytest.raises(IndexError):
        jd(paddle.to_tensor(x), paddle.to_tensor(mem), cache=jc)
    with pytest.raises(IndexError):
        pd(torch.from_numpy(x), torch.from_numpy(mem), cache=pc)


def test_cloned_layers_start_equal_in_both_packages():
    """The reference's ``_clone_layer`` deep-copies the layer (its
    docstring promises re-initialised parameters): every layer of an
    encoder starts with the first layer's weights and parameter names, in
    both packages (ROADMAP C, "Found in the reference, kept by the
    port"). The clones hold their own tensors."""
    for pkg in (paddle, pt):
        enc = pkg.nn.TransformerEncoder(
            pkg.nn.TransformerEncoderLayer(E, H, FF), 3)
        first = dict(enc.layers[0].named_parameters())
        for layer in enc.layers[1:]:
            for n, p in layer.named_parameters():
                np.testing.assert_array_equal(_np(p), _np(first[n]))
                assert p.name == first[n].name
                assert p is not first[n]
    pl = pt.nn.TransformerEncoder(pt.nn.TransformerEncoderLayer(E, H, FF), 2)
    with torch.no_grad():
        pl.layers[1].linear1.weight.add_(1.0)
    assert not torch.equal(pl.layers[0].linear1.weight,
                           pl.layers[1].linear1.weight)


def test_weights_from_one_seed():
    """Built after the same seed, the layers' weights are the reference's
    draws: XavierNormal within the port's normal allowance (2 ulps of
    the unit draw, ops/random.py), the biases and LayerNorms exact."""
    paddle.seed(21)
    with paddle.utils.unique_name.guard():
        jl = paddle.nn.TransformerEncoderLayer(E, H, FF)
    pt.seed(21)
    with pt.utils.unique_name.guard():
        pl = pt.nn.TransformerEncoderLayer(E, H, FF)
    for (jn, jp), (pn, pp) in zip(jl.named_parameters(),
                                  pl.named_parameters()):
        assert jn == pn and jp.name == pp.name
        ref = np.asarray(jp.numpy())
        ulp = np.spacing(np.abs(ref).max()).astype(np.float32)
        assert np.abs(pp.detach().numpy() - ref).max() <= 2 * ulp, jn
