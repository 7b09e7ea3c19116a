"""Flash attention, forward and backward, on Paddle's [b, s, h, d] layout.

Counterpart: ``paddle_tpu/kernels/flash_attention.py``: ``_fwd_kernel``
(:167), ``_dq_kernel`` (:329), ``_dkv_kernel`` (:420), ``_fwd`` (:272),
``_bwd`` (:539), the ``custom_vjp`` assembly (:624) and
``flash_attention_bshd`` (:722), with the key-padding bias variant
(``kv_bias``, non-causal; :790 canonicalises it, :648 gives it no
gradient). Dropout is ROADMAP A6b and raises here.

The forward and backward are ``torch.library`` custom ops,
``paddle_tpu_torch::flash_fwd`` → ``(out, lse)`` and
``paddle_tpu_torch::flash_bwd`` → ``(dq, dk, dv)``, joined by
``register_autograd``: a selective-checkpoint policy sees the forward as
one dispatcher op and can save its ``out``/``lse``, as the reference's
``flash_out``/``flash_lse`` names do (:641-642). Both take an optional
``bias`` [B, Sk] f32 (the canonicalised key-padding row of each batch)
and ``heads`` (q heads per batch: row ``bh`` reads bias row ``bh //
heads``). For CUDA tensors the ops
launch the hand-written Hopper kernels of ``csrc/flash_attention.cu`` (its
header names the TPU kernels replaced, the operation bound and what the
design does about it) or raise; for CPU tensors they take the plain
PyTorch versions ``flash_fwd_ref`` / ``flash_bwd_ref``. ``launches``
counts kernel launches by kernel name (CPU calls do not count).
"""
import ctypes
import functools

import torch

from . import _build

__all__ = ["flash_attention_bshd", "flash_fwd", "flash_bwd", "flash_fwd_ref",
           "flash_bwd_ref", "flash_dq_ref", "flash_dkv_ref", "launches"]

_NEG_INF = -1e30   # flash_attention.py:61: the mask value, never -inf
_MASK_THRESH = -1e8   # :65: biases at or below it are canonicalised to -1e30
_MAX_HEAD_DIM = 256

launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


# ---------------------------------------------------------------------------
# plain versions ([BH, S, D]; the kernels' numerics)
# ---------------------------------------------------------------------------

def _causal_keep(sq, sk, device):
    """[Sq, Sk] bool: query row r sees key column c iff c <= r + (sk - sq)."""
    row = torch.arange(sq, device=device)[:, None]
    col = torch.arange(sk, device=device)[None, :]
    return col <= row + (sk - sq)


def _round(x, dtype):
    """x (f32) rounded to `dtype` and back to f32: the reference's casts."""
    return x.to(dtype).float()


def _bias_rows(bias, heads):
    """[B, Sk] f32 → [BH, 1, Sk]: batch b's row for each of its heads."""
    return bias.float().repeat_interleave(heads, 0)[:, None, :]


def flash_fwd_ref(q, k, v, causal: bool, scale: float, bias=None,
                  heads: int = 1):
    """Plain version of the forward kernel. q [BH, Sq, D], k/v [BH, Sk, D]
    → (out [BH, Sq, D] in q's dtype, lse [BH, Sq] f32).

    q is scaled in f32 and rounded to its dtype (flash_attention.py:196);
    scores and softmax in f32 with masked entries at -1e30; the bias row
    (``bias`` [B, Sk] f32, non-causal) added to the scores (:211); p
    rounded to v's dtype before the product (:229); ``lse = m + log(l)``
    with ``l == 0 → 1`` (:266-268)."""
    dt = q.dtype
    s = _round(q.float() * scale, dt) @ k.float().transpose(1, 2)
    if bias is not None:
        s = s + _bias_rows(bias, heads)
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[1], k.shape[1], q.device),
                          _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (_round(p, v.dtype) @ v.float()) / safe_l
    return out.to(dt), (m + torch.log(safe_l))[..., 0]


def _probs(s, lse, causal, bias, heads):
    """p = exp(s (+ bias) - lse) in f32, zero where the causal mask hides
    it."""
    if bias is not None:
        s = s + _bias_rows(bias, heads)
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(s.shape[1], s.shape[2], s.device),
                          0.0)
    return p


def flash_dq_ref(q, k, v, dout, lse, delta, causal: bool, scale: float,
                 bias=None, heads: int = 1):
    """Plain version of the dQ kernel: the scale folds into k, rounded to
    the input dtype (:357); ``ds`` is rounded before ``ds·ks`` (:384)."""
    dt = q.dtype
    ks = _round(k.float() * scale, dt)
    p = _probs(q.float() @ ks.transpose(1, 2), lse, causal, bias, heads)
    dp = dout.float() @ v.float().transpose(1, 2)
    return (_round(p * (dp - delta[..., None]), dt) @ ks).to(dt)


def flash_dkv_ref(q, k, v, dout, lse, delta, causal: bool, scale: float,
                  bias=None, heads: int = 1):
    """Plain version of the dK/dV kernel: the scale folds into q, rounded
    to the input dtype (:448); p and ``ds`` are rounded before their
    products (:478, :485). Returns (dk, dv)."""
    dt = q.dtype
    qs = _round(q.float() * scale, dt)
    p = _probs(qs @ k.float().transpose(1, 2), lse, causal, bias, heads)
    dof = dout.float()
    dv = _round(p, dt).transpose(1, 2) @ dof
    dp = dof @ v.float().transpose(1, 2)
    dk = _round(p * (dp - delta[..., None]), dt).transpose(1, 2) @ qs
    return dk.to(dt), dv.to(dt)


def _delta(out, dout):
    """rowsum(dO·O) in f32 [BH, Sq] (flash_attention.py:551)."""
    return (dout.float() * out.float()).sum(-1)


def flash_bwd_ref(q, k, v, out, lse, dout, causal: bool, scale: float,
                  bias=None, heads: int = 1):
    """Plain version of the backward (delta, then the dQ and dK/dV
    kernels' plain versions) → (dq, dk, dv) in the input dtype."""
    delta = _delta(out, dout)
    dk, dv = flash_dkv_ref(q, k, v, dout, lse, delta, causal, scale, bias,
                           heads)
    return (flash_dq_ref(q, k, v, dout, lse, delta, causal, scale, bias,
                         heads), dk, dv)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# bh, sq, sk, d, causal, heads, scale, stream
_TAIL = [_I] * 6 + [_F, _P]
_ARGTYPES = {"flash_fwd": [_P] * 6 + _TAIL,     # q, k, v, bias, o, lse
             "flash_dq": [_P] * 8 + _TAIL,      # ..., delta, bias, dq
             "flash_dkv": [_P] * 9 + _TAIL}     # ..., delta, bias, dk, dv


@functools.cache
def _lib():
    return _build.library("flash_attention.cu", _ARGTYPES)


def _check_cuda(name, tensors, d):
    """The kernels' contract: one CUDA device, float32 or bfloat16 for
    every data tensor, f32 row vectors and bias, contiguous, head dim ≤
    256."""
    q = tensors[0]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous tensors")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"{name} kernel takes head_dim <= {_MAX_HEAD_DIM}, "
                         f"got {d}")


def _call(name, dtype, device, *args):
    _build.call(_lib(), name, dtype, device, *args)
    launches[name] += 1


def _shapes(q, k, v):
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"flash kernels take q [BH, Sq, D] and k/v "
                         f"[BH, Sk, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in BH or D")
    return bh, sq, k.shape[1], d


def _bias_arg(bias, heads, bh, sk, causal):
    """The bias pointer for the kernels (None without one), after the
    contract's checks: [bh / heads, sk] f32, non-causal."""
    if bias is None:
        return None
    if causal:
        raise NotImplementedError(
            "flash kernels: kv_bias is only implemented for the non-causal "
            "kernel")
    if heads < 1 or bh % heads or tuple(bias.shape) != (bh // heads, sk):
        raise ValueError(f"flash kernels: bias {tuple(bias.shape)} must be "
                         f"[{bh} // heads={heads}, {sk}]")
    if bias.dtype != torch.float32:
        raise TypeError(f"flash kernels: bias must be float32, got "
                        f"{bias.dtype}")
    return bias.data_ptr()


def _fwd_cuda(q, k, v, causal, scale, bias=None, heads=1):
    bh, sq, sk, d = _shapes(q, k, v)
    _check_cuda("flash_fwd", (q, k, v) + (() if bias is None else (bias,)),
                d)
    for t in (k, v):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_fwd kernel: k/v are {t.dtype}, q is "
                            f"{q.dtype} (one dtype for all)")
    bptr = _bias_arg(bias, heads, bh, sk, causal)
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _call("flash_fwd", q.dtype, q.device, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), bptr, out.data_ptr(), lse.data_ptr(), bh, sq, sk, d,
          int(causal), int(heads), float(scale))
    return out, lse


def _bwd_cuda(q, k, v, out, lse, dout, causal, scale, bias=None, heads=1):
    bh, sq, sk, d = _shapes(q, k, v)
    _check_cuda("flash_bwd", (q, k, v, out, dout, lse)
                + (() if bias is None else (bias,)), d)
    for t in (k, v, out, dout):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_bwd kernels: one dtype for q, k, v, out "
                            f"and dout, got {t.dtype} and {q.dtype}")
    if lse.dtype != torch.float32 or lse.shape != (bh, sq):
        raise ValueError(f"lse must be float32 [{bh}, {sq}], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("out and dout must have q's shape")
    # delta outside the kernels, as in the reference
    delta = _delta(out, dout)
    return (_dq_cuda(q, k, v, dout, lse, delta, causal, scale, bias, heads),
            *_dkv_cuda(q, k, v, dout, lse, delta, causal, scale, bias,
                       heads))


def _dq_cuda(q, k, v, dout, lse, delta, causal, scale, bias=None, heads=1):
    bh, sq, sk, d = _shapes(q, k, v)
    bptr = _bias_arg(bias, heads, bh, sk, causal)
    dq = torch.empty_like(q)
    _call("flash_dq", q.dtype, q.device, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
          bptr, dq.data_ptr(), bh, sq, sk, d, int(causal), int(heads),
          float(scale))
    return dq


def _dkv_cuda(q, k, v, dout, lse, delta, causal, scale, bias=None, heads=1):
    bh, sq, sk, d = _shapes(q, k, v)
    bptr = _bias_arg(bias, heads, bh, sk, causal)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _call("flash_dkv", q.dtype, q.device, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
          bptr, dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d, int(causal),
          int(heads), float(scale))
    return dk, dv


def _on(device, name):
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, got {device}")
    return device.type == "cuda"


# ---------------------------------------------------------------------------
# custom ops + autograd
# ---------------------------------------------------------------------------

@torch.library.custom_op(
    "paddle_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, float scale, "
           "Tensor? bias=None, int heads=1) -> (Tensor, Tensor)")
def flash_fwd(q, k, v, causal, scale, bias=None, heads=1):
    """Flash-attention forward on [BH, S, D] → (out, lse [BH, Sq] f32)."""
    if _on(q.device, "flash_fwd"):
        return _fwd_cuda(q, k, v, causal, scale, bias, heads)
    return flash_fwd_ref(q, k, v, causal, scale, bias, heads)


@torch.library.custom_op(
    "paddle_tpu_torch::flash_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
           "Tensor dout, bool causal, float scale, Tensor? bias=None, "
           "int heads=1) -> (Tensor, Tensor, Tensor)")
def flash_bwd(q, k, v, out, lse, dout, causal, scale, bias=None, heads=1):
    """Flash-attention backward on [BH, S, D] → (dq, dk, dv)."""
    if _on(q.device, "flash_bwd"):
        return _bwd_cuda(q, k, v, out, lse, dout, causal, scale, bias, heads)
    return flash_bwd_ref(q, k, v, out, lse, dout, causal, scale, bias, heads)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, scale, bias, heads = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, bias)
    ctx.causal, ctx.scale, ctx.heads = causal, scale, heads


def _backward(ctx, dout, _dlse):
    # lse is a residual for the backward only; flash_attention_bshd never
    # returns it, so its cotangent carries nothing. The bias gets no
    # gradient, as in the reference (:648)
    q, k, v, out, lse, bias = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(), ctx.causal,
                           ctx.scale, bias, ctx.heads)
    return dq, dk, dv, None, None, None, None


flash_fwd.register_autograd(_backward, setup_context=_setup_context)


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

def flash_attention_bshd(q, k, v, causal=False, scale=None, kv_bias=None,
                         dropout_p=0.0, dropout_seed=None):
    """Flash attention on Paddle's layout [b, s, h, d] (GQA-aware).

    Returns out [b, sq, h, d] in q's dtype. k/v may have fewer heads
    (GQA): they are repeated to q's heads before the kernel, and the
    repeat's gradient sums each group (flash_attention.py:764-767). The
    default scale is ``d ** -0.5``. ``kv_bias`` [b, sk] is the
    key-padding regime (non-causal): an additive f32 bias per key column,
    0 keeping a column; values ≤ -1e8 are canonicalised to the kernels'
    -1e30, so fully masked KV tiles are skipped; a row with no valid key
    is undefined, as in the reference. ``dropout_p > 0`` (in-kernel
    attention dropout) is ROADMAP A6b: it raises NotImplementedError
    after the reference's own checks."""
    if causal and kv_bias is not None:
        raise NotImplementedError(
            "flash_attention_bshd: kv_bias (key-padding mask) is only "
            "implemented for the non-causal kernel; use the XLA reference "
            "path for causal + mask")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError(
            "flash_attention_bshd: dropout_p > 0 requires dropout_seed "
            "(a (2,) int32/uint32 key-data pair)")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    hk = k.shape[2]
    bias = None
    if kv_bias is not None:
        bias = torch.as_tensor(kv_bias, device=q.device).float()
        if tuple(bias.shape) != (b, sk):
            raise ValueError(
                f"kv_bias must have shape {(b, sk)}, got "
                f"{tuple(bias.shape)}")
        bias = torch.where(bias <= _MASK_THRESH,
                           torch.full_like(bias, _NEG_INF), bias).contiguous()
    if dropout_p > 0.0:
        raise NotImplementedError(
            "flash_attention_bshd: in-kernel attention dropout (the "
            "portable keep-mask hash keyed by the reference's tiles) is "
            "ROADMAP A6b")
    if hk != h:
        rep = h // hk
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if scale is None:
        scale = d ** -0.5

    def flat(t, s):
        return t.transpose(1, 2).reshape(b * h, s, d).contiguous()

    out, _ = flash_fwd(flat(q, sq), flat(k, sk), flat(v, sk), bool(causal),
                       float(scale), bias, int(h))
    return out.reshape(b, h, sq, d).transpose(1, 2)
