"""Flash attention, forward and backward, on Paddle's [b, s, h, d] layout.

Counterpart: ``paddle_tpu/kernels/flash_attention.py``: ``_fwd_kernel``
(:167), ``_dq_kernel`` (:329), ``_dkv_kernel`` (:420), ``_fwd`` (:272),
``_bwd`` (:539), the ``custom_vjp`` assembly (:624) and
``flash_attention_bshd`` (:722). The key-padding bias and dropout
variants belong to a later slice (ROADMAP A6) and raise here.

The forward and backward are ``torch.library`` custom ops,
``paddle_tpu_torch::flash_fwd`` → ``(out, lse)`` and
``paddle_tpu_torch::flash_bwd`` → ``(dq, dk, dv)``, joined by
``register_autograd``: a selective-checkpoint policy sees the forward as
one dispatcher op and can save its ``out``/``lse``, as the reference's
``flash_out``/``flash_lse`` names do (:641-642). For CUDA tensors the ops
launch the hand-written Hopper kernels of ``csrc/flash_attention.cu`` (its
header names the TPU kernels replaced, the operation bound and what the
design does about it) or raise; for CPU tensors they take the plain
PyTorch versions ``flash_fwd_ref`` / ``flash_bwd_ref``. ``launches``
counts kernel launches by kernel name (CPU calls do not count).
"""
import ctypes
import functools

import torch

__all__ = ["flash_attention_bshd", "flash_fwd", "flash_bwd", "flash_fwd_ref",
           "flash_bwd_ref", "flash_dq_ref", "flash_dkv_ref", "launches"]

_NEG_INF = -1e30   # flash_attention.py:61: the mask value, never -inf
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


def flash_fwd_ref(q, k, v, causal: bool, scale: float):
    """Plain version of the forward kernel. q [BH, Sq, D], k/v [BH, Sk, D]
    → (out [BH, Sq, D] in q's dtype, lse [BH, Sq] f32).

    q is scaled in f32 and rounded to its dtype (flash_attention.py:196);
    scores and softmax in f32 with masked entries at -1e30; p rounded to
    v's dtype before the product (:229); ``lse = m + log(l)`` with
    ``l == 0 → 1`` (:266-268)."""
    dt = q.dtype
    s = _round(q.float() * scale, dt) @ k.float().transpose(1, 2)
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[1], k.shape[1], q.device),
                          _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (_round(p, v.dtype) @ v.float()) / safe_l
    return out.to(dt), (m + torch.log(safe_l))[..., 0]


def _probs(s, lse, causal):
    """p = exp(s - lse) in f32, zero where the causal mask hides it."""
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(s.shape[1], s.shape[2], s.device),
                          0.0)
    return p


def flash_dq_ref(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """Plain version of the dQ kernel: the scale folds into k, rounded to
    the input dtype (:357); ``ds`` is rounded before ``ds·ks`` (:384)."""
    dt = q.dtype
    ks = _round(k.float() * scale, dt)
    p = _probs(q.float() @ ks.transpose(1, 2), lse, causal)
    dp = dout.float() @ v.float().transpose(1, 2)
    return (_round(p * (dp - delta[..., None]), dt) @ ks).to(dt)


def flash_dkv_ref(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """Plain version of the dK/dV kernel: the scale folds into q, rounded
    to the input dtype (:448); p and ``ds`` are rounded before their
    products (:478, :485). Returns (dk, dv)."""
    dt = q.dtype
    qs = _round(q.float() * scale, dt)
    p = _probs(qs @ k.float().transpose(1, 2), lse, causal)
    dof = dout.float()
    dv = _round(p, dt).transpose(1, 2) @ dof
    dp = dof @ v.float().transpose(1, 2)
    dk = _round(p * (dp - delta[..., None]), dt).transpose(1, 2) @ qs
    return dk.to(dt), dv.to(dt)


def _delta(out, dout):
    """rowsum(dO·O) in f32 [BH, Sq] (flash_attention.py:551)."""
    return (dout.float() * out.float()).sum(-1)


def flash_bwd_ref(q, k, v, out, lse, dout, causal: bool, scale: float):
    """Plain version of the backward (delta, then the dQ and dK/dV
    kernels' plain versions) → (dq, dk, dv) in the input dtype."""
    delta = _delta(out, dout)
    dk, dv = flash_dkv_ref(q, k, v, dout, lse, delta, causal, scale)
    return flash_dq_ref(q, k, v, dout, lse, delta, causal, scale), dk, dv


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I] * 5 + [_F, _P]      # bh, sq, sk, d, causal, scale, stream
_ARGTYPES = {"flash_fwd": [_P] * 5 + _TAIL,
             "flash_dq": [_P] * 7 + _TAIL,
             "flash_dkv": [_P] * 8 + _TAIL}


@functools.cache
def _lib():
    from ._build import load
    lib = load("flash_attention.cu")
    for name, argtypes in _ARGTYPES.items():
        for suffix in ("f32", "bf16"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(name, tensors, d):
    """The kernels' contract: one CUDA device, float32 or bfloat16 for
    every data tensor, f32 row vectors, contiguous, head dim ≤ 256."""
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
    lib = _lib()
    fn = getattr(lib, f"{name}_{'bf16' if dtype == torch.bfloat16 else 'f32'}")
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.flash_error_string(rc).decode()})")
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


def _fwd_cuda(q, k, v, causal, scale):
    bh, sq, sk, d = _shapes(q, k, v)
    _check_cuda("flash_fwd", (q, k, v), d)
    for t in (k, v):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_fwd kernel: k/v are {t.dtype}, q is "
                            f"{q.dtype} (one dtype for all)")
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _call("flash_fwd", q.dtype, q.device, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, sq, sk, d,
          int(causal), float(scale))
    return out, lse


def _bwd_cuda(q, k, v, out, lse, dout, causal, scale):
    bh, sq, sk, d = _shapes(q, k, v)
    _check_cuda("flash_bwd", (q, k, v, out, dout, lse), d)
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
    return (_dq_cuda(q, k, v, dout, lse, delta, causal, scale),
            *_dkv_cuda(q, k, v, dout, lse, delta, causal, scale))


def _dq_cuda(q, k, v, dout, lse, delta, causal, scale):
    bh, sq, sk, d = _shapes(q, k, v)
    dq = torch.empty_like(q)
    _call("flash_dq", q.dtype, q.device, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
          dq.data_ptr(), bh, sq, sk, d, int(causal), float(scale))
    return dq


def _dkv_cuda(q, k, v, dout, lse, delta, causal, scale):
    bh, sq, sk, d = _shapes(q, k, v)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _call("flash_dkv", q.dtype, q.device, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
          dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d, int(causal),
          float(scale))
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
    schema="(Tensor q, Tensor k, Tensor v, bool causal, float scale) "
           "-> (Tensor, Tensor)")
def flash_fwd(q, k, v, causal, scale):
    """Flash-attention forward on [BH, S, D] → (out, lse [BH, Sq] f32)."""
    if _on(q.device, "flash_fwd"):
        return _fwd_cuda(q, k, v, causal, scale)
    return flash_fwd_ref(q, k, v, causal, scale)


@torch.library.custom_op(
    "paddle_tpu_torch::flash_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
           "Tensor dout, bool causal, float scale) "
           "-> (Tensor, Tensor, Tensor)")
def flash_bwd(q, k, v, out, lse, dout, causal, scale):
    """Flash-attention backward on [BH, S, D] → (dq, dk, dv)."""
    if _on(q.device, "flash_bwd"):
        return _bwd_cuda(q, k, v, out, lse, dout, causal, scale)
    return flash_bwd_ref(q, k, v, out, lse, dout, causal, scale)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale


def _backward(ctx, dout, _dlse):
    # lse is a residual for the backward only; flash_attention_bshd never
    # returns it, so its cotangent carries nothing
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(), ctx.causal,
                           ctx.scale)
    return dq, dk, dv, None, None


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
    default scale is ``d ** -0.5``. ``kv_bias`` (the key-padding regime)
    and ``dropout_p > 0`` are the BERT variants, ported in ROADMAP A6:
    they raise NotImplementedError after the reference's own checks."""
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
    if kv_bias is not None:
        if tuple(kv_bias.shape) != (b, sk):
            raise ValueError(
                f"kv_bias must have shape {(b, sk)}, got "
                f"{tuple(kv_bias.shape)}")
        raise NotImplementedError(
            "flash_attention_bshd: the kv_bias (key-padding) kernel variant "
            "is ported with BERT (ROADMAP A6)")
    if dropout_p > 0.0:
        raise NotImplementedError(
            "flash_attention_bshd: in-kernel attention dropout is ported "
            "with BERT (ROADMAP A6)")
    if hk != h:
        rep = h // hk
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if scale is None:
        scale = d ** -0.5

    def flat(t, s):
        return t.transpose(1, 2).reshape(b * h, s, d).contiguous()

    out, _ = flash_fwd(flat(q, sq), flat(k, sk), flat(v, sk), bool(causal),
                       float(scale))
    return out.reshape(b, h, sq, d).transpose(1, 2)
