"""Chunked-vocabulary softmax cross-entropy (memory-lean LM loss head).

Counterpart: ``paddle_tpu/kernels/chunked_xent.py`` (``_pick_chunks``
:29, ``_resolve_chunks`` :53, ``chunked_softmax_xent`` :70,
``chunked_softmax_xent_per_token`` :80 with its vjp :130). Plain PyTorch,
not a kernel: the reference has no Pallas here. Its ``lax.scan`` over K
vocab chunks is a Python loop inside a ``torch.autograd.Function``: the
forward carries the online-softmax state (running max, running sum-exp)
and the gold-label logit, so only [B, S] f32 statistics outlive a chunk;
the backward recomputes each chunk's logits from the saved (x, w, lse).
The [B, S, V] logits never exist at once. The chunk count comes from the
largest-divisor heuristic; the reference's autotuning table is not
ported.
"""
from __future__ import annotations

import torch

__all__ = ["chunked_softmax_xent", "chunked_softmax_xent_per_token"]

_NEG = -1e30


def _pick_chunks(vocab: int, want: int = 8) -> int:
    """The largest divisor of the vocab that is ≤ want."""
    for k in range(min(want, vocab), 0, -1):
        if vocab % k == 0:
            return k
    return 1


def _resolve_chunks(n_chunks, vocab: int) -> int:
    """Explicit n_chunks must divide the (padded) vocab exactly; chunk
    counts are never re-rounded (the reference's message)."""
    if n_chunks:
        k = int(n_chunks)
        if k <= 0 or vocab % k:
            raise ValueError(
                f"chunked_softmax_xent: explicit n_chunks={n_chunks} does "
                f"not divide the padded vocab {vocab} — pass a divisor "
                f"(or None for the tuned/heuristic pick); chunk counts "
                f"are never silently re-rounded")
        return k
    return _pick_chunks(vocab)


def _chunk_logits(x32, wc, bc):
    """[B, S, Vc] f32 logits of one chunk: the product of the input
    dtype's values accumulated in f32, plus the f32 bias."""
    return x32 @ wc.float().T + bc


class _ChunkedXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, bias, labels, n_chunks):
        V, H = w.shape
        K = _resolve_chunks(n_chunks, V)
        Vc = V // K
        B, S, _ = x.shape
        x32 = x.float()
        m = torch.full((B, S), _NEG, device=x.device)
        s = torch.zeros((B, S), device=x.device)
        gold = torch.full((B, S), _NEG, device=x.device)
        for c in range(K):
            bc = (torch.zeros((Vc,), device=x.device) if bias is None
                  else bias[c * Vc:(c + 1) * Vc].float())
            logits = _chunk_logits(x32, w[c * Vc:(c + 1) * Vc], bc)
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[..., None]).sum(-1)
            m = m_new
            local = labels.long() - c * Vc
            in_chunk = (local >= 0) & (local < Vc)
            picked = logits.gather(-1, local.clamp(0, Vc - 1)[..., None])[..., 0]
            gold = torch.where(in_chunk, picked, gold)
        lse = torch.log(s) + m
        ctx.save_for_backward(x, w, bias, labels, lse)
        ctx.n_chunks = K
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        x, w, bias, labels, lse = ctx.saved_tensors
        V, H = w.shape
        K = ctx.n_chunks
        Vc = V // K
        gs = g.float()[..., None]
        x32 = x.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw, db = [], []
        for c in range(K):
            wc = w[c * Vc:(c + 1) * Vc]
            bc = (torch.zeros((Vc,), device=x.device) if bias is None
                  else bias[c * Vc:(c + 1) * Vc].float())
            p = torch.exp(_chunk_logits(x32, wc, bc) - lse[..., None])
            local = labels.long() - c * Vc
            in_chunk = ((local >= 0) & (local < Vc)).float()
            onehot = torch.nn.functional.one_hot(
                local.clamp(0, Vc - 1), Vc).float() * in_chunk[..., None]
            d = (p - onehot) * gs                        # [B, S, Vc] f32
            dhalf = d.to(x.dtype).float()
            dx += dhalf @ wc.float()
            dw.append((dhalf.reshape(-1, Vc).T @ x32.reshape(-1, H))
                      .to(w.dtype))
            db.append(d.sum((0, 1)))
        dbias = None if bias is None else torch.cat(db).to(bias.dtype)
        return dx.to(x.dtype), torch.cat(dw), dbias, None, None


def chunked_softmax_xent_per_token(x, w, bias, labels, n_chunks=None):
    """Per-position cross-entropy of a tied-embedding head with optional
    bias, never materialising [B, S, V] logits. x [B, S, H]; w [V, H];
    bias [V] or None; labels [B, S] int. Returns f32 [B, S] losses."""
    return _ChunkedXent.apply(x, w, bias, labels, n_chunks)


def chunked_softmax_xent(x, w, labels, n_chunks=None):
    """Mean token cross-entropy of a tied-embedding LM head (no bias):
    the GPT loss."""
    return chunked_softmax_xent_per_token(x, w, None, labels,
                                          n_chunks).mean()
