"""Multi-token decode window with sampling on the device.

Counterpart: ``paddle_tpu/inference/device_loop.py`` — ``decode_window``
(:47-92) and the speculative draft loop ``draft_window`` (:95-118).

Where the reference runs one compiled ``lax.scan``, the port runs a
Python loop of k decode steps whose tensors stay on the card: each step
appends the incoming token's K/V (inside the model's decode step),
samples the next token on the card and feeds it to the next step. The
host reads the packed ``[B, k]`` int32 matrix ONCE per window, through
the caller; ``-1`` marks lanes already finished.

Masked lanes, as in the reference: a lane that hits EOS or its token
budget keeps stepping with its block-table row replaced by the pad row
(its KV write lands in or past the trash slot), its position input
clamped to 0 (the position table is indexed unclamped), and its carried
token/position/count frozen. ``write_limits`` pad-masks any step whose
write position would pass the lane's reserved budget. Positions are
also clamped to the context window: torch raises on an out-of-range
gather where JAX clamps.

Uniform draws: a lane still live at window step j has emitted exactly j
tokens in this window, so its draw is ``uniform(fold_in(PRNGKey(seed),
counts + j))`` — the reference's draw for that lane. The port computes
the [B, k] draws once per window where the seeds live (the host) and
copies them to the card in one transfer; a finished lane's draw is
never used. Windows with no sampled lane skip the categorical math.
"""
from __future__ import annotations

import torch

from ..nn.functional.sampling import (categorical_math, derive_key,
                                      greedy_math, uniform)

__all__ = ["decode_window", "draft_window", "window_uniforms"]


def window_uniforms(seeds: torch.Tensor, counts: torch.Tensor,
                    k: int) -> torch.Tensor:
    """[B, k] float32: lane i's draw for generated-token #counts[i]+j."""
    cnt = counts.long()[:, None] + torch.arange(k, device=counts.device)
    return uniform(derive_key(seeds.long()[:, None], cnt))


def decode_window(decode_fn, params, k_pool, v_pool, tokens, positions,
                  tables, done0, counts, eos, limits, write_limits,
                  temperature, top_k, top_p, seeds, pad_block, k,
                  block_size):
    """Run k decode+sample steps; the reference's arguments.

    decode_fn: ``(params, k_pool, v_pool, tokens, positions, tables) →
    (logits, k_pool, v_pool)``. tokens/positions [B] int32 and tables
    [B, MB] int32 on the pools' device; the per-lane bookkeeping (done0
    [B] bool, counts/eos/limits/write_limits/top_k [B] int, temperature/
    top_p [B] float, seeds [B] int holding uint32 values) may live on
    the host and is copied to the card once per window.

    Returns ``(out [B, k] int32 on the card, k_pool, v_pool)``;
    ``out[i, j]`` is -1 iff lane i was done before window-step j."""
    dev = tokens.device
    ctx = tables.shape[1] * block_size
    sampled = bool((temperature > 0).any())
    if sampled:
        u = window_uniforms(seeds, counts, k).to(dev)
    done0, counts, eos, limits, write_limits, temperature, top_k, top_p = (
        t.to(dev) for t in (done0, counts, eos, limits, write_limits,
                            temperature, top_k, top_p))
    tok, pos, done, cnt = tokens, positions, done0, counts.to(torch.int32)
    outs = []
    for j in range(k):
        mask = done | (pos > write_limits)
        bt = torch.where(mask[:, None], pad_block, tables)
        pos_in = torch.where(done, 0, pos).clamp(max=ctx - 1)
        logits, k_pool, v_pool = decode_fn(params, k_pool, v_pool, tok,
                                           pos_in, bt)
        nxt = greedy_math(logits)
        if sampled:
            nxt = torch.where(temperature > 0,
                              categorical_math(logits, u[:, j], temperature,
                                               top_k, top_p), nxt)
        outs.append(torch.where(done, -1, nxt))
        cnt2 = cnt + (~done).to(cnt.dtype)
        done2 = done | ((eos >= 0) & (nxt == eos)) | (cnt2 >= limits)
        tok = torch.where(done, tok, nxt)
        pos = torch.where(done, pos, pos + 1)
        done, cnt = done2, cnt2
    return torch.stack(outs, dim=1), k_pool, v_pool


def draft_window(decode_fn, params, k_pool, v_pool, tokens, positions,
                 tables, limits, pad_block, k, block_size):
    """k greedy decode steps of the speculative draft model, the tokens
    kept on the card: every lane steps all k times; a step whose
    position passes the lane's ``limits`` entry gets the pad block-table
    row (its write goes to the trash slot), and positions are clamped to
    the context window. tokens/positions/tables on the pools' device;
    ``limits`` [B] int may live on the host. Returns ``(drafts [B, k]
    int32 on the card, k_pool, v_pool)``; the caller reads the drafts
    once."""
    ctx = tables.shape[1] * block_size
    limits = limits.to(tokens.device)
    tok, pos = tokens, positions
    outs = []
    for _ in range(k):
        bt = torch.where((pos > limits)[:, None], pad_block, tables)
        logits, k_pool, v_pool = decode_fn(params, k_pool, v_pool, tok,
                                           pos.clamp(max=ctx - 1), bt)
        tok = greedy_math(logits)
        outs.append(tok)
        pos = pos + 1
    return torch.stack(outs, dim=1), k_pool, v_pool
