"""Token sampling for the serving decode path.

Counterpart: ``paddle_tpu/nn/functional/sampling.py`` (:55-173). Same
contracts:

* greedy is ``argmax`` with the first-occurrence tie-break;
* ``categorical_math`` takes the uniform variate ``u`` as an input
  (inverse CDF over the temperature-scaled, top-k then top-p filtered
  distribution, ordered by a STABLE descending sort), so given the same
  ``u`` the token is the reference's;
* ``derive_key(seed, count)`` = ``fold_in(PRNGKey(seed), count)``. The
  threefry-2x32 hash, ``PRNGKey``, ``fold_in``, ``split``,
  ``random_bits``, ``uniform`` and ``bernoulli`` are reimplemented here in
  int64 tensor arithmetic masked to 32 bits, so a sampled stream and a
  dropout mask are bitwise ``jax.random``'s (default threefry
  implementation, ``jax_threefry_partitionable`` on) for the same key —
  tests/test_torch_sampling.py and tests/test_torch_dropout.py pin it.
  ``threefry2x32`` takes Python ints too (the framework generator,
  core/generator.py, splits its key on the host);
* invalid knobs raise ValueError with the exact reference strings;
* ``sample_greedy`` and ``sample_categorical`` are registered ops (white,
  not differentiable), as the reference's are (:176-178).
"""
from __future__ import annotations

import torch

from ...core.dispatch import register_op

__all__ = ["sample_categorical", "sample_greedy", "greedy_math",
           "categorical_math", "derive_key", "sample_token", "prng_key",
           "fold_in", "split", "random_bits", "uniform", "bernoulli",
           "threefry2x32"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# ---------------------------------------------------------------------------
# threefry-2x32 and the jax.random key functions built on it
# ---------------------------------------------------------------------------

def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 hash of (x1, x2) under key (k1, k2).
    All four are int64 tensors holding uint32 values (broadcastable), or
    all Python ints; returns the two uint32 output words in that form."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` key data, [..., 2] int64 (uint32
    values): the 64-bit seed split into (high, low) words."""
    s = torch.as_tensor(seed, dtype=torch.int64)
    return torch.stack([(s >> 32) & _M32, s & _M32], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash of the counter pair (0, data)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` key data, [num, 2] int64: key i is
    the hash of the counter pair (0, i) (``_threefry_split_foldlike``)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(i), i)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32, as int64 values), for key
    data [..., 2] → [..., *shape]: each element hashes its row-major flat
    index, split into (high, low) 32-bit counter words, and the two output
    words are xor-ed (``_threefry_random_bits_partitionable``)."""
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = tuple(key.shape[:-1]) + (1,) * len(shape)
    k1, k2 = key[..., 0].reshape(lead), key[..., 1].reshape(lead)
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return y1 ^ y2


def uniform(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32, [0, 1)) for key data
    [..., 2] → [..., *shape]: the top 23 of each element's 32 random bits
    become the mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` with p in
    float32."""
    u = uniform(key, shape)
    return u < torch.tensor(float(p), dtype=torch.float32, device=u.device)


def derive_key(seed, count) -> torch.Tensor:
    """Counter-derived key: fold_in(PRNGKey(seed), count). ``count`` is
    the request's generated-token count, so a stream is a pure function
    of (seed, position in the stream)."""
    return fold_in(prng_key(seed), count)


# ---------------------------------------------------------------------------
# pure forms
# ---------------------------------------------------------------------------

def greedy_math(logits):
    """[..., V] → [...] int32 argmax, first-occurrence tie-break."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def categorical_math(logits, u, temperature, top_k, top_p):
    """Batched inverse-CDF sampling with per-lane knob tensors.

    logits [B, V]; u/temperature/top_p [B] float; top_k [B] int.
    Returns [B] int32 (reference: sampling.py:61)."""
    ft = torch.promote_types(logits.dtype, torch.float32)
    z = logits.to(ft)
    V = z.shape[-1]
    t = temperature.to(ft)
    z = z / torch.where(t > 0, t, torch.ones_like(t))[:, None]

    order = torch.argsort(-z, dim=-1, stable=True)
    z_sorted = torch.gather(z, -1, order)

    top_k = top_k.long()
    kth = torch.gather(z_sorted, -1, (top_k - 1).clamp(0, V - 1)[:, None])
    apply_k = (top_k > 0) & (top_k < V)
    z = torch.where(apply_k[:, None] & (z < kth),
                    torch.full_like(z, float("-inf")), z)

    p = torch.softmax(z, dim=-1)
    p_sorted = torch.gather(p, -1, order)
    csum = torch.cumsum(p_sorted, dim=-1)

    top_p = top_p.to(ft)
    cut = (csum < top_p[:, None]).sum(-1) + 1
    cut = torch.where(top_p < 1.0, cut.clamp(max=V), torch.full_like(cut, V))
    keep = torch.arange(V, device=z.device)[None, :] < cut[:, None]
    p_kept = torch.where(keep, p_sorted, torch.zeros_like(p_sorted))
    total = p_kept.sum(-1)
    csum_kept = torch.cumsum(p_kept, dim=-1)

    u = u.to(ft)
    j = (csum_kept < (u * total)[:, None]).sum(-1)
    j = torch.minimum(j.clamp(min=0), cut - 1)
    return torch.gather(order, -1, j[:, None])[:, 0].to(torch.int32)


def sample_token(logits_row, seed, count, temperature, top_k, top_p) -> int:
    """The exact token the device loop emits for generated-token
    #``count`` of a request (used for the prefill-sampled first token)."""
    row = logits_row.reshape(1, -1)
    if temperature == 0:
        return int(greedy_math(row)[0])
    dev = row.device
    u = uniform(derive_key(int(seed), int(count))).reshape(1).to(dev)
    tok = categorical_math(
        row, u,
        torch.full((1,), temperature, dtype=torch.float32, device=dev),
        torch.full((1,), int(top_k), dtype=torch.int32, device=dev),
        torch.full((1,), top_p, dtype=torch.float32, device=dev))
    return int(tok[0])


# ---------------------------------------------------------------------------
# knob-checked entry points (the reference's registered ops)
# ---------------------------------------------------------------------------

def _sample_greedy(logits):
    """Greedy token per lane: [B, V] (or [V]) logits → int32 argmax."""
    return greedy_math(logits)


def _sample_categorical(logits, u, temperature=1.0, top_k=0, top_p=1.0):
    """Seeded categorical sample: [B, V] logits + [B] uniforms → [B]
    int32 tokens. Knobs are Python scalars validated with the exact
    messages ``SamplingParams`` pins."""
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature == 0:
        raise ValueError(
            "temperature=0 is exact greedy; top_k/top_p would be "
            "silently dead — pass temperature > 0 to sample")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0 (0 = off), got {top_k}")
    if not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if logits.ndim != 2:
        raise ValueError(
            f"sample_categorical wants [B, V] logits, got shape "
            f"{tuple(logits.shape)}")
    B, dev = logits.shape[0], logits.device
    return categorical_math(
        logits, torch.as_tensor(u, device=dev),
        torch.full((B,), temperature, dtype=torch.float32, device=dev),
        torch.full((B,), int(top_k), dtype=torch.int32, device=dev),
        torch.full((B,), top_p, dtype=torch.float32, device=dev))


sample_greedy = register_op("sample_greedy", amp="white",
                            differentiable=False)(_sample_greedy)
sample_categorical = register_op("sample_categorical", amp="white",
                                 differentiable=False)(_sample_categorical)
