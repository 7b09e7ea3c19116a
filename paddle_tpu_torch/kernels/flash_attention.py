"""Flash attention, forward and backward, on Paddle's [b, s, h, d] layout.

Counterpart: ``paddle_tpu/kernels/flash_attention.py``: ``_fwd_kernel``
(:167), ``_dq_kernel`` (:329), ``_dkv_kernel`` (:420), ``_fwd`` (:272),
``_bwd`` (:539), the ``custom_vjp`` assembly (:624) and
``flash_attention_bshd`` (:722), with the key-padding bias variant
(``kv_bias``, non-causal; :790 canonicalises it, :648 gives it no
gradient) and in-kernel attention dropout (``dropout_p``,
``dropout_seed``). Also the keep-mask every dropout kernel of the port
draws: ``_keep_threshold`` (:92), the portable hash ``_interpret_bits``
(:97) and ``_keep_mask`` (:119) as ``keep_mask_ref``, the reference's
interpret-mode masks bit for bit (the compiled TPU's hardware generator
cannot be reproduced), and the block picks that key them,
``_auto_block`` / ``_auto_blocks`` (:652-717, the tuning table's entries
included, ``analysis/autotune.py``).

Dropout keys each element by the reference's logical tile, never by a
CUDA tile: the element (r, c) of head ``bh``'s score matrix hashes
(seed pair, bh, r // BQ, c // BK) with the index (r % BQ)·BK + c % BK in
its tile, (BQ, BK) being ``_auto_blocks``'s pick clamped to the
sequence as ``_fwd`` clamps it (:284-285). So any kernel tile draws the
reference's mask. The forward keeps l and lse undropped and feeds
``where(keep, p, 0) · f32(1 / (1 − p))`` to the product with v (:220-229);
dQ and dK/dV regenerate the mask from the seed pair (no mask is stored)
and apply it to dP with the same scaling, dV taking the dropped p
(:377-383, :467-485).

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
counts launches of the dropout-free kernels by kernel name,
``dropout_launches`` those of the dropout variants (CPU calls do not
count).

The forward has two CUDA kernels, chosen by ``fwd_route`` from the
dtype, the head dim and the pointers' alignment alone: ``wgmma``
(``flash_fwd_wgmma_kernel``, the Hopper design: TMA ring, warp-specialised
wgmma, softmax in registers) for bfloat16 at D = 64 or 128 with 16-byte
aligned tensors, every model path's case; ``generic``
(``flash_fwd_kernel``) for float32, other head dims and unaligned views.
``fwd_routes`` counts forward launches by route (dropout or not). No call
falls back from one to the other. ``fwd_tile_plan`` mirrors the wgmma
kernel's schedule (the KV tiles each q tile visits, masks or skips),
``fwd_block_items`` its persistent blocks' order over the q tiles and
``flash_bits_shifted`` its dropout key's shift path.

The backward has the same two routes, chosen by ``bwd_route`` by the same
rule: ``wgmma`` runs a pre-pass (``flash_bwd_prep_kernel``: q and k
scaled and rounded to bf16, delta = rowsum(dO·O) in f32; counted in
``prep_launches``), then ``flash_dq_wgmma_kernel`` and
``flash_dkv_wgmma_kernel`` (TMA rings, wgmma, accumulators in registers);
``generic`` computes delta in PyTorch and runs ``flash_dq_kernel`` and
``flash_dkv_kernel``. ``bwd_routes`` counts the dQ and dK/dV launches by
route. ``dq_tile_plan`` and ``dkv_tile_plan`` mirror the two kernels'
schedules, ``dkv_block_items`` the dK/dV kernel's persistent order
(``fwd_block_items`` is the dQ kernel's).
"""
import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build
from ..analysis import autotune

__all__ = ["DropKey", "drop_key", "dropout_bits_cuda", "dropout_launches",
           "flash_attention_bshd", "flash_bits_ref", "flash_bits_shifted",
           "flash_bwd", "flash_bwd_ref", "flash_dkv_ref", "flash_dq_ref",
           "flash_drop_tile", "flash_fwd", "flash_fwd_ref",
           "flash_key_shifts", "fwd_block_items", "fwd_route", "fwd_routes",
           "fwd_tile_plan", "bwd_route", "bwd_routes", "dq_tile_plan",
           "dkv_tile_plan", "dkv_block_items", "interpret_bits",
           "keep_mask_ref", "launches", "prep_launches", "row_bits_ref",
           "seed_pair"]

_NEG_INF = -1e30   # flash_attention.py:61: the mask value, never -inf
_MASK_THRESH = -1e8   # :65: biases at or below it are canonicalised to -1e30
_MAX_HEAD_DIM = 256

launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
dropout_launches = dict(launches)
# the wgmma backward's pre-pass (no dropout variant: every rate counts here)
prep_launches = {"flash_bwd_prep": 0}
fwd_routes = {"wgmma": 0, "generic": 0}
bwd_routes = {"wgmma": 0, "generic": 0}   # dQ and dK/dV launches
DEFAULT_BLOCK_Q = 128     # :56
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_BQ = WGMMA_BK = 128     # the wgmma forward's q and KV tiles
DQ_BQ, DQ_BK = 128, 64        # the wgmma dQ kernel's q tile and KV tiles
DKV_BKV, DKV_BQ = 64, 64      # the wgmma dK/dV kernel's kv tile and q tiles
_SKIP_BELOW = _NEG_INF / 2    # a KV tile whose bias entries are all at or
                              # below it is skipped (:253)


# ---------------------------------------------------------------------------
# the dropout keep-mask (:88-130): a murmur-style hash of the seed pair,
# the tile's (b, i, j) triple and the element's index in its tile
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_C1, _C2, _C3, _C4, _C5 = (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F,
                           0x165667B1)


def _mul32(x, c: int):
    """x·c mod 2^32 for uint32 values x held in int64 (tensors or ints):
    c is split into 16-bit halves, so no product leaves the int64 range."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _keep_threshold(dropout_p) -> int:
    """:92: an element is kept iff its bits are below this."""
    keep = 1.0 - float(dropout_p)
    return min(int(round(keep * 2 ** 32)), 2 ** 32 - 1)


def _hash_base(s0, s1, b, i, j):
    """The tile's word: seed pair and (b, i, j), each times its constant,
    xor-ed (:103-107)."""
    return (_mul32(b, _C3) ^ _mul32(i, _C4) ^ _mul32(j, _C5)
            ^ (_mul32(int(s0) & _M32, _C1) ^ _mul32(int(s1) & _M32, _C2)))


def _hash_mix(base, idx):
    """The element's bits from its tile's word and its index in the tile
    (:108-115)."""
    x = _mul32(idx, _C1) ^ base
    x = x ^ (x >> 16)
    x = _mul32(x, _C2)
    x = x ^ (x >> 13)
    x = _mul32(x, _C3)
    return x ^ (x >> 16)


def interpret_bits(s0, s1, b, i, j, shape, device=None) -> torch.Tensor:
    """``_interpret_bits`` (:97): the uint32 bits (as int64) of one
    [rows, cols] tile keyed (s0, s1, b, i, j)."""
    rows = torch.arange(shape[0], dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(shape[1], dtype=torch.int64, device=device)[None, :]
    return _hash_mix(_hash_base(s0, s1, b, i, j), rows * shape[1] + cols)


def keep_mask_ref(s0, s1, b, i, j, shape, dropout_p,
                  device=None) -> torch.Tensor:
    """``_keep_mask`` (:119) as interpret mode draws it: bool [shape]."""
    return (interpret_bits(s0, s1, b, i, j, shape, device)
            < _keep_threshold(dropout_p))


class DropKey(NamedTuple):
    """One dropout call: the rate, the seed pair (one generator split, two
    uint32 words) and the reference's logical tile that keys the mask
    (flash: (block_q, block_k); LayerNorm and projection-LN: (block_r,
    H))."""
    p: float
    s0: int
    s1: int
    rows: int
    cols: int

    @property
    def threshold(self) -> int:
        return _keep_threshold(self.p)

    @property
    def inv(self) -> float:
        """1 / (1 − p), which the kernels multiply by in f32 (:225)."""
        return 1.0 / (1.0 - self.p)

    def inv_f32(self, device) -> torch.Tensor:
        return torch.tensor(self.inv, dtype=torch.float32, device=device)


def flash_key_shifts(key: DropKey):
    """(log2 rows, log2 cols) of the key's logical tile when both sides
    are powers of two, the kernels' shift path (common.cuh's FlashKey);
    None where they take the division path."""
    rows, cols = int(key.rows), int(key.cols)
    if rows < 1 or cols < 1 or rows & (rows - 1) or cols & (cols - 1):
        return None
    return rows.bit_length() - 1, cols.bit_length() - 1


def flash_bits_shifted(key: DropKey, bh: int, sq: int, sk: int,
                       device=None) -> torch.Tensor:
    """``flash_bits_ref`` as the shift path reckons it: tile (r >> lr,
    c >> lc) and index ((r & (rows - 1)) << lc) + (c & (cols - 1)). Only
    for a key whose tile sides are powers of two (ValueError else)."""
    shifts = flash_key_shifts(key)
    if shifts is None:
        raise ValueError(f"the shift path needs a power-of-two tile, got "
                         f"({key.rows}, {key.cols})")
    lr, lc = shifts

    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)
    r, c = ar(sq)[:, None], ar(sk)[None, :]
    base = _hash_base(key.s0, key.s1, ar(bh)[:, None, None], (r >> lr)[None],
                      (c >> lc)[None])
    return _hash_mix(base,
                     ((r & (key.rows - 1)) << lc) + (c & (key.cols - 1)))


def flash_bits_ref(key: DropKey, bh: int, sq: int, sk: int,
                   device=None) -> torch.Tensor:
    """The bits of every element of the [bh, sq, sk] score matrices: the
    element (r, c) of head b hashes (b, r // rows, c // cols) and its
    index (r % rows)·cols + c % cols in that tile."""
    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)
    r, c = ar(sq)[:, None], ar(sk)[None, :]
    base = _hash_base(key.s0, key.s1, ar(bh)[:, None, None],
                      (r // key.rows)[None], (c // key.cols)[None])
    return _hash_mix(base, (r % key.rows) * key.cols + c % key.cols)


def row_bits_ref(key: DropKey, r: int, h: int, device=None) -> torch.Tensor:
    """The bits of every element of an [r, h] row matrix under row tiles
    (LayerNorm, projection-LN): row ``row`` hashes (row // rows, 0, 0) and
    the index (row % rows)·cols + c (cols = H)."""
    row = torch.arange(r, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(h, dtype=torch.int64, device=device)[None, :]
    return _hash_mix(_hash_base(key.s0, key.s1, row // key.rows, 0, 0),
                     (row % key.rows) * key.cols + col)


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _auto_block(seq_len: int) -> int:
    """:652: 1024 / 512 / 128 by what divides the length."""
    if seq_len % 1024 == 0:
        return 1024
    return 512 if seq_len % 512 == 0 else DEFAULT_BLOCK_Q


def _auto_blocks(sq: int, sk: int, causal: bool, dtype=None):
    """:672: (block_q, block_k): an exact tuning-table hit (a hit that
    cannot tile raises, :704-709), else the causal square tiles or the
    non-causal wide-K ones (256, 512). The reference's sweep flags
    (FLAGS_flash_block*) are not ported."""
    hit = autotune.lookup("flash_attention",
                          autotune.flash_sig(sq, sk, causal, dtype))
    if hit is not None:
        tbq, tbk = int(hit["block_q"]), int(hit["block_k"])
        if tbq <= 0 or tbk <= 0 or sq % tbq or sk % tbk:
            raise ValueError(
                f"tuning-table flash_attention entry ({tbq}, {tbk}) "
                f"cannot tile (sq={sq}, sk={sk}) — regenerate the "
                f"table (scripts/autotune.py search) or set "
                f"FLAGS_kernel_tuning=0")
        return tbq, tbk
    if causal:
        return _auto_block(sq), _auto_block(sk)
    return (256 if sq % 256 == 0 else _auto_block(sq),
            512 if sk % 512 == 0 else _auto_block(sk))


def flash_drop_tile(sq: int, sk: int, causal: bool, dtype):
    """The tile that keys the attention dropout mask: ``_auto_blocks``'s
    pick, clamped to the sequence as ``_fwd`` clamps it (:284-285)."""
    block_q, block_k = _auto_blocks(sq, sk, bool(causal), dtype)
    return min(block_q, _ceil_to(sq, 8)), min(block_k, _ceil_to(sk, 8))


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


def _flash_keep(drop: DropKey, s):
    """The keep-mask of the score matrices s [BH, Sq, Sk]."""
    return (flash_bits_ref(drop, s.shape[0], s.shape[1], s.shape[2],
                           s.device) < drop.threshold)


def flash_fwd_ref(q, k, v, causal: bool, scale: float, bias=None,
                  heads: int = 1, drop: Optional[DropKey] = None):
    """Plain version of the forward kernel. q [BH, Sq, D], k/v [BH, Sk, D]
    → (out [BH, Sq, D] in q's dtype, lse [BH, Sq] f32).

    q is scaled in f32 and rounded to its dtype (flash_attention.py:196);
    scores and softmax in f32 with masked entries at -1e30; the bias row
    (``bias`` [B, Sk] f32, non-causal) added to the scores (:211); with
    ``drop``, l and lse stay undropped and p becomes ``where(keep, p, 0) ·
    f32(1 / (1 − p))`` (:220-226); p rounded to v's dtype before the
    product (:229); ``lse = m + log(l)`` with ``l == 0 → 1``
    (:266-268)."""
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
    if drop is not None:
        p = torch.where(_flash_keep(drop, p), p * drop.inv_f32(p.device),
                        0.0)
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


def _drop_dp(dp, drop):
    """dP under dropout: ``where(keep, dp · f32(1 / (1 − p)), 0)`` (:383,
    :484)."""
    if drop is None:
        return dp
    return torch.where(_flash_keep(drop, dp), dp * drop.inv_f32(dp.device),
                       0.0)


def flash_dq_ref(q, k, v, dout, lse, delta, causal: bool, scale: float,
                 bias=None, heads: int = 1, drop: Optional[DropKey] = None):
    """Plain version of the dQ kernel: the scale folds into k, rounded to
    the input dtype (:357); ``ds`` is rounded before ``ds·ks`` (:384)."""
    dt = q.dtype
    ks = _round(k.float() * scale, dt)
    p = _probs(q.float() @ ks.transpose(1, 2), lse, causal, bias, heads)
    dp = _drop_dp(dout.float() @ v.float().transpose(1, 2), drop)
    return (_round(p * (dp - delta[..., None]), dt) @ ks).to(dt)


def flash_dkv_ref(q, k, v, dout, lse, delta, causal: bool, scale: float,
                  bias=None, heads: int = 1, drop: Optional[DropKey] = None):
    """Plain version of the dK/dV kernel: the scale folds into q, rounded
    to the input dtype (:448); p (dropped for dV, :474-476) and ``ds`` are
    rounded before their products (:478, :485). Returns (dk, dv)."""
    dt = q.dtype
    qs = _round(q.float() * scale, dt)
    p = _probs(qs @ k.float().transpose(1, 2), lse, causal, bias, heads)
    dof = dout.float()
    pv = p
    if drop is not None:
        pv = torch.where(_flash_keep(drop, p), p * drop.inv_f32(p.device),
                         0.0)
    dv = _round(pv, dt).transpose(1, 2) @ dof
    dp = _drop_dp(dof @ v.float().transpose(1, 2), drop)
    dk = _round(p * (dp - delta[..., None]), dt).transpose(1, 2) @ qs
    return dk.to(dt), dv.to(dt)


def _delta(out, dout):
    """rowsum(dO·O) in f32 [BH, Sq] (flash_attention.py:551)."""
    return (dout.float() * out.float()).sum(-1)


def flash_bwd_ref(q, k, v, out, lse, dout, causal: bool, scale: float,
                  bias=None, heads: int = 1, drop: Optional[DropKey] = None):
    """Plain version of the backward (delta, then the dQ and dK/dV
    kernels' plain versions) → (dq, dk, dv) in the input dtype."""
    delta = _delta(out, dout)
    dk, dv = flash_dkv_ref(q, k, v, dout, lse, delta, causal, scale, bias,
                           heads, drop)
    return (flash_dq_ref(q, k, v, dout, lse, delta, causal, scale, bias,
                         heads, drop), dk, dv)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def fwd_route(dtype, d: int, aligned: bool) -> str:
    """The forward kernel a CUDA call takes: ``"wgmma"`` for bfloat16 at
    head dim 64 or 128 with every pointer 16-byte aligned (TMA's rule),
    else ``"generic"``."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS and aligned:
        return "wgmma"
    return "generic"


def bwd_route(dtype, d: int, aligned: bool) -> str:
    """The backward kernels a CUDA call takes, by ``fwd_route``'s rule:
    ``"wgmma"`` (the pre-pass, ``flash_dq_wgmma_kernel``,
    ``flash_dkv_wgmma_kernel``) or ``"generic"``."""
    return fwd_route(dtype, d, aligned)


def fwd_tile_plan(sq: int, sk: int, causal: bool, bias_row=None,
                  bq: int = WGMMA_BQ, bk: int = WGMMA_BK):
    """The wgmma forward's schedule, reckoned as its producer and consumers
    reckon it: for each q tile i (of ``bq`` rows), the KV tiles j (of
    ``bk`` rows) it visits in order, each as (j, masked). Causal: tiles up
    to the diagonal of the tile's last row below ``sq`` (the offset sk -
    sq included; none when that row sees no key). ``bias_row`` ([sk],
    non-causal): a tile whose entries are all <= -5e29 is skipped. A tile
    is masked unless it lies wholly below the diagonal of the tile's first
    row and inside ``sk``."""
    nq, nk = -(-sq // bq), -(-sk // bk)
    off = sk - sq
    plan = []
    for i in range(nq):
        last = min((i + 1) * bq, sq) - 1 + off
        nvis = nk
        if causal:
            nvis = 0 if last < 0 else min(nk, last // bk + 1)
        tiles = []
        for j in range(nvis):
            if bias_row is not None and not any(
                    float(x) > _SKIP_BELOW
                    for x in bias_row[j * bk:(j + 1) * bk]):
                continue
            interior = ((j + 1) * bk <= sk
                        and (not causal or (j + 1) * bk - 1 <= i * bq + off))
            tiles.append((j, not interior))
        plan.append(tiles)
    return plan


def dq_tile_plan(sq: int, sk: int, causal: bool, bias_row=None):
    """The wgmma dQ kernel's schedule: ``fwd_tile_plan`` at its tiles
    (q tiles of ``DQ_BQ`` rows, KV tiles of ``DQ_BK``), reckoned by its
    producer as the forward's reckons it."""
    return fwd_tile_plan(sq, sk, causal, bias_row, DQ_BQ, DQ_BK)


def dkv_tile_plan(sq: int, sk: int, causal: bool, bias_row=None):
    """The wgmma dK/dV kernel's schedule: for each kv tile j (of
    ``DKV_BKV`` rows), the q tiles i (of ``DKV_BQ`` rows) it visits in
    order, each as (i,
    masked). ``bias_row`` ([sk], non-causal): a kv tile whose rows' entries
    are all <= -5e29 visits nothing (its dK and dV are zero). Causal: q
    tiles whose last row below ``sq`` sees the kv tile's first row (the
    offset sk - sq included). A tile is masked unless it lies wholly
    below the diagonal of its first q row, inside ``sq`` and inside
    ``sk``."""
    bkv, bq = DKV_BKV, DKV_BQ
    nq, nkv = -(-sq // bq), -(-sk // bkv)
    off = sk - sq
    plan = []
    for j in range(nkv):
        if bias_row is not None and not any(
                float(x) > _SKIP_BELOW for x in bias_row[j * bkv:(j + 1) * bkv]):
            plan.append([])
            continue
        tiles = []
        for i in range(nq):
            if causal and j * bkv > min((i + 1) * bq, sq) - 1 + off:
                continue
            interior = ((i + 1) * bq <= sq and (j + 1) * bkv <= sk
                        and (not causal or (j + 1) * bkv - 1 <= i * bq + off))
            tiles.append((i, not interior))
        plan.append(tiles)
    return plan


def _snake(total: int, blocks: int):
    """csrc ``work_item``: the positions each of ``blocks`` persistent
    blocks takes from a list of ``total`` items (round r: block b, or
    blocks - 1 - b when r is odd)."""
    out = []
    for b in range(blocks):
        items, r = [], 0
        while True:
            pos = r * blocks + (blocks - 1 - b if r & 1 else b)
            if pos >= total:
                break
            items.append(pos)
            r += 1
        out.append(items)
    return out


def dkv_block_items(sk: int, bh: int, blocks: int):
    """The wgmma dK/dV kernel's persistent schedule: its (kv tile, head)
    items listed low kv tiles first (under causal they see the most q
    tiles: position p is tile ``p // bh`` of head ``p % bh``), taken in
    the snake order. Returns, for each block, its pairs in order."""
    return [[(p // bh, p % bh) for p in items]
            for items in _snake(-(-sk // DKV_BKV) * bh, blocks)]


def fwd_block_items(sq: int, bh: int, blocks: int, bq: int = WGMMA_BQ):
    """The wgmma forward's persistent schedule (csrc ``work_item``): its
    q tiles listed heaviest first (q tile index from the last down, every
    head at each: position p is tile ``nq - 1 - p // bh`` of head ``p %
    bh``), taken by ``blocks`` blocks in a snake order (round r: block b,
    or blocks - 1 - b when r is odd). Returns, for each block, its (q
    tile, head) pairs in order."""
    nq = -(-sq // bq)
    return [[(nq - 1 - p // bh, p % bh) for p in items]
            for items in _snake(nq * bh, blocks)]


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# bh, sq, sk, d, causal, heads, scale; the dropout key (s0, s1, threshold,
# 1 / (1 - p), the reference's tile rows and cols; rows 0: no dropout);
# stream
_TAIL = [_I] * 6 + [_F] + [_U] * 3 + [_F, _I, _I] + [_P]
_ARGTYPES = {"flash_fwd": [_P] * 6 + _TAIL,     # q, k, v, bias, o, lse
             "flash_dq": [_P] * 8 + _TAIL,      # ..., delta, bias, dq
             "flash_dkv": [_P] * 9 + _TAIL}     # ..., delta, bias, dk, dv
# the wgmma routes' entries (bf16 only): the forward's, dQ's and dK/dV's
# arguments; the pre-pass: q, k, o, dout, qs, ks, delta, bh, sq, sk, d,
# scale, stream
_WGMMA_ARGTYPES = {"flash_fwd_wgmma": _ARGTYPES["flash_fwd"],
                   "flash_dq_wgmma": _ARGTYPES["flash_dq"],
                   "flash_dkv_wgmma": _ARGTYPES["flash_dkv"],
                   "flash_bwd_prep": [_P] * 7 + [_I] * 4 + [_F, _P]}


@functools.cache
def _lib():
    lib = _build.library("flash_attention.cu", _ARGTYPES)
    for name, types in _WGMMA_ARGTYPES.items():
        fn = getattr(lib, f"{name}_bf16")
        fn.argtypes, fn.restype = types, ctypes.c_int
    return lib


def _drop_args(drop: Optional[DropKey]):
    """The kernels' dropout arguments (all zero without dropout)."""
    if drop is None:
        return (0, 0, 0, 0.0, 0, 0)
    return (drop.s0 & _M32, drop.s1 & _M32, drop.threshold, drop.inv,
            int(drop.rows), int(drop.cols))


def dropout_bits_cuda(lib, key: DropKey, shape, row_layout: bool,
                      device) -> torch.Tensor:
    """The device hash of ``lib`` (any of the port's libraries: each
    builds common.cuh's ``dropout_bits``) over a [nb, nr, nc] score
    matrix (flash keys) or an [nr, nc] row matrix (``row_layout``: row
    keys, nb = 1): the uint32 bits as int64, to hold against
    ``flash_bits_ref`` / ``row_bits_ref``. A debug entry: no kernel of a
    path calls it."""
    nb, nr, nc = (1, *shape) if row_layout else shape
    out = torch.empty((nb, nr, nc), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = lib.dropout_bits(out.data_ptr(), nb, nr, nc, key.s0 & _M32,
                              key.s1 & _M32, int(key.rows), int(key.cols),
                              int(row_layout),
                              torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dropout_bits launch failed: CUDA error {rc} "
                           f"({lib.kernel_error_string(rc).decode()})")
    bits = out.to(torch.int64) & _M32
    return bits[0] if row_layout else bits


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


def _call(name, drop, dtype, device, *args, entry=None):
    """Launch ``entry`` (the kernel ``name`` by default) and count it under
    ``name``."""
    _build.call(_lib(), entry or name, dtype, device, *args,
                *_drop_args(drop))
    (launches if drop is None else dropout_launches)[name] += 1


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


def _fwd_cuda(q, k, v, causal, scale, bias=None, heads=1, drop=None,
              route=None):
    """The forward on the route ``fwd_route`` picks (``route`` names one
    instead: a measurement holds the two kernels on the same inputs)."""
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
    if route is None:
        route = fwd_route(q.dtype, d, _aligned(q, k, v, out))
    _call("flash_fwd", drop, q.dtype, q.device, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), bptr, out.data_ptr(), lse.data_ptr(), bh, sq, sk, d,
          int(causal), int(heads), float(scale),
          entry="flash_fwd_wgmma" if route == "wgmma" else None)
    fwd_routes[route] += 1
    return out, lse


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _bwd_cuda(q, k, v, out, lse, dout, causal, scale, bias=None, heads=1,
              drop=None, route=None):
    """The backward on the route ``bwd_route`` picks (``route`` names one
    instead, for measurement). wgmma: the pre-pass (qs, ks, delta), then
    dQ and dK/dV from the scaled copies; generic: delta in PyTorch, as the
    reference computes it outside its kernels (:551), then the generic
    kernels."""
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
    if route is None:
        route = bwd_route(q.dtype, d, _aligned(q, k, v, out, dout))
    qs = ks = None
    if route == "wgmma":
        qs, ks, delta = _bwd_prep_cuda(q, k, out, dout, scale)
    else:
        delta = _delta(out, dout)
    return (_dq_cuda(q, k, v, dout, lse, delta, causal, scale, bias, heads,
                     drop, route, ks),
            *_dkv_cuda(q, k, v, dout, lse, delta, causal, scale, bias,
                       heads, drop, route, qs))


def _bwd_prep_cuda(q, k, out, dout, scale):
    """The wgmma backward's pre-pass, one launch: (round(q·scale),
    round(k·scale), rowsum(dO·O) in f32)."""
    bh, sq, sk, d = _shapes(q, k, k)
    qs, ks = torch.empty_like(q), torch.empty_like(k)
    delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _build.call(_lib(), "flash_bwd_prep", q.dtype, q.device,
                q.data_ptr(), k.data_ptr(), out.data_ptr(), dout.data_ptr(),
                qs.data_ptr(), ks.data_ptr(), delta.data_ptr(), bh, sq, sk,
                d, float(scale))
    prep_launches["flash_bwd_prep"] += 1
    return qs, ks, delta


def _scaled(name, route, x):
    """The wgmma kernels read the pre-pass's scaled operand in place of
    q or k (``_bwd_cuda`` passes it)."""
    if route == "wgmma" and x is None:
        raise ValueError(f"{name}: the wgmma kernel reads the pre-pass's "
                         f"scaled operand (_bwd_prep_cuda)")
    return x


def _dq_cuda(q, k, v, dout, lse, delta, causal, scale, bias=None, heads=1,
             drop=None, route=None, ks=None):
    """dQ on the route ``bwd_route`` picks (or ``route``); the wgmma
    kernel reads ks = round(k·scale), the pre-pass's."""
    bh, sq, sk, d = _shapes(q, k, v)
    bptr = _bias_arg(bias, heads, bh, sk, causal)
    dq = torch.empty_like(q)
    if route is None:
        route = bwd_route(q.dtype, d, _aligned(q, k, v, dout, dq))
    ks = _scaled("flash_dq", route, ks)
    _call("flash_dq", drop, q.dtype, q.device, q.data_ptr(),
          (ks if route == "wgmma" else k).data_ptr(), v.data_ptr(),
          dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), bptr,
          dq.data_ptr(), bh, sq, sk, d, int(causal), int(heads),
          float(scale),
          entry="flash_dq_wgmma" if route == "wgmma" else None)
    bwd_routes[route] += 1
    return dq


def _dkv_cuda(q, k, v, dout, lse, delta, causal, scale, bias=None, heads=1,
              drop=None, route=None, qs=None):
    """dK, dV on the route ``bwd_route`` picks (or ``route``); the wgmma
    kernel reads qs = round(q·scale), the pre-pass's."""
    bh, sq, sk, d = _shapes(q, k, v)
    bptr = _bias_arg(bias, heads, bh, sk, causal)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if route is None:
        route = bwd_route(q.dtype, d, _aligned(q, k, v, dout, dk, dv))
    qs = _scaled("flash_dkv", route, qs)
    _call("flash_dkv", drop, q.dtype, q.device,
          (qs if route == "wgmma" else q).data_ptr(), k.data_ptr(),
          v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
          bptr, dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d, int(causal),
          int(heads), float(scale),
          entry="flash_dkv_wgmma" if route == "wgmma" else None)
    bwd_routes[route] += 1
    return dk, dv


def _on(device, name):
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, got {device}")
    return device.type == "cuda"


def drop_key(dropout_p, seed0, seed1, rows, cols, what="dropout"):
    """The custom ops' dropout arguments as a DropKey, None at p = 0:
    the rate, the seed pair and the reference's tile (flash: block_q by
    block_k; the row kernels: block_r by the row's width)."""
    if dropout_p <= 0.0:
        return None
    if rows < 1 or cols < 1:
        raise ValueError(f"{what} needs the reference's tile, got "
                         f"({rows}, {cols})")
    return DropKey(float(dropout_p), int(seed0), int(seed1), int(rows),
                   int(cols))


# ---------------------------------------------------------------------------
# custom ops + autograd
# ---------------------------------------------------------------------------

_DROP_SCHEMA = ("float dropout_p=0.0, int seed0=0, int seed1=0, "
                "int block_q=0, int block_k=0")


@torch.library.custom_op(
    "paddle_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, float scale, "
           f"Tensor? bias=None, int heads=1, {_DROP_SCHEMA}) "
           "-> (Tensor, Tensor)")
def flash_fwd(q, k, v, causal, scale, bias=None, heads=1, dropout_p=0.0,
              seed0=0, seed1=0, block_q=0, block_k=0):
    """Flash-attention forward on [BH, S, D] → (out, lse [BH, Sq] f32);
    with ``dropout_p > 0`` the mask keyed (seed0, seed1) by the tile
    (block_q, block_k)."""
    drop = drop_key(dropout_p, seed0, seed1, block_q, block_k,
                    "flash dropout")
    if _on(q.device, "flash_fwd"):
        return _fwd_cuda(q, k, v, causal, scale, bias, heads, drop)
    return flash_fwd_ref(q, k, v, causal, scale, bias, heads, drop)


@torch.library.custom_op(
    "paddle_tpu_torch::flash_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
           "Tensor dout, bool causal, float scale, Tensor? bias=None, "
           f"int heads=1, {_DROP_SCHEMA}) -> (Tensor, Tensor, Tensor)")
def flash_bwd(q, k, v, out, lse, dout, causal, scale, bias=None, heads=1,
              dropout_p=0.0, seed0=0, seed1=0, block_q=0, block_k=0):
    """Flash-attention backward on [BH, S, D] → (dq, dk, dv), the forward's
    dropout mask regenerated from its key."""
    drop = drop_key(dropout_p, seed0, seed1, block_q, block_k,
                    "flash dropout")
    if _on(q.device, "flash_bwd"):
        return _bwd_cuda(q, k, v, out, lse, dout, causal, scale, bias, heads,
                         drop)
    return flash_bwd_ref(q, k, v, out, lse, dout, causal, scale, bias, heads,
                         drop)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, scale, bias, heads, *drop = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, bias)
    ctx.causal, ctx.scale, ctx.heads, ctx.drop = causal, scale, heads, drop


def _backward(ctx, dout, _dlse):
    # lse is a residual for the backward only; flash_attention_bshd never
    # returns it, so its cotangent carries nothing. The bias gets no
    # gradient, as in the reference (:648); the dropout key none either
    q, k, v, out, lse, bias = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(), ctx.causal,
                           ctx.scale, bias, ctx.heads, *ctx.drop)
    return (dq, dk, dv) + (None,) * 9


flash_fwd.register_autograd(_backward, setup_context=_setup_context)


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

def seed_pair(dropout_seed):
    """A dropout seed (two uint32 or int32 words: a generator key, a
    tensor, an array) → two Python ints, the words as uint32 (the
    reference bitcasts int32 words, :793-797)."""
    if isinstance(dropout_seed, torch.Tensor):
        dropout_seed = dropout_seed.reshape(-1).tolist()
    words = [int(w) & _M32 for w in dropout_seed]
    if len(words) != 2:
        raise ValueError(f"dropout_seed must be two words, got {len(words)}")
    return words[0], words[1]


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
    is undefined, as in the reference. ``dropout_p > 0``: in-kernel
    attention-probability dropout (after the softmax, inverted scale)
    with the mask keyed by ``dropout_seed`` (two uint32 or int32 words,
    one generator key) and the reference's tile, ``_auto_blocks``'s pick
    for q's dtype; the CUDA kernels run their own tiles."""
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
    drop = ()
    if dropout_p > 0.0:
        tile = flash_drop_tile(sq, sk, bool(causal), q.dtype)
        drop = (float(dropout_p), *seed_pair(dropout_seed), *tile)
    bias = None
    if kv_bias is not None:
        bias = torch.as_tensor(kv_bias, device=q.device).float()
        if tuple(bias.shape) != (b, sk):
            raise ValueError(
                f"kv_bias must have shape {(b, sk)}, got "
                f"{tuple(bias.shape)}")
        bias = torch.where(bias <= _MASK_THRESH,
                           torch.full_like(bias, _NEG_INF), bias).contiguous()
    if hk != h:
        rep = h // hk
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if scale is None:
        scale = d ** -0.5

    def flat(t, s):
        return t.transpose(1, 2).reshape(b * h, s, d).contiguous()

    out, _ = flash_fwd(flat(q, sq), flat(k, sk), flat(v, sk), bool(causal),
                       float(scale), bias, int(h), *drop)
    return out.reshape(b, h, sq, d).transpose(1, 2)
