"""The forward's two CUDA routes, reckoned on the CPU.

``fwd_route`` sends bfloat16 at head dim 64 or 128 with aligned pointers
to the Hopper kernel (TMA ring, warp-specialised wgmma) and everything
else to the generic kernel. ``fwd_tile_plan`` mirrors the wgmma kernel's
schedule, as its producer and consumers reckon it: here it is held
against brute force over every (query, key) pair — a q tile visits
exactly the KV tiles that hold a visible pair, masks every visited tile
that holds a hidden one (the causal band, the ragged tail, Sq != Sk),
and skips a tile whose keys the bias hides entirely — and an emulation
of the kernel's online softmax over that plan, rounding q and p to the
input dtype where the kernel does, is held against the reference's
Pallas forward in interpret mode. ``fwd_block_items``, the persistent
blocks' order over the q tiles, takes each once and balances the causal
work. ``flash_bits_shifted`` is the dropout key's shift path (the
kernels' ``FlashKey`` for power-of-two logical tiles): equal to the
division path, ``flash_bits_ref``, bit for bit.

Tolerance of the emulation against the reference: atol 2e-5 on out and
lse, as in test_torch_flash_attention.py — f32 inputs, so the roundings
to the input dtype are exact and only the order of the sums differs (a
tile wrongly skipped or left unmasked moves rows by O(1)).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as pfa

BQ, BK = pfa.WGMMA_BQ, pfa.WGMMA_BK


@pytest.mark.parametrize("dtype,d,aligned,route", [
    (torch.bfloat16, 128, True, "wgmma"),
    (torch.bfloat16, 64, True, "wgmma"),
    (torch.bfloat16, 128, False, "generic"),
    (torch.bfloat16, 96, True, "generic"),
    (torch.bfloat16, 32, True, "generic"),
    (torch.bfloat16, 256, True, "generic"),
    (torch.float32, 128, True, "generic"),
    (torch.float32, 64, True, "generic"),
    (torch.float16, 128, True, "generic"),
])
def test_route_rule(dtype, d, aligned, route):
    assert pfa.fwd_route(dtype, d, aligned) == route


def test_cpu_calls_count_no_route():
    before = dict(pfa.fwd_routes)
    q = torch.zeros((2, 64, 128), dtype=torch.bfloat16)
    pfa.flash_fwd(q, q, q, True, 0.1)
    assert pfa.fwd_routes == before == {"wgmma": 0, "generic": 0}


def _visible(sq, sk, causal, bias_row):
    """[sq, sk] bool: query row r sees key c."""
    r = np.arange(sq)[:, None]
    c = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= c <= r + (sk - sq)
    if bias_row is not None:
        vis &= (np.asarray(bias_row) > -5e29)[None, :]
    return vis


def _brute_plan(sq, sk, causal, bias_row):
    """For each q tile, the KV tiles holding a visible pair, and for each
    whether some position of the whole BQ x BK tile (rows past sq
    included: the kernel computes them) lies past sk or above the causal
    diagonal."""
    vis = _visible(sq, sk, causal, bias_row)
    nq, nk = -(-sq // BQ), -(-sk // BK)
    plan = []
    for i in range(nq):
        tiles = []
        for j in range(nk):
            if not vis[i * BQ:(i + 1) * BQ, j * BK:(j + 1) * BK].any():
                continue
            r = np.arange(i * BQ, (i + 1) * BQ)[:, None]
            c = np.arange(j * BK, (j + 1) * BK)[None, :]
            hidden = (c >= sk) | ((c > r + (sk - sq)) if causal else False)
            tiles.append((j, bool(np.any(hidden))))
        plan.append(tiles)
    return plan


def _bias_row(sk, kind):
    """The key-padding row: None, or valid keys then -1e30; 'holes' also
    hides KV tile 1 wholly (a skipped tile between live ones)."""
    if kind is None:
        return None
    row = np.zeros(sk, np.float32)
    if kind == "short":
        row[min(sk, 70):] = -1e30
    elif kind == "holes":
        row[BK:2 * BK] = -1e30
        row[sk - 5:] = -1e30
    return row


SHAPES = [(128, 128), (256, 256), (200, 200), (2048, 2048), (512, 1000),
          (1000, 512), (300, 129), (1, 700), (700, 1), (127, 385)]


@pytest.mark.parametrize("sq,sk", SHAPES)
@pytest.mark.parametrize("mode", ["causal", "dense", "short", "holes"])
def test_tile_plan_matches_brute_force(sq, sk, mode):
    causal = mode == "causal"
    bias = _bias_row(sk, mode if mode in ("short", "holes") else None)
    if mode == "holes" and sk <= 2 * BK:
        bias = _bias_row(sk, "short")
    plan = pfa.fwd_tile_plan(sq, sk, causal, bias)
    assert plan == _brute_plan(sq, sk, causal, bias)
    # every visible pair is covered by a visited tile, every hidden pair
    # of a valid row inside a visited tile by its mask
    vis = _visible(sq, sk, causal, bias)
    covered = np.zeros_like(vis)
    for i, tiles in enumerate(plan):
        for j, masked in tiles:
            block = vis[i * BQ:(i + 1) * BQ, j * BK:(j + 1) * BK]
            covered[i * BQ:(i + 1) * BQ, j * BK:(j + 1) * BK] = True
            if not masked and bias is None:
                assert block.all()
    assert not (vis & ~covered).any()


def test_tile_plan_rows_without_keys_visit_nothing():
    """Causal with sk < sq: the first sq - sk rows see no key; a q tile of
    only such rows visits no KV tile (its rows stay undefined, as in the
    reference)."""
    plan = pfa.fwd_tile_plan(600, 300, True)
    assert plan[0] == [] and plan[1] == []
    assert plan[2] == [(0, True)]
    assert [j for j, _ in plan[-1]] == [0, 1, 2]


def _emulate(q, k, v, causal, scale, bias=None, heads=1):
    """The wgmma kernel's arithmetic on fwd_tile_plan's schedule: q scaled
    and rounded to its dtype, per visited tile s = q k^T (+ bias) with the
    masks only on masked tiles, the online softmax in f32, round(p) into
    the product with v, O / l and lse = m + log(l)."""
    bh, sq, _ = q.shape
    sk = k.shape[1]

    def rnd(x):
        return x.to(q.dtype).float()
    qs = rnd(q.float() * scale)
    kf, vf = k.float(), v.float()
    out = torch.zeros(bh, sq, q.shape[2])
    lse = torch.zeros(bh, sq)
    for b in range(bh):
        brow = None if bias is None else bias[b // heads]
        plan = pfa.fwd_tile_plan(sq, sk, causal, brow)
        for i, tiles in enumerate(plan):
            rows = torch.arange(i * BQ, min((i + 1) * BQ, sq))
            m = torch.full((len(rows),), -1e30)
            l = torch.zeros(len(rows))
            acc = torch.zeros(len(rows), q.shape[2])
            for j, masked in tiles:
                cols = torch.arange(j * BK, (j + 1) * BK)
                valid = cols < sk
                kt = torch.zeros(BK, q.shape[2])
                vt = torch.zeros(BK, q.shape[2])
                kt[valid], vt[valid] = kf[b, cols[valid]], vf[b, cols[valid]]
                s = qs[b, rows] @ kt.T
                if brow is not None:
                    bt = torch.full((BK,), -1e30)
                    bt[valid] = torch.as_tensor(brow)[cols[valid]]
                    s = s + bt
                if masked:
                    hide = (cols[None, :] >= sk)
                    if causal:
                        hide = hide | (cols[None, :] > rows[:, None] + sk - sq)
                    s = s.masked_fill(hide, -1e30)
                m_new = torch.maximum(m, s.amax(1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[:, None])
                l = alpha * l + p.sum(1)
                acc = alpha[:, None] * acc + rnd(p) @ vt
                m = m_new
            safe = torch.where(l == 0, torch.ones_like(l), l)
            out[b, rows] = acc / safe[:, None]
            lse[b, rows] = m + torch.log(safe)
    return out, lse


@pytest.mark.parametrize("sq,sk,mode", [
    (200, 200, "causal"), (256, 256, "dense"), (130, 300, "causal"),
    (300, 130, "dense"), (200, 300, "holes")])
def test_emulated_kernel_matches_pallas_forward(sq, sk, mode):
    bh, d = 2, 64
    causal = mode == "causal"
    rng = np.random.default_rng(sq * 7 + sk)
    q, k, v = (rng.standard_normal((bh, n, d)).astype(np.float32)
               for n in (sq, sk, sk))
    bias = None
    if mode == "holes":
        bias = np.zeros((bh, sk), np.float32)
        bias[0, BK:2 * BK] = -1e30
        bias[1, 90:] = -1e30
    scale = d ** -0.5
    jout, jlse = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None if bias is None else jnp.asarray(bias), None,
                          causal, scale, 64, 64, True, 1, 0.0)
    out, lse = _emulate(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal, scale,
                        None if bias is None else torch.from_numpy(bias))
    rows = slice(sq - sk, None) if causal and sk < sq else slice(None)
    np.testing.assert_allclose(out[:, rows].numpy(),
                               np.asarray(jout)[:, rows], atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse[:, rows].numpy(),
                               np.asarray(jlse)[:, rows], atol=2e-5, rtol=0)


@pytest.mark.parametrize("sq,sk,bh,causal", [
    (2048, 2048, 64, True), (2048, 2048, 32, True), (512, 512, 384, False),
    (1000, 1000, 16, True), (200, 200, 36, False), (128, 128, 1, True)])
def test_persistent_blocks_take_every_q_tile_once(sq, sk, bh, causal):
    """The persistent grid (one block per SM of an H100's 132, at most one
    per q tile): every (q tile, head) exactly once, and with the causal
    band each block's KV tiles within one q tile's of every other's."""
    nq = -(-sq // BQ)
    blocks = min(132, nq * bh)
    order = pfa.fwd_block_items(sq, bh, blocks)
    taken = [item for items in order for item in items]
    assert sorted(taken) == [(i, h) for i in range(nq) for h in range(bh)]
    plan = pfa.fwd_tile_plan(sq, sk, causal)
    work = [sum(len(plan[i]) for i, _ in items) for items in order]
    assert max(work) - min(work) <= max(len(t) for t in plan)
    # heaviest first: each block's q tiles in non-increasing work
    for items in order:
        w = [len(plan[i]) for i, _ in items]
        assert w == sorted(w, reverse=True)


@pytest.mark.parametrize("rows,cols", [(128, 128), (256, 512), (1024, 1024),
                                       (256, 128), (512, 128), (1, 64),
                                       (64, 1)])
def test_dropout_shift_path_equals_division_path(rows, cols):
    key = pfa.DropKey(0.1, 0x9E3779B9, 0x7F4A7C15, rows, cols)
    assert pfa.flash_key_shifts(key) == (rows.bit_length() - 1,
                                         cols.bit_length() - 1)
    for bh, sq, sk in ((3, 300, 700), (2, 1024, 257)):
        assert torch.equal(pfa.flash_bits_shifted(key, bh, sq, sk),
                           pfa.flash_bits_ref(key, bh, sq, sk))


@pytest.mark.parametrize("rows,cols", [(104, 104), (200, 128), (128, 96)])
def test_dropout_division_path_for_other_tiles(rows, cols):
    key = pfa.DropKey(0.1, 1, 2, rows, cols)
    assert pfa.flash_key_shifts(key) is None
    with pytest.raises(ValueError, match="power-of-two"):
        pfa.flash_bits_shifted(key, 1, 8, 8)


def test_model_paths_take_the_shift_path():
    """Every model path's logical tile has power-of-two sides: GPT and
    LLaMA (causal, S=2048), BERT (S=512), in bf16 and f32."""
    for s, causal in ((2048, True), (512, False), (512, True),
                      (2048, False)):
        for dtype in (torch.bfloat16, torch.float32):
            key = pfa.DropKey(0.1, 0, 0,
                              *pfa.flash_drop_tile(s, s, causal, dtype))
            assert pfa.flash_key_shifts(key) is not None
