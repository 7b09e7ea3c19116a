"""The backward's two CUDA routes, reckoned on the CPU.

``bwd_route`` sends bfloat16 at head dim 64 or 128 with aligned pointers
to the Hopper kernels (a pre-pass, then ``flash_dq_wgmma_kernel`` and
``flash_dkv_wgmma_kernel``) and everything else to the generic ones.
``dq_tile_plan`` and ``dkv_tile_plan`` mirror the two kernels' schedules,
as their producers reckon them. Here each is held against brute force
over every (query, key) pair: a dQ q tile visits exactly the KV tiles
that hold a visible pair and a dK/dV kv tile exactly the q tiles that do,
every visited tile that holds a hidden pair is masked (the causal band,
the ragged tails, Sq != Sk), and the bias skips a KV tile, or empties a
kv tile, whose keys it hides entirely. The persistent blocks' orders
(``fwd_block_items`` at dQ's tile, ``dkv_block_items``) take each (tile,
head) once, heaviest first, and balance the causal work. An emulation of
each kernel's arithmetic over its plan — ks = round(k·scale) and qs =
round(q·scale) from the pre-pass, p = exp(s + bias - lse) masked only on
masked tiles, dP dropped by the mask of ``flash_bits_ref``, ds rounded
before its product, dV from the dropped p — is held against the
reference's Pallas ``_dq_kernel`` / ``_dkv_kernel`` through ``_bwd`` in
interpret mode.

Tolerance of the emulations against the reference: atol 2e-5 on dq, dk
and dv, as in test_torch_flash_attention.py — f32 inputs, so the
roundings to the input dtype are exact and only the order of the sums
differs (a tile wrongly skipped or left unmasked moves values by O(1)).
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as pfa

BQ, BK = pfa.DQ_BQ, pfa.DQ_BK
BKV, BQ2 = pfa.DKV_BKV, pfa.DKV_BQ
SEED = (0x9E3779B9, 0x80000001)


@pytest.mark.parametrize("dtype,d,aligned,route", [
    (torch.bfloat16, 128, True, "wgmma"),
    (torch.bfloat16, 64, True, "wgmma"),
    (torch.bfloat16, 128, False, "generic"),
    (torch.bfloat16, 96, True, "generic"),
    (torch.bfloat16, 32, True, "generic"),
    (torch.bfloat16, 256, True, "generic"),
    (torch.float32, 128, True, "generic"),
    (torch.float32, 64, True, "generic"),
    (torch.float16, 64, True, "generic"),
])
def test_route_rule(dtype, d, aligned, route):
    assert pfa.bwd_route(dtype, d, aligned) == route


@pytest.mark.parametrize("drop", [False, True])
def test_cpu_calls_count_no_route(drop):
    before = (dict(pfa.bwd_routes), dict(pfa.prep_launches),
              dict(pfa.launches), dict(pfa.dropout_launches))
    q = torch.randn((2, 64, 128)).bfloat16()
    key = (0.1, 1, 2, 64, 64) if drop else ()
    out, lse = pfa.flash_fwd(q, q, q, True, 0.1, None, 1, *key)
    pfa.flash_bwd(q, q, q, out, lse, q, True, 0.1, None, 1, *key)
    assert (dict(pfa.bwd_routes), dict(pfa.prep_launches),
            dict(pfa.launches), dict(pfa.dropout_launches)) == before
    assert before[0] == {"wgmma": 0, "generic": 0}
    assert before[1] == {"flash_bwd_prep": 0}


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


def _hidden(sq, sk, causal, rows, cols):
    """Whether some position of the whole tile rows x cols (past sq or sk
    included: the kernels compute them) is past sq, past sk or above the
    causal diagonal."""
    r, c = rows[:, None], cols[None, :]
    hide = (r >= sq) | (c >= sk)
    if causal:
        hide = hide | (c > r + (sk - sq))
    return bool(hide.any())


def _brute_dkv(sq, sk, causal, bias_row):
    vis = _visible(sq, sk, causal, bias_row)
    plan = []
    for j in range(-(-sk // BKV)):
        kv = vis[:, j * BKV:(j + 1) * BKV]
        if bias_row is not None and not (
                np.asarray(bias_row)[j * BKV:(j + 1) * BKV] > -5e29).any():
            plan.append([])
            continue
        cols = np.arange(j * BKV, (j + 1) * BKV)
        tiles = []
        for i in range(-(-sq // BQ2)):
            if not kv[i * BQ2:(i + 1) * BQ2].any():
                continue
            rows = np.arange(i * BQ2, (i + 1) * BQ2)
            tiles.append((i, _hidden(sq, sk, causal, rows, cols)))
        plan.append(tiles)
    return plan


def _bias_row(sk, kind):
    """The key-padding row: None, or valid keys then -1e30; 'holes' also
    hides keys [64, 128) wholly (a skipped tile between live ones)."""
    if kind is None:
        return None
    row = np.zeros(sk, np.float32)
    if kind == "short":
        row[min(sk, 70):] = -1e30
    elif kind == "holes":
        row[64:128] = -1e30
        row[sk - 5:] = -1e30
    return row


SHAPES = [(128, 128), (256, 256), (200, 200), (2048, 2048), (512, 1000),
          (1000, 512), (300, 129), (1, 700), (700, 1), (127, 385)]
MODES = ["causal", "dense", "short", "holes"]


def _mode(sk, mode):
    bias = _bias_row(sk, mode if mode in ("short", "holes") else None)
    if mode == "holes" and sk <= 128:
        bias = _bias_row(sk, "short")
    return mode == "causal", bias


@pytest.mark.parametrize("sq,sk", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_dq_plan_matches_brute_force(sq, sk, mode):
    causal, bias = _mode(sk, mode)
    plan = pfa.dq_tile_plan(sq, sk, causal, bias)
    vis = _visible(sq, sk, causal, bias)
    want = []
    for i in range(-(-sq // BQ)):
        tiles = []
        for j in range(-(-sk // BK)):
            if not vis[i * BQ:(i + 1) * BQ, j * BK:(j + 1) * BK].any():
                continue
            r = np.arange(i * BQ, (i + 1) * BQ)[:, None]
            c = np.arange(j * BK, (j + 1) * BK)[None, :]
            hide = (c >= sk) | ((c > r + (sk - sq)) if causal else False)
            tiles.append((j, bool(np.any(hide))))
        want.append(tiles)
    assert plan == want


@pytest.mark.parametrize("sq,sk", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_dkv_plan_matches_brute_force(sq, sk, mode):
    causal, bias = _mode(sk, mode)
    plan = pfa.dkv_tile_plan(sq, sk, causal, bias)
    assert plan == _brute_dkv(sq, sk, causal, bias)
    # every visible pair is covered by a visited tile
    vis = _visible(sq, sk, causal, bias)
    covered = np.zeros_like(vis)
    for j, tiles in enumerate(plan):
        for i, masked in tiles:
            covered[i * BQ2:(i + 1) * BQ2, j * BKV:(j + 1) * BKV] = True
            if not masked and bias is None:
                assert vis[i * BQ2:(i + 1) * BQ2, j * BKV:(j + 1) * BKV].all()
    assert not (vis & ~covered).any()


def test_dkv_plan_bias_hole_visits_nothing():
    """A kv tile whose keys the bias hides entirely visits no q tile (its
    dK and dV are written as zeros); its neighbours visit all of them."""
    bias = _bias_row(300, "holes")
    plan = pfa.dkv_tile_plan(200, 300, False, bias)
    assert plan[1] == []
    assert [i for i, _ in plan[0]] == [i for i, _ in plan[2]] == [0, 1, 2, 3]


def test_dkv_plan_causal_band():
    """Causal at S = 2048: kv tile j visits q tiles j to the last, only
    the diagonal one masked; with sk < sq the offset moves the band."""
    plan = pfa.dkv_tile_plan(2048, 2048, True)
    for j, tiles in enumerate(plan):
        assert [i for i, _ in tiles] == list(range(j, 2048 // BQ2))
        assert [m for _, m in tiles] == [True] + [False] * (len(tiles) - 1)
    plan = pfa.dkv_tile_plan(600, 300, True)
    assert [i for i, _ in plan[0]] == list(range(300 // BQ2, -(-600 // BQ2)))


def _blocks_balanced(order, work, every, heaviest_first):
    taken = [item for items in order for item in items]
    assert sorted(taken) == sorted(every)
    totals = [sum(work[t] for t, _ in items) for items in order]
    assert max(totals) - min(totals) <= max(work)
    if heaviest_first:
        for items in order:
            w = [work[t] for t, _ in items]
            assert w == sorted(w, reverse=True)


@pytest.mark.parametrize("sq,sk,bh,causal", [
    (2048, 2048, 64, True), (2048, 2048, 32, True), (512, 512, 384, False),
    (1000, 1000, 16, True), (200, 200, 36, False), (128, 128, 1, True)])
def test_persistent_blocks_take_every_tile_once(sq, sk, bh, causal):
    """The persistent grids (one block per SM of an H100's 132, at most one
    per item): dQ's (q tile, head) and dK/dV's (kv tile, head) each
    exactly once, heaviest first, each block's work within one item's of
    every other's."""
    nq = -(-sq // BQ)
    plan = pfa.dq_tile_plan(sq, sk, causal)
    order = pfa.fwd_block_items(sq, bh, min(132, nq * bh), BQ)
    _blocks_balanced(order, [len(t) for t in plan],
                     [(i, h) for i in range(nq) for h in range(bh)], True)
    nkv = -(-sk // BKV)
    plan = pfa.dkv_tile_plan(sq, sk, causal)
    order = pfa.dkv_block_items(sk, bh, min(132, nkv * bh))
    _blocks_balanced(order, [len(t) for t in plan],
                     [(j, h) for j in range(nkv) for h in range(bh)], True)


def _rnd(x, dtype):
    return x.to(dtype).float()


def _bits_keep(drop, bh, sq, sk):
    if drop is None:
        return None
    return pfa.flash_bits_ref(drop, bh, sq, sk) < drop.threshold


def _emulate_dq(q, k, v, dout, lse, delta, causal, scale, bias, heads, drop):
    """The wgmma dQ kernel's arithmetic on dq_tile_plan's schedule: ks =
    round(k·scale) (the pre-pass), per visited tile s = q ks^T (+ bias),
    p = exp(s - lse) with the masks only on masked tiles, dP = dO v^T
    dropped, ds = round(p (dP - delta)) into dQ += ds ks."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    ks = _rnd(k.float() * scale, q.dtype)
    keep = _bits_keep(drop, bh, sq, sk)
    dq = torch.zeros(bh, sq, d)
    for b in range(bh):
        brow = None if bias is None else bias[b // heads]
        for i, tiles in enumerate(pfa.dq_tile_plan(sq, sk, causal, brow)):
            rows = torch.arange(i * BQ, min((i + 1) * BQ, sq))
            acc = torch.zeros(len(rows), d)
            for j, masked in tiles:
                cols = torch.arange(j * BK, (j + 1) * BK)
                valid = cols < sk
                kt, vt = torch.zeros(BK, d), torch.zeros(BK, d)
                kt[valid], vt[valid] = ks[b, cols[valid]], v[b, cols[valid]]
                s = q[b, rows] @ kt.T
                if brow is not None:
                    bt = torch.full((BK,), -1e30)
                    bt[valid] = torch.as_tensor(brow)[cols[valid]]
                    s = s + bt
                p = torch.exp(s - lse[b, rows, None])
                if masked:
                    hide = cols[None, :] >= sk
                    if causal:
                        hide = hide | (cols[None, :] > rows[:, None] + sk - sq)
                    p = p.masked_fill(hide, 0.0)
                dp = dout[b, rows] @ vt.T
                if drop is not None:
                    kp = torch.ones(len(rows), BK, dtype=torch.bool)
                    kp[:, valid] = keep[b][rows][:, cols[valid]]
                    dp = torch.where(kp, dp * drop.inv_f32(None), 0.0)
                acc = acc + _rnd(p * (dp - delta[b, rows, None]), q.dtype) @ kt
            dq[b, rows] = acc
    return dq


def _emulate_dkv(q, k, v, dout, lse, delta, causal, scale, bias, heads, drop):
    """The wgmma dK/dV kernel's arithmetic on dkv_tile_plan's schedule:
    qs = round(q·scale) (the pre-pass), per visited q tile S^T = k qs^T,
    P^T = exp(S^T + bias - lse) with the masks only on masked tiles, dV
    += round(dropped P^T) dO, dP^T = v dO^T dropped, dS^T = round(P^T
    (dP^T - delta)) into dK += dS^T qs."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    qs = _rnd(q.float() * scale, q.dtype)
    keep = _bits_keep(drop, bh, sq, sk)
    dk, dv = torch.zeros(bh, sk, d), torch.zeros(bh, sk, d)
    for b in range(bh):
        brow = None if bias is None else bias[b // heads]
        for j, tiles in enumerate(pfa.dkv_tile_plan(sq, sk, causal, brow)):
            kv = torch.arange(j * BKV, min((j + 1) * BKV, sk))
            bk = (torch.zeros(len(kv)) if brow is None
                  else torch.as_tensor(brow)[kv])
            dk_acc, dv_acc = torch.zeros(len(kv), d), torch.zeros(len(kv), d)
            for i, masked in tiles:
                rows = torch.arange(i * BQ2, (i + 1) * BQ2)
                valid = rows < sq
                qt, dot = torch.zeros(BQ2, d), torch.zeros(BQ2, d)
                lt, dlt = torch.zeros(BQ2), torch.zeros(BQ2)
                qt[valid], dot[valid] = qs[b, rows[valid]], dout[b, rows[valid]]
                lt[valid], dlt[valid] = lse[b, rows[valid]], delta[b, rows[valid]]
                p = torch.exp(k[b, kv] @ qt.T + bk[:, None] - lt[None, :])
                if masked:
                    hide = ~valid[None, :].expand(len(kv), BQ2)
                    if causal:
                        hide = hide | (kv[:, None] > rows[None, :] + sk - sq)
                    p = p.masked_fill(hide, 0.0)
                dp = v[b, kv] @ dot.T
                pv = p
                if drop is not None:
                    kp = torch.ones(len(kv), BQ2, dtype=torch.bool)
                    kp[:, valid] = keep[b][rows[valid]][:, kv].T
                    inv = drop.inv_f32(None)
                    pv = torch.where(kp, p * inv, 0.0)
                    dp = torch.where(kp, dp * inv, 0.0)
                dv_acc = dv_acc + _rnd(pv, q.dtype) @ dot
                dk_acc = dk_acc + _rnd(p * (dp - dlt[None, :]), q.dtype) @ qt
            dk[b, kv], dv[b, kv] = dk_acc, dv_acc
    return dk, dv


def _reference(q, k, v, dout, causal, scale, bias, heads, drop_p, blocks):
    """(out, lse, dq, dk, dv) of the reference's Pallas kernels in
    interpret mode at its tiles ``blocks``."""
    seeds = (jax.lax.bitcast_convert_type(jnp.asarray(SEED, jnp.uint32),
                                          jnp.int32) if drop_p else None)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    out, lse = jfa._fwd(jq, jk, jv, jb, seeds, causal, scale, *blocks, True,
                        heads, drop_p)
    grads = jfa._bwd(causal, scale, *blocks, True, heads, drop_p,
                     (jq, jk, jv, jb, seeds, out, lse), jnp.asarray(dout))
    return [np.asarray(x) for x in (out, lse, *grads)]


@pytest.mark.parametrize("sq,sk,mode,drop", [
    (200, 200, "causal", False), (256, 256, "dense", False),
    (130, 300, "causal", False), (300, 130, "causal", False),
    (300, 130, "dense", False), (200, 300, "holes", False),
    (256, 256, "causal", True), (200, 300, "holes", True),
    (256, 256, "dense", True)])
def test_emulated_kernels_match_pallas_backward(sq, sk, mode, drop):
    bh, heads, d = 4, 2, 64
    causal = mode == "causal"
    rng = np.random.default_rng(sq * 7 + sk + drop)
    q, dout = (rng.standard_normal((bh, sq, d)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((bh, sk, d)).astype(np.float32)
            for _ in range(2))
    bias = None
    if mode == "holes":
        bias = np.zeros((bh // heads, sk), np.float32)
        bias[0, BKV:2 * BKV] = -1e30
        bias[1, 90:] = -1e30
    scale = d ** -0.5
    # the model's logical tile keys the mask (_auto_blocks, clamped as
    # _fwd clamps it); without dropout the reference runs 64 x 64 tiles
    blocks = (pfa.flash_drop_tile(sq, sk, causal, torch.float32) if drop
              else (64, 64))
    key = (pfa.DropKey(0.1, *SEED, *blocks) if drop else None)
    out, lse, jdq, jdk, jdv = _reference(q, k, v, dout, causal, scale, bias,
                                         heads, 0.1 if drop else 0.0, blocks)
    t = [torch.from_numpy(x) for x in (q, k, v, dout)]
    tb = None if bias is None else torch.from_numpy(bias)
    tl = torch.from_numpy(lse)
    delta = pfa._delta(torch.from_numpy(out), t[3])
    dq = _emulate_dq(*t, tl, delta, causal, scale, tb, heads, key)
    dk, dv = _emulate_dkv(*t, tl, delta, causal, scale, tb, heads, key)
    rows = slice(sq - sk, None) if causal and sk < sq else slice(None)
    np.testing.assert_allclose(dq[:, rows].numpy(), jdq[:, rows], atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(dk.numpy(), jdk, atol=2e-5, rtol=0)
    np.testing.assert_allclose(dv.numpy(), jdv, atol=2e-5, rtol=0)
    if bias is not None:   # the hidden kv tile's dK and dV are zeros
        assert not dk[:heads, BKV:2 * BKV].any()
        assert not dv[:heads, BKV:2 * BKV].any()


def test_wgmma_ctypes_signatures_match_the_cuda_source():
    src = (Path(pfa.__file__).parent / "csrc"
           / "flash_attention.cu").read_text()
    for name, argtypes in pfa._WGMMA_ARGTYPES.items():
        m = re.search(rf"int {name}_bf16\(([^)]*)\)", src)
        assert m is not None, name
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_float
                 if "float" in p else ctypes.c_uint if "unsigned" in p
                 else ctypes.c_int for p in m.group(1).split(",")]
        assert kinds == argtypes, name
        assert f"int {name}_f32(" not in src    # bf16 only
    for const, value in (("kBQ", BQ), ("kBK", BK), ("kBKV", BKV),
                         ("kBQ2", BQ2)):
        assert re.search(rf"constexpr int [^;]*\b{const} = {value}\b", src)
