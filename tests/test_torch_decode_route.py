"""The B=1 decode kernel's split route (TPU kernel 12 on Hopper), reckoned
on the CPU.

``decode_route`` sends float32 and bfloat16 at D 64 or 128 and NH·D 1024
or 2048, with KVH dividing NH in groups of 1, 2, 4 or 8, to the split
kernels and everything else to the generic ones. ``decode_split_plan``
is the context each attention block reads, from pos on the device;
``decode_proj_plan`` the projection weight's bands. An emulation of the
split kernels' arithmetic over those plans -- per kv head and split,
32-position tiles with one online-softmax rescale a tile, each head's
partials (m, l, o) merged in split order, attn rounded to the weight
type, each head's dot, the heads added to the f32 bias in order -- is
held against the reference's ``decode_attn_proj(..., interpret=True)``.

Tolerances, of the output's largest magnitude: f32 2e-5 (the same f32
arithmetic in other summation orders); bf16 2^-7 (both round q', attn
and y to bf16 at the same points, and an f32 sum near a rounding
boundary may round the other way: a unit of attn's last place moves y
by about 2^-9 of its largest magnitude). Each is shown to reject the
emulation with one split's partial dropped and with one head's
projection dropped.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax.numpy as jnp

from paddle_tpu.kernels.mlp_fusion import decode_attn_proj as jax_decode
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import mlp_fusion as pmf

TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
NEG = -1e30
HO = 48


@pytest.mark.parametrize("dtype,nh,kvh,d,ho,aligned,route", [
    (torch.bfloat16, 16, 16, 128, 2048, True, "split"),
    (torch.float32, 16, 16, 128, 2048, True, "split"),
    (torch.bfloat16, 16, 4, 128, 2048, True, "split"),
    (torch.bfloat16, 16, 8, 64, 1024, True, "split"),
    (torch.bfloat16, 32, 32, 64, 2048, True, "split"),
    (torch.float32, 8, 1, 128, 1000, True, "split"),
    (torch.bfloat16, 16, 2, 64, 768, True, "split"),
    (torch.bfloat16, 32, 32, 128, 4096, True, "generic"),
    (torch.bfloat16, 12, 12, 64, 768, True, "generic"),
    (torch.bfloat16, 16, 16, 96, 1536, True, "generic"),
    (torch.bfloat16, 16, 16, 32, 512, True, "generic"),
    (torch.bfloat16, 32, 2, 64, 2048, True, "generic"),
    (torch.bfloat16, 16, 6, 128, 2048, True, "generic"),
    (torch.bfloat16, 16, 16, 128, 2044, True, "generic"),
    (torch.float32, 16, 16, 128, 2046, True, "generic"),
    (torch.bfloat16, 16, 16, 128, 2048, False, "generic"),
    (torch.float16, 16, 16, 128, 2048, True, "generic"),
])
def test_route_rule(dtype, nh, kvh, d, ho, aligned, route):
    assert pmf.decode_route(dtype, nh, kvh, d, ho, 64, aligned) == route
    if route == "split":   # the block table sits in shared memory
        assert pmf.decode_route(dtype, nh, kvh, d, ho,
                                pmf.DECODE_MAX_PAGES, aligned) == "split"
        assert pmf.decode_route(dtype, nh, kvh, d, ho,
                                pmf.DECODE_MAX_PAGES + 1, aligned) == "generic"


@pytest.mark.parametrize("kvh,mb,want", [(16, 64, 16), (4, 64, 32),
                                         (32, 64, 8), (1, 64, 32),
                                         (4, 6, 6), (256, 64, 1),
                                         (2, 300, 32)])
def test_splits_aim_at_the_target_blocks(kvh, mb, want):
    got = pmf.decode_splits(kvh, mb)
    assert got == want
    assert got * kvh <= max(pmf.DECODE_TARGET_BLOCKS, kvh)
    assert got <= pmf.DECODE_MAX_SPLITS


def _plan_cases():
    cases = []
    for bs, mb in ((16, 64), (8, 6), (48, 3), (1, 80)):
        for kvh in (16, 4, 1):
            last = mb * bs - 1
            for pos in sorted({0, 1, bs - 1, bs, 2 * bs - 1, last // 2,
                               last - 1, last, last + 5}):
                cases.append((pos, mb, bs, kvh))
    return cases


@pytest.mark.parametrize("pos,mb,bs,kvh", _plan_cases())
def test_split_plan_reads_each_position_once(pos, mb, bs, kvh):
    """Every position <= pos (within the table) read exactly once, none
    past pos; each split a run of whole pages but the last, which stops
    at pos; no more splits than the grid's."""
    plan = pmf.decode_split_plan(pos, mb, bs, kvh)
    assert 1 <= len(plan) <= pmf.decode_splits(kvh, mb)
    seen = np.zeros(mb * bs, np.int64)
    for a, b in plan:
        assert a < b and a % bs == 0
        seen[a:b] += 1
    want = np.arange(mb * bs) <= pos
    np.testing.assert_array_equal(seen, want.astype(np.int64))
    for a, b in plan[:-1]:
        assert b % bs == 0
    # pages whose first position is past pos are not read
    assert max(b for _, b in plan) <= min(pos + 1, mb * bs)


def _slots(table, positions, bs, nblocks):
    """The pool rows a block reads for these positions: table entries
    clipped onto a real block, as the kernel clips them."""
    blk = np.clip(table[positions // bs], 0, nblocks - 1)
    return blk * bs + positions % bs


def test_pad_entries_clip_onto_real_blocks():
    bs, nblocks, mb = 16, 6, 8
    table = np.array([3, 1, 5, nblocks, nblocks, -1, nblocks, nblocks])
    for pos in (0, 40, 47, mb * bs - 1):
        for a, b in pmf.decode_split_plan(pos, mb, bs, 16):
            slots = _slots(table, np.arange(a, b), bs, nblocks)
            assert slots.min() >= 0 and slots.max() < nblocks * bs


@pytest.mark.parametrize("nh,d,ho,dtype", [
    (16, 128, 2048, torch.bfloat16), (16, 128, 2048, torch.float32),
    (16, 64, 48, torch.bfloat16), (8, 128, 772, torch.float32),
    (32, 64, 264, torch.bfloat16)])
def test_proj_plan_reads_each_weight_element_once(nh, d, ho, dtype):
    """Each block a band of whole heads: the eight bands tile the rows in
    rank order, the column tiles the columns; every element read once."""
    seen = np.zeros((nh * d, ho), np.int64)
    plan = pmf.decode_proj_plan(nh, d, ho, dtype)
    rb = nh * d // pmf.DECODE_CLUSTER
    assert rb in pmf.DECODE_BANDS and rb % d == 0
    for i, (r0, r1, c0, c1) in enumerate(plan):
        assert (r0, r1) == ((i % 8) * rb, (i % 8 + 1) * rb)
        seen[r0:r1, c0:c1] += 1
    assert (seen == 1).all()
    vec = 16 // (4 if dtype == torch.float32 else 2)
    ct = pmf.DECODE_VECS * vec
    assert {c1 - c0 for *_, c0, c1 in plan if c1 != ho} <= {ct}
    assert len(plan) == pmf.DECODE_CLUSTER * -(-ho // ct)


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def _inputs(nh, kvh, bs, mb, nblocks, pos, pad, seed, d=64):
    rng = np.random.default_rng(seed)
    f = np.float32
    q = rng.normal(size=(nh, d)).astype(f)
    kp = rng.normal(size=(nblocks * bs + 1, kvh, d)).astype(f)
    vp = rng.normal(size=(nblocks * bs + 1, kvh, d)).astype(f)
    table = rng.permutation(nblocks)[:mb].astype(np.int32)
    if pad:
        table[pos // bs + 1:] = nblocks      # pad entries (= num_blocks)
    w = (rng.normal(size=(nh * d, HO)) * 0.1).astype(f)
    b = rng.normal(size=(HO,)).astype(f)
    return q, kp, vp, table, w, b


def _emulate(q, kp, vp, pos, table, w, b, bs, scale, dtype,
             drop_split=None, drop_head=None):
    """The split kernels' arithmetic, in their order, in f32 with their
    roundings to ``dtype``."""
    rnd = (lambda t: t.to(dtype).float())
    nh, d = q.shape
    kvh = kp.shape[1]
    grp = nh // kvh
    nblocks = (kp.shape[0] - 1) // bs
    mb = table.shape[0]
    qs = rnd(rnd(q).float() * scale)
    kf, vf = rnd(kp), rnd(vp)
    attn = torch.empty(nh, d)
    plan = pmf.decode_split_plan(pos, mb, bs, kvh)
    for i in range(kvh):
        qg = qs[i * grp:(i + 1) * grp]                   # [G, D]
        parts = []
        for si, (a, stop) in enumerate(plan):
            m = torch.full((grp,), NEG)
            l = torch.zeros(grp)
            o = torch.zeros(grp, d)
            for t0 in range(a, stop, pmf.DECODE_TILE):
                pos_t = np.arange(t0, min(t0 + pmf.DECODE_TILE, stop))
                slots = torch.from_numpy(_slots(table, pos_t, bs, nblocks))
                s = qg @ kf[slots, i].T                  # [G, T]
                m_new = torch.maximum(m, s.max(1).values)
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[:, None])
                l = l * alpha + p.sum(1)
                o = o * alpha[:, None] + p @ vf[slots, i]
                m = m_new
            if not (drop_split == si and i == 0):
                parts.append((m, l, o))
        mg = torch.stack([m for m, _, _ in parts]).max(0).values
        lt = torch.zeros(grp)
        ot = torch.zeros(grp, d)
        for m, l, o in parts:
            ws = torch.exp(m - mg)
            lt = lt + l * ws
            ot = ot + o * ws[:, None]
        attn[i * grp:(i + 1) * grp] = rnd(ot / lt[:, None])
    att = attn.reshape(nh * d)
    # the projection: eight row bands of whole heads (any band height
    # here), each head's dot over its rows, the heads added in order
    wf = rnd(w)
    y = rnd(b).clone()
    for h in range(nh):
        if h != drop_head:
            y = y + att[h * d:(h + 1) * d] @ wf[h * d:(h + 1) * d]
    return rnd(y)


def _reading(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max()) / float(np.abs(ref).max())


def _reference(q, kp, vp, pos, table, w, b, bs, scale, dtype):
    j = JNP[dtype]
    return np.asarray(jax_decode(
        jnp.asarray(q).astype(j), jnp.asarray(kp).astype(j),
        jnp.asarray(vp).astype(j), pos, jnp.asarray(table),
        jnp.asarray(w).astype(j), jnp.asarray(b).astype(j), block_size=bs,
        scale=scale, interpret=True).astype(jnp.float32))


# (bs, mb, nblocks, d): pages of 8 (several splits of one page each);
# pages of 48 (1.5 tiles a page: a ragged tile in every split); D 128
GEOMETRY = [(8, 6, 7, 64), (48, 3, 4, 64), (16, 4, 5, 128)]
GEOMETRY_IDS = ["bs8", "bs48", "d128"]


def _positions(bs, mb):
    last = bs * mb - 1
    return [(0, True), (bs - 1, True), (bs, True), (last, False)]


# (geometry, NH, KVH): NH 4 and 8, KVH = NH and NH / 4, each geometry met
EMU_CASES = [(0, 4, 4), (1, 8, 2), (2, 8, 8), (2, 4, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", EMU_CASES,
                         ids=["bs8-mha4", "bs48-gqa8", "d128-mha8",
                              "d128-gqa4"])
def test_emulation_matches_pallas_decode(case, dtype):
    g, nh, kvh = case
    bs, mb, nblocks, d = GEOMETRY[g]
    scale = 1.0 / np.sqrt(d)
    for k, (pos, pad) in enumerate(_positions(bs, mb)):
        q, kp, vp, table, w, b = _inputs(nh, kvh, bs, mb, nblocks, pos, pad,
                                         seed=100 * nh + 10 * kvh + k, d=d)
        ref = _reference(q, kp, vp, pos, table, w, b, bs, scale, dtype)
        t = torch.from_numpy
        got = _emulate(t(q), t(kp), t(vp), pos, table, t(w), t(b), bs,
                       scale, dtype)
        assert _reading(got, ref) <= TOL[dtype], (pos, pad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", GEOMETRY, ids=GEOMETRY_IDS)
def test_tolerance_rejects_a_dropped_split_or_head(geom, dtype):
    bs, mb, nblocks, d = geom
    nh, kvh = 8, 2
    scale = 1.0 / np.sqrt(d)
    pos = bs * mb - 1
    q, kp, vp, table, w, b = _inputs(nh, kvh, bs, mb, nblocks, pos, False, 9,
                                     d=d)
    ref = _reference(q, kp, vp, pos, table, w, b, bs, scale, dtype)
    t = torch.from_numpy
    args = (t(q), t(kp), t(vp), pos, table, t(w), t(b), bs, scale, dtype)
    nsplit = len(pmf.decode_split_plan(pos, mb, bs, kvh))
    assert nsplit > 1
    for si in range(nsplit):
        assert _reading(_emulate(*args, drop_split=si), ref) > TOL[dtype], si
    for h in range(nh):
        assert _reading(_emulate(*args, drop_head=h), ref) > TOL[dtype], h


def test_cpu_calls_take_the_plain_version_and_count_no_route():
    q, kp, vp, table, w, b = _inputs(8, 2, 8, 6, 7, 20, True, 4)
    t = torch.from_numpy
    before = dict(pmf.decode_routes), pmf.decode_attn_proj.launches
    got = pmf.decode_attn_proj(t(q), t(kp), t(vp), 20, t(table), t(w), t(b),
                               block_size=8, scale=0.125)
    ref = pmf.decode_attn_proj_ref(t(q), t(kp), t(vp), 20, t(table), t(w),
                                   t(b), block_size=8, scale=0.125)
    assert torch.equal(got, ref)
    assert (dict(pmf.decode_routes), pmf.decode_attn_proj.launches) == before


# ---------------------------------------------------------------------------
# the C interface
# ---------------------------------------------------------------------------

def _kinds(params):
    return [ctypes.c_void_p if "*" in p else ctypes.c_float if "float" in p
            else ctypes.c_uint if "unsigned" in p else ctypes.c_int
            for p in params.split(",")]


def test_ctypes_signatures_match_the_cuda_source():
    src = (Path(pmf.__file__).parent / "csrc" / "decode_attn_proj.cu"
           ).read_text()
    m = re.search(r"int decode_attn_proj_split_##SUFFIX\(([^)]*)\)", src)
    assert m is not None
    assert _kinds(m.group(1).replace("\\", "")) == pmf._SPLIT_ARGTYPES
    for suffix in ("f32", "bf16"):
        m = re.search(rf"int decode_attn_proj_{suffix}\(([^)]*)\)", src)
        assert m is not None
        assert _kinds(m.group(1)) == pmf._ARGTYPES
    # the probe's entry: the route's arguments and the parts' bitmask
    m = re.search(r"int decode_attn_proj_split_parts_bf16\(([^)]*)\)", src)
    assert m is not None
    assert _kinds(m.group(1)) == pmf._SPLIT_ARGTYPES[:-1] + [
        ctypes.c_int, ctypes.c_void_p]
    assert "if (rb == 128)" in src and "} else if (rb == 256)" in src
    assert pmf.DECODE_BANDS == (128, 256)
    assert "DECODE_SPLIT(f32, float)" in src
    assert "DECODE_SPLIT(bf16, __nv_bfloat16)" in src
    for const, value in (("kTile", pmf.DECODE_TILE),
                         ("kMaxSplits", pmf.DECODE_MAX_SPLITS),
                         ("kCluster", pmf.DECODE_CLUSTER),
                         ("kMaxPages", pmf.DECODE_MAX_PAGES),
                         ("kVecs", pmf.DECODE_VECS)):
        assert re.search(rf"constexpr int {const} = {value};", src), const


def test_split_route_raises_without_nvcc(monkeypatch):
    """No fallback: without the library both routes raise, and a named
    route the shapes do not allow is refused, not rerouted."""
    def no_nvcc():
        raise RuntimeError("paddle_tpu_torch: nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_target",
                        lambda name: Path("/nonexistent") / name)
    pmf._lib.cache_clear()
    before = dict(pmf.decode_routes), pmf.decode_attn_proj.launches
    try:
        q, kp, vp, table, w, b = (torch.from_numpy(a) for a in _inputs(
            16, 4, 8, 6, 7, 9, True, 5))
        assert pmf.decode_route(q.dtype, 16, 4, 64, 48, 6, True) == "split"
        pos = torch.tensor([9], dtype=torch.int32)
        args = (q, kp, vp, pos, table, w, b, 8, 0.125)
        with pytest.raises(RuntimeError, match="nvcc"):
            pmf._launch(*args)
        with pytest.raises(RuntimeError, match="nvcc"):
            pmf._launch(*args, route="generic")
        small = (q[:, :16].contiguous(), kp[..., :16].contiguous(),
                 vp[..., :16].contiguous(), pos, table, w[:256], b)
        with pytest.raises(ValueError, match="split route"):
            pmf._launch(*small, 8, 0.125, route="split")
        with pytest.raises(ValueError, match="route"):
            pmf._launch(*args, route="fast")
    finally:
        pmf._lib.cache_clear()
    assert (dict(pmf.decode_routes), pmf.decode_attn_proj.launches) == before
