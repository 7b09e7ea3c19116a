"""The port's dropout primitives against the JAX reference, bit for bit.

- the keep-mask hash (``kernels/flash_attention.py`` ``interpret_bits`` /
  ``keep_mask_ref``) against the reference's ``_interpret_bits`` /
  ``_keep_mask`` in interpret mode, seeds and indices at and above 2^31
  included;
- ``split``, ``random_bits``, ``uniform`` and ``bernoulli``
  (``nn/functional/sampling.py``) against ``jax.random``;
- the framework generator (``core/generator.py``): the keys after
  ``seed(s)`` against ``paddle_tpu.seed(s)`` and ``split_key``;
- ``F.dropout`` and ``nn.Dropout`` against the reference's (both modes,
  ``axis``, eval mode, p = 0 consuming no split);
- the block picks that key the kernels' masks (``_auto_blocks``,
  ``ln_block_r``, ``mlp_blocks``) against the reference's over a grid of
  shapes in both dtypes, the tuning table's hits and
  ``FLAGS_kernel_tuning`` off included, and the port's copy of the table
  against ``paddle_tpu/analysis/tuning_table.json``.

Every comparison is exact: masks, bits and keys equal, dropout outputs
equal to the last bit (the compiled reference's scaling by 1 / (1 - p)).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as paddle
from paddle_tpu.core import generator as jgen
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels import mlp_fusion as jmf
from paddle_tpu.kernels import norm_fusion as jnf
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.analysis import autotune as pauto
from paddle_tpu_torch.core import generator as pgen
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.kernels import mlp_fusion as pmf
from paddle_tpu_torch.kernels import norm_fusion as pnf
from paddle_tpu_torch.nn import Dropout as PDropout
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.functional import sampling as S

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the keep-mask hash
# ---------------------------------------------------------------------------

HASH_CASES = [(1, 2, 3, 4, 5, (8, 16)),
              (2 ** 31 + 5, 2 ** 32 - 1, 7, 0, 3, (40, 24)),
              (0xDEADBEEF, 0x12345678, 1000, 2 ** 31, 9, (3, 5)),
              (0, 0, 0, 0, 0, (128, 128)),
              (0x80000000, 0x7FFFFFFF, 2 ** 32 - 1, 65535, 2 ** 31 + 1,
               (24, 768))]


@pytest.mark.parametrize("case", HASH_CASES, ids=lambda c: f"s{c[0]}_b{c[2]}")
def test_hash_bits_and_mask_equal_the_reference(case):
    s0, s1, b, i, j, shape = case
    seeds = jax.lax.bitcast_convert_type(
        jnp.asarray([s0, s1], jnp.uint32), jnp.int32)
    u32 = jnp.uint32
    want = np.asarray(jfa._interpret_bits(seeds[0], seeds[1], u32(b), u32(i),
                                          u32(j), shape)).astype(np.int64)
    got = pfa.interpret_bits(s0, s1, b, i, j, shape).numpy()
    np.testing.assert_array_equal(got, want)
    for p in (0.1, 0.5, 0.0):
        keep = np.asarray(jfa._keep_mask(seeds, u32(b), u32(i), u32(j), shape,
                                         p, True))
        np.testing.assert_array_equal(
            pfa.keep_mask_ref(s0, s1, b, i, j, shape, p).numpy(), keep)
        assert pfa._keep_threshold(p) == int(jfa._keep_threshold(p))


def test_global_masks_tile_the_reference_mask():
    """flash_bits_ref / row_bits_ref over whole matrices are the
    reference's per-tile bits placed at their tiles: (bh, i, j) for the
    score matrices, (row block, 0, 0) for the row matrices."""
    key = pfa.DropKey(0.1, 0xCAFEBABE, 2 ** 31 + 3, 16, 24)
    bits = pfa.flash_bits_ref(key, 3, 40, 50).numpy()
    for bh in range(3):
        for i in range(3):
            for j in range(3):
                tile = pfa.interpret_bits(key.s0, key.s1, bh, i, j, (16, 24))
                blk = bits[bh, 16 * i:16 * i + 16, 24 * j:24 * j + 24]
                np.testing.assert_array_equal(
                    blk, tile.numpy()[:blk.shape[0], :blk.shape[1]])
    rkey = pfa.DropKey(0.1, 9, 10, 8, 12)
    rows = pfa.row_bits_ref(rkey, 20, 12).numpy()
    for i in range(3):
        tile = pfa.interpret_bits(9, 10, i, 0, 0, (8, 12)).numpy()
        np.testing.assert_array_equal(rows[8 * i:8 * i + 8], tile[:len(
            rows[8 * i:8 * i + 8])])
    keep = (rows < rkey.threshold).mean()
    assert 0.8 < keep < 1.0


# ---------------------------------------------------------------------------
# jax.random
# ---------------------------------------------------------------------------

SHAPES = [(), (1,), (5,), (3, 4), (2, 3, 5), (7, 130)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_random_bits_uniform_bernoulli_equal_jax(shape, seed):
    key, kp = jax.random.PRNGKey(seed), S.prng_key(seed)
    np.testing.assert_array_equal(
        S.random_bits(kp, shape).numpy(),
        np.asarray(jax.random.bits(key, shape)).astype(np.int64))
    np.testing.assert_array_equal(S.uniform(kp, shape).numpy(),
                                  np.asarray(jax.random.uniform(key, shape)))
    for p in (0.9, 0.5, 0.1):
        np.testing.assert_array_equal(
            S.bernoulli(kp, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(key, p, shape)))


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_equals_jax(num):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.key_data(jax.random.split(key, num)))
    np.testing.assert_array_equal(S.split(S.prng_key(11), num).numpy(),
                                  want.astype(np.int64))


# ---------------------------------------------------------------------------
# the framework generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1])
def test_generator_keys_equal_the_reference(seed):
    paddle.seed(seed)
    gen = pt_seed(seed)
    assert gen is pgen.default_generator and gen.initial_seed() == seed
    for n in range(50):
        want = tuple(int(w) for w in np.asarray(
            jgen.default_generator.split_key()))
        assert gen.split_key() == want, n
    np.testing.assert_array_equal(
        gen.get_state().numpy(),
        np.asarray(jgen.default_generator.get_state()).astype(np.int64))


def test_generator_state_round_trip():
    gen = pgen.Generator(5)
    state = gen.get_state()
    first = [gen.split_key() for _ in range(3)]
    gen.set_state(state)
    assert [gen.split_key() for _ in range(3)] == first
    # int32 views of the words (the reference's bitcast seeds) are taken
    # modulo 2^32
    gen.set_state(np.asarray(state.numpy(), np.uint32).view(np.int32))
    assert gen.split_key() == first[0]
    pgen.set_rng_state(pgen.get_rng_state())
    with pytest.raises(ValueError, match="two uint32 words"):
        gen.set_state([1, 2, 3])


# ---------------------------------------------------------------------------
# F.dropout and nn.Dropout
# ---------------------------------------------------------------------------

DROPOUT_CASES = [dict(p=0.1), dict(p=0.5, mode="downscale_in_infer"),
                 dict(p=0.3, axis=1), dict(p=0.2, axis=[0, 2]),
                 dict(p=0.25, training=False, mode="downscale_in_infer"),
                 dict(p=0.5, training=False), dict(p=0.0)]


@pytest.mark.parametrize("kw", DROPOUT_CASES, ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()))
def test_functional_dropout_equals_the_reference(kw):
    x = np.random.default_rng(3).standard_normal((4, 6, 5)).astype(
        np.float32)
    paddle.seed(21)
    pt_seed(21)
    want = np.asarray(paddle.nn.functional.dropout(
        paddle.to_tensor(x), **kw).numpy())
    got = PF.dropout(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    # the same number of splits: the next keys agree
    assert pgen.default_generator.split_key() == tuple(
        int(w) for w in np.asarray(jgen.default_generator.split_key()))
    if not kw.get("training", True) or kw["p"] == 0.0:
        assert pgen.default_generator.get_state().tolist() == list(
            S.split(S.prng_key(21), 2)[0].tolist())


def test_dropout_layer_follows_train_and_eval():
    x = np.random.default_rng(4).standard_normal((8, 16)).astype(np.float32)
    jlayer = paddle.nn.Dropout(0.4)
    layer = PDropout(0.4)
    assert repr(layer).endswith("(p=0.4, axis=None, mode=upscale_in_train)")
    for train in (True, False):
        jlayer.train() if train else jlayer.eval()
        layer.train(train)
        paddle.seed(5)
        pt_seed(5)
        want = np.asarray(jlayer(paddle.to_tensor(x)).numpy())
        got = layer(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy() == 0).any() == train


# ---------------------------------------------------------------------------
# the block picks that key the masks, and the table they read
# ---------------------------------------------------------------------------

SEQS = [8, 40, 100, 128, 200, 256, 300, 512, 1000, 1024, 2048, 4096]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_blocks_equal_the_reference(dt, causal):
    for sq in SEQS:
        for sk in (sq, 512, 2048):
            want = jfa._auto_blocks(sq, sk, causal, dt[1])
            assert pfa._auto_blocks(sq, sk, causal, dt[0]) == want, (sq, sk)
    # BERT-base's bf16 signature is a table hit, f32 the heuristic's
    assert pfa._auto_blocks(512, 512, False, torch.bfloat16) == (128, 128)
    assert pfa._auto_blocks(512, 512, False, torch.float32) == (256, 512)
    assert pfa._auto_blocks(2048, 2048, True, torch.bfloat16) == (256, 128)


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_ln_and_mlp_blocks_equal_the_reference(dt):
    for r in (1, 20, 37, 300, 1024, 4096, 16384):
        for h in (24, 64, 768, 1024, 2048, 4096):
            assert pnf.ln_block_r(r, h, dt[0]) == jnf._auto_block_r(
                r, h, dt[1]), (r, h)
            for f in (24, 100, 768, 3072, 520, 8192):
                assert pmf.mlp_blocks(r, h, f, dtype=dt[0]) == jmf.mlp_blocks(
                    r, h, f, dtype=dt[1]), (r, h, f)
    bf = torch.bfloat16
    assert pnf.ln_block_r(1024, 768, bf) == 1024      # table hits
    assert pnf.ln_block_r(4096, 2048, bf) == 8
    assert pmf.mlp_blocks(1024, 768, 3072, dtype=bf) == (16, 128)


def test_tuning_off_follows_the_reference():
    """FLAGS_kernel_tuning off: both packages take the heuristics, so
    BERT-base's bf16 signature keys (256, 512) again."""
    try:
        paddle.set_flags({"FLAGS_kernel_tuning": False})
        pt_set_flags({"FLAGS_kernel_tuning": False})
        for sq in (512, 2048, 200):
            for causal in (False, True):
                assert pfa._auto_blocks(sq, sq, causal, torch.bfloat16) == \
                    jfa._auto_blocks(sq, sq, causal, jnp.bfloat16)
        assert pfa._auto_blocks(512, 512, False, torch.bfloat16) == (256, 512)
        assert pnf.ln_block_r(1024, 768, torch.bfloat16) == \
            jnf._auto_block_r(1024, 768, jnp.bfloat16) == 128
        assert pmf.mlp_blocks(1024, 768, 3072, dtype=torch.bfloat16) == \
            jmf.mlp_blocks(1024, 768, 3072, dtype=jnp.bfloat16)
    finally:
        paddle.set_flags({"FLAGS_kernel_tuning": True})
        pt_set_flags({"FLAGS_kernel_tuning": True})


def test_table_copy_equals_the_reference_table():
    table = json.loads((ROOT / "paddle_tpu" / "analysis"
                        / "tuning_table.json").read_text())["entries"]
    for family, entries in pauto.TABLE.items():
        want = {sig: e["params"] for sig, e in table[family].items()}
        assert entries == want, family
    assert pauto.flash_sig(512, 512, False, torch.bfloat16) == \
        "sq=512,sk=512,causal=0,dtype=bfloat16"
    assert pauto.ln_sig(8, 16, torch.float32) == "r=8,h=16,dtype=float32"
    assert pauto.mlp_sig(1, 2, 3) == "r=1,h=2,f=3,dtype=any"
    with pytest.raises(KeyError, match="unknown family"):
        pauto.lookup("fused_bn", "c=64")
