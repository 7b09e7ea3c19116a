"""Route decisions of the port's functionals: tensors the kernels do not
take go to the dense route with the reference's once-warning, and never
reach a kernel; the launch wrapper refuses a dtype it has no entry point
for.

- The projection-LN kernels take an even Hout up to the width their
  shared-memory row tile allows (1356 in bf16, 1512 in f32, reckoned as
  ``proj_ln.cu`` reckons it); ``fused_attn_proj_residual_layer_norm``
  takes the dense route beyond it, the reference's own route when its
  kernel rejects a shape (``paddle_tpu/nn/functional/mlp.py:162-182``).
- fp16 (or mixed dtypes), and a head dim above 256 for attention and the
  decode kernel, take the dense routes of ``scaled_dot_product_attention``,
  ``fused_mlp``, ``fused_swiglu``, ``fused_attn_proj_residual_layer_norm``
  and the B=1 serving decode step (BatchNorm's are in
  test_torch_batch_norm.py).
- ``_build.call`` raises TypeError for a dtype other than float32 and
  bfloat16, with the library mocked (no card here).

Every kernel entry is replaced by a stub that fails the test if reached on
a dense route; dense results are held against the same math written out
(atol 1e-3 / rtol 1e-3 in fp16, 1e-5 in f32).
"""
import warnings

import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

from paddle_tpu_torch import set_flags
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import mlp_fusion as pmf
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.nn.functional import attention as pattn
from paddle_tpu_torch.nn.functional import mlp as pmlp
from paddle_tpu_torch.nn.functional import norm as pnorm


@pytest.fixture(autouse=True)
def fresh_warnings(monkeypatch):
    for mod in (pmlp, pnorm):
        monkeypatch.setattr(mod, "_DENSE_FALLBACK_WARNED", False)
    monkeypatch.setattr(pattn, "_DENSE_MASK_WARNED", False)
    monkeypatch.setattr(pgpt, "_DECODE_KERNEL_WARNED", False)
    set_flags({"FLAGS_fused_mlp": True, "FLAGS_fused_norm": True})
    yield
    set_flags({"FLAGS_fused_mlp": True, "FLAGS_fused_norm": True})


def _never(name):
    def stub(*a, **k):
        raise AssertionError(f"{name} reached on a dense route")
    return stub


def _dense_warnings(seen):
    return [w for w in seen if "dense" in str(w.message)
            or "composite" in str(w.message)]


# ---------------------------------------------------------------------------
# the projection-LN width (C1)
# ---------------------------------------------------------------------------

def test_proj_ln_width_is_reckoned_as_the_kernel_reckons_it():
    assert pmf.proj_ln_max_hout(torch.bfloat16) == 1356
    assert pmf.proj_ln_max_hout(torch.float32) == 1512
    for dtype, limit in ((torch.bfloat16, 1356), (torch.float32, 1512)):
        assert pmf.proj_ln_eligible(limit, dtype)
        assert not pmf.proj_ln_eligible(limit + 2, dtype)
        assert not pmf.proj_ln_eligible(767, dtype)
        assert pmf.proj_ln_eligible(768, dtype)


@pytest.mark.parametrize("hout,fused", [(64, True), (2048, False),
                                        (63, False)])
def test_proj_ln_routes_by_hout(hout, fused, monkeypatch):
    if not fused:
        monkeypatch.setattr(pmlp, "fused_proj_ln_2d",
                            _never("fused_proj_ln_2d"))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 32, generator=g)
    w = torch.randn(32, hout, generator=g) * 0.2
    b, lnw, lnb = (torch.randn(hout, generator=g) for _ in range(3))
    res = torch.randn(2, 3, hout, generator=g)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        y = pmlp.fused_attn_proj_residual_layer_norm(x, w, b, res, lnw, lnb,
                                                     dropout_rate=0.0)
    assert pmlp.last_mlp_path() == ("fused_proj_ln/plain" if fused
                                    else "dense")
    assert len(_dense_warnings(seen)) == int(not fused)
    want = torch.nn.functional.layer_norm(res + x @ w + b, (hout,), lnw, lnb)
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# fp16 and wide heads (C2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.bfloat16])
def test_mlp_functionals_route_by_dtype(dtype, monkeypatch):
    kernel = dtype != torch.float16
    if not kernel:
        monkeypatch.setattr(pmlp, "fused_mlp_2d", _never("fused_mlp_2d"))
        monkeypatch.setattr(pmlp, "fused_swiglu_2d",
                            _never("fused_swiglu_2d"))
        monkeypatch.setattr(pmlp, "fused_proj_ln_2d",
                            _never("fused_proj_ln_2d"))
    g = torch.Generator().manual_seed(1)

    def r(*s):
        return (torch.randn(*s, generator=g) * 0.3).to(dtype)

    x, w1, b1, w2, b2 = r(2, 4, 16), r(16, 128), r(128), r(128, 16), r(16)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        y = pmlp.fused_mlp(x, w1, b1, w2, b2)
        path_mlp = pmlp.last_mlp_path()
        ys = pmlp.fused_swiglu(x, w1, w1, w2)
        path_swiglu = pmlp.last_mlp_path()
        yp = pmlp.fused_attn_proj_residual_layer_norm(
            x, r(16, 16), r(16), x, r(16), r(16), dropout_rate=0.0)
        path_pl = pmlp.last_mlp_path()
    want = ("fused_mlp/plain", "fused_swiglu/plain", "fused_proj_ln/plain")
    assert (path_mlp, path_swiglu, path_pl) == (
        want if kernel else ("dense",) * 3)
    mine = [w for w in seen
            if str(w.message).startswith("fused_mlp: taking the dense")]
    assert len(mine) == int(not kernel)                    # once
    assert y.dtype == ys.dtype == yp.dtype == dtype
    if not kernel:
        h = torch.nn.functional.gelu(x.float() @ w1.float() + b1.float())
        torch.testing.assert_close(y.float(), h @ w2.float() + b2.float(),
                                   atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype,d,mask,kernel", [
    (torch.float32, 64, False, True), (torch.bfloat16, 64, True, True),
    (torch.float16, 64, False, False), (torch.float16, 64, True, False),
    (torch.float32, 320, False, False), (torch.float32, 320, True, False)])
def test_attention_routes_by_dtype_and_head_dim(dtype, d, mask, kernel,
                                                monkeypatch):
    if not kernel:
        monkeypatch.setattr(pattn, "flash_attention_bshd",
                            _never("flash_attention_bshd"))
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 5, 2, d, generator=g).to(dtype)
               for _ in range(3))
    keep = torch.ones(2, 1, 1, 5, dtype=torch.bool)
    keep[1, ..., 3:] = False
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = pattn.scaled_dot_product_attention(
            q, k, v, attn_mask=keep if mask else None,
            is_causal=not mask, training=False)
    path = pattn.last_attn_path()
    assert path == ((("flash_masked/plain" if mask else "flash/plain"))
                    if kernel else "ref")
    assert len(_dense_warnings(seen)) == int(not kernel)
    assert out.dtype == dtype and out.shape == q.shape
    want = pattn._sdpa_ref(q.float(), k.float(), v.float(),
                           keep if mask else None, not mask)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,d,mode", [
    (torch.float32, 128, "plain"), (torch.bfloat16, 256, "plain"),
    (torch.float16, 128, None), (torch.float32, 320, None)])
def test_decode_kernel_route_by_dtype_and_head_dim(dtype, d, mode):
    set_flags({"FLAGS_serving_decode_kernel": True})
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            got = pgpt._decode_kernel_mode(1, torch.device("cpu"), dtype, d)
            again = pgpt._decode_kernel_mode(1, torch.device("cpu"), dtype,
                                             d)
        assert got == again == mode
        assert len(seen) == int(mode is None)               # once
        assert pgpt._decode_kernel_mode(4, torch.device("cpu"), dtype,
                                        d) is None
    finally:
        set_flags({"FLAGS_serving_decode_kernel": False})


# ---------------------------------------------------------------------------
# the launch wrapper
# ---------------------------------------------------------------------------

class _Lib:
    """Stands in for a kernel library: records which entry point ran."""

    def __init__(self):
        self.ran = []

    def __getattr__(self, name):
        def entry(*args):
            self.ran.append((name, args))
            return 0
        return entry


def test_build_call_refuses_other_dtypes(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 7})())
    lib = _Lib()
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            _build.call(lib, "k", dtype, torch.device("cpu"), 1)
    assert lib.ran == []
    _build.call(lib, "k", torch.float32, torch.device("cpu"), 1)
    _build.call(lib, "k", torch.bfloat16, torch.device("cpu"), 2)
    assert lib.ran == [("k_f32", (1, 7)), ("k_bf16", (2, 7))]
    assert _build.kernel_dtypes(torch.zeros(1), torch.zeros(2))
    assert not _build.kernel_dtypes(torch.zeros(1), torch.zeros(1).bfloat16())
    assert not _build.kernel_dtypes(torch.zeros(1).half())


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
