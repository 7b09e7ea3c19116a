#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card (H100 class, sm_90a) and nvcc; exits non-zero and
prints no result without a card, or when run outside the repository.
Phases, one line each; any failure raises and exits non-zero:

1. environment: torch / CUDA versions, the card's name and power limit
   (nvidia-smi), the matmul precision settings used throughout;
2. build every kernel from the repository's sources (kernels/csrc/);
3. each kernel against its plain PyTorch version on the card at the
   main path's shapes (GPT-3 1.3B: NH=16, D=128, HO=2048, block_size
   16, 64-entry tables, MHA and GQA), fp32 and bf16, with its time,
   its plain version's, a PyTorch library call's and its bound;
4. serve gpt3-1.3b (random weights from a seed, bf16, full width and
   depth) through ServingEngine with FLAGS_serving_decode_kernel on at
   max_batch=1: 4 greedy requests, prompts 128/256/384/512, 32 new
   tokens each; every B=1 decode step must launch the kernel once per
   layer;
5. torch.profiler over 8 more B=1 decode steps: device busy time per
   step, idle share, the kernels that take the time;
6. serve with max_batch=4 and device_loop_k=4: 8 requests, greedy and
   sampled mixed;
7. parity in fp32 at full width: one request, 16 greedy tokens, decode
   kernel on vs the composite PyTorch path: same tokens, close logits;
then the kernels' JSON line and the final status line.
"""
import json
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": (5e-5, 5e-5), "bfloat16": (1.6e-2, 1.6e-2)}  # atol, rtol
REPLACES = "paddle_tpu/kernels/mlp_fusion.py:977"
SOURCE = "paddle_tpu_torch/kernels/csrc/decode_attn_proj.cu"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(n, name, **fields):
    print(f"phase {n} {name}: " + json.dumps(fields), flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, sets, iters=30):
    """Mean ms per call over `iters` calls cycling through `sets` of
    inputs (together larger than the 50 MB L2, as in the real decode
    where each layer's weights are cold), timed with CUDA events."""
    import torch
    for s in sets[:2]:
        fn(s)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: decode_attn_proj against its plain version
# ---------------------------------------------------------------------------

NH, D, HO, BS, MB, NBLOCKS = 16, 128, 2048, 16, 64, 96
POSITIONS = (0, 15, 16, 511, 1023)


def kernel_inputs(torch, kvh, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    pool = NBLOCKS * BS + 1
    return dict(q=rnd(NH, D), k_pool=rnd(pool, kvh, D),
                v_pool=rnd(pool, kvh, D), proj_w=rnd(NH * D, HO, scale=0.02),
                proj_b=rnd(HO, scale=0.02),
                order=torch.randperm(NBLOCKS, generator=g, device=dev))


def table_for(torch, order, pos):
    """Shuffled block ids for the pages pos needs, pad entries
    (= num_blocks) after them."""
    t = order[:MB].to(torch.int32).clone()
    t[pos // BS + 1:] = NBLOCKS
    return t


def bound_ms(pos, kvh, dtype_name):
    e = 2 if dtype_name == "bfloat16" else 4
    nbytes = (NH * D * e + 4 + MB * 4 + 2 * (pos + 1) * kvh * D * e
              + NH * D * HO * e + HO * e + HO * e)
    flops = 4 * NH * (pos + 1) * D + 2 * NH * D * HO
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel_vs_plain(torch):
    from paddle_tpu_torch.kernels.mlp_fusion import (decode_attn_proj,
                                                     decode_attn_proj_ref)
    scale = 1.0 / np.sqrt(D)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        atol, rtol = TOL[name]
        for kvh in (16, 4):
            x = kernel_inputs(torch, kvh, dtype, seed=kvh)
            for pos in POSITIONS:
                table = table_for(torch, x["order"], pos)
                p = torch.tensor([pos], dtype=torch.int32, device="cuda")
                args = (x["q"], x["k_pool"], x["v_pool"], p, table,
                        x["proj_w"], x["proj_b"])
                got = decode_attn_proj(*args, block_size=BS, scale=scale)
                ref = decode_attn_proj_ref(*args, block_size=BS, scale=scale)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), "kernel output not finite")
                err = (got.float() - ref.float()).abs()
                lim = atol + rtol * ref.float().abs()
                check(bool((err <= lim).all()),
                      f"kernel disagrees with plain: {name} kvh={kvh} "
                      f"pos={pos} max_abs_err={float(err.max())}")
                worst[name] = max(worst.get(name, 0.0), float(err.max()))
    # times at the main path's shape: bf16 MHA, pos=511, cold weights
    pos, kvh = 511, 16
    sets = []
    for s in range(6):
        x = kernel_inputs(torch, kvh, torch.bfloat16, seed=100 + s)
        table = table_for(torch, x["order"], pos)
        slots = (table.long().clamp(0, NBLOCKS - 1)[:, None] * BS
                 + torch.arange(BS, device="cuda")).reshape(-1)[:pos + 1]
        x.update(table=table,
                 p=torch.tensor([pos], dtype=torch.int32, device="cuda"),
                 kc=x["k_pool"][slots].permute(1, 0, 2)[None].contiguous(),
                 vc=x["v_pool"][slots].permute(1, 0, 2)[None].contiguous())
        sets.append(x)

    def run_kernel(x):
        decode_attn_proj(x["q"], x["k_pool"], x["v_pool"], x["p"],
                         x["table"], x["proj_w"], x["proj_b"],
                         block_size=BS, scale=scale)

    def run_plain(x):
        decode_attn_proj_ref(x["q"], x["k_pool"], x["v_pool"], x["p"],
                             x["table"], x["proj_w"], x["proj_b"],
                             block_size=BS, scale=scale)

    def run_library(x):
        # yardstick only, never called by the port: SDPA over the
        # context gathered beforehand + addmm
        attn = torch.nn.functional.scaled_dot_product_attention(
            x["q"][None, :, None, :], x["kc"], x["vc"])
        torch.addmm(x["proj_b"], attn.reshape(1, NH * D), x["proj_w"])

    t = {}
    for key, fn in (("plain_ms", run_plain), ("ms", run_kernel),
                    ("ms_2", run_kernel), ("plain_ms_2", run_plain),
                    ("library_ms", run_library)):
        t[key] = cuda_ms(fn, sets)
    bms, by = bound_ms(pos, kvh, "bfloat16")
    return dict(max_abs_err=worst["bfloat16"], max_abs_err_f32=worst["float32"],
                ms=min(t["ms"], t["ms_2"]),
                plain_ms=min(t["plain_ms"], t["plain_ms_2"]),
                library_ms=t["library_ms"], bound_ms=bms, bound_by=by,
                timed_at=dict(pos=pos, dtype="bfloat16", kvh=kvh, ho=HO),
                all_ms=t)


# ---------------------------------------------------------------------------
# phases 4-6: the serving path
# ---------------------------------------------------------------------------

def phase_serve_b1(torch, model):
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.inference import (SamplingParams, ServingEngine,
                                            gpt_adapter)
    from paddle_tpu_torch.kernels.mlp_fusion import decode_attn_proj
    from paddle_tpu_torch.models import gpt
    cfg = model.cfg
    set_flags({"FLAGS_serving_decode_kernel": True})
    eng = ServingEngine(gpt_adapter(model), num_blocks=512, block_size=16,
                        max_model_len=1024, max_batch=1)
    rng = np.random.default_rng(0)
    eng.submit(rng.integers(0, cfg.vocab_size, 16), SamplingParams(4),
               request_id="warmup")
    eng.run_until_idle()
    steps0 = eng.stats()["decode_steps"]
    decode_attn_proj.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, n),
                       SamplingParams(max_new_tokens=32))
            for n in (128, 256, 384, 512)]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = decode_attn_proj.launches
    st = eng.stats()
    steps = st["decode_steps"] - steps0
    check(all(r.state == "FINISHED" and len(r.tokens) == 32 for r in reqs),
          "B=1 serving: not every request finished with 32 tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          "B=1 serving: token out of vocabulary")
    check(st["leaked_blocks"] == 0, f"leaked {st['leaked_blocks']} blocks")
    check(gpt.last_decode_kernel_path() == "kernel/cuda",
          f"decode path {gpt.last_decode_kernel_path()}")
    check(launches == cfg.num_layers * steps and steps > 0,
          f"decode_attn_proj launched {launches} times in {steps} B=1 "
          f"decode steps ({cfg.num_layers} layers)")
    ntok = sum(len(r.tokens) for r in reqs)
    out = dict(requests=len(reqs), tokens=ntok, decode_steps=steps,
               kernel_launches=launches, leaked_blocks=st["leaked_blocks"],
               wall_s=wall, tokens_per_s=ntok / wall,
               prefill_ms=[(r.t_first_token - r.t_admit) * 1e3 for r in reqs],
               ttft_ms=[(r.t_first_token - r.t_submit) * 1e3 for r in reqs],
               ms_per_token=[(r.t_terminal - r.t_first_token) * 1e3
                             / (len(r.tokens) - 1) for r in reqs])
    return out, eng


def phase_profile_b1(torch, eng, vocab_size, steps=8):
    """torch.profiler over `steps` B=1 decode steps of one more request
    (after the measured run): device busy time per step against the
    profiled wall time, and the kernels that take it. The profiler adds
    host time, so the idle share here is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import SamplingParams
    prompt = np.random.default_rng(3).integers(0, vocab_size, 256)
    eng.submit(prompt, SamplingParams(max_new_tokens=steps + 2))
    eng.step()                       # admission + prefill + first decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_idle()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms == 0.0:
        return dict(steps=steps, device_time="not measured (no CUDA events)")
    ours = sum(e.self_device_time_total for e in dev
               if any(k in e.key for k in ("attn_partial", "proj_partial",
                                           "proj_out"))) / 1e3
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    return dict(steps=steps, wall_ms_per_step=wall_ms / steps,
                device_busy_ms_per_step=busy_ms / steps,
                device_idle_share=1.0 - busy_ms / wall_ms,
                decode_attn_proj_ms_per_step=ours / steps,
                top_device_ms_per_step=[
                    (e.key[:60], e.self_device_time_total / 1e3 / steps,
                     e.count // steps) for e in top[:8]])


def phase_serve_b4(torch, model):
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.inference import (SamplingParams, ServingEngine,
                                            gpt_adapter)
    from paddle_tpu_torch.kernels.mlp_fusion import decode_attn_proj
    cfg = model.cfg
    set_flags({"FLAGS_serving_decode_kernel": True})
    eng = ServingEngine(gpt_adapter(model), num_blocks=512, block_size=16,
                        max_model_len=1024, max_batch=4, device_loop_k=4)
    rng = np.random.default_rng(1)
    decode_attn_proj.launches = 0
    t0 = time.perf_counter()
    reqs = []
    for i in range(8):
        samp = (dict(temperature=0.8, top_p=0.9, seed=i) if i % 2 else {})
        reqs.append(eng.submit(rng.integers(0, cfg.vocab_size,
                                            int(rng.integers(64, 513))),
                               SamplingParams(max_new_tokens=32, **samp)))
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    check(all(r.state == "FINISHED" and len(r.tokens) == 32 for r in reqs),
          "B=4 serving: not every request finished with 32 tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          "B=4 serving: token out of vocabulary")
    check(st["leaked_blocks"] == 0, f"leaked {st['leaked_blocks']} blocks")
    ntok = sum(len(r.tokens) for r in reqs)
    out = dict(requests=len(reqs), tokens=ntok, windows=st["decode_steps"],
               kernel_launches_b1_tail=decode_attn_proj.launches,
               leaked_blocks=st["leaked_blocks"], wall_s=wall,
               tokens_per_s=ntok / wall)
    del eng
    return out


def generate(torch, params, cfg, prompt, n_new, kernel):
    """Prefill + greedy decode through a BlockPool; returns tokens and
    the logits rows."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.inference import BlockPool, kv_append
    from paddle_tpu_torch.models import gpt
    set_flags({"FLAGS_serving_decode_kernel": kernel})
    bs, width = 16, 8
    pool = BlockPool(cfg.num_layers, 16, bs, cfg.num_heads,
                     cfg.hidden_size // cfg.num_heads, dtype=cfg.dtype)
    pool.alloc("r", pool.blocks_needed(len(prompt) + n_new))
    ids = torch.tensor(prompt, dtype=torch.int32, device="cuda")[None]
    last, ks, vs = gpt.serving_prefill(
        params, ids, torch.tensor([len(prompt)], device="cuda"), cfg)
    slots = torch.from_numpy(pool.slots_for("r", 0, len(prompt))).cuda()
    for layer in range(cfg.num_layers):
        kv_append(pool.k[layer], ks[layer, 0], slots)
        kv_append(pool.v[layer], vs[layer, 0], slots)
    bt = torch.from_numpy(pool.block_table("r", width)).cuda()[None]
    rows = [last[0]]
    toks = [int(torch.argmax(last[0]))]
    for i in range(n_new - 1):
        lg, _, _ = gpt.serving_decode_step(
            params, pool.k, pool.v,
            torch.tensor([toks[-1]], dtype=torch.int32, device="cuda"),
            torch.tensor([len(prompt) + i], dtype=torch.int32, device="cuda"),
            bt, cfg, bs)
        rows.append(lg[0])
        toks.append(int(torch.argmax(lg[0])))
    check(gpt.last_decode_kernel_path() == ("kernel/cuda" if kernel
                                            else "composite"),
          f"parity run took {gpt.last_decode_kernel_path()}")
    return toks, torch.stack(rows)


def phase_parity_fp32(torch):
    from paddle_tpu_torch.models import gpt
    cfg = gpt.CONFIGS["gpt3-1.3b"]._replace(dtype=torch.float32)
    model = gpt.GPTForCausalLM(cfg, seed=1)
    params = gpt.serving_params(model)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 64).tolist()
    tk, lk = generate(torch, params, cfg, prompt, 16, kernel=True)
    tc, lc = generate(torch, params, cfg, prompt, 16, kernel=False)
    diff = float((lk - lc).abs().max())
    check(bool(torch.isfinite(lk).all()) and lk.shape == (16, cfg.vocab_size),
          "parity logits not finite or misshapen")
    check(tk == tc, f"greedy tokens differ: kernel {tk} vs composite {tc}")
    check(diff <= 1e-3, f"logits differ by {diff} > 1e-3")
    del model, params
    return dict(tokens=len(tk), same_tokens=tk == tc, max_abs_logit_diff=diff,
                tolerance=1e-3)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import gpt

    # full-precision matmuls for every comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = gpu_line()
    phase(1, "environment", torch=torch.__version__, cuda=torch.version.cuda,
          device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=card,
          allow_tf32=False, allow_bf16_reduced_precision_reduction=False)
    print(card, flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    phase(2, "build", seconds=time.perf_counter() - t0,
          libraries=[str(p.name) for p in libs.values()],
          ptxas=[ln.strip() for log in _build.build_log.values()
                 for ln in log.splitlines() if "registers" in ln])

    kern = phase_kernel_vs_plain(torch)
    phase(3, "decode_attn_proj vs plain", tolerance=TOL, **kern)

    model = gpt.GPTForCausalLM(gpt.CONFIGS["gpt3-1.3b"], seed=0)
    serve1, eng = phase_serve_b1(torch, model)
    phase(4, "serve gpt3-1.3b bf16 max_batch=1 kernel on", **serve1)
    prof = phase_profile_b1(torch, eng, model.cfg.vocab_size)
    phase(5, "profile of the B=1 decode step", **prof)
    del eng
    serve4 = phase_serve_b4(torch, model)
    phase(6, "serve gpt3-1.3b bf16 max_batch=4 k=4", **serve4)
    del model
    torch.cuda.empty_cache()
    par = phase_parity_fp32(torch)
    phase(7, "parity fp32 kernel vs composite", **par)

    print(json.dumps({"kernels": [{
        "name": "decode_attn_proj", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": serve1["kernel_launches"],
        "max_abs_err": kern["max_abs_err"], "max_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
