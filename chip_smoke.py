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
8. the three flash-attention kernels (forward, dQ, dK/dV) against their
   plain versions on the card: causal and not, S 2048 and 1000 (ragged),
   B*NH 64 and 16, D=128, fp32 and bf16 (out, lse, dq, dk, dv), each
   element within its row's scale; then their times at the slice's
   shape (B=4, NH=16, S=2048, bf16, causal) beside the plain versions'
   and the bound, the forward beside SDPA's forward, and the whole
   backward (delta, dQ, dK/dV) beside SDPA's backward;
9. the three fused MLP kernels (forward, dX, dW) against their plain
   versions on the card: gpt3-1.3b (R=8192, H=2048, F=8192) and ragged
   shapes (R=1000/333, H=96/100, F=320/200/2560), fp32 and bf16, both
   GeLU forms (y, dx, dw1, db1, dw2, db2), each element within its
   row's scale, the check shown to reject a forward missing one ffn
   chunk; their times at gpt3-1.3b shape beside the plain versions' and
   the bound, the forward beside the dense addmm -> gelu -> addmm, the
   shared backward beside that composite's backward;
10. train gpt3-1.3b (random weights from a seed, bf16, full width and
   depth, FLAGS_fused_mlp on as by default, remat save_small, bf16 AdamW
   moments, the plain LM head) at B=4, S=2048 on one fixed batch: one
   warm-up step, then 4 steps; finite, falling loss; the fused MLP path
   taken; each flash and fused MLP kernel launched 24 times per step;
   ms/step, tokens/s, model TFLOP/s, peak memory, and the card's SM
   clock, power draw and temperature sampled during the timed steps;
11. torch.profiler over 2 more training steps: device busy time per
   step, idle share, the flash and fused MLP kernels' shares, the
   kernels that take the time;
12. one step under remat 'full': the flash and fused MLP forwards run 48
   times, the backward kernels 24;
13. the same training with FLAGS_fused_mlp off (the dense MLP; 1 warm-up
   and 2 steps): ms/step, peak memory and the card's clocks beside the
   fused step's, whose peak may exceed it by no more than the kernels'
   workspace;
14. parity in fp32 at gpt3-1.3b width, 2 layers, B=1, S=2048: loss and
   every gradient with the fused MLP kernels vs the dense MLP, and with
   the flash kernels vs _block_apply's dense attention branch;
15. the fused SwiGLU kernels (forward, and the backward that computes dX
   and dW in one call) against their plain versions on the card through
   the custom ops and autograd through fused_swiglu_2d: llama-7b (R=2048,
   H=4096, F=11008, the last ffn chunk ragged) and ragged shapes
   (R=1000/333, H=96/2048/100, F=320/2560/200), fp32 and bf16 (y, dx,
   dwg, dwu, dwd), each element within its row's scale; two backward
   calls give the same bits; the check shown to reject a forward missing
   one ffn chunk; their times at llama-7b shape beside the plain
   versions', the bound and the dense silu-gated composite through cuBLAS
   (forward, and its autograd backward);
16. train llama-7b (random weights from a seed, bf16, full width and
   depth, FLAGS_fused_mlp on as by default) through the Layer model and
   AdamW (model.loss -> backward -> opt.step -> opt.clear_grad) at B=1,
   S=2048 on one fixed batch: one warm-up step, then 4 steps; finite,
   falling loss; each SwiGLU and flash kernel launched 32 times per step;
   ms/step, tokens/s, model TFLOP/s, the AdamW update's ms (CUDA events),
   peak memory and the card's clocks;
17. torch.profiler over 2 more llama-7b steps: device busy time per step,
   idle share, the flash and SwiGLU kernels' shares, the optimizer
   step's device time, the kernels that take the time;
18. the same llama-7b training with FLAGS_fused_mlp off (the dense
   SwiGLU through cuBLAS; 1 warm-up and 2 steps): ms/step and peak
   memory beside the fused step's;
19. parity in fp32 at llama-7b width, 2 layers, B=1, S=2048: loss and
   every gradient with the SwiGLU kernels vs the dense SwiGLU, and with
   the flash kernels vs a dense causal attention written here;
then the card's name and power limit again, the kernels' JSON line and
the final status line.
"""
import gc
import json
import subprocess
import sys
import threading
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


class ClockSampler:
    """Samples the card's SM clock, power draw and temperature with
    nvidia-smi every `period` s while the `with` block runs (a thread,
    joined on exit): min / mean / max of each."""

    QUERY = "clocks.sm,power.draw,temperature.gpu"

    def __init__(self, period=0.25):
        self.period = period
        self.rows = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", f"--query-gpu={self.QUERY}",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=30).stdout.strip().splitlines()
                self.rows.append([float(v) for v in out[0].split(",")])
            except (OSError, subprocess.SubprocessError, IndexError,
                    ValueError):
                return      # no reading: summary() says so
            self._stop.wait(self.period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)

    def summary(self):
        if not self.rows:
            return "not measured (no nvidia-smi samples)"
        cols = zip(*self.rows)
        return {name: dict(min=min(c), mean=sum(c) / len(c), max=max(c))
                for name, c in zip(("sm_clock_mhz", "power_w", "temp_c"),
                                   cols)} | {"samples": len(self.rows)}


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


# ---------------------------------------------------------------------------
# phase 8: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

FLASH_SOURCE = "paddle_tpu_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = {"flash_fwd": "paddle_tpu/kernels/flash_attention.py:167",
                  "flash_dq": "paddle_tpu/kernels/flash_attention.py:329",
                  "flash_dkv": "paddle_tpu/kernels/flash_attention.py:420"}
# Each element is held to |kernel - plain| <= tol * (rms + |plain|), with
# rms that of the element's row of plain (the last axis: D for out, dq,
# dk, dv; S for lse), so late causal rows, whose values are small, are
# held at their own scale. f32 sums in another order; bf16 I/O rounds p
# and ds to 8 bits at other points (the kernel's online softmax scales p
# by the running max, the plain version by the row's final max). Worst
# readings at these seeds on an H100: 7.0e-6 (f32), 0.0103 (bf16); a
# forward that drops one tile reads over 1.6 (flash_check_rejects).
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2 ** -5}
FLASH_D = 128
FLASH_CASES = [(causal, s, bh) for causal in (True, False)
               for s in (2048, 1000) for bh in (64, 16)]
TRAIN_B, TRAIN_S, TRAIN_NH = 4, 2048, 16     # the slice's attention shape


def flash_inputs(torch, bh, s, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, s, FLASH_D, generator=g, device="cuda").to(dtype)
            for _ in range(4)]                           # q, k, v, dout


def flash_bounds(bh, s, causal):
    """bound_ms and what bounds it for each kernel at [bh, s, 128] bf16:
    the products each kernel's function needs over the visible (q, k)
    pairs (fwd: s and p.v; dQ: s, dp, ds.k; dK/dV: s, dp, p^T.dO,
    ds^T.q), each 2 flops per pair per head-dim element, at 989 TFLOP/s;
    its inputs read once and outputs written once at 3.35 TB/s."""
    pairs = s * (s + 1) // 2 if causal else s * s
    prod = 2.0 * pairs * FLASH_D * bh
    mat = bh * s * FLASH_D * 2                 # one bf16 [bh, s, d]
    row = bh * s * 4                           # one f32 [bh, s]
    work = {"flash_fwd": (2 * prod, 4 * mat + row),
            "flash_dq": (3 * prod, 5 * mat + 2 * row),
            "flash_dkv": (4 * prod, 6 * mat + 2 * row)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / H100_FLOPS["bfloat16"]
        t_bytes = nbytes / H100_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def flash_reading(got, ref):
    """max over elements of |got - ref| / (rms + |ref|), rms that of each
    row (the last axis) of ref but no less than 1/16 of the whole
    tensor's (a row whose terms cancel to ~0, as causal dQ's first row
    does, is held at the tensor's scale): what FLASH_TOL bounds."""
    g, r = got.float(), ref.float()
    rms = r.square().mean(-1, keepdim=True).sqrt().clamp_min(
        float(r.square().mean().sqrt()) / 16)
    return float(((g - r).abs() / (rms + r.abs()).clamp_min(1e-30)).max())


def phase_flash_vs_plain(torch):
    """All three kernels against their plain versions on the card (out,
    lse, dq, dk, dv), then their times at the slice's shape."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    scale = FLASH_D ** -0.5
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for causal, s, bh in FLASH_CASES:
            q, k, v, do = flash_inputs(torch, bh, s, dtype, seed=s + bh)
            out, lse = fa.flash_fwd(q, k, v, causal, scale)
            dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, causal, scale)
            rout, rlse = fa.flash_fwd_ref(q, k, v, causal, scale)
            # the plain backward from the kernel's own (out, lse), so each
            # kernel is held alone
            rdq, rdk, rdv = fa.flash_bwd_ref(q, k, v, out, lse, do, causal,
                                             scale)
            torch.cuda.synchronize()
            for key, got, ref in (("out", out, rout), ("lse", lse, rlse),
                                  ("dq", dq, rdq), ("dk", dk, rdk),
                                  ("dv", dv, rdv)):
                check(bool(torch.isfinite(got).all()),
                      f"flash {key} not finite ({name} s={s} bh={bh})")
                err = float((got.float() - ref.float()).abs().max())
                rel = flash_reading(got, ref)
                check(rel <= FLASH_TOL[name],
                      f"flash {key} disagrees with plain: {name} causal="
                      f"{causal} s={s} bh={bh} max_abs_err={err} "
                      f"relative {rel} > {FLASH_TOL[name]}")
                kern = {"out": "flash_fwd", "lse": "flash_fwd",
                        "dq": "flash_dq"}.get(key, "flash_dkv")
                w = worst.setdefault(name, {}).setdefault(kern, [0.0, 0.0])
                w[0], w[1] = max(w[0], err), max(w[1], rel)
            del q, k, v, do, out, lse, dq, dk, dv, rout, rlse, rdq, rdk, rdv
            torch.cuda.empty_cache()
    times = flash_times(torch, fa, scale)
    return dict(tolerance_relative_to_row_rms_plus_abs=FLASH_TOL,
                worst={n: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for n, w in worst.items()},
                cases=len(FLASH_CASES) * 2,
                wrong_kernel_readings=flash_check_rejects(torch, fa, scale),
                **times)


def flash_check_rejects(torch, fa, scale, tile=64):
    """The bf16 check must reject a forward that skips a tile: the plain
    forward with the diagonal tile dropped for the late half of the rows
    (causal, S=2048), or with the ragged tail tile dropped (S=1000).
    Returns each one's reading, and its max error over max |plain| (the
    measure a whole-tensor check would see)."""
    out = {}
    for label, causal, s in (("diagonal", True, 2048), ("tail", False, 1000)):
        q, k, v, _ = flash_inputs(torch, 16, s, torch.bfloat16, seed=s + 16)
        ref, _ = fa.flash_fwd_ref(q, k, v, causal, scale)
        i = torch.arange(s, device="cuda")
        row, col = i[:, None], i[None, :]
        if causal:
            keep = (col <= row) & ~((row // tile == col // tile)
                                    & (row >= s // 2))
        else:
            keep = (col < s // tile * tile).expand(s, s)
        qs = (q.float() * scale).to(q.dtype).float()
        sc = qs @ k.float().transpose(1, 2)
        wrong = (torch.softmax(sc.masked_fill(~keep, -1e30), -1)
                 @ v.float()).to(q.dtype)
        reading = flash_reading(wrong, ref)
        check(reading > FLASH_TOL["bfloat16"],
              f"the bf16 flash check passes a forward with the {label} tile "
              f"dropped: {reading} <= {FLASH_TOL['bfloat16']}")
        out[label] = dict(reading=reading, relative_to_max=float(
            (wrong.float() - ref.float()).abs().max()
            / ref.float().abs().max()))
        del q, k, v, ref, qs, sc, wrong
    torch.cuda.empty_cache()
    return out


def in_turns(a, b, iters=20):
    """CUDA-event ms of a and b timed in turns (a, b, b, a), the better
    pass of each, and all four passes."""
    t = {}
    for key, fn in (("a", a), ("b", b), ("b_2", b), ("a_2", a)):
        t[key] = cuda_ms(fn, [None], iters=iters)
    return min(t["a"], t["a_2"]), min(t["b"], t["b_2"]), t


def flash_times(torch, fa, scale):
    """CUDA-event times at B=4, NH=16, S=2048, D=128, bf16, causal: each
    kernel in turns with its plain version. The library yardsticks (never
    called by the port): SDPA's forward for the forward kernel; no
    library call computes dQ alone or dK/dV alone, so SDPA's backward
    (dQ, dK and dV in one call, on a retained forward graph) is held
    against the port's whole backward (delta, dQ, dK/dV) instead."""
    bh, s = TRAIN_B * TRAIN_NH, TRAIN_S
    q, k, v, do = flash_inputs(torch, bh, s, torch.bfloat16, seed=7)
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = fa._delta(out, do)
    runs = {
        "flash_fwd": (lambda _: fa._fwd_cuda(q, k, v, True, scale),
                      lambda _: fa.flash_fwd_ref(q, k, v, True, scale)),
        "flash_dq": (lambda _: fa._dq_cuda(q, k, v, do, lse, delta, True,
                                           scale),
                     lambda _: fa.flash_dq_ref(q, k, v, do, lse, delta, True,
                                               scale)),
        "flash_dkv": (lambda _: fa._dkv_cuda(q, k, v, do, lse, delta, True,
                                             scale),
                      lambda _: fa.flash_dkv_ref(q, k, v, do, lse, delta,
                                                 True, scale)),
    }
    res = {}
    for name, (kern, plain) in runs.items():
        plain_ms, ms, t = in_turns(plain, kern)
        res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, all_ms=t)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, doh = (x.view(TRAIN_B, TRAIN_NH, s, FLASH_D)
                       for x in (q, k, v, do))
    res["flash_fwd"]["library_ms"], _, _ = in_turns(
        lambda _: sdpa(qh, kh, vh, is_causal=True), runs["flash_fwd"][0])
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qh, kh, vh))
    og = sdpa(qg, kg, vg, is_causal=True)
    sdpa_bwd_ms, bwd_ms, t = in_turns(
        lambda _: torch.autograd.grad(og, (qg, kg, vg), doh,
                                      retain_graph=True),
        lambda _: fa._bwd_cuda(q, k, v, out, lse, do, True, scale))
    bounds = flash_bounds(bh, s, True)
    for name in runs:
        res[name].update(bound_ms=bounds[name][0], bound_by=bounds[name][1])
    res["backward"] = dict(ms=bwd_ms, sdpa_bwd_ms=sdpa_bwd_ms, all_ms=t,
                           bound_ms=bounds["flash_dq"][0]
                           + bounds["flash_dkv"][0])
    res["timed_at"] = dict(b=TRAIN_B, nh=TRAIN_NH, s=s, d=FLASH_D,
                           dtype="bfloat16", causal=True)
    del q, k, v, do, out, lse, delta, qg, kg, vg, og
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 9: the fused MLP kernels against their plain versions
# ---------------------------------------------------------------------------

MLP_SOURCE = "paddle_tpu_torch/kernels/csrc/fused_mlp.cu"
MLP_REPLACES = {"fused_mlp_fwd": "paddle_tpu/kernels/mlp_fusion.py:228",
                "fused_mlp_dx": "paddle_tpu/kernels/mlp_fusion.py:260",
                "fused_mlp_dw": "paddle_tpu/kernels/mlp_fusion.py:296"}
# Each element is held as the flash kernels are (flash_reading): |kernel -
# plain| <= tol * (rms of its row + |plain|). f32 sums in another order.
# bf16: act and da are rounded at the same points in both (the kernel's
# f32 sums may land across a rounding boundary), and for dW the bf16
# kernel feeds round(da) and round(act) to the tensor cores where the
# plain version (the reference) keeps them f32; dW1 and dW2 come out in
# bf16, the plain ones in f32.
MLP_TOL = {"float32": 1e-4, "bfloat16": 2 ** -5}
MLP_R, MLP_H, MLP_F = TRAIN_B * TRAIN_S, 2048, 8192   # the slice's shape
# (r, h, f, dtype, approximate): gpt3-1.3b; rows not a multiple of any
# tile, f <= 512 not a multiple of 128, h not a multiple of 64; the last
# ffn chunk ragged (2560 = 2048 + 512); strides not a multiple of
# 16 bytes (h = 100: the kernels' scalar load path)
MLP_CASES = [(MLP_R, MLP_H, MLP_F, "bfloat16", True),
             (1000, 96, 320, "bfloat16", False),
             (1000, 96, 320, "float32", True),
             (1000, 2048, 2560, "float32", False),
             (1000, 2048, 2560, "bfloat16", True),
             (333, 100, 200, "bfloat16", True)]


def mlp_inputs(torch, r, h, f, dtype, seed):
    """x, w1, b1, w2, b2, g at the model's scale (normal(0, 0.02)
    weights; LayerNorm'd x; small biases)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * s).to(dtype)

    return (rnd(r, h), rnd(h, f, s=0.02), rnd(f, s=0.02), rnd(f, h, s=0.02),
            rnd(h, s=0.02), rnd(r, h, s=1e-3))


def mlp_bounds(r, h, f, esize):
    """bound_ms and what bounds it for the forward and the backward: the
    products each call needs (forward 4 RHF; backward 10 RHF: dX's two
    products, dW's two and the first product recomputed once for both)
    at 989 TFLOP/s; its inputs read once and outputs written once at
    3.35 TB/s."""
    rhf = float(r) * h * f
    rows, w, vf, vh = r * h * esize, h * f * esize, f * esize, h * esize
    work = {"forward": (4 * rhf, rows + 2 * w + vf + vh + rows),
            "backward": (10 * rhf, 2 * rows + 2 * w + vf + rows
                         + 2 * w + 4 * f + 4 * h)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / H100_FLOPS["bfloat16"]
        t_bytes = nbytes / H100_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def mlp_workspace_gb(r, h, f, esize):
    """The backward's workspace (csrc/fused_mlp.cu), the larger one: the
    f32 pre-activation chunk, da and act chunks in the dtype, the f32
    [R, H] dX accumulator when there is more than one chunk, and the f32
    column-sum partials of the bias gradients."""
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    fc = min(f, mf._CHUNK_F)
    parts = -(-r // mf._ROW_BLOCK)
    return (r * fc * (4 + 2 * esize) + (r * h * 4 if f > fc else 0)
            + parts * (f + h) * 4) / 1e9


def phase_mlp_vs_plain(torch):
    """The forward and backward custom ops (``fused_mlp_fwd``,
    ``fused_mlp_bwd``: the kernels' wrappers, which the training step
    reaches through ``fused_mlp_2d``) against their plain versions on
    the card (y, dx, dw1, db1, dw2, db2) in every MLP_CASES case; the
    backward repeated gives the same bits, and autograd through
    ``fused_mlp_2d`` gives the backward op's results; the check shown to
    reject a forward missing one ffn chunk; then the times at the
    slice's shape."""
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    worst = {}
    for r, h, f, name, approx in MLP_CASES:
        dtype = getattr(torch, name)
        x, w1, b1, w2, b2, g = mlp_inputs(torch, r, h, f, dtype, seed=r + f)
        y = mf.fused_mlp_fwd(x, w1, b1, w2, b2, approx)
        grads = mf.fused_mlp_bwd(x, w1, b1, w2, b2, g, approx)
        dx, dw1, db1, dw2, db2 = grads
        again = mf.fused_mlp_bwd(x, w1, b1, w2, b2, g, approx)
        prim = [t.detach().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        y_ag = mf.fused_mlp_2d(*prim, approximate=approx)
        auto = torch.autograd.grad(y_ag, prim, g)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(again, grads)),
              f"fused MLP backward differs between two calls ({name} r={r} "
              f"h={h} f={f})")
        check(torch.equal(y_ag, y) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(auto, grads)),
              f"autograd through fused_mlp_2d differs from the fused MLP "
              f"ops ({name} r={r} h={h} f={f})")
        ry = mf.fused_mlp_fwd_ref(x, w1, b1, w2, b2, approx)
        rdx = mf.fused_mlp_dx_ref(x, w1, b1, w2, g, approx)
        rdw = mf.fused_mlp_dw_ref(x, w1, b1, w2, g, approx)
        for key, got, ref in (("y", y, ry), ("dx", dx, rdx),
                              ("dw1", dw1, rdw[0]), ("db1", db1, rdw[1]),
                              ("dw2", dw2, rdw[2]), ("db2", db2, rdw[3])):
            check(bool(torch.isfinite(got).all()),
                  f"fused MLP {key} not finite ({name} r={r} h={h} f={f})")
            err = float((got.float() - ref.float()).abs().max())
            rel = flash_reading(got, ref)
            check(rel <= MLP_TOL[name],
                  f"fused MLP {key} disagrees with plain: {name} r={r} h={h} "
                  f"f={f} approximate={approx} max_abs_err={err} relative "
                  f"{rel} > {MLP_TOL[name]}")
            kern = {"y": "fused_mlp_fwd", "dx": "fused_mlp_dx"}.get(
                key, "fused_mlp_dw")
            w = worst.setdefault(name, {}).setdefault(kern, [0.0, 0.0])
            w[0], w[1] = max(w[0], err), max(w[1], rel)
        del x, w1, b1, w2, b2, g, y, grads, dx, dw1, db1, dw2, db2, again
        del prim, y_ag, auto, ry, rdx, rdw
        torch.cuda.empty_cache()
    return dict(tolerance_relative_to_row_rms_plus_abs=MLP_TOL,
                worst={n: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for n, w in worst.items()},
                cases=[list(c) for c in MLP_CASES],
                wrong_kernel_reading=mlp_check_rejects(torch, mf),
                **mlp_times(torch, mf))


def mlp_check_rejects(torch, mf):
    """The bf16 check must reject a forward that skips one ffn chunk: the
    plain forward at the slice's shape with the second ffn chunk of the
    activation left out. Returns its reading."""
    x, w1, b1, w2, b2, _ = mlp_inputs(torch, MLP_R, MLP_H, MLP_F,
                                      torch.bfloat16, seed=MLP_R + MLP_F)
    ref = mf.fused_mlp_fwd_ref(x, w1, b1, w2, b2, True)
    keep = torch.ones(MLP_F, dtype=torch.bool, device="cuda")
    keep[mf._CHUNK_F:2 * mf._CHUNK_F] = False
    act = mf._gelu_f32(mf._pre(x, w1, b1), True).to(x.dtype).float()
    wrong = (act[:, keep] @ w2.float()[keep] + b2.float()).to(x.dtype)
    reading = flash_reading(wrong, ref)
    check(reading > MLP_TOL["bfloat16"],
          f"the bf16 MLP check passes a forward with one ffn chunk dropped: "
          f"{reading} <= {MLP_TOL['bfloat16']}")
    del x, w1, b1, w2, b2, ref, act, wrong
    torch.cuda.empty_cache()
    return reading


def mlp_times(torch, mf):
    """CUDA-event times at R=8192, H=2048, F=8192, bf16, tanh: the forward
    and the backward op, each in turns with its plain version. The
    backward computes dX and dW in one call, so the dX and dW kernels
    share its time, its plain version's (dX's and dW's together) and its
    bound. The library yardsticks (never called by the port): the dense
    composite addmm -> gelu -> addmm through cuBLAS for the forward; no
    library call computes dX alone or dW alone, so their library_ms is
    null and the composite's whole backward (autograd on a retained
    graph) is timed beside the backward op."""
    x, w1, b1, w2, b2, g = mlp_inputs(torch, MLP_R, MLP_H, MLP_F,
                                      torch.bfloat16, seed=11)

    def plain_bwd(_):
        return (mf.fused_mlp_dx_ref(x, w1, b1, w2, g, True),
                *mf.fused_mlp_dw_ref(x, w1, b1, w2, g, True))

    runs = {
        "forward": (lambda _: mf.fused_mlp_fwd(x, w1, b1, w2, b2, True),
                    lambda _: mf.fused_mlp_fwd_ref(x, w1, b1, w2, b2, True)),
        "backward": (lambda _: mf.fused_mlp_bwd(x, w1, b1, w2, b2, g, True),
                     plain_bwd),
    }
    bounds = mlp_bounds(MLP_R, MLP_H, MLP_F, 2)
    res = {}
    for name, (kern, plain) in runs.items():
        plain_ms, ms, t = in_turns(plain, kern, iters=10)
        res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, all_ms=t,
                         bound_ms=bounds[name][0], bound_by=bounds[name][1])
    gelu = torch.nn.functional.gelu

    def composite(x, w1, b1, w2, b2):
        return torch.addmm(b2, gelu(torch.addmm(b1, x, w1),
                                    approximate="tanh"), w2)

    res["forward"]["library_ms"], _, _ = in_turns(
        lambda _: composite(x, w1, b1, w2, b2), runs["forward"][0], iters=10)
    prim = [t.detach().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    yc = composite(*prim)
    bwd = res["backward"]
    bwd["library_bwd_ms"], bwd["ms_beside_library"], _ = in_turns(
        lambda _: torch.autograd.grad(yc, prim, g, retain_graph=True),
        runs["backward"][0], iters=10)
    res["timed_at"] = dict(r=MLP_R, h=MLP_H, f=MLP_F, dtype="bfloat16",
                           approximate=True, chunk_f=mf._CHUNK_F)
    del x, w1, b1, w2, b2, g, prim, yc
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 10-14: the training path
# ---------------------------------------------------------------------------

TRAIN_STEPS = 4


def model_flops_per_step(cfg, tokens, seq):
    """6 flops per token per matmul weight (forward + backward; the tied
    head counts once) plus causal attention's two products over S(S+1)/2
    pairs per head per layer, times 3 for forward + backward. Remat
    recompute is not counted (model flops, not hardware flops)."""
    H, L = cfg.hidden_size, cfg.num_layers
    weights = L * (3 * H * H + H * H + 2 * H * cfg.ffn) + cfg.vocab_size * H
    pairs = seq * (seq + 1) // 2
    attn = 3 * 2 * 2 * pairs * H * L * (tokens // seq)
    return 6.0 * weights * tokens + attn


def reset_launches():
    """Every kernel count of the training path to 0."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    for counts in (fa.launches, mf.launches):
        for key in counts:
            counts[key] = 0


def read_launches():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    return {**fa.launches, **mf.launches}


def phase_train(torch, cfg, fused, steps=TRAIN_STEPS):
    """Train cfg at B=4, S=2048 on one fixed batch: one warm-up step, then
    `steps` steps, with FLAGS_fused_mlp as `fused` says. Each flash
    kernel runs 24 times per step; with the flag on each fused MLP kernel
    24 times too (save_small keeps the MLP forward's output), with it off
    none."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn.functional import last_mlp_path
    set_flags({"FLAGS_fused_mlp": fused})
    params = gpt.init_hybrid_params(cfg, seed=0)
    opt = gpt.init_opt_state(params, dtype=cfg.opt_dtype)
    step = gpt.make_train_step(cfg)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (TRAIN_B, TRAIN_S + 1))).cuda()
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    _, _, loss0 = step(params, opt, x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with ClockSampler() as clocks:
        t0 = time.perf_counter()
        losses = [step(params, opt, x, y)[2] for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_launches()
    path = last_mlp_path()
    losses = [float(l) for l in losses]
    check(all(np.isfinite(losses)), f"training loss not finite: {losses}")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")
    check(path == ("fused_mlp/cuda" if fused else "dense"),
          f"training took the MLP path {path} with FLAGS_fused_mlp={fused}")
    L = cfg.num_layers
    for key, n in counts.items():
        want = (L * steps if key.startswith("flash")
                or (fused and key.startswith("fused_mlp")) else 0)
        check(n == want, f"{key} launched {n} times in {steps} steps of {L} "
              f"layers (want {want}; FLAGS_fused_mlp={fused})")
    tokens = TRAIN_B * TRAIN_S
    flops = model_flops_per_step(cfg, tokens, TRAIN_S)
    ms = wall / steps * 1e3
    out = dict(config="gpt3-1.3b", b=TRAIN_B, s=TRAIN_S,
               fused_mlp=fused, last_mlp_path=path,
               remat_policy=cfg.remat_policy, opt_dtype=str(cfg.opt_dtype),
               lm_head=cfg.lm_head, warmup_loss=float(loss0), losses=losses,
               ms_per_step=ms, tokens_per_s=tokens / (ms / 1e3),
               model_tflop_per_step=flops / 1e12,
               model_tflops=flops / (ms / 1e3) / 1e12,
               model_flops_share_of_989=flops / (ms / 1e3) / 989e12,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               card_during_steps=clocks.summary(), launches=counts,
               launches_per_step={k: n / steps for k, n in counts.items()})
    return out, params, opt, (x, y)


def phase_profile_train(torch, cfg, params, opt, batch, steps=2):
    """torch.profiler over `steps` training steps: device busy time per
    step against the profiled wall time, the flash and fused MLP kernels'
    shares, and the kernels that take the time."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import gpt
    step = gpt.make_train_step(cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(params, opt, *batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms == 0.0:
        return dict(steps=steps, device_time="not measured (no CUDA events)")
    flash = {k: sum(e.self_device_time_total for e in dev if k in e.key)
             / 1e3 / steps
             for k in ("flash_fwd_kernel", "flash_dq_kernel",
                       "flash_dkv_kernel")}
    # the fused MLP kernels by instantiation: <dtype, A col-major, B
    # col-major, epilogue> (0 gelu, 1 accumulate, 2 pre-activation, 3
    # gelu', 4 store), the column sums of g and the bias gradients' sum
    # over the row blocks
    mlp = {e.key[:100]: e.self_device_time_total / 1e3 / steps
           for e in dev if any(k in e.key for k in (
               "mlp_gemm_kernel", "colsum_kernel", "sum_parts_kernel"))}
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    return dict(steps=steps, wall_ms_per_step=wall_ms / steps,
                device_busy_ms_per_step=busy_ms / steps,
                device_idle_share=1.0 - busy_ms / wall_ms,
                flash_ms_per_step=flash,
                flash_share_of_busy=sum(flash.values()) * steps / busy_ms,
                fused_mlp_ms_per_step=sum(mlp.values()),
                fused_mlp_share_of_busy=sum(mlp.values()) * steps / busy_ms,
                fused_mlp_kernels_ms_per_step=mlp,
                top_device_ms_per_step=[
                    (e.key[:70], e.self_device_time_total / 1e3 / steps,
                     e.count // steps) for e in top[:12]])


def phase_remat_full(torch, cfg, params, opt, batch):
    """One step under remat 'full': the backward re-runs each layer's
    flash forward and fused MLP forward (2 per layer); dQ, dK/dV, the MLP
    dX and dW once per layer."""
    from paddle_tpu_torch.models import gpt
    cfg = cfg._replace(remat_policy="full")
    step = gpt.make_train_step(cfg)
    reset_launches()
    _, _, loss = step(params, opt, *batch)
    torch.cuda.synchronize()
    counts = read_launches()
    L = cfg.num_layers
    want = dict.fromkeys(counts, 0) | {
        "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
        "fused_mlp_fwd": 2 * L, "fused_mlp_dx": L, "fused_mlp_dw": L}
    check(counts == want, f"remat 'full' step launched {counts} (want "
          f"{want})")
    check(bool(np.isfinite(float(loss))), "remat 'full' loss not finite")
    return dict(remat_policy="full", loss=float(loss), launches=counts)


def phase_train_parity_fp32(torch):
    """fp32 at gpt3-1.3b width, 2 layers, B=1, S=2048: loss and every
    gradient of the step (a) with the flash and fused MLP kernels against
    (b) the same step with FLAGS_fused_mlp off (the dense MLP), and (b)
    against (c) the step through _block_apply's dense attention branch
    (reached by replacing _attn_mode in this script only) as well."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models import gpt
    cfg = gpt.CONFIGS["gpt3-1.3b"]._replace(
        dtype=torch.float32, num_layers=2, remat_policy="save_small",
        lm_head="plain")
    params = gpt.init_hybrid_params(cfg, seed=1)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (1, TRAIN_S + 1))).cuda()
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    leaves = gpt._leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def grads(fused):
        set_flags({"FLAGS_fused_mlp": fused})
        reset_launches()
        loss = gpt.loss_fn(params, x, y, cfg)
        g = torch.autograd.grad(loss, leaves)
        return loss.item(), g, read_launches()

    lf, gf, counts = grads(True)
    check(counts["fused_mlp_fwd"] == 2 and counts["fused_mlp_dw"] == 2,
          f"fp32 parity run with FLAGS_fused_mlp on launched {counts}")
    lk, gk, _ = grads(False)
    attn_mode = gpt._attn_mode
    gpt._attn_mode = lambda seq_len, head_dim: None
    try:
        ld, gd, _ = grads(False)
    finally:
        gpt._attn_mode = attn_mode
        set_flags({"FLAGS_fused_mlp": True})
    torch.cuda.synchronize()
    tol = 1e-4      # per leaf, relative to the leaf's largest gradient

    def worst(ga, gb):
        w = 0.0
        for a, b in zip(ga, gb):
            check(bool(torch.isfinite(a).all()), "parity gradient not finite")
            w = max(w, float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30))
        return w

    worst_mlp, worst_flash = worst(gf, gk), worst(gk, gd)
    check(abs(lf - lk) <= 1e-5 * abs(lk), f"fp32 loss: fused MLP {lf} vs "
          f"dense MLP {lk}")
    check(abs(lk - ld) <= 1e-5 * abs(ld), f"fp32 loss: flash {lk} vs dense "
          f"{ld}")
    check(worst_mlp <= tol, f"fp32 gradients: fused vs dense MLP relative "
          f"{worst_mlp} > {tol}")
    check(worst_flash <= tol, f"fp32 gradients: flash vs dense attention "
          f"relative {worst_flash} > {tol}")
    del params, gf, gk, gd
    return dict(loss_fused_mlp=lf, loss_flash=lk, loss_dense=ld,
                worst_grad_relative_fused_vs_dense_mlp=worst_mlp,
                worst_grad_relative_flash_vs_dense_attention=worst_flash,
                tolerance=tol, leaves=len(leaves))


# ---------------------------------------------------------------------------
# phase 15: the fused SwiGLU kernels against their plain versions
# ---------------------------------------------------------------------------

SWIGLU_REPLACES = {
    "fused_swiglu_fwd": "paddle_tpu/kernels/mlp_fusion.py:522",
    "fused_swiglu_dx": "paddle_tpu/kernels/mlp_fusion.py:543",
    "fused_swiglu_dw": "paddle_tpu/kernels/mlp_fusion.py:572"}
# Held as the GeLU MLP kernels are (flash_reading, MLP_TOL). bf16: act,
# dag and dau are rounded at the same points in both for y and dx; for dW
# the bf16 kernel feeds round(dag), round(dau) and round(act) to the
# tensor cores where the plain version (the reference) keeps them f32.
LLAMA_S = 2048                                  # the slice's B=1 sequence
SW_R, SW_H, SW_F = LLAMA_S, 4096, 11008         # the slice's MLP shape
# (r, h, f, dtype): llama-7b (5 chunks of 2048 and a ragged one of 768),
# in bf16 and f32; rows not a multiple of any tile, f <= 512 not a
# multiple of 128, h not a multiple of 64; a ragged last chunk (2560 =
# 2048 + 512); strides not a multiple of 16 bytes (h = 100: the scalar
# load path)
SWIGLU_CASES = [(SW_R, SW_H, SW_F, "bfloat16"), (SW_R, SW_H, SW_F, "float32"),
                (1000, 96, 320, "bfloat16"), (1000, 96, 320, "float32"),
                (1000, 2048, 2560, "bfloat16"), (333, 100, 200, "bfloat16"),
                (333, 100, 200, "float32")]


def swiglu_inputs(torch, r, h, f, dtype, seed):
    """x, wg, wu, wd, g at the model's scale (an RMSNorm'd x, Xavier-normal
    weights, a small upstream gradient)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * s).to(dtype)

    std = (2.0 / (h + f)) ** 0.5
    return (rnd(r, h), rnd(h, f, s=std), rnd(h, f, s=std), rnd(f, h, s=std),
            rnd(r, h, s=1e-3))


def swiglu_bounds(r, h, f, esize):
    """bound_ms and what bounds it: forward 6 RHF (ag, au, the down
    product), backward 16 RHF (ag and au recomputed once, dact, dX's two
    products, dW's three) at 989 TFLOP/s; inputs read once and outputs
    written once at 3.35 TB/s."""
    rhf = float(r) * h * f
    rows, w = r * h * esize, h * f * esize
    work = {"forward": (6 * rhf, rows + 3 * w + rows),
            "backward": (16 * rhf, 2 * rows + 3 * w + rows + 3 * w)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / H100_FLOPS["bfloat16"]
        t_bytes = nbytes / H100_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def swiglu_workspace_gb(r, h, f, esize):
    """The backward's workspace (csrc/fused_mlp.cu), the larger one: ag
    and au chunks in f32, dag, dau and act chunks in the dtype, the f32
    [R, H] dX accumulator."""
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    fc = min(f, mf._CHUNK_F)
    return (r * fc * (8 + 3 * esize) + r * h * 4) / 1e9


def phase_swiglu_vs_plain(torch):
    """The forward and backward custom ops (``fused_swiglu_fwd``,
    ``fused_swiglu_bwd``: the kernels' wrappers, which the LLaMA MLP
    reaches through ``fused_swiglu_2d``) against their plain versions on
    the card (y, dx, dwg, dwu, dwd) in every SWIGLU_CASES case; the
    backward repeated gives the same bits, and autograd through
    ``fused_swiglu_2d`` gives the ops' results; the check shown to reject a
    forward missing one ffn chunk; then the times at the slice's shape."""
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    worst = {}
    for r, h, f, name in SWIGLU_CASES:
        dtype = getattr(torch, name)
        x, wg, wu, wd, g = swiglu_inputs(torch, r, h, f, dtype, seed=r + f)
        y = mf.fused_swiglu_fwd(x, wg, wu, wd)
        grads = mf.fused_swiglu_bwd(x, wg, wu, wd, g)
        again = mf.fused_swiglu_bwd(x, wg, wu, wd, g)
        prim = [t.detach().requires_grad_(True) for t in (x, wg, wu, wd)]
        y_ag = mf.fused_swiglu_2d(*prim)
        auto = torch.autograd.grad(y_ag, prim, g)
        torch.cuda.synchronize()
        where = f"{name} r={r} h={h} f={f}"
        check(all(torch.equal(a, b) for a, b in zip(again, grads)),
              f"fused SwiGLU backward differs between two calls ({where})")
        check(torch.equal(y_ag, y) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(auto, grads)),
              f"autograd through fused_swiglu_2d differs from the SwiGLU "
              f"ops ({where})")
        ry = mf.fused_swiglu_fwd_ref(x, wg, wu, wd)
        rdx = mf.fused_swiglu_dx_ref(x, wg, wu, wd, g)
        rdw = mf.fused_swiglu_dw_ref(x, wg, wu, wd, g)
        for key, got, ref in (("y", y, ry), ("dx", grads[0], rdx),
                              ("dwg", grads[1], rdw[0]),
                              ("dwu", grads[2], rdw[1]),
                              ("dwd", grads[3], rdw[2])):
            check(bool(torch.isfinite(got).all()),
                  f"fused SwiGLU {key} not finite ({where})")
            err = float((got.float() - ref.float()).abs().max())
            rel = flash_reading(got, ref)
            check(rel <= MLP_TOL[name],
                  f"fused SwiGLU {key} disagrees with plain: {where} "
                  f"max_abs_err={err} relative {rel} > {MLP_TOL[name]}")
            kern = {"y": "fused_swiglu_fwd", "dx": "fused_swiglu_dx"}.get(
                key, "fused_swiglu_dw")
            w = worst.setdefault(name, {}).setdefault(kern, [0.0, 0.0])
            w[0], w[1] = max(w[0], err), max(w[1], rel)
        del x, wg, wu, wd, g, y, grads, again, prim, y_ag, auto, ry, rdx, rdw
        torch.cuda.empty_cache()
    return dict(tolerance_relative_to_row_rms_plus_abs=MLP_TOL,
                worst={n: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for n, w in worst.items()},
                cases=[list(c) for c in SWIGLU_CASES],
                wrong_kernel_reading=swiglu_check_rejects(torch, mf),
                **swiglu_times(torch, mf))


def swiglu_check_rejects(torch, mf):
    """The bf16 check must reject a forward that skips one ffn chunk: the
    plain forward at the slice's shape with the second ffn chunk of the
    activation left out. Returns its reading."""
    x, wg, wu, wd, _ = swiglu_inputs(torch, SW_R, SW_H, SW_F, torch.bfloat16,
                                     seed=SW_R + SW_F)
    ref = mf.fused_swiglu_fwd_ref(x, wg, wu, wd)
    keep = torch.ones(SW_F, dtype=torch.bool, device="cuda")
    keep[mf._CHUNK_F:2 * mf._CHUNK_F] = False
    ag, au = mf._gate_up(x, wg, wu)
    act = (mf._silu_f32(ag) * au).to(x.dtype).float()
    wrong = (act[:, keep] @ wd.float()[keep]).to(x.dtype)
    reading = flash_reading(wrong, ref)
    check(reading > MLP_TOL["bfloat16"],
          f"the bf16 SwiGLU check passes a forward with one ffn chunk "
          f"dropped: {reading} <= {MLP_TOL['bfloat16']}")
    del x, wg, wu, wd, ref, ag, au, act, wrong
    torch.cuda.empty_cache()
    return reading


def swiglu_times(torch, mf):
    """CUDA-event times at R=2048, H=4096, F=11008, bf16: the forward and
    the backward op, each in turns with its plain version. The backward
    computes dX and dW in one call, so the dX and dW kernels share its
    time, its plain version's and its bound. The library yardsticks
    (never called by the port): the dense composite (silu(x Wg) * (x Wu))
    Wd through cuBLAS for the forward; no library call computes dX alone
    or dW alone, so their library_ms is null and the composite's whole
    backward (autograd on a retained graph) is timed beside the backward
    op."""
    x, wg, wu, wd, g = swiglu_inputs(torch, SW_R, SW_H, SW_F, torch.bfloat16,
                                     seed=13)

    def plain_bwd(_):
        return (mf.fused_swiglu_dx_ref(x, wg, wu, wd, g),
                *mf.fused_swiglu_dw_ref(x, wg, wu, wd, g))

    runs = {
        "forward": (lambda _: mf.fused_swiglu_fwd(x, wg, wu, wd),
                    lambda _: mf.fused_swiglu_fwd_ref(x, wg, wu, wd)),
        "backward": (lambda _: mf.fused_swiglu_bwd(x, wg, wu, wd, g),
                     plain_bwd),
    }
    bounds = swiglu_bounds(SW_R, SW_H, SW_F, 2)
    res = {}
    for name, (kern, plain) in runs.items():
        plain_ms, ms, t = in_turns(plain, kern, iters=10)
        res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, all_ms=t,
                         bound_ms=bounds[name][0], bound_by=bounds[name][1])
    silu = torch.nn.functional.silu

    def composite(x, wg, wu, wd):
        return (silu(x @ wg) * (x @ wu)) @ wd

    res["forward"]["library_ms"], _, _ = in_turns(
        lambda _: composite(x, wg, wu, wd), runs["forward"][0], iters=10)
    prim = [t.detach().requires_grad_(True) for t in (x, wg, wu, wd)]
    yc = composite(*prim)
    bwd = res["backward"]
    bwd["library_bwd_ms"], bwd["ms_beside_library"], _ = in_turns(
        lambda _: torch.autograd.grad(yc, prim, g, retain_graph=True),
        runs["backward"][0], iters=10)
    res["timed_at"] = dict(r=SW_R, h=SW_H, f=SW_F, dtype="bfloat16",
                           chunk_f=mf._CHUNK_F)
    del x, wg, wu, wd, g, prim, yc
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 16-19: LLaMA training through the Layer model and AdamW
# ---------------------------------------------------------------------------

LLAMA_LR = 1e-4


def llama_flops_per_step(cfg, tokens, seq):
    """6 flops per token per matmul weight (forward + backward; the untied
    head counts) plus causal attention's two products over S(S+1)/2 pairs
    per head per layer, times 3 for forward + backward."""
    H, L = cfg.hidden_size, cfg.num_hidden_layers
    kv = cfg.kv_heads * (H // cfg.num_attention_heads)
    weights = (L * (2 * H * H + 2 * H * kv + 3 * H * cfg.intermediate_size)
               + cfg.vocab_size * H)
    pairs = seq * (seq + 1) // 2
    attn = 3 * 2 * 2 * pairs * H * L * (tokens // seq)
    return 6.0 * weights * tokens + attn


def llama_trainer(torch, cfg, seed=0):
    """The user's loop: LlamaForCausalLM (bf16 on the card), AdamW over its
    parameters, one fixed [1, S] batch with labels = ids as the reference's
    test passes them. Returns (model, opt, step); step() -> (loss, the
    CUDA events recorded around the AdamW update)."""
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.optimizer import AdamW
    model = llama.LlamaForCausalLM(cfg, seed=seed)
    opt = AdamW(learning_rate=LLAMA_LR, parameters=model.parameters())
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (1, LLAMA_S))).cuda()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def step():
        loss = model.loss(ids, ids)
        loss.backward()
        ev[0].record()
        with torch.profiler.record_function("adamw_step"):
            opt.step()
        ev[1].record()
        opt.clear_grad()
        return loss.detach(), ev

    return model, opt, step


def phase_train_llama(torch, cfg, fused, steps=TRAIN_STEPS):
    """Train cfg at B=1, S=2048 on one fixed batch: one warm-up step, then
    `steps` steps, with FLAGS_fused_mlp as `fused` says. Each flash kernel
    runs once per layer per step; with the flag on each SwiGLU kernel
    too, with it off none; the GeLU MLP kernels never."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.nn.functional import last_mlp_path
    set_flags({"FLAGS_fused_mlp": fused})
    model, opt, step = llama_trainer(torch, cfg)
    loss0, _ = step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, adamw_ms = [], []
    with ClockSampler() as clocks:
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, ev = step()
            losses.append(loss)
            ev[1].synchronize()
            adamw_ms.append(ev[0].elapsed_time(ev[1]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_launches()
    path = last_mlp_path()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"llama loss not finite: {losses}")
    check(losses[-1] < losses[0], f"llama loss did not fall: {losses}")
    check(path == ("fused_swiglu/cuda" if fused else "dense"),
          f"llama took the MLP path {path} with FLAGS_fused_mlp={fused}")
    L = cfg.num_hidden_layers
    for key, n in counts.items():
        want = (L * steps if key.startswith("flash")
                or (fused and key.startswith("fused_swiglu")) else 0)
        check(n == want, f"{key} launched {n} times in {steps} llama steps "
              f"of {L} layers (want {want}; FLAGS_fused_mlp={fused})")
    tokens = LLAMA_S
    flops = llama_flops_per_step(cfg, tokens, LLAMA_S)
    ms = wall / steps * 1e3
    out = dict(config="llama-7b", layers=L, b=1, s=LLAMA_S, dtype="bfloat16",
               fused_mlp=fused, last_mlp_path=path, lr=LLAMA_LR,
               warmup_loss=float(loss0), losses=losses, ms_per_step=ms,
               tokens_per_s=tokens / (ms / 1e3),
               model_tflop_per_step=flops / 1e12,
               model_tflops=flops / (ms / 1e3) / 1e12,
               model_flops_share_of_989=flops / (ms / 1e3) / 989e12,
               adamw_ms_per_step=sum(adamw_ms) / steps,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               parameters=sum(p.numel() for p in model.parameters()),
               card_during_steps=clocks.summary(), launches=counts,
               launches_per_step={k: n / steps for k, n in counts.items()})
    return out, model, opt, step


def phase_profile_llama(torch, step, steps=2):
    """torch.profiler over `steps` llama training steps: device busy time
    per step against the profiled wall time, the flash and SwiGLU
    kernels' shares, the optimizer step's span on the device, and the
    kernels that take the time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the "adamw_step" range of llama_trainer shows on the device timeline
    # as an annotation spanning the optimizer's kernels: its span is the
    # AdamW update's device time, and it is kept out of the busy sum
    spans = {}
    dev = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.key == "adamw_step":
                spans[e.key] = e.self_device_time_total / 1e3 / steps
            else:
                dev.append(e)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms == 0.0:
        return dict(steps=steps, device_time="not measured (no CUDA events)")
    flash = {k: sum(e.self_device_time_total for e in dev if k in e.key)
             / 1e3 / steps
             for k in ("flash_fwd_kernel", "flash_dq_kernel",
                       "flash_dkv_kernel")}
    # the SwiGLU kernels by instantiation: <dtype, A col-major, B
    # col-major, epilogue> (1 accumulate, 2 gate/up product, 4 store, 5
    # silu-gated activation, 6 dact with the SwiGLU derivatives)
    mlp = {e.key[:100]: e.self_device_time_total / 1e3 / steps
           for e in dev if "mlp_gemm_kernel" in e.key}
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    return dict(steps=steps, wall_ms_per_step=wall_ms / steps,
                device_busy_ms_per_step=busy_ms / steps,
                device_idle_share=1.0 - busy_ms / wall_ms,
                flash_ms_per_step=flash,
                flash_share_of_busy=sum(flash.values()) * steps / busy_ms,
                swiglu_ms_per_step=sum(mlp.values()),
                swiglu_share_of_busy=sum(mlp.values()) * steps / busy_ms,
                swiglu_kernels_ms_per_step=mlp,
                adamw_span_ms_per_step=spans.get(
                    "adamw_step", "not measured (no adamw_step range)"),
                top_device_ms_per_step=[
                    (e.key[:70], e.self_device_time_total / 1e3 / steps,
                     e.count // steps) for e in top[:14]])


def dense_causal_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                           is_causal=False, training=True):
    """Plain causal softmax attention on [B, S, NH, D], written here for
    the parity phase only (the port's LLaMA takes the flash kernels)."""
    import torch
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    n = s.shape[-1]
    keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
    return (p @ v).transpose(1, 2)


def phase_llama_parity_fp32(torch):
    """fp32 at llama-7b width, 2 layers, B=1, S=2048: loss and every
    gradient of the Layer model's loss (a) with the SwiGLU and flash
    kernels against (b) FLAGS_fused_mlp off (the dense SwiGLU), and (b)
    against (c) the model with its attention call replaced, in this
    script only, by dense_causal_attention."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models import llama
    cfg = llama.CONFIGS["llama-7b"]._replace(num_hidden_layers=2)
    model = llama.LlamaForCausalLM(cfg, dtype=torch.float32, seed=1)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, LLAMA_S))).cuda()
    params = list(model.parameters())

    def grads(fused):
        set_flags({"FLAGS_fused_mlp": fused})
        reset_launches()
        loss = model.loss(ids, ids)
        g = torch.autograd.grad(loss, params)
        return loss.item(), g, read_launches()

    lf, gf, counts = grads(True)
    check(counts["fused_swiglu_fwd"] == 2 and counts["fused_swiglu_dw"] == 2
          and counts["flash_fwd"] == 2,
          f"llama fp32 parity run with FLAGS_fused_mlp on launched {counts}")
    lk, gk, _ = grads(False)
    sdpa = llama.scaled_dot_product_attention
    llama.scaled_dot_product_attention = dense_causal_attention
    try:
        ld, gd, counts_d = grads(False)
    finally:
        llama.scaled_dot_product_attention = sdpa
        set_flags({"FLAGS_fused_mlp": True})
    check(counts_d["flash_fwd"] == 0, f"dense attention run launched "
          f"{counts_d}")
    torch.cuda.synchronize()
    tol = 1e-4      # per leaf, relative to the leaf's largest gradient

    def worst(ga, gb):
        w = 0.0
        for a, b in zip(ga, gb):
            check(bool(torch.isfinite(a).all()), "parity gradient not finite")
            w = max(w, float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30))
        return w

    worst_mlp, worst_flash = worst(gf, gk), worst(gk, gd)
    check(abs(lf - lk) <= 1e-5 * abs(lk), f"llama fp32 loss: SwiGLU kernels "
          f"{lf} vs dense {lk}")
    check(abs(lk - ld) <= 1e-5 * abs(ld), f"llama fp32 loss: flash {lk} vs "
          f"dense attention {ld}")
    check(worst_mlp <= tol, f"llama fp32 gradients: SwiGLU kernels vs dense "
          f"relative {worst_mlp} > {tol}")
    check(worst_flash <= tol, f"llama fp32 gradients: flash vs dense "
          f"attention relative {worst_flash} > {tol}")
    leaves = len(gk)
    del model, params, gf, gk, gd
    return dict(loss_fused_mlp=lf, loss_flash=lk, loss_dense=ld,
                worst_grad_relative_fused_vs_dense_mlp=worst_mlp,
                worst_grad_relative_flash_vs_dense_attention=worst_flash,
                tolerance=tol, leaves=leaves)


def free_card(torch):
    """Drop what the phases before left for the collector, return the
    cached blocks and restart the peak count."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import gpt, llama

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
    torch.cuda.empty_cache()

    flash = phase_flash_vs_plain(torch)
    phase(8, "flash attention kernels vs plain", **flash)
    mlp = phase_mlp_vs_plain(torch)
    phase(9, "fused MLP kernels vs plain", **mlp)
    cfg = gpt.CONFIGS["gpt3-1.3b"]._replace(
        remat_policy="save_small", opt_dtype=torch.bfloat16, lm_head="auto")
    train, params, opt, batch = phase_train(torch, cfg, fused=True)
    phase(10, "train gpt3-1.3b bf16 B=4 S=2048 save_small fused MLP",
          **train)
    phase(11, "profile of the training step",
          **phase_profile_train(torch, cfg, params, opt, batch))
    phase(12, "remat full launches",
          **phase_remat_full(torch, cfg, params, opt, batch))
    del params, opt, batch
    torch.cuda.empty_cache()
    dense, params, opt, batch = phase_train(torch, cfg, fused=False, steps=2)
    del params, opt, batch
    torch.cuda.empty_cache()
    # the fused route may hold its kernels' workspace beyond what the
    # dense route needs, no more
    work_gb = mlp_workspace_gb(TRAIN_B * TRAIN_S, cfg.hidden_size, cfg.ffn, 2)
    extra_gb = train["peak_memory_gb"] - dense["peak_memory_gb"]
    check(extra_gb <= work_gb, f"fused MLP step peaks {extra_gb} GB above "
          f"the dense one (workspace {work_gb} GB)")
    phase(13, "train gpt3-1.3b bf16 B=4 S=2048 save_small dense MLP",
          fused_peak_minus_dense_gb=extra_gb, mlp_workspace_gb=work_gb,
          **dense)
    set_flags({"FLAGS_fused_mlp": True})
    phase(14, "training parity fp32 fused vs dense MLP, flash vs dense "
          "attention", **phase_train_parity_fp32(torch))

    free_card(torch)
    swiglu = phase_swiglu_vs_plain(torch)
    phase(15, "fused SwiGLU kernels vs plain", **swiglu)
    free_card(torch)
    lcfg = llama.CONFIGS["llama-7b"]
    ltrain, lmodel, lopt, lstep = phase_train_llama(torch, lcfg, fused=True)
    phase(16, "train llama-7b bf16 B=1 S=2048 fused SwiGLU, Layer model + "
          "AdamW", **ltrain)
    phase(17, "profile of the llama-7b training step",
          **phase_profile_llama(torch, lstep))
    del lmodel, lopt, lstep
    free_card(torch)
    ldense, lmodel, lopt, lstep = phase_train_llama(torch, lcfg, fused=False,
                                                    steps=2)
    del lmodel, lopt, lstep
    free_card(torch)
    # as for GPT: the fused route may hold its kernels' workspace beyond
    # what the dense route needs, no more
    work_gb = swiglu_workspace_gb(LLAMA_S, lcfg.hidden_size,
                                  lcfg.intermediate_size, 2)
    extra_gb = ltrain["peak_memory_gb"] - ldense["peak_memory_gb"]
    check(extra_gb <= work_gb, f"fused SwiGLU step peaks {extra_gb} GB above "
          f"the dense one (workspace {work_gb} GB)")
    phase(18, "train llama-7b bf16 B=1 S=2048 dense SwiGLU",
          fused_peak_minus_dense_gb=extra_gb, swiglu_workspace_gb=work_gb,
          **ldense)
    set_flags({"FLAGS_fused_mlp": True})
    phase(19, "llama training parity fp32 SwiGLU kernels vs dense, flash vs "
          "dense attention", **phase_llama_parity_fp32(torch))

    kernels = [{
        "name": "decode_attn_proj", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": serve1["kernel_launches"],
        "max_abs_err": kern["max_abs_err"], "max_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"]}]
    # the dX and dW kernels run in one backward call and share its times
    # and bound
    for name, src, replaces, res, key in (
            *((n, FLASH_SOURCE, FLASH_REPLACES[n], flash, n)
              for n in ("flash_fwd", "flash_dq", "flash_dkv")),
            ("fused_mlp_fwd", MLP_SOURCE, MLP_REPLACES["fused_mlp_fwd"], mlp,
             "forward"),
            *((n, MLP_SOURCE, MLP_REPLACES[n], mlp, "backward")
              for n in ("fused_mlp_dx", "fused_mlp_dw"))):
        t = res[key]
        err = res["worst"]["bfloat16"][name]["max_abs_err"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": train["launches"][name],
            "max_abs_err": err, "max_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        if key == "backward":
            kernels[-1]["note"] = ("dX and dW run in one backward call: ms, "
                                   "plain_ms and bound_ms are that call's")
    # the SwiGLU kernels' launches are llama-7b training's (phase 16); the
    # dX and dW kernels run in one backward call (fused_swiglu_bwd)
    for name in SWIGLU_REPLACES:
        t = swiglu["forward" if name == "fused_swiglu_fwd" else "backward"]
        err = swiglu["worst"]["bfloat16"][name]["max_abs_err"]
        kernels.append({
            "name": name, "route": "cuda", "source": MLP_SOURCE,
            "replaces": SWIGLU_REPLACES[name],
            "launches": ltrain["launches"][name], "max_abs_err": err,
            "max_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
        if name != "fused_swiglu_fwd":
            kernels[-1]["note"] = ("dX and dW run in one backward call, "
                                   "fused_swiglu_bwd: ms, plain_ms and "
                                   "bound_ms are that call's")
    print(card, flush=True)     # again here: the top of the log may be cut
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
