#!/usr/bin/env python3
"""Where the time of chip_smoke.py's phase 55 step goes, measured on one
CUDA card.

    python3 scripts/user_nn_profile.py

Builds phase 55 (a)'s model (``chip_smoke.user_classifier``: a user's
nn.Embedding → nn.TransformerEncoder → nn.Linear at bert-base width and
depth, random weights from a seed) with LookAhead(AdamW), B=32, S=512,
the same key-padding mask, under amp.auto_cast O1. After two warm-up
steps it profiles two steps with torch.profiler (device busy ms a step
against the wall, the kernels by group and the 15 that take the most
time), then times steps at dropout 0.1 and at 0 (every Dropout layer's
and the attention's rate set to 0 in place) in turns, 0.1, 0, 0, 0.1,
three steps a turn. Prints one JSON line and writes it to
``chiprun_out/user_nn_profile.json``. Needs nvcc and a card; run from
the repository's root (~1 min after the build).
"""
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

GROUPS = {
    "flash (fwd, pre-pass, dq, dkv)": ("flash_",),
    "layer_norm (ln_fwd, ln_bwd_persist, sum_parts)": ("::ln_fwd_",
                                                       "::ln_bwd_",
                                                       "sum_parts_kernel"),
    "GEMMs (cuBLAS / CUTLASS)": ("gemm", "cutlass", "nvjet", "sm90_xmma"),
}


def build(paddle):
    from paddle_tpu_torch.incubate.optimizer import LookAhead
    paddle.seed(0)
    model = cs.user_classifier(paddle)
    inner = paddle.optimizer.AdamW(learning_rate=cs.BERT_LR,
                                   weight_decay=0.01,
                                   parameters=model.parameters())
    opt = LookAhead(inner, alpha=0.5, k=cs.NN_K)
    rng = np.random.default_rng(55)
    lengths = cs.bert_lengths(cs.BERT_B, cs.BERT_S, 55)
    ids = paddle.to_tensor(rng.integers(0, cs.NN_VOCAB,
                                        (cs.BERT_B, cs.BERT_S)))
    mask = paddle.to_tensor((np.arange(cs.BERT_S)[None, :]
                             < lengths[:, None])[:, None, None, :])
    labels = paddle.to_tensor(rng.integers(0, 2, (cs.BERT_B,)))
    loss_fn = paddle.nn.CrossEntropyLoss()

    def step():
        with paddle.amp.auto_cast(level="O1"):
            loss = loss_fn(model(ids, mask), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()

    return model, step


def set_dropout(paddle, model, p):
    for layer in model.sublayers():
        if isinstance(layer, paddle.nn.Dropout):
            layer.p = p
        if isinstance(layer, paddle.nn.MultiHeadAttention):
            layer.dropout = p


def wall_ms(torch, step, steps=3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def main():
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.kernels import _build
    if not torch.cuda.is_available():
        print("user_nn_profile: needs a CUDA card", file=sys.stderr)
        return 2
    _build.build_all()
    model, step = build(paddle)
    for _ in range(2):
        step()
    steps = 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    out = dict(card=cs.gpu_line(), b=cs.BERT_B, s=cs.BERT_S,
               wall_ms_per_step=wall)
    if busy == 0.0:
        out["device_time"] = "not measured (no CUDA events)"
    else:
        grouped = {g: sum(e.self_device_time_total for e in dev
                          if any(k in e.key for k in keys)) / 1e3 / steps
                   for g, keys in GROUPS.items()}
        grouped["the rest"] = busy - sum(grouped.values())
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:15]
        out.update(busy_ms_per_step=busy, idle_share=1.0 - busy / wall,
                   by_group_ms=grouped,
                   top_kernels=[dict(name=e.key[:120],
                                     ms_per_step=e.self_device_time_total
                                     / 1e3 / steps,
                                     calls_per_step=e.count / steps)
                                for e in top])
    turns = {}
    for label, p in (("dropout_0.1", 0.1), ("dropout_0", 0.0),
                     ("dropout_0_2", 0.0), ("dropout_0.1_2", 0.1)):
        set_dropout(paddle, model, p)
        step()              # the first step at a rate warms its routes
        turns[label] = wall_ms(torch, step)
    out["in_turns_ms"] = turns
    out["dropout_cost_ms"] = (min(turns["dropout_0.1"],
                                  turns["dropout_0.1_2"])
                              - min(turns["dropout_0"], turns["dropout_0_2"]))
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    line = json.dumps(out)
    (ROOT / "chiprun_out" / "user_nn_profile.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
