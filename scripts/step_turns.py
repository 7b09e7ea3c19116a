#!/usr/bin/env python3
"""Two checkouts' training steps on one CUDA card, timed in turns.

    python3 scripts/step_turns.py OTHER_ROOT [MODEL ...]

MODEL is any of gpt3-1.3b, llama-7b, bert-base, resnet50-amp-o2 and
bert-base-amp-o1 (all five by default). Runs chip_smoke.py's training
phases of each checkout in a process of its own, in the order other,
this, this, other, so that a drift of the card or of its host over the
call weighs on both alike: each process builds its checkout's kernels
(into that checkout's ``build/``), then per model trains as
chip_smoke.py does (one warm-up step, 4 timed steps: gpt3-1.3b at B=4,
S=2048 as phase 10, llama-7b as phase 16, bert-base at its default
dropout as phase 33) and profiles 2 more steps (phases 11, 17, 34); the
two AMP models take phase 47's and phase 48's fused step
(``resnet_amp_trainer``, ``bert_amp_trainer``: resnet50 B=256 224^2
under O2, bert-base B=64 S=512 under O1), two warm-up steps,
``AMP_STEPS`` timed steps and phase 47's profile of 2 more
(``amp_profile``). Prints the card's name and power limit,
then one JSON object: per checkout and model each pass's ms a step
(wall), the profiled device busy ms a step and the idle share, and the
better of each checkout's two passes. Needs one card; run from the
repository's root.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODELS = ("gpt3-1.3b", "llama-7b", "bert-base", "resnet50-amp-o2",
          "bert-base-amp-o1")

# one process: the models' phases from the checkout it runs in
CHILD = r'''
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models import bert, gpt, llama
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
_build.build_all()
out = {}


def keep(name, train, prof):
    out[name] = dict(ms_per_step=train["ms_per_step"],
                     busy_ms_per_step=prof.get("device_busy_ms_per_step"),
                     idle_share=prof.get("device_idle_share"),
                     peak_memory_gb=train["peak_memory_gb"])


def amp_train(step):
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(cs.AMP_STEPS):
        step()
    torch.cuda.synchronize()
    return dict(ms_per_step=(time.perf_counter() - t0) / cs.AMP_STEPS * 1e3,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


for name in sys.argv[1:]:
    if name in ("resnet50-amp-o2", "bert-base-amp-o1"):
        if name == "resnet50-amp-o2":
            _, step, _ = cs.resnet_amp_trainer(torch, True)
        else:
            _, step, _ = cs.bert_amp_trainer(torch, bert.CONFIGS["bert-base"],
                                             True)
        keep(name, amp_train(step), cs.amp_profile(torch, step))
        del step
    elif name == "gpt3-1.3b":
        cfg = gpt.CONFIGS[name]._replace(remat_policy="save_small",
                                         opt_dtype=torch.bfloat16,
                                         lm_head="auto")
        train, params, opt, batch = cs.phase_train(torch, cfg, fused=True)
        keep(name, train, cs.phase_profile_train(torch, cfg, params, opt,
                                                 batch))
        del params, opt, batch
    elif name == "llama-7b":
        train, model, opt, step = cs.phase_train_llama(
            torch, llama.CONFIGS[name], fused=True)
        keep(name, train, cs.phase_profile_llama(torch, step))
        del model, opt, step
    else:
        train, model, step = cs.phase_train_bert(torch, bert.CONFIGS[name],
                                                 fused=True)
        keep(name, train, cs.phase_profile_bert(torch, step))
        del model, step
    cs.free_card(torch)
print(json.dumps(out))
'''


def run(root, models):
    """One pass in ``root``: the models' numbers (the child's last line)."""
    proc = subprocess.run([sys.executable, "-c", CHILD, *models], cwd=root,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    models = sys.argv[2:] or list(MODELS)
    if not set(models) <= set(MODELS):
        print(f"step_turns: models are {MODELS}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    card = cs.gpu_line()
    print(card, flush=True)
    passes = {"other": [], "this": []}
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        passes[label].append(run(root, models))
        print(label, json.dumps(passes[label][-1]), flush=True)
    best = {label: {m: min((p[m] for p in runs), key=lambda x: x["ms_per_step"])
                    for m in models} for label, runs in passes.items()}
    print(json.dumps({"card": card, "other_root": str(other), "passes": passes,
                      "best": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
