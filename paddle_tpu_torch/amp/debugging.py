"""AMP debugging: the operator statistics.

Counterpart: ``paddle_tpu/amp/debugging.py``, ``collect_operator_stats``
(:399-436). The tensor checker (``TensorCheckerConfig``,
``enable_tensor_checker``) and ``check_numerics`` are ROADMAP A5b.
"""
from __future__ import annotations

from contextlib import contextmanager

from ..core import dispatch

__all__ = ["collect_operator_stats"]

_BUCKETS = {"torch.float16": "fp16", "torch.bfloat16": "bf16",
            "torch.float32": "fp32"}


@contextmanager
def collect_operator_stats():
    """Bucket the registered ops dispatched under the ``with`` block by
    the dtype of their first output. Yields the live dict ``{op_name:
    {"fp16", "bf16", "fp32", "other", "calls"}}``, which stays valid after
    the block; a summary is printed when it exits."""
    stats = {}

    def hook(op_name, values):
        rec = stats.get(op_name)
        if rec is None:
            rec = stats[op_name] = {"fp16": 0, "bf16": 0, "fp32": 0,
                                    "other": 0, "calls": 0}
        rec["calls"] += 1
        dt = str(getattr(values[0], "dtype", "")) if values else ""
        rec[_BUCKETS.get(dt, "other")] += 1

    prev = dispatch._output_hook
    dispatch.set_output_hook(hook)
    try:
        yield stats
    finally:
        dispatch.set_output_hook(prev)
        print("<-------------- op list by output dtype -------------->")
        for name in sorted(stats):
            rec = stats[name]
            print(f"  {name}: calls={rec['calls']} fp16={rec['fp16']} "
                  f"bf16={rec['bf16']} fp32={rec['fp32']} "
                  f"other={rec['other']}")
