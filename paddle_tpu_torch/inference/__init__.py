"""Serving on the paged KV cache.

Counterpart: ``paddle_tpu/inference/__init__.py`` — the serving exports
(the AOT Predictor belongs to a later slice, see ROADMAP.md).
"""
from .batching import BucketLadder, SLOQueue, pad_batch, pad_tokens
from .engine import (ModelAdapter, Request, SamplingParams, ServingEngine,
                     gpt_adapter)
from .kv_cache import BlockPool, CacheExhaustedError, kv_append, kv_gather

__all__ = ["BlockPool", "BucketLadder", "CacheExhaustedError", "ModelAdapter",
           "Request", "SLOQueue", "SamplingParams", "ServingEngine",
           "gpt_adapter", "kv_append", "kv_gather", "pad_batch", "pad_tokens"]
