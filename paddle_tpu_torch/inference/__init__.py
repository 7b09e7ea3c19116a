"""Serving on the paged KV cache.

Counterpart: ``paddle_tpu/inference/__init__.py`` — the serving exports
(the AOT Predictor belongs to a later slice, see ROADMAP.md).
"""
from .batching import (BucketLadder, SLOQueue, chunk_spans, pad_batch,
                       pad_tokens)
from .engine import (ModelAdapter, Request, SamplingParams, ServingEngine,
                     SpeculativeConfig, gpt_adapter, llama_adapter)
from .kv_cache import (BlockPool, CacheExhaustedError, PrefixCache, kv_append,
                       kv_copy, kv_gather)

__all__ = ["BlockPool", "BucketLadder", "CacheExhaustedError", "ModelAdapter",
           "PrefixCache", "Request", "SLOQueue", "SamplingParams",
           "ServingEngine", "SpeculativeConfig", "chunk_spans", "gpt_adapter",
           "kv_append", "kv_copy", "kv_gather", "llama_adapter", "pad_batch",
           "pad_tokens"]
