"""Continuous-batching serving engine over the paged KV cache.

Counterpart: ``paddle_tpu/inference/engine.py``: requests, admission
with whole-request block reservation, whole-prompt prefill, the device
decode window and the host-decode branch of ``step``, finish/timeout
paths, ``run_until_idle`` and ``stats``; the adapters ``gpt_adapter``
and ``llama_adapter``; and the fast path: chunked prefill (the
``PREFILLING`` state), the prefix cache (shared blocks, copy-on-write
tails, LRU eviction) and greedy speculative decoding
(``SpeculativeConfig``, a draft pool, one verify per round). Same
contract:

- Prompts pad to a prefill bucket, the decode batch pads to a batch
  bucket, every block table is MB = ceil(max_model_len / block_size)
  wide, so the card sees a small fixed set of shapes.
- Blocks for the WHOLE request (prompt + max_new_tokens) are reserved
  at admission; a full pool is admission policy ("queue" waits,
  "reject" fails fast), never a failure mid-flight.
- The engine is host-side control flow; the model functions run on the
  adapter's device. One step = admissions + one chunk per PREFILLING
  request + one decode dispatch (a speculative round with a draft) over
  the running batch.
- Every terminal state drops the request's references exactly once;
  ``stats()["leaked_blocks"]`` (the pool against live requests and the
  trie) and ``stats()["draft_leaked_blocks"]`` (the draft pool) are 0
  after any run.

Knobs of the serving-at-scale slice keep their place in the constructor
and raise NotImplementedError naming their ROADMAP.md item: priority
bands, deadlines, cross-priority preemption and the watchdog. Fault
points, preemption, fleet drain and the metrics registry come with that
slice too.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.flags import get_flag
from ..profiler import flightrec
from ..profiler.histogram import LogHistogram
from ..nn.functional.sampling import greedy_math
from .batching import BucketLadder, SLOQueue, chunk_spans
from .device_loop import decode_window, draft_window
from .kv_cache import (BlockPool, CacheExhaustedError, PrefixCache,
                       kv_append, kv_copy)

__all__ = ["SamplingParams", "Request", "ServingEngine", "ModelAdapter",
           "SpeculativeConfig", "gpt_adapter", "llama_adapter"]

# Request lifecycle states
WAITING = "WAITING"        # queued, blocks not yet reserved
PREFILLING = "PREFILLING"  # blocks reserved, prompt prefilled in chunks
RUNNING = "RUNNING"        # prefilled, decoding
FINISHED = "FINISHED"      # emitted max_new_tokens or hit eos
TIMED_OUT = "TIMED_OUT"    # exceeded timeout_steps before finishing
REJECTED = "REJECTED"      # admission policy "reject"/queue full

_LATER = {
    "num_priorities": "A7 (SLO classes)",
    "deadlines": "A7 (SLO classes: deadlines)",
    "xprio_preempt_steps": "A7 (SLO classes: cross-priority preemption)",
    "watchdog": "A7 (EngineWatchdog)",
}


def _later(knob: str, got) -> NotImplementedError:
    return NotImplementedError(
        f"ServingEngine: {knob}={got!r} is not ported yet — ROADMAP.md "
        f"queue A, item {_LATER[knob]}")


class SamplingParams:
    """Per-request sampling configuration — every knob works or raises.

    temperature == 0.0 is exact greedy (argmax); combining it with
    top_k/top_p raises. temperature > 0 samples from softmax(logits /
    temperature) after optional top_k then top_p filtering. With
    ``FLAGS_serving_device_loop`` on (the default) sampled requests draw
    through the counter-derived sampler (nn/functional/sampling.py);
    ``sample`` is the host numpy sampler of the flag-off path."""

    def __init__(self, max_new_tokens: int = 16, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 eos_token_id: Optional[int] = None):
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {top_k}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if temperature == 0.0 and (top_k != 0 or top_p != 1.0):
            raise ValueError(
                "temperature=0 is exact greedy; top_k/top_p would be "
                "silently dead — pass temperature > 0 to sample")
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.eos_token_id = eos_token_id

    def sample(self, logits: np.ndarray, rng: np.random.Generator) -> int:
        """One token from one [V] logits row (host numpy)."""
        if self.temperature == 0.0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / self.temperature
        if self.top_k > 0 and self.top_k < z.size:
            kth = np.partition(z, -self.top_k)[-self.top_k]
            z = np.where(z >= kth, z, -np.inf)
        p = np.exp(z - np.max(z))
        p /= p.sum()
        if self.top_p < 1.0:
            order = np.argsort(-p)
            csum = np.cumsum(p[order])
            cut = int(np.searchsorted(csum, self.top_p)) + 1
            mask = np.zeros_like(p)
            mask[order[:cut]] = 1.0
            p = p * mask
            p /= p.sum()
        return int(rng.choice(p.size, p=p))


class Request:
    """One generation request; engine-owned bookkeeping."""

    def __init__(self, request_id: str, prompt: np.ndarray,
                 sampling: SamplingParams, timeout_steps: Optional[int],
                 submitted_step: int, tenant: str = "default",
                 now: Optional[float] = None):
        self.request_id = request_id
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.sampling = sampling
        self.timeout_steps = timeout_steps
        self.submitted_step = submitted_step
        self.state = WAITING
        self.tokens: List[int] = []      # generated tokens
        self.position = 0                # next absolute position to write
        self.blocks_reserved = 0
        self.prefill_pos = 0             # next prompt position to compute
        self.reused_tokens = 0           # prefix-cache tokens NOT computed
        self.finish_reason: Optional[str] = None
        self.finished_step: Optional[int] = None
        self._rng = np.random.default_rng(sampling.seed)
        self.priority = 0
        self.tenant = str(tenant)
        self._seq: Optional[int] = None     # SLOQueue arrival stamp
        self.t_submit = time.perf_counter() if now is None else now
        self.t_submit_wall = time.time()
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_terminal: Optional[float] = None
        self.admitted_step: Optional[int] = None
        self._t_prev_token: Optional[float] = None

    def __repr__(self):
        return (f"Request({self.request_id!r}, state={self.state}, "
                f"prompt={len(self.prompt)}, generated={len(self.tokens)})")


class ModelAdapter:
    """Uniform surface the engine drives: functions plus the cache
    geometry. ``prefill(params, ids, lengths)`` → (last_logits [B, V],
    k [L, B, S, KVH, D], v [...]); ``decode(params, kp, vp, tokens,
    positions, block_tables, block_size)`` → (logits [B, V], kp, vp);
    optional ``chunk(params, kp, vp, ids, positions, slots,
    block_tables, block_size)`` → (logits [B, Q, V], kp, vp), the
    multi-token step behind chunked prefill, prefix-cache suffix prefill
    and speculative verify. ``device`` is where ``params`` live."""

    def __init__(self, name: str, params: Any, num_layers: int,
                 num_kv_heads: int, head_dim: int, vocab_size: int,
                 max_positions: int, prefill: Callable, decode: Callable,
                 device: torch.device, dtype=torch.float32,
                 chunk: Optional[Callable] = None):
        self.name = name
        self.params = params
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.vocab_size = vocab_size
        self.max_positions = max_positions
        self.prefill = prefill
        self.decode = decode
        self.chunk = chunk
        self.device = torch.device(device)
        self.dtype = dtype


def gpt_adapter(model) -> ModelAdapter:
    """Serving adapter for models.gpt.GPTForCausalLM (MHA: KVH = NH)."""
    from ..models import gpt
    cfg = model.cfg
    return ModelAdapter(
        name="gpt", params=gpt.serving_params(model),
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_heads,
        head_dim=cfg.hidden_size // cfg.num_heads,
        vocab_size=cfg.vocab_size, max_positions=cfg.max_seq_len,
        prefill=lambda p, ids, lens: gpt.serving_prefill(p, ids, lens, cfg),
        decode=lambda p, kp, vp, t, po, bt, bs: gpt.serving_decode_step(
            p, kp, vp, t, po, bt, cfg, bs),
        device=model.device, dtype=cfg.dtype,
        chunk=lambda p, kp, vp, ids, po, sl, bt, bs: gpt.serving_chunk_step(
            p, kp, vp, ids, po, sl, bt, cfg, bs))


def llama_adapter(model) -> ModelAdapter:
    """Serving adapter for models.llama.LlamaForCausalLM: the pool holds
    cfg.kv_heads heads (GQA), not num_attention_heads."""
    from ..models import llama
    cfg = model.cfg
    return ModelAdapter(
        name="llama", params=llama.llama_serving_params(model),
        num_layers=cfg.num_hidden_layers, num_kv_heads=cfg.kv_heads,
        head_dim=cfg.hidden_size // cfg.num_attention_heads,
        vocab_size=cfg.vocab_size,
        max_positions=cfg.max_position_embeddings,
        prefill=lambda p, ids, lens: llama.llama_serving_prefill(
            p, ids, lens, cfg),
        decode=lambda p, kp, vp, t, po, bt, bs:
            llama.llama_serving_decode_step(p, kp, vp, t, po, bt, cfg, bs),
        device=model.device, dtype=model.lm_head.weight.dtype,
        chunk=lambda p, kp, vp, ids, po, sl, bt, bs:
            llama.llama_serving_chunk_step(p, kp, vp, ids, po, sl, bt,
                                           cfg, bs))


class SpeculativeConfig:
    """Draft-model speculative decoding, greedy only: the accept rule
    compares each draft token with the target's argmax. ``k`` draft
    tokens a round; the draft runs on its own BlockPool of the engine's
    block count and geometry (the draft holds the same tokens per
    request as the target), reserved at admission."""

    def __init__(self, draft_adapter: ModelAdapter, k: int = 2):
        if k < 1:
            raise ValueError(f"speculative k must be >= 1, got {k}")
        if draft_adapter.chunk is None:
            raise ValueError(
                "speculative decoding needs a draft adapter with a "
                "chunk() step (draft prefill runs through it)")
        self.draft_adapter = draft_adapter
        self.k = int(k)


class ServingEngine:
    """Continuous-batching scheduler: submit() any time, step() joins
    newly admitted prefills into the running decode batch at step
    boundaries. ``device`` (None → the CUDA card) must be where the
    adapter's parameters live; the KV pool is allocated there."""

    def __init__(self, adapter: ModelAdapter, num_blocks: int,
                 block_size: int, max_model_len: Optional[int] = None,
                 max_batch: int = 8,
                 prefill_buckets: Optional[List[int]] = None,
                 batch_buckets: Optional[List[int]] = None,
                 admission: str = "queue",
                 max_queue: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 speculative: Optional[SpeculativeConfig] = None,
                 device_loop_k: int = 1,
                 num_priorities: int = 1,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 unknown_tenant: str = "default",
                 deadline_percentile: float = 0.9,
                 deadline_min_samples: int = 12,
                 xprio_preempt_steps: Optional[int] = None,
                 watchdog: Optional[Any] = None,
                 clock: Optional[Callable[[], float]] = None,
                 device: DeviceLike = None):
        for knob, got, default in (
                ("num_priorities", num_priorities, 1),
                ("deadlines", (deadline_percentile, deadline_min_samples),
                 (0.9, 12)),
                ("xprio_preempt_steps", xprio_preempt_steps, None),
                ("watchdog", watchdog, None)):
            if got != default:
                raise _later(knob, got)
        self.device = resolve_device(device)
        if adapter.device != self.device:
            raise ValueError(
                f"adapter {adapter.name!r} parameters live on "
                f"{adapter.device}, engine device is {self.device}")
        if admission not in ("queue", "reject"):
            raise ValueError(f"admission must be 'queue' or 'reject', "
                             f"got {admission!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (None = unbounded), "
                             f"got {max_queue}")
        if unknown_tenant not in ("default", "reject"):
            raise ValueError(
                f"unknown_tenant must be 'default' (unknown tenants get "
                f"default_weight) or 'reject' (unknown tenants fail at "
                f"submit), got {unknown_tenant!r}")
        if unknown_tenant == "reject" and not tenant_weights:
            raise ValueError(
                "unknown_tenant='reject' with no tenant_weights would "
                "reject every request — name the allowed tenants")
        if clock is not None and not callable(clock):
            raise ValueError(f"clock must be callable, got {clock!r}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1 (None = off), "
                             f"got {prefill_chunk}")
        if speculative is not None and not isinstance(speculative,
                                                     SpeculativeConfig):
            raise ValueError("speculative must be a SpeculativeConfig, "
                             f"got {type(speculative).__name__}")
        self.device_loop = bool(get_flag("serving_device_loop"))
        if device_loop_k < 1:
            raise ValueError(f"device_loop_k must be >= 1, got "
                             f"{device_loop_k}")
        if device_loop_k > 1 and not self.device_loop:
            raise ValueError(
                f"device_loop_k={device_loop_k} needs "
                "FLAGS_serving_device_loop on — with the device loop "
                "disabled the multi-token window cannot run and the knob "
                "would be silently dead")
        if device_loop_k > 1 and speculative is not None:
            raise ValueError(
                f"device_loop_k={device_loop_k} with speculative decoding "
                "is contradictory: spec rounds replace the plain decode "
                "window (the draft loop already batches k steps per "
                "dispatch) — drop device_loop_k or speculative")
        self.device_loop_k = int(device_loop_k)
        if adapter.chunk is None and (prefill_chunk is not None
                                      or prefix_cache
                                      or speculative is not None):
            raise ValueError(
                f"adapter {adapter.name!r} has no chunk() step; "
                "prefill_chunk / prefix_cache / speculative require it")
        self.adapter = adapter
        self.block_size = int(block_size)
        self.max_model_len = int(max_model_len or adapter.max_positions)
        if self.max_model_len > adapter.max_positions:
            raise ValueError(
                f"max_model_len {self.max_model_len} exceeds the model's "
                f"position table ({adapter.max_positions})")
        self.table_width = math.ceil(self.max_model_len / self.block_size)
        self.ctx = self.table_width * self.block_size
        self.pool = BlockPool(adapter.num_layers, num_blocks,
                              self.block_size, adapter.num_kv_heads,
                              adapter.head_dim, dtype=adapter.dtype,
                              device=self.device)
        self.prefill_ladder = BucketLadder(
            prefill_buckets or list(BucketLadder.pow2(self.max_model_len)))
        if self.prefill_ladder.max > self.max_model_len:
            raise ValueError(
                f"prefill bucket {self.prefill_ladder.max} exceeds "
                f"max_model_len {self.max_model_len}")
        self.batch_ladder = BucketLadder(
            batch_buckets or list(BucketLadder.pow2(max_batch)))
        self.max_batch = self.batch_ladder.max
        self.admission = admission
        self.max_queue = max_queue
        self.waiting = SLOQueue(1, tenant_weights)
        self.tenant_weights = self.waiting.tenant_weights
        self.unknown_tenant = unknown_tenant
        self._clock = clock or time.perf_counter
        self.running: List[Request] = []
        self.prefilling: List[Request] = []
        self.requests: Dict[str, Request] = {}
        self.prefill_chunk = (int(prefill_chunk)
                              if prefill_chunk is not None else None)
        self.chunk_ladder = (BucketLadder.pow2(self.prefill_chunk)
                             if self.prefill_chunk is not None else None)
        self.prefix = PrefixCache(self.pool) if prefix_cache else None
        self.spec = speculative
        self.draft_pool: Optional[BlockPool] = None
        if self.spec is not None:
            da = self.spec.draft_adapter
            if da.max_positions < self.max_model_len:
                raise ValueError(
                    f"draft model position table ({da.max_positions}) "
                    f"shorter than max_model_len {self.max_model_len}")
            if da.device != self.device:
                raise ValueError(
                    f"draft adapter {da.name!r} parameters live on "
                    f"{da.device}, engine device is {self.device}")
            self.draft_pool = BlockPool(
                da.num_layers, num_blocks,
                self.block_size, da.num_kv_heads, da.head_dim,
                dtype=da.dtype, device=self.device)
        self._step_i = 0
        self._next_id = 0
        self._counters = {"prefills": 0, "decode_steps": 0,
                          "tokens_generated": 0, "finished": 0,
                          "timed_out": 0, "rejected": 0, "shed": 0,
                          "prefill_chunks": 0, "chunk_tokens": 0,
                          "prefix_recompute_tokens": 0,
                          "spec_drafted": 0, "spec_accepted": 0,
                          "spec_verify_steps": 0,
                          "device_loop_windows": 0,
                          "device_loop_tokens": 0}
        self._util_peak = 0.0
        self._util_sum = 0.0
        self._util_n = 0
        self._hist_ttft_ms = LogHistogram()
        self._hist_itl_ms = LogHistogram()
        self._span_counts = {FINISHED: 0, TIMED_OUT: 0, REJECTED: 0}

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    # -- submission -------------------------------------------------------

    def submit(self, prompt, sampling: Optional[SamplingParams] = None,
               timeout_steps: Optional[int] = None,
               request_id: Optional[str] = None, priority: int = 0,
               tenant: str = "default",
               ttft_deadline_ms: Optional[float] = None,
               e2e_deadline_ms: Optional[float] = None) -> Request:
        """Queue one request. Raises ValueError for requests that can
        NEVER run (too long for the bucket ladder / position table /
        whole pool); pool-full at this instant is policy instead:
        admission='queue' waits, 'reject' → state REJECTED."""
        if ttft_deadline_ms is not None or e2e_deadline_ms is not None:
            raise _later("deadlines", (ttft_deadline_ms, e2e_deadline_ms))
        if priority != 0:
            raise _later("num_priorities", priority)
        sampling = sampling or SamplingParams()
        if self.spec is not None and sampling.temperature != 0.0:
            raise ValueError(
                "speculative decoding is greedy-only (the accept rule "
                "compares drafts against the target argmax); got "
                f"temperature={sampling.temperature} — submit with "
                "temperature=0 or build the engine without speculative")
        if not tenant or not isinstance(tenant, str):
            raise ValueError(
                f"tenant must be a non-empty string, got {tenant!r}")
        if (self.unknown_tenant == "reject"
                and tenant not in self.tenant_weights):
            raise ValueError(
                f"unknown tenant {tenant!r}: engine built with "
                f"unknown_tenant='reject' and weights for "
                f"{sorted(self.tenant_weights)}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if timeout_steps is not None and timeout_steps < 1:
            raise ValueError(f"timeout_steps must be >= 1, got "
                             f"{timeout_steps}")
        total = prompt.size + sampling.max_new_tokens
        if self.prefill_ladder.bucket_or_none(prompt.size) is None:
            raise ValueError(
                f"prompt length {prompt.size} exceeds the prefill bucket "
                f"ladder (max {self.prefill_ladder.max})")
        if total > self.max_model_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({sampling.max_new_tokens}) = {total} exceeds "
                f"max_model_len {self.max_model_len}")
        need = self.pool.blocks_needed(total)
        if need > self.pool.num_blocks:
            raise ValueError(
                f"request needs {need} blocks; the whole pool has "
                f"{self.pool.num_blocks}")
        if request_id is None:
            request_id = f"req-{self._next_id}"
            self._next_id += 1
        if request_id in self.requests:
            raise ValueError(f"duplicate request_id {request_id!r}")
        req = Request(request_id, prompt, sampling, timeout_steps,
                      self._step_i, tenant=tenant, now=self._clock())
        self.requests[request_id] = req
        if (self.max_queue is not None
                and len(self.waiting) >= self.max_queue):
            # one priority band: the newcomer is the one shed
            self._counters["shed"] += 1
            self._reject(req, f"load shed: queue full "
                              f"({len(self.waiting)}/{self.max_queue} "
                              f"waiting)")
            return req
        if self.admission == "reject" and need > self.pool.free_blocks:
            self._counters["rejected"] += 1
            self._reject(req, f"pool full: need {need} blocks, "
                              f"{self.pool.free_blocks} free")
            return req
        self.waiting.push(req)
        return req

    def _reject(self, req: Request, reason: str):
        req.state = REJECTED
        req.finish_reason = reason
        req.finished_step = self._step_i
        flightrec.record("serving_request", request=req.request_id,
                         state=REJECTED, prompt_len=int(req.prompt.size),
                         new_tokens=0, steps_in_flight=0)
        self._record_span(req, REJECTED)

    # -- scheduling -------------------------------------------------------

    def _record_span(self, req: Request, state: str):
        """One "serving_span" record per terminal transition: the
        request's submit→admit→first-token→terminal lifecycle (ms)."""
        req.t_terminal = self._clock()
        self._span_counts[state] += 1
        ms = 1e3
        flightrec.record(
            "serving_span", request=req.request_id, state=state,
            t_submit_wall=req.t_submit_wall,
            total_ms=(req.t_terminal - req.t_submit) * ms,
            queue_ms=((req.t_admit - req.t_submit) * ms
                      if req.t_admit is not None else None),
            ttft_ms=((req.t_first_token - req.t_submit) * ms
                     if req.t_first_token is not None else None),
            decode_ms=((req.t_terminal - req.t_first_token) * ms
                       if req.t_first_token is not None else None),
            tenant=req.tenant, prompt_len=int(req.prompt.size),
            tokens=len(req.tokens), submitted_step=req.submitted_step,
            admitted_step=req.admitted_step,
            finished_step=req.finished_step, reason=req.finish_reason)

    def _finish(self, req: Request, state: str, reason: str):
        if req.state in (RUNNING, PREFILLING):
            # decrement-only: a prefix block another request or the trie
            # still maps survives this terminal path
            self.pool.free(req.request_id)
            if self.draft_pool is not None:
                self.draft_pool.free(req.request_id)
        req.state = state
        req.finish_reason = reason
        req.finished_step = self._step_i
        flightrec.record(
            "serving_request", request=req.request_id, state=state,
            prompt_len=int(req.prompt.size), new_tokens=len(req.tokens),
            steps_in_flight=self._step_i - req.submitted_step)
        self._record_span(req, state)

    def _check_timeouts(self):
        for req in list(self.waiting):
            if (req.timeout_steps is not None and
                    self._step_i - req.submitted_step >= req.timeout_steps):
                self.waiting.remove(req)
                self._finish(req, TIMED_OUT, "timed out in queue")
                self._counters["timed_out"] += 1
        for req in list(self.prefilling):
            if (req.timeout_steps is not None and
                    self._step_i - req.submitted_step >= req.timeout_steps):
                self.prefilling.remove(req)
                self._finish(req, TIMED_OUT, "timed out while prefilling")
                self._counters["timed_out"] += 1
        for req in list(self.running):
            if (req.timeout_steps is not None and
                    self._step_i - req.submitted_step >= req.timeout_steps):
                self.running.remove(req)
                self._finish(req, TIMED_OUT, "timed out while decoding")
                self._counters["timed_out"] += 1

    def _admit_one(self, req: Request) -> bool:
        """Reserve the request's blocks (sharing cached prefix blocks
        when the trie matches), then prefill it whole or from its cached
        prefix, or park it in PREFILLING for the chunk loop. False when
        the pool cannot hold it right now (it stays queued)."""
        need = self.pool.blocks_needed(
            req.prompt.size + req.sampling.max_new_tokens)
        shared: List[int] = []
        partial = None
        if self.prefix is not None:
            shared, partial = self.prefix.match(req.prompt)
        n_new = need - len(shared)
        try:
            try:
                self._reserve(req, shared, n_new)
            except CacheExhaustedError:
                # LRU-evict cache-only blocks (never ones this admission
                # is about to share) and retry once
                if self.prefix is None or not self.prefix.evict_for(
                        n_new, keep=shared):
                    raise
                self._reserve(req, shared, n_new)
        except CacheExhaustedError:
            return False
        if self.draft_pool is not None:
            try:
                self.draft_pool.alloc(req.request_id, need)
            except CacheExhaustedError:
                self.pool.free(req.request_id)  # atomic admission
                return False
        req.blocks_reserved = need
        req.t_admit = self._clock()
        req.admitted_step = self._step_i
        reused = len(shared) * self.block_size
        cow = 0
        if partial is not None:
            donor_block, m = partial
            own_block = self.pool.owned(req.request_id)[len(shared)]
            self._cow_copy(donor_block, own_block, m)
            cow = m
            reused += m
        req.reused_tokens = reused
        req.prefill_pos = reused
        if self.prefix is not None:
            if reused > 0:
                self.prefix.hits += 1
                self.prefix.tokens_reused += reused
                self.prefix.cow_tokens += cow
                flightrec.record("prefix_hit", request=req.request_id,
                                 blocks_shared=len(shared),
                                 tokens_reused=reused, cow_tokens=cow)
            else:
                self.prefix.misses += 1
        if self.prefill_chunk is not None:
            req.state = PREFILLING
            self.prefilling.append(req)
        elif reused > 0:
            self._prefill_suffix(req)
        else:
            self._prefill_full(req)
        return True

    def _reserve(self, req: Request, shared: List[int], n_new: int):
        if shared:
            self.pool.alloc_shared(req.request_id, shared, n_new)
        else:
            self.pool.alloc(req.request_id, n_new)

    def _prefill_full(self, req: Request):
        """Whole-prompt prefill + K/V scatter into the pool + first
        token."""
        S = self.prefill_ladder.bucket_for(req.prompt.size)
        ids = np.zeros((1, S), np.int32)
        ids[0, :req.prompt.size] = req.prompt
        last_logits, ks, vs = self.adapter.prefill(
            self.adapter.params, self._tensor(ids),
            self._tensor([req.prompt.size]))
        slots = np.full((S,), self.pool.num_slots, np.int32)  # pad → trash
        slots[:req.prompt.size] = self.pool.slots_for(
            req.request_id, 0, req.prompt.size)
        slots_t = self._tensor(slots)
        kv_shape = (S, self.adapter.num_kv_heads, self.adapter.head_dim)
        for layer in range(self.adapter.num_layers):
            kv_append(self.pool.k[layer], ks[layer].reshape(kv_shape), slots_t)
            kv_append(self.pool.v[layer], vs[layer].reshape(kv_shape), slots_t)
        tok = self._sample_first(req, last_logits[0])
        flightrec.record("serving_prefill", request=req.request_id,
                         bucket=S, prompt_len=int(req.prompt.size),
                         blocks=req.blocks_reserved)
        self._complete_prefill(req, tok)

    def _prefill_suffix(self, req: Request):
        """Prefill only the uncached tail [reused_tokens, len) in one
        chunk call (chunking off, a prefix hit landed);
        ``prefix_recompute_tokens`` counts any cached token computed
        again."""
        start = req.prefill_pos
        n = req.prompt.size - start
        Qb = self.prefill_ladder.bucket_for(n)
        logits = self._run_chunk(req, start, n, Qb)
        self._counters["prefix_recompute_tokens"] += max(
            0, req.reused_tokens - start)
        req.prefill_pos = req.prompt.size
        flightrec.record("serving_chunk", request=req.request_id,
                         start=int(start), tokens=int(n), bucket=Qb,
                         remaining=0)
        tok = self._sample_first(req, logits[0, n - 1])
        self._complete_prefill(req, tok)

    def _prefill_chunk_one(self, req: Request) -> bool:
        """One chunk of one PREFILLING request; True when the prompt
        completed (first token sampled, request now RUNNING)."""
        start = req.prefill_pos
        n = min(self.prefill_chunk, req.prompt.size - start)
        Qb = self.chunk_ladder.bucket_for(n)
        logits = self._run_chunk(req, start, n, Qb)
        self._counters["prefill_chunks"] += 1
        self._counters["chunk_tokens"] += n
        self._counters["prefix_recompute_tokens"] += max(
            0, req.reused_tokens - start)
        req.prefill_pos = start + n
        flightrec.record("serving_chunk", request=req.request_id,
                         start=int(start), tokens=int(n), bucket=Qb,
                         remaining=int(req.prompt.size - req.prefill_pos))
        if req.prefill_pos >= req.prompt.size:
            tok = self._sample_first(req, logits[0, n - 1])
            self.prefilling.remove(req)
            self._complete_prefill(req, tok)
            return True
        return False

    def _run_chunk(self, req: Request, start: int, n: int, Qb: int,
                   draft: bool = False) -> torch.Tensor:
        """One (1, Qb) chunk call computing prompt positions [start,
        start + n) into the target's (or the draft's) pool; pad rows
        carry the position sentinel ctx and the trash slot. Returns the
        [1, Qb, V] logits."""
        pool = self.draft_pool if draft else self.pool
        ad = self.spec.draft_adapter if draft else self.adapter
        ids = np.zeros((1, Qb), np.int32)
        ids[0, :n] = req.prompt[start:start + n]
        positions = np.full((1, Qb), self.ctx, np.int32)
        positions[0, :n] = start + np.arange(n)
        slots = np.full((1, Qb), pool.num_slots, np.int32)
        slots[0, :n] = pool.slots_for(req.request_id, start, start + n)
        tables = pool.block_table(req.request_id, self.table_width)[None]
        logits, pool.k, pool.v = ad.chunk(
            ad.params, pool.k, pool.v, self._tensor(ids),
            self._tensor(positions), self._tensor(slots),
            self._tensor(tables), self.block_size)
        return logits

    def _cow_copy(self, donor_block: int, own_block: int, m: int):
        """Copy-on-write: the donor block's first m rows land in the
        request's own tail block; the rest of the [block_size] copy reads
        the trash row and drops its write."""
        bs = self.block_size
        src = np.full((bs,), self.pool.num_slots, np.int32)
        dst = np.full((bs,), self.pool.num_slots + 1, np.int32)
        src[:m] = donor_block * bs + np.arange(m)
        dst[:m] = own_block * bs + np.arange(m)
        src_t, dst_t = self._tensor(src), self._tensor(dst)
        for layer in range(self.adapter.num_layers):
            kv_copy(self.pool.k[layer], src_t, dst_t)
            kv_copy(self.pool.v[layer], src_t, dst_t)

    def _draft_prefill(self, req: Request):
        """Fill the draft pool's KV for the whole prompt (the draft has
        no prefix cache: it always computes from position 0)."""
        if self.prefill_chunk is not None:
            spans = chunk_spans(req.prompt.size, self.prefill_chunk)
            ladder = self.chunk_ladder
        else:
            spans = [(0, int(req.prompt.size))]
            ladder = self.prefill_ladder
        for s, e in spans:
            self._run_chunk(req, s, e - s, ladder.bucket_for(e - s),
                            draft=True)

    def _sample_first(self, req: Request, row: torch.Tensor) -> int:
        """First generated token from the prefill's last logits row.
        With the device loop on, sampled requests draw through the same
        counter-derived math as the in-window steps (token #0 = count
        0); greedy requests and the flag-off path use the host
        sampler."""
        if not self.device_loop or req.sampling.temperature == 0.0:
            return req.sampling.sample(row.float().cpu().numpy(), req._rng)
        from ..nn.functional.sampling import sample_token
        s = req.sampling
        return sample_token(row, s.seed, len(req.tokens), s.temperature,
                            s.top_k, s.top_p)

    def _complete_prefill(self, req: Request, tok: int):
        """Prompt fully in cache: RUNNING, its full blocks published in
        the trie, the draft pool prefilled, the first token emitted."""
        req.position = int(req.prompt.size)
        req.state = RUNNING
        self.running.append(req)
        self._counters["prefills"] += 1
        if self.prefix is not None:
            self.prefix.insert(req.prompt, self.pool.owned(req.request_id))
        if self.spec is not None:
            self._draft_prefill(req)
        self._emit(req, tok)

    def _batch_inputs(self, batch: List[Request], B: int):
        """Host arrays of the padded decode batch: tokens, positions,
        block tables (pad rows all ``num_blocks``)."""
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        tables = np.broadcast_to(
            self.pool.pad_block_table(self.table_width),
            (B, self.table_width)).copy()
        for i, req in enumerate(batch):
            tokens[i] = req.tokens[-1]
            positions[i] = req.position
            tables[i] = self.pool.block_table(req.request_id,
                                              self.table_width)
        return tokens, positions, tables

    def _device_decode_window(self) -> Tuple[List[Tuple[str, int]], int]:
        """One device decode window over the running batch: k
        decode+sample steps on the card and ONE host read of the packed
        [B, k] token matrix (-1 = lane was done). The host applies the
        same finish rules in ``_emit`` while draining the matrix."""
        batch = list(self.running)
        nb = len(batch)
        B = self.batch_ladder.bucket_for(nb)
        k = self.device_loop_k
        tokens, positions, tables = self._batch_inputs(batch, B)
        done0 = np.ones((B,), bool)       # pad lanes start done
        counts = np.zeros((B,), np.int32)
        eos = np.full((B,), -1, np.int32)
        limits = np.ones((B,), np.int32)
        wlim = np.full((B,), -1, np.int32)
        temps = np.zeros((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        top_ps = np.ones((B,), np.float32)
        seeds = np.zeros((B,), np.int64)
        for i, req in enumerate(batch):
            s = req.sampling
            done0[i] = False
            counts[i] = len(req.tokens)
            eos[i] = -1 if s.eos_token_id is None else int(s.eos_token_id)
            limits[i] = s.max_new_tokens
            # last position decode legally writes for this request
            wlim[i] = req.prompt.size + s.max_new_tokens - 2
            temps[i] = s.temperature
            top_ks[i] = s.top_k
            top_ps[i] = s.top_p
            seeds[i] = s.seed & 0xFFFFFFFF
        ad, bs = self.adapter, self.block_size
        mat, self.pool.k, self.pool.v = decode_window(
            lambda p, kk, vv, tt, oo, bb: ad.decode(p, kk, vv, tt, oo, bb,
                                                    bs),
            ad.params, self.pool.k, self.pool.v, self._tensor(tokens),
            self._tensor(positions), self._tensor(tables),
            *(torch.from_numpy(a) for a in (done0, counts, eos, limits, wlim,
                                            temps, top_ks, top_ps, seeds)),
            self.pool.num_blocks, k, bs)
        mat = mat.cpu().numpy()  # the window's ONE host read
        emitted: List[Tuple[str, int]] = []
        for i, req in enumerate(batch):
            for j in range(k):
                tok = int(mat[i, j])
                if tok < 0 or req.state != RUNNING:
                    break
                req.position += 1
                emitted.append((req.request_id, tok))
                self._emit(req, tok)
        self._counters["decode_steps"] += 1
        self._counters["device_loop_windows"] += 1
        self._counters["device_loop_tokens"] += len(emitted)
        flightrec.record("serving_device_window", step=self._step_i,
                         batch=nb, k=k, tokens=len(emitted))
        return emitted, nb

    def _spec_round(self) -> Tuple[List[Tuple[str, int]], int]:
        """One speculative round over the running batch: k greedy draft
        steps propose tokens, one (B, k+1) target verify scores every
        candidate row, and each lane emits the longest draft run that
        agrees with the target's argmax plus the target's own next
        token — the target's greedy stream; the draft only sets how many
        tokens a round yields.

        No KV rollback: rejected rows leave stale K/V beyond the new
        position, which every later round rewrites before it reads
        (append precedes gather in each layer, and the j <= pos mask
        hides the rest). Rows that would write past the request's
        reservation (position > prompt + max_new - 2) target the trash
        row, so no two rows collide on a real slot."""
        batch = list(self.running)
        nb = len(batch)
        B = self.batch_ladder.bucket_for(nb)
        k = self.spec.k
        dpool = self.draft_pool
        da, bs = self.spec.draft_adapter, self.block_size
        pad_row = dpool.pad_block_table(self.table_width)
        cur = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        limit = np.full((B,), -1, np.int32)
        tables = np.broadcast_to(pad_row, (B, self.table_width)).copy()
        for i, req in enumerate(batch):
            cur[i] = req.tokens[-1]
            pos[i] = req.position
            limit[i] = req.prompt.size + req.sampling.max_new_tokens - 2
            tables[i] = dpool.block_table(req.request_id, self.table_width)
        # the whole draft phase on the card, one host read; the flag
        # only decides whether it counts as a device-loop window
        dmat, dpool.k, dpool.v = draft_window(
            lambda p, kk, vv, tt, oo, bb: da.decode(p, kk, vv, tt, oo,
                                                    bb, bs),
            da.params, dpool.k, dpool.v, self._tensor(cur),
            self._tensor(pos), self._tensor(tables),
            torch.from_numpy(limit), dpool.num_blocks, k, bs)
        drafts = dmat.cpu().numpy()
        if self.device_loop:
            self._counters["device_loop_windows"] += 1
        # -- one batched verify over [last_token, d_1 .. d_k] ------------
        Q = k + 1
        ids = np.zeros((B, Q), np.int32)
        vpos = np.full((B, Q), self.ctx, np.int32)
        slots = np.full((B, Q), self.pool.num_slots, np.int32)
        ttables = np.broadcast_to(
            self.pool.pad_block_table(self.table_width),
            (B, self.table_width)).copy()
        for i, req in enumerate(batch):
            ttables[i] = self.pool.block_table(req.request_id,
                                               self.table_width)
            ids[i, 0] = req.tokens[-1]
            ids[i, 1:] = drafts[i]
            for j in range(Q):
                p = int(req.position) + j
                vpos[i, j] = p
                if p <= limit[i]:
                    slots[i, j] = self.pool.slots_for(
                        req.request_id, p, p + 1)[0]
        logits, self.pool.k, self.pool.v = self.adapter.chunk(
            self.adapter.params, self.pool.k, self.pool.v,
            self._tensor(ids), self._tensor(vpos), self._tensor(slots),
            self._tensor(ttables), bs)
        greedy = greedy_math(logits).cpu().numpy()   # [B, Q]
        emitted: List[Tuple[str, int]] = []
        drafted = accepted = 0
        for i, req in enumerate(batch):
            # row 0 is the target's own next token; each leading draft
            # that agrees with the target lets the row after it stand
            n_emit = 1 + int(np.cumprod(drafts[i] == greedy[i, :k]).sum())
            drafted += k
            accepted += n_emit - 1
            for j in range(n_emit):
                if req.state != RUNNING:
                    break  # finished mid-burst (eos / budget)
                req.position += 1
                tok = int(greedy[i, j])
                emitted.append((req.request_id, tok))
                self._emit(req, tok)
        self._counters["decode_steps"] += 1
        self._counters["spec_verify_steps"] += 1
        self._counters["spec_drafted"] += drafted
        self._counters["spec_accepted"] += accepted
        flightrec.record("serving_spec_verify", step=self._step_i,
                         batch=nb, drafted=drafted, accepted=accepted)
        return emitted, nb

    def _host_decode(self) -> Tuple[List[Tuple[str, int]], int]:
        """One decode step with host numpy sampling (device loop off)."""
        batch = list(self.running)
        B = self.batch_ladder.bucket_for(len(batch))
        tokens, positions, tables = self._batch_inputs(batch, B)
        logits, self.pool.k, self.pool.v = self.adapter.decode(
            self.adapter.params, self.pool.k, self.pool.v,
            self._tensor(tokens), self._tensor(positions),
            self._tensor(tables), self.block_size)
        logits = logits.float().cpu().numpy()
        emitted: List[Tuple[str, int]] = []
        for i, req in enumerate(batch):
            req.position += 1
            tok = req.sampling.sample(logits[i], req._rng)
            emitted.append((req.request_id, int(tok)))
            self._emit(req, tok)
        self._counters["decode_steps"] += 1
        return emitted, len(batch)

    def _emit(self, req: Request, tok: int):
        """Account one generated token; applies the finish conditions."""
        req.tokens.append(int(tok))
        self._counters["tokens_generated"] += 1
        now = self._clock()
        if req.t_first_token is None:
            req.t_first_token = now
            self._hist_ttft_ms.add((now - req.t_submit) * 1e3)
        elif req._t_prev_token is not None:
            self._hist_itl_ms.add((now - req._t_prev_token) * 1e3)
        req._t_prev_token = now
        eos = req.sampling.eos_token_id
        if eos is not None and tok == eos:
            self.running.remove(req)
            self._finish(req, FINISHED, "eos")
            self._counters["finished"] += 1
        elif len(req.tokens) >= req.sampling.max_new_tokens:
            self.running.remove(req)
            self._finish(req, FINISHED, "max_new_tokens")
            self._counters["finished"] += 1

    def step(self) -> Dict[str, Any]:
        """One engine step: expire timeouts, admit waiting requests into
        free batch slots and pool space, run one chunk of each
        PREFILLING request, then one decode dispatch (a speculative
        round with a draft) over the running batch."""
        self._check_timeouts()
        done_before = self._counters["prefills"]
        while len(self.running) + len(self.prefilling) < self.max_batch:
            cand = self.waiting.next_candidate()
            if cand is None or not self._admit_one(cand):
                break
            self.waiting.grant(cand)
        # one chunk per PREFILLING request per step: a long prompt
        # advances chunk by chunk while the running batch keeps decoding
        for req in list(self.prefilling):
            self._prefill_chunk_one(req)
        prefills = self._counters["prefills"] - done_before
        emitted: List[Tuple[str, int]] = []
        decode_batch = 0
        if self.running and self.spec is not None:
            emitted, decode_batch = self._spec_round()
        elif self.running and self.device_loop:
            emitted, decode_batch = self._device_decode_window()
        elif self.running:
            emitted, decode_batch = self._host_decode()
        self._step_i += 1
        util = self.pool.utilization()
        self._util_peak = max(self._util_peak, util)
        self._util_sum += util
        self._util_n += 1
        flightrec.record("serving_step", step=self._step_i,
                         prefills=prefills, decode_batch=decode_batch,
                         tokens=len(emitted) + prefills,
                         running=len(self.running),
                         waiting=len(self.waiting), utilization=util)
        return {"step": self._step_i, "prefills": prefills,
                "decode_batch": decode_batch, "emitted": emitted,
                "running": len(self.running), "waiting": len(self.waiting),
                "prefilling": len(self.prefilling), "utilization": util}

    def run_until_idle(self, max_steps: int = 100000) -> List[Request]:
        """Step until nothing is waiting or running; returns the terminal
        requests. Raises RuntimeError if max_steps elapse first."""
        for _ in range(max_steps):
            if (not self.waiting and not self.running
                    and not self.prefilling):
                break
            self.step()
        else:
            raise RuntimeError(
                f"run_until_idle: still {len(self.waiting)} waiting / "
                f"{len(self.running)} running / "
                f"{len(self.prefilling)} prefilling after {max_steps} steps")
        return [r for r in self.requests.values()
                if r.state in (FINISHED, TIMED_OUT, REJECTED)]

    # -- introspection ----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        live = [r.request_id for r in self.running + self.prefilling]
        cached = self.prefix.blocks() if self.prefix is not None else ()
        out = {
            "steps": self._step_i, **self._counters,
            "pool": self.pool.stats(),
            "leaked_blocks": self.pool.leaked_blocks(live_owners=live,
                                                     cached=cached),
            "utilization_peak": self._util_peak,
            "utilization_mean": (self._util_sum / self._util_n
                                 if self._util_n else 0.0),
            "ttft_ms": self._hist_ttft_ms.summary(),
            "inter_token_ms": self._hist_itl_ms.summary(),
        }
        if self.prefix is not None:
            out["prefix_cache"] = self.prefix.stats()
        if self.draft_pool is not None:
            out["draft_pool"] = self.draft_pool.stats()
            out["draft_leaked_blocks"] = self.draft_pool.leaked_blocks(
                live_owners=live)
        return out
