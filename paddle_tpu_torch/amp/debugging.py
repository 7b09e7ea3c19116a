"""AMP debugging: the tensor checker, ``check_numerics``, the operator
statistics.

Counterpart: ``paddle_tpu/amp/debugging.py``: ``DebugMode``,
``TensorCheckerConfig`` (every field acts or raises, :79-154), the
batched ``_EagerNanChecker`` (:155-302), ``advance_step``,
``flush_eager_checks``, ``eager_checker_stats``,
``enable_tensor_checker`` / ``disable_tensor_checker``,
``check_numerics``, ``collect_operator_stats`` and ``compare_accuracy``
(which raises, as the reference's does).

Two rules govern the checker, as in the reference:

1. No silent knobs: every ``TensorCheckerConfig`` field acts
   (``checked_op_list``, ``skipped_op_list``, ``debug_step``,
   ``output_dir``, ``stack_height_limit``) or is refused when the config
   is made.
2. Never read the device per tensor: with ``FLAGS_check_nan_inf`` on,
   ``core/dispatch.py`` hands every registered op's outputs (the kernels'
   ops among them) to the checker, which counts their non-finite values
   on the device into one accumulator and reads it once per
   ``FLAGS_check_nan_inf_flush`` ops. A clean window costs that one read;
   only a dirty window reads each pending op's count, to name the ops
   that saw the values. ``check_numerics`` reads one packed health
   vector (``profiler/numerics.py``).

``debug_step`` counts optimizer steps: ``GradScaler.update()`` and
``advance_step()`` advance it. Alarms go to the flight recorder as
``numerics_alarm`` records (``profiler/flightrec.py``).
"""
from __future__ import annotations

import os
import threading
import traceback
from contextlib import contextmanager
from enum import Enum

import torch

from ..core import dispatch
from ..core.flags import get_flag, set_flags
from ..core.tensor import to_plain, wrap
from ..profiler import flightrec, numerics

__all__ = [
    "DebugMode", "TensorCheckerConfig", "enable_tensor_checker",
    "disable_tensor_checker", "check_numerics", "collect_operator_stats",
    "compare_accuracy", "advance_step", "flush_eager_checks",
    "eager_checker_stats",
]


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0   # raise FloatingPointError on nan/inf
    CHECK_NAN_INF = 1             # record + report, keep running
    CHECK_ALL_FOR_OVERFLOW = 2    # + underflow stats for fp16/bf16 outputs
    CHECK_ALL = 3                 # + underflow stats for every float output


_LOW_PRECISION = (torch.float16, torch.bfloat16)
_MAX_STACK_HEIGHT = 64
_MAX_PENDING = 512


def _op_name_list(value, field):
    if value is None:
        return frozenset()
    if isinstance(value, str) or not hasattr(value, "__iter__"):
        raise TypeError(
            f"TensorCheckerConfig.{field} must be an iterable of op-name "
            f"strings or None, got {value!r}")
    out = []
    for item in value:
        if not isinstance(item, str):
            raise TypeError(
                f"TensorCheckerConfig.{field} must contain only op-name "
                f"strings, got {item!r}")
        out.append(item)
    return frozenset(out)


class TensorCheckerConfig:
    """Checker configuration — every field honored, none silently eaten.

    - ``enable``: master switch (bool).
    - ``debug_mode``: DebugMode; ABORT raises on the flush that observes
      nan/inf, the other three record ``numerics_alarm`` flightrec
      evidence and keep running (overflow/all additionally accumulate
      underflow-to-zero counts, visible in ``eager_checker_stats()``).
    - ``output_dir``: directory that receives one JSON dump per alarm
      (``numerics_dump_<pid>_<n>.json``); created at enable time.
    - ``checked_op_list``: only these op names are checked (empty = all).
    - ``skipped_op_list``: these op names are never checked.
    - ``debug_step``: ``(start, end)`` optimizer-step half-open range in
      which checking is active; the counter advances on
      ``GradScaler.update()`` / ``advance_step()``.
    - ``stack_height_limit``: host stack frames captured into each alarm
      record (0 disables capture; max 64).
    """

    def __init__(self, enable, debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1):
        if not isinstance(enable, bool):
            raise TypeError(
                f"TensorCheckerConfig.enable must be a bool, got "
                f"{enable!r}")
        if not isinstance(debug_mode, DebugMode):
            raise TypeError(
                f"TensorCheckerConfig.debug_mode must be a DebugMode, got "
                f"{debug_mode!r}")
        if output_dir is not None and not isinstance(output_dir, str):
            raise TypeError(
                f"TensorCheckerConfig.output_dir must be a str path or "
                f"None, got {output_dir!r}")
        if debug_step is not None:
            try:
                start, end = debug_step
            except (TypeError, ValueError):
                raise ValueError(
                    f"TensorCheckerConfig.debug_step must be a (start, end) "
                    f"pair, got {debug_step!r}") from None
            if not (isinstance(start, int) and isinstance(end, int)
                    and 0 <= start < end):
                raise ValueError(
                    f"TensorCheckerConfig.debug_step must satisfy "
                    f"0 <= start < end, got {debug_step!r}")
            debug_step = (start, end)
        if (not isinstance(stack_height_limit, int)
                or isinstance(stack_height_limit, bool)
                or not 0 <= stack_height_limit <= _MAX_STACK_HEIGHT):
            raise ValueError(
                f"TensorCheckerConfig.stack_height_limit must be an int in "
                f"[0, {_MAX_STACK_HEIGHT}], got {stack_height_limit!r}")
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = _op_name_list(checked_op_list,
                                             "checked_op_list")
        self.skipped_op_list = _op_name_list(skipped_op_list,
                                             "skipped_op_list")
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit

    def _step_active(self, step):
        if self.debug_step is None:
            return True
        return self.debug_step[0] <= step < self.debug_step[1]

    def _op_wanted(self, op_name):
        if op_name in self.skipped_op_list:
            return False
        if self.checked_op_list and op_name not in self.checked_op_list:
            return False
        return True


class _EagerNanChecker:
    """The batched FLAGS_check_nan_inf dispatch hook.

    Per checked op: device-side ``sum(~isfinite)`` folded into one scalar
    accumulator plus a bounded pending list for attribution. Host sync
    happens ONCE per FLAGS_check_nan_inf_flush ops — on a clean window
    that one read is the entire cost; only a dirty window (rare) pays
    per-op attribution reads.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._acc = None
        self._under_acc = None
        self._pending = []
        self._ops_in_window = 0
        self.ops_checked = 0
        self.syncs = 0
        self.windows = 0
        self.alarms = 0
        self.underflow = 0
        self.dumps = 0

    def on_op(self, op_name, values):
        """Fold one op's non-finite count into the window (no read)."""
        cfg = _CHECKER_CONFIG
        if cfg is not None:
            if not (cfg._step_active(_STEP[0]) and cfg._op_wanted(op_name)):
                return
        mode = cfg.debug_mode if cfg is not None else None
        want_under = mode in (DebugMode.CHECK_ALL,
                              DebugMode.CHECK_ALL_FOR_OVERFLOW)
        bad = None
        under = None
        for v in values:
            if not isinstance(v, torch.Tensor) or not v.is_floating_point():
                continue
            finite = torch.isfinite(v)
            nb = v.numel() - finite.sum()
            bad = nb if bad is None else bad + nb
            if want_under and v.dtype in _LOW_PRECISION:
                tiny = torch.finfo(v.dtype).tiny
                nu = ((v != 0) & (v.abs() < tiny) & finite).sum()
                under = nu if under is None else under + nu
        if bad is None:
            return
        with self._lock:
            self.ops_checked += 1
            self._acc = bad if self._acc is None else self._acc + bad
            if under is not None:
                self._under_acc = (under if self._under_acc is None
                                   else self._under_acc + under)
            self._pending.append((op_name, bad))
            if len(self._pending) > _MAX_PENDING:
                del self._pending[:len(self._pending) - _MAX_PENDING]
            self._ops_in_window += 1
            due = self._ops_in_window >= max(
                1, int(get_flag("check_nan_inf_flush")))
        if due:
            self.flush()

    def flush(self):
        """Sync the window accumulator (ONE device read); act on badness."""
        with self._lock:
            acc, under_acc = self._acc, self._under_acc
            pending = self._pending
            self._acc = None
            self._under_acc = None
            self._pending = []
            self._ops_in_window = 0
        if acc is None:
            return 0
        total = int(acc)  # the one read for the whole window
        with self._lock:
            self.syncs += 1
            self.windows += 1
            if under_acc is not None:
                self.underflow += int(under_acc)
        if not total:
            return 0
        # Dirty window — rare path; per-op reads for attribution are fine.
        culprits = [(name, int(b)) for name, b in pending]
        culprits = [(n, c) for n, c in culprits if c > 0]
        self._alarm(total, culprits)
        return total

    def _alarm(self, total, culprits):
        cfg = _CHECKER_CONFIG
        with self._lock:
            self.alarms += 1
        stack = []
        limit = cfg.stack_height_limit if cfg is not None else 0
        if limit:
            frames = traceback.extract_stack()[:-3]
            stack = [f"{f.filename}:{f.lineno} {f.name}"
                     for f in frames[-limit:]]
        rec = dict(source="eager_checker", bad=total,
                   ops=[n for n, _ in culprits],
                   counts=[c for _, c in culprits])
        if stack:
            rec["stack"] = stack
        flightrec.record("numerics_alarm", **rec)
        if cfg is not None and cfg.output_dir:
            import json
            with self._lock:
                self.dumps += 1
                seq = self.dumps
            path = os.path.join(cfg.output_dir,
                                f"numerics_dump_{os.getpid()}_{seq}.json")
            with open(path, "w") as f:
                json.dump({"kind": "numerics_alarm", **rec}, f, indent=1)
        detail = ", ".join(f"{n} ({c})" for n, c in culprits) or "unattributed"
        msg = (f"eager nan/inf checker: {total} non-finite output values in "
               f"the last flush window; culprit ops: {detail} "
               f"(FLAGS_check_nan_inf)")
        abort = (cfg.debug_mode is DebugMode.CHECK_NAN_INF_AND_ABORT
                 if cfg is not None
                 else int(get_flag("check_nan_inf_level")) == 0)
        if abort:
            raise FloatingPointError(msg)
        print(msg)

    def stats(self):
        with self._lock:
            return {"ops_checked": self.ops_checked, "syncs": self.syncs,
                    "windows": self.windows, "alarms": self.alarms,
                    "underflow": self.underflow, "dumps": self.dumps,
                    "pending_ops": len(self._pending)}

    def reset(self):
        with self._lock:
            self._acc = None
            self._under_acc = None
            self._pending = []
            self._ops_in_window = 0
            self.ops_checked = self.syncs = self.windows = 0
            self.alarms = self.underflow = self.dumps = 0


_BUCKETS = {"torch.float16": "fp16", "torch.bfloat16": "bf16",
            "torch.float32": "fp32"}

_CHECKER = _EagerNanChecker()
_CHECKER_CONFIG = None
_STEP = [0]


def advance_step():
    """Advance the optimizer-step counter TensorCheckerConfig.debug_step
    filters on. Called by GradScaler.update(); call directly in loops
    that don't use a scaler. Flushes the checker window at the step
    boundary so an alarm is attributed to the step that produced it."""
    _STEP[0] += 1
    if get_flag("check_nan_inf"):
        _CHECKER.flush()


def flush_eager_checks():
    """Force the batched checker's window sync now (ONE device read)."""
    return _CHECKER.flush()


def eager_checker_stats():
    return _CHECKER.stats()


def enable_tensor_checker(checker_config):
    """Arm the batched eager checker from a TensorCheckerConfig."""
    global _CHECKER_CONFIG
    if not isinstance(checker_config, TensorCheckerConfig):
        raise TypeError(
            f"enable_tensor_checker expects a TensorCheckerConfig, got "
            f"{checker_config!r}")
    if not checker_config.enable:
        raise ValueError(
            "enable_tensor_checker: checker_config.enable is False — "
            "refusing to arm a disabled config (pass enable=True, or use "
            "disable_tensor_checker() to turn checking off)")
    if checker_config.output_dir:
        os.makedirs(checker_config.output_dir, exist_ok=True)
    _CHECKER.reset()
    _CHECKER_CONFIG = checker_config
    abort = checker_config.debug_mode is DebugMode.CHECK_NAN_INF_AND_ABORT
    set_flags({"check_nan_inf": True,
               "check_nan_inf_level": 0 if abort else 3})


def disable_tensor_checker():
    global _CHECKER_CONFIG
    if get_flag("check_nan_inf"):
        _CHECKER.flush()  # don't drop a half-window of evidence
    _CHECKER_CONFIG = None
    set_flags({"check_nan_inf": False})


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """Check one tensor with one packed device read (nan, inf, max-abs,
    l2, underflow). A hit records a ``numerics_alarm``, then raises
    FloatingPointError or prints, by ``debug_mode`` (default: the armed
    checker's mode, else ``FLAGS_check_nan_inf_level``). Returns
    ``(num_nan, num_inf)`` as int64 tensors."""
    if debug_mode is not None and not isinstance(debug_mode, DebugMode):
        raise TypeError(
            f"check_numerics debug_mode must be a DebugMode or None, got "
            f"{debug_mode!r}")
    v = to_plain(tensor) if isinstance(tensor, torch.Tensor) \
        else torch.as_tensor(tensor)
    vec = numerics.health_vector(v.detach()).tolist()  # ONE device read
    n_nan, n_inf = int(vec[0]), int(vec[1])
    if n_nan or n_inf:
        flightrec.record("numerics_alarm", source="check_numerics",
                         op=op_type or None, tensor=var_name or None,
                         nan=n_nan, inf=n_inf, max_abs=float(vec[2]),
                         l2=float(vec[3]))
        mode = debug_mode
        if mode is None and _CHECKER_CONFIG is not None:
            mode = _CHECKER_CONFIG.debug_mode
        if mode is None:
            mode = (DebugMode.CHECK_NAN_INF_AND_ABORT
                    if int(get_flag("check_nan_inf_level")) == 0
                    else DebugMode.CHECK_NAN_INF)
        msg = (f"check_numerics: {op_type or '<tensor>'}"
               f"{'/' + var_name if var_name else ''} has {n_nan} NaN and "
               f"{n_inf} Inf values (max_abs={float(vec[2]):.6g}, "
               f"l2={float(vec[3]):.6g})")
        if mode is DebugMode.CHECK_NAN_INF_AND_ABORT:
            raise FloatingPointError(msg)
        print(msg)
    return (wrap(torch.tensor(n_nan, dtype=torch.int64)),
            wrap(torch.tensor(n_inf, dtype=torch.int64)))


@contextmanager
def collect_operator_stats():
    """Bucket dispatched ops by output dtype under the ``with`` block.

    Yields the live dict ``{op_name: {"fp16", "bf16", "fp32", "other",
    "calls"}}`` — each call lands in exactly one dtype bucket (its first
    output's dtype), the reference's low_precision_op_list analog. The
    dict stays valid after the block exits; a summary is printed when it
    exits."""
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


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    """Reference: diff two checker dump dirs into a workbook. Not built."""
    raise NotImplementedError(
        "compare_accuracy is not implemented yet. It will "
        "consume two directories of per-alarm JSON dumps as written by "
        "enable_tensor_checker(TensorCheckerConfig(output_dir=...)) — one "
        "file per alarm named numerics_dump_<pid>_<n>.json with keys "
        "{kind, source, bad, ops, counts, stack} — and emit a per-op "
        "accuracy diff table like the reference "
        "(python/paddle/amp/debugging.py compare_accuracy). The dump "
        "producer side exists; the diff/report side does not.")


# Install the batched checker as THE FLAGS_check_nan_inf dispatch path.
dispatch.set_nan_check_hook(_CHECKER.on_op)
