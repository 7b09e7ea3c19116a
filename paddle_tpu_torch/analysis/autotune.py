"""The tuning table's lookup, for the dropout masks' tile keys.

Counterpart: ``paddle_tpu/analysis/autotune.py``: the signatures
(``flash_sig`` :92, ``ln_sig`` :97, ``mlp_sig`` :105) and ``lookup``
(:282), over the entries of ``paddle_tpu/analysis/tuning_table.json``
that the block picks of the dropout kernels read (the families
``flash_attention``, ``fused_ln`` and ``fused_mlp``).

With ``FLAGS_kernel_tuning`` on (its default), the reference's block
picks (``_auto_blocks``, ``_auto_block_r``, ``mlp_blocks``) take a
table entry of the exact signature before their heuristics, and the
keep-mask of each element is keyed by the tile the pick gives. The port
keeps its own copy of those entries in ``TABLE`` and reads them for that
alone: the CUDA kernels' own tiles are the port's (ROADMAP's rule
against porting TPU tile winners), and the masks come out the
reference's whatever tile a kernel runs. The search, the other
families, the hit/miss statistics and ``FLAGS_tuning_table`` (another
table file) are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.flags import get_flag

__all__ = ["TABLE", "flash_sig", "ln_sig", "lookup", "mlp_sig"]

# family -> signature -> params, as tuning_table.json holds them
TABLE: Dict[str, Dict[str, Dict[str, int]]] = {
    "flash_attention": {
        "sq=2048,sk=2048,causal=1,dtype=bfloat16": {"block_k": 128,
                                                    "block_q": 256},
        "sq=512,sk=512,causal=0,dtype=bfloat16": {"block_k": 128,
                                                  "block_q": 128},
    },
    "fused_ln": {
        "r=1024,h=768,dtype=bfloat16": {"block_r": 1024},
        "r=4096,h=2048,dtype=bfloat16": {"block_r": 8},
    },
    "fused_mlp": {
        "r=1024,h=768,f=3072,dtype=bfloat16": {"block_f": 128,
                                               "block_r": 16},
        "r=4096,h=2048,f=8192,dtype=bfloat16": {"block_f": 128,
                                                "block_r": 32},
    },
}


def _dtype_name(dtype) -> str:
    """The signature's dtype token: None → "any", torch dtypes by numpy's
    name ("float32", "bfloat16")."""
    if dtype is None:
        return "any"
    if isinstance(dtype, str):
        return dtype
    return str(dtype).replace("torch.", "")


def flash_sig(sq: int, sk: int, causal, dtype=None) -> str:
    return (f"sq={int(sq)},sk={int(sk)},causal={int(bool(causal))},"
            f"dtype={_dtype_name(dtype)}")


def ln_sig(r: int, h: int, dtype=None) -> str:
    return f"r={int(r)},h={int(h)},dtype={_dtype_name(dtype)}"


def mlp_sig(r: int, h: int, f: int, dtype=None) -> str:
    return f"r={int(r)},h={int(h)},f={int(f)},dtype={_dtype_name(dtype)}"


def lookup(family: str, sig: str) -> Optional[Dict[str, int]]:
    """The entry's params for (family, sig), a copy; None on a miss or with
    ``FLAGS_kernel_tuning`` off."""
    if not get_flag("kernel_tuning"):
        return None
    if family not in TABLE:
        raise KeyError(f"autotune.lookup: unknown family {family!r} "
                       f"(known: {', '.join(TABLE)})")
    entry = TABLE[family].get(sig)
    return None if entry is None else dict(entry)

