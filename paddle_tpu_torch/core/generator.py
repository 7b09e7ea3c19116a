"""The framework's stateful random generator.

Counterpart: ``paddle_tpu/core/generator.py``: ``Generator`` (:27-69),
``default_generator`` and ``seed`` (:72-80), ``get_rng_state`` /
``set_rng_state`` (:92-100). The state is a threefry key, the pair of
uint32 words ``jax.random.PRNGKey(seed)`` holds, and ``split_key``
advances it as ``jax.random.split`` does (the state becomes the hash of
the counter pair (0, 0), the returned key that of (0, 1)), so the keys a
seed yields are the reference's, key for key.

The reference keeps its state in a device tensor so that a compiled
step can thread it through the graph. The port runs eagerly: the state
is two Python ints on the host and a split is four threefry hashes in
Python (``nn/functional/sampling.py``), with no device work and no
synchronisation. The dropout kernels take the returned pair by value;
the dense routes build their mask from it on the tensor's device.
The reference's recompute snapshots of every live generator
(``all_state_tensors``) belong to fleet recompute and are not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..nn.functional.sampling import threefry2x32

__all__ = ["Generator", "default_generator", "get_rng_state", "seed",
           "set_rng_state"]

_M32 = 0xFFFFFFFF
Key = Tuple[int, int]


def _key_of(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``'s words: the 64-bit seed's high and low
    halves."""
    s = int(seed)
    return (s >> 32) & _M32, s & _M32


class Generator:
    def __init__(self, seed: int = 0):
        self.manual_seed(seed)

    def manual_seed(self, seed: int):
        self._seed = int(seed)
        self._key = _key_of(self._seed)
        return self

    seed = manual_seed

    def initial_seed(self) -> int:
        return self._seed

    def get_state(self) -> torch.Tensor:
        """The key's two uint32 words as an int64 CPU tensor [2]."""
        return torch.tensor(self._key, dtype=torch.int64)

    def set_state(self, state):
        """Take a key: two uint32 words (a tensor, array or sequence;
        int32 views of the words are taken modulo 2^32)."""
        words = [int(w) & _M32 for w in torch.as_tensor(state).reshape(-1)]
        if len(words) != 2:
            raise ValueError(f"a generator state is two uint32 words, got "
                             f"{len(words)}")
        self._key = (words[0], words[1])

    def split_key(self) -> Key:
        """Advance the state; return a fresh subkey, two uint32 words."""
        k1, k2 = self._key
        self._key = threefry2x32(k1, k2, 0, 0)
        return threefry2x32(k1, k2, 0, 1)


default_generator = Generator(0)


def seed(s: int):
    """``paddle.seed``: reseed the default generator."""
    default_generator.manual_seed(s)
    return default_generator


def get_rng_state():
    return [default_generator.get_state()]


def set_rng_state(states):
    if isinstance(states, (list, tuple)):
        default_generator.set_state(states[0])
    else:
        default_generator.set_state(states)
