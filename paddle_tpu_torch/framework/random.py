"""Seeding. reference: paddle_tpu/framework/random.py (`seed`).

`seed(n)` restarts one `torch.Generator` per device from `n`. Initializers
and sampling take that generator explicitly. The draws are torch's own and
do not reproduce the JAX package's bits: parity tests copy weights across
instead of re-seeding.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["seed", "get_generator", "generator_scope"]

_SEED = [0]
_GENERATORS: dict = {}


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(s: int) -> None:
    """Restart every device's generator from `s`."""
    _SEED[0] = int(s)
    _GENERATORS.clear()


def get_generator(device) -> torch.Generator:
    """The generator of `device`, created from the current seed on first use;
    None on the meta device, where nothing is drawn."""
    dev = _key(device)
    if dev.type == "meta":
        return None
    gen = _GENERATORS.get(dev)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(_SEED[0])
        _GENERATORS[dev] = gen
    return gen


@contextlib.contextmanager
def generator_scope(key):
    """Draw from `key` inside the block: an int restarts every device's
    generator from it (as `seed` would), a torch.Generator stands in for
    its own device's. The generators in use before come back after it.
    The port's counterpart of the reference's rng-key trace scope."""
    saved = dict(_GENERATORS), _SEED[0]
    if isinstance(key, torch.Generator):
        _GENERATORS[_key(key.device)] = key
    else:
        seed(key)
    try:
        yield
    finally:
        _GENERATORS.clear()
        _GENERATORS.update(saved[0])
        _SEED[0] = saved[1]
