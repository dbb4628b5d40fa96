"""Seeding. reference: paddle_tpu/framework/random.py (`seed`).

`seed(n)` restarts one `torch.Generator` per device from `n`. Initializers
and sampling take that generator explicitly. The draws are torch's own and
do not reproduce the JAX package's bits: parity tests copy weights across
instead of re-seeding.
"""

from __future__ import annotations

import torch

__all__ = ["seed", "get_generator"]

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
