"""Seeding. reference: paddle_tpu/framework/random.py (`seed`).

`seed(n)` restarts one `torch.Generator` per device from `n`. Initializers
and sampling take that generator explicitly. The draws are torch's own and
do not reproduce the JAX package's bits: parity tests copy weights across
instead of re-seeding.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["seed", "get_generator", "generator_scope", "get_rng_state",
           "set_rng_state", "get_cuda_rng_state", "set_cuda_rng_state"]

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


def get_rng_state(*, device=None):
    """paddle.get_rng_state: the seed and the torch state of every
    generator made so far (or of `device`'s alone), to hand back to
    `set_rng_state`. The reference's state is its key and counter
    (framework/random.py:104-109)."""
    devs = list(_GENERATORS) if device is None else [_key(device)]
    return {"seed": _SEED[0], "whole": device is None,
            "states": {d: get_generator(d).get_state() for d in devs}}


def set_rng_state(state) -> None:
    """Restore a `get_rng_state`: each generator it holds draws on from
    where it stood. A whole state also restarts every other generator
    from its seed, as `seed` would."""
    _SEED[0] = state["seed"]
    if state["whole"]:
        _GENERATORS.clear()
    for dev, st in state["states"].items():
        gen = torch.Generator(device=dev)
        gen.set_state(st)
        _GENERATORS[dev] = gen


def get_cuda_rng_state():
    """get_rng_state of the CUDA generators made so far."""
    return {"seed": _SEED[0], "whole": False,
            "states": {d: g.get_state() for d, g in _GENERATORS.items()
                       if d.type == "cuda"}}


set_cuda_rng_state = set_rng_state


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
