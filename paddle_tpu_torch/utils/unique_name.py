"""Unique name generator. reference: paddle_tpu/utils/unique_name.py
(`generate`, `guard`, `switch`), itself after python/paddle/utils/
unique_name.py. The names are the reference's letter for letter
(`<key>_<n>`, n counted per key from 0): `static.nn`'s parameter names
come from here, and `convert.load_reference_program` matches them."""

from __future__ import annotations

import contextlib
from collections import defaultdict

__all__ = ["generate", "guard", "switch"]


class _Generator:
    def __init__(self):
        self.ids = defaultdict(int)

    def __call__(self, key):
        n = self.ids[key]
        self.ids[key] += 1
        return f"{key}_{n}"


_generator = _Generator()


def generate(key):
    return _generator(key)


def switch(new_generator=None):
    global _generator
    old = _generator
    _generator = new_generator or _Generator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    old = switch(new_generator)
    try:
        yield
    finally:
        global _generator
        _generator = old
