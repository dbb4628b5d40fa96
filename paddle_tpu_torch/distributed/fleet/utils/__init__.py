"""fleet.utils: recompute (activation checkpointing). reference:
paddle_tpu/distributed/fleet/utils/__init__.py, after fleet/recompute/
recompute.py:455.

`recompute` is `torch.utils.checkpoint` around the function: the backward
runs the forward again. With preserve_rng_state the port's generators are
set back to the state they had at the call before each run of the
function, forward and recompute alike, as the reference restores its key
(:29-30), so dropout draws the same masks twice.
"""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from ....framework.random import get_rng_state, set_rng_state

__all__ = ["recompute", "recompute_sequential"]


def recompute(function, *args, **kwargs):
    """`use_reentrant` is accepted; torch's non-reentrant checkpoint
    always runs."""
    preserve_rng_state = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", True)
    rng_snapshot = get_rng_state() if preserve_rng_state else None

    def run(*call_args):
        if rng_snapshot is not None:
            set_rng_state(rng_snapshot)
        return function(*call_args, **kwargs)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state)


def recompute_sequential(ctx, functions, *args, **kwargs):
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    funcs = list(functions)
    n = len(funcs)
    seg = max(n // max(segments, 1), 1)
    out = args[0] if len(args) == 1 else args

    def run_segment(fs):
        def seg_fn(x):
            for f in fs:
                x = f(x)
            return x
        return seg_fn

    for i in range(0, n, seg):
        out = recompute(run_segment(funcs[i:i + seg]), out)
    return out


from . import sequence_parallel_utils  # noqa: E402,F401
