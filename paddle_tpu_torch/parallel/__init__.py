"""paddle_tpu_torch.parallel. reference: paddle_tpu/parallel/__init__.py,
of which the functional helpers are ported (:13); the mesh engine (spmd,
pipeline, moe) waits for the distributed slice."""

from .functional import functional_call, make_loss_fn  # noqa: F401

__all__ = ["functional_call", "make_loss_fn"]
