"""paddle_tpu_torch.parallel. reference: paddle_tpu/parallel/__init__.py:
the functional helpers and the mesh trainer (`spmd`). The pipeline and MoE
engines (`pipeline`, `llama_pipeline`, `moe`) are ROADMAP Queue 1's."""

from .functional import functional_call, make_loss_fn  # noqa: F401
from .spmd import (  # noqa: F401
    DP_ONLY_RULES, GPT_SHARDING_RULES, LLAMA_SHARDING_RULES, SpmdTrainer,
    create_mesh, shard_params_by_rules)

__all__ = ["functional_call", "make_loss_fn", "create_mesh", "SpmdTrainer",
           "shard_params_by_rules", "LLAMA_SHARDING_RULES",
           "GPT_SHARDING_RULES", "DP_ONLY_RULES"]
