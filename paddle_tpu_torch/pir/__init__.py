"""paddle_tpu_torch.pir: the PIR-lite compiler layer. reference:
paddle_tpu/pir/ (after paddle/pir/: the Program/Operation/Value SSA IR,
pir::PassManager, DRR pattern rewriting, the PIR serialize layer).

* capture (`pir.capture`): `make_fx` on fake tensors lowers a torch
  function to a small SSA IR with stable canonical hashing; a
  data-dependent branch raises `GraphBreak`;
* the PassManager (`pir.passes`, `pir.patterns`, `pir.fuse`): ordered,
  flag-toggled, instrumented passes: constant folding, CSE, the DRR
  patterns that send dense attention to K1 (`pt.sdpa`) and its RMSNorm
  epilogue to K2 (`pt.sdpa_rms_epilogue`), cost-guided fusion and DCE,
  each held to the structural verifier (`pir.verifier`, mutation-tested
  by `pir.mutate`) and priced by `pir.analysis.CostModel`;
* the sharding passes (`pir.shard_search`, `pir.shard_prop`,
  `pir.overlap`): the cost-driven search over a bounded strategy space,
  GSPMD-style propagation of input annotations under
  `shard_prop.mesh_scope` (a `distributed.ProcessMesh`), and the
  collective-overlap scheduler over the `_c10d_functional` collectives
  (`ops/collectives.py`), priced on the CostModel's NVLink row;
* the compile cache (`pir.cache`, `pir.pipeline`): persistent,
  sha256-verified, LRU-capped artifacts of the rewritten program
  (`pir.serialize`), keyed by (canonical IR hash, sharding, flags, torch
  version, device).

`jit.to_static` and the serving engine compile through
`pipeline.compile_flat` (`pir_jit`).
"""

from .analysis import (DEFAULT_INTERCONNECT, DEFAULT_ROOFLINE, CostModel,
                       DataflowAnalysis,
                       FlatLattice, Lattice, Liveness, OpCost, ProgramCost,
                       ShapeDtypeInference, ShardingConsistency,
                       check_donation_safety, price)
from .cache import (CompileCache, CompileCacheCorruptionError, cache_key,
                    default_cache, stats_snapshot)
from .capture import GraphBreak, capture, effect_scope, from_graph_module
from .fuse import (FUSIBLE_ELEMENTWISE, FUSIBLE_LAYOUT, FUSIBLE_REDUCE,
                   FusionPass, FusionPassError)
from .ir import Operation, Program, Value
from .mutate import CORRUPTIONS, SkipCorruption, corrupt
from .overlap import CollectiveOverlap
from .passes import (CommonSubexprElimination, ConstantFolding,
                     DeadCodeElimination, Pass, PassManager, PassResult)
from .patterns import (PatternRewriter, RewritePattern, RmsEpiloguePattern,
                       SdpaRoutePattern)
from .pipeline import CompileReport, compile_flat, pir_jit
from .shard_prop import (ShardingPropagation, annotate_inputs,
                         current_mesh, match_partition_rules, mesh_scope)
from .shard_search import ShardingSearch
from .verifier import (EFFECT_SCOPES, RULES, IRVerificationError,
                       verify_mode, verify_program)

__all__ = [
    "Program", "Operation", "Value",
    "capture", "from_graph_module", "GraphBreak", "effect_scope",
    "Pass", "PassResult", "PassManager",
    "DeadCodeElimination", "ConstantFolding", "CommonSubexprElimination",
    "RewritePattern", "PatternRewriter", "SdpaRoutePattern",
    "RmsEpiloguePattern",
    "FusionPass", "FusionPassError", "FUSIBLE_ELEMENTWISE",
    "FUSIBLE_LAYOUT", "FUSIBLE_REDUCE",
    "CompileCache", "CompileCacheCorruptionError", "cache_key",
    "default_cache", "stats_snapshot",
    "CompileReport", "compile_flat", "pir_jit",
    "ShardingPropagation", "ShardingSearch", "CollectiveOverlap",
    "mesh_scope", "current_mesh", "annotate_inputs",
    "match_partition_rules",
    "RULES", "EFFECT_SCOPES", "IRVerificationError", "verify_program",
    "verify_mode",
    "DataflowAnalysis", "Lattice", "FlatLattice", "ShapeDtypeInference",
    "Liveness", "ShardingConsistency", "check_donation_safety",
    "CostModel", "OpCost", "ProgramCost", "DEFAULT_ROOFLINE",
    "DEFAULT_INTERCONNECT", "price",
    "CORRUPTIONS", "SkipCorruption", "corrupt",
]
