"""paddle.distributed.ps: parameter-server training for sparse models.
reference: paddle_tpu/distributed/ps/__init__.py.

- the row store is native C++ (csrc/ps_table.cc, the reference's) behind
  ctypes, striped hash shards with per-row optimizer state; the rules are
  the accessor's (accessor.py: naive/adagrad/adam, the CTR decay/shrink
  policy and the entry gates);
- the transport is the port's RPC over its TCPStore, with an in-process
  channel (service.py);
- workers pull and push deduplicated rows (embedding.py: PsEmbedding for
  eager steps, PsBatch for fixed-shape ones); geo-async SGD is a local
  shadow table pushing weight deltas (service.GeoWorkerCache);
- dense parameters stay on the card: the PS carries the sparse embedding
  rows that exceed device memory.
"""

from .accessor import (CountFilterEntry, CtrAccessor, ProbabilityEntry,
                       ShowClickEntry, SparseAdaGradRule, SparseAdamRule,
                       SparseNaiveSGDRule)
from .embedding import PsBatch, PsEmbedding, ps_sparse_embedding
from .service import (GeoWorkerCache, LocalChannel, PsClient, PsServer,
                      RpcChannel, TableConfig, serve_tables)
from .table import DenseTable, SparseTable
from .the_one_ps import TheOnePs, from_env

__all__ = [
    "CountFilterEntry", "ProbabilityEntry", "ShowClickEntry",
    "CtrAccessor", "SparseAdaGradRule", "SparseAdamRule",
    "SparseNaiveSGDRule", "PsBatch", "PsEmbedding", "ps_sparse_embedding",
    "GeoWorkerCache", "LocalChannel", "PsClient", "PsServer", "RpcChannel",
    "TableConfig", "serve_tables", "DenseTable", "SparseTable", "TheOnePs",
    "from_env",
]
