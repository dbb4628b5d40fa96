"""Fleet facade: hybrid parallelism over one ProcessMesh. reference:
paddle_tpu/distributed/fleet/__init__.py (after python/paddle/distributed/
fleet/: fleet.py:218 init, model.py:32 distributed_model, base/topology.py
HybridCommunicateGroup with the axis order pp→mp→sep→sharding→dp).

The rank grid is a ProcessMesh (distributed/placement.py) with named axes;
each communicator group is a mesh axis. As in the reference, one process
drives the whole mesh, so each axis rank is 0. The parameter-server mode
(`init(is_collective=False)`, `ps_tables`, `init_server`, `run_server`,
`init_worker`, `stop_worker`, `save_persistables`) runs over
distributed/ps's TheOnePs, as the reference's does.
"""

from __future__ import annotations

import os

import numpy as np

from ..parallel_env import get_rank, get_world_size
from ..placement import ProcessMesh

__all__ = ["init", "DistributedStrategy", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "distributed_model",
           "distributed_optimizer", "fleet", "worker_num", "worker_index",
           "is_first_worker", "CommunicateTopology"]

from . import meta_parallel  # noqa: F401,E402
from . import meta_optimizers  # noqa: F401,E402
from .utils import recompute  # noqa: F401,E402

class DistributedStrategy:
    """reference: fleet/base/distributed_strategy.py (proto-backed)."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sep_degree": 1, "sharding_degree": 1,
            "order": ["pp", "mp", "sep", "sharding", "dp"],
        }
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1}
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.find_unused_parameters = False


class CommunicateTopology:
    """reference: fleet/base/topology.py:CommunicateTopology."""

    def __init__(self, hybrid_group_names, dims):
        self._names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world_size = int(np.prod(dims))
        self._rank_grid = np.arange(self._world_size).reshape(dims)

    def get_hybrid_group_names(self):
        return self._names

    def get_dim(self, name):
        return self._dims[self._names.index(name)]

    def world_size(self):
        return self._world_size

    def get_rank(self, **kwargs):
        idx = tuple(kwargs[n] for n in self._names)
        return int(self._rank_grid[idx])

    def get_coord(self, rank):
        return np.unravel_index(rank, self._dims)

    def get_axis_list(self, axis_name, index):
        ax = self._names.index(axis_name)
        return np.take(self._rank_grid, index, axis=ax).reshape(-1).tolist()

    def get_comm_list(self, axis_name):
        ax = self._names.index(axis_name)
        moved = np.moveaxis(self._rank_grid, ax, -1)
        return moved.reshape(-1, self._dims[ax]).tolist()


class HybridCommunicateGroup:
    """reference: fleet/base/topology.py:189. Its `mesh` is a ProcessMesh
    over the topology's ranks, on `device` (the port's default if None);
    each group carries its mesh axis name."""

    def __init__(self, topology: CommunicateTopology, *, device=None):
        self._topo = topology
        names = topology.get_hybrid_group_names()
        dims = [topology.get_dim(n) for n in names]
        self._dims = dict(zip(names, dims))
        self._mesh = ProcessMesh(np.arange(int(np.prod(dims))).reshape(dims),
                                 names, device=device)
        self._rank = 0  # one process drives the whole mesh

        from ..parallel_env import new_group
        self._groups = {}
        for name in names:
            g = new_group(list(range(self._dims[name])))
            g.axis_name = name
            self._groups[name] = g

    @property
    def mesh(self):
        return self._mesh

    def get_mesh(self):
        return self._mesh

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self._rank

    def get_rank_from_stage(self, stage_id, **kwargs):
        return stage_id

    # -- degrees ------------------------------------------------------------
    def get_data_parallel_world_size(self):
        return self._dims.get("dp", 1)

    def get_model_parallel_world_size(self):
        return self._dims.get("mp", 1)

    def get_pipe_parallel_world_size(self):
        return self._dims.get("pp", 1)

    def get_sep_parallel_world_size(self):
        return self._dims.get("sep", 1)

    def get_sharding_parallel_world_size(self):
        return self._dims.get("sharding", 1)

    # -- ranks (one process: rank 0 of each axis) ---------------------------
    def get_data_parallel_rank(self):
        return 0

    def get_model_parallel_rank(self):
        return 0

    def get_stage_id(self):
        return 0

    def get_sep_parallel_rank(self):
        return 0

    def get_sharding_parallel_rank(self):
        return 0

    # -- groups -------------------------------------------------------------
    def get_data_parallel_group(self):
        return self._groups.get("dp")

    def get_model_parallel_group(self):
        return self._groups.get("mp")

    def get_pipe_parallel_group(self):
        return self._groups.get("pp")

    def get_sep_parallel_group(self):
        return self._groups.get("sep")

    def get_sharding_parallel_group(self):
        return self._groups.get("sharding")

    def get_check_parallel_group(self, *a):
        return self._groups.get("mp")

    def get_data_parallel_group_src_rank(self):
        return 0

    def get_model_parallel_group_src_rank(self):
        return 0

    def get_p2p_groups(self):
        return None


_hcg = None
_strategy = None


def get_hybrid_communicate_group():
    return _hcg


class _Fleet:
    _role_maker = None
    _ps_engine = None

    def init(self, role_maker=None, is_collective=False, strategy=None,
             log_level="INFO", *, device=None):
        """Collective mode: the hybrid group of `strategy`'s
        hybrid_configs, its mesh on `device` (the port's default if None).
        With is_collective=False (or a PS role maker), PS mode: the role
        maker from the environment and no mesh; the tables come from
        `ps_tables`."""
        global _hcg, _strategy
        if role_maker is None and not is_collective:
            role_maker = PaddleCloudRoleMaker(is_collective=False)
        if role_maker is not None and not getattr(role_maker, "_collective",
                                                  True):
            self._role_maker = role_maker
            _strategy = strategy or DistributedStrategy()
            return self
        self._role_maker = role_maker
        from ..parallel_env import init_parallel_env
        init_parallel_env()
        _strategy = strategy or DistributedStrategy()
        cfg = _strategy.hybrid_configs
        order = cfg.get("order", ["pp", "mp", "sep", "sharding", "dp"])
        name_map = {"pp": "pp_degree", "mp": "mp_degree", "dp": "dp_degree",
                    "sep": "sep_degree", "sharding": "sharding_degree"}
        dims = [max(int(cfg.get(name_map[n], 1) or 1), 1) for n in order]
        _hcg = HybridCommunicateGroup(CommunicateTopology(order, dims),
                                      device=device)
        return self

    @property
    def worker_num(self):
        return get_world_size()

    def worker_index(self):
        return get_rank()

    def is_first_worker(self):
        return self.worker_index() == 0

    def barrier_worker(self):
        from ..parallel_env import barrier
        barrier()

    def distributed_model(self, model):
        """reference: fleet/model.py:32 — wrap by topology."""
        if _hcg is None:
            self.init(is_collective=True)
        from .meta_parallel import PipelineParallel, TensorParallel
        from .meta_parallel.pp_layers import PipelineLayer
        if _hcg.get_pipe_parallel_world_size() > 1 and \
                isinstance(model, PipelineLayer):
            return PipelineParallel(model, _hcg, _strategy)
        if _hcg.get_model_parallel_world_size() > 1:
            return TensorParallel(model, _hcg, _strategy)
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        """reference: fleet/fleet.py:1427."""
        from .meta_optimizers import HybridParallelOptimizer
        if _hcg is None:
            self.init(is_collective=True)
        return HybridParallelOptimizer(optimizer, _hcg, _strategy)

    def get_hybrid_communicate_group(self):
        return _hcg

    # -- the parameter-server lifecycle (reference fleet.py init_server/
    # run_server/init_worker/stop_worker; the runtime is ps.TheOnePs) -------
    def ps_tables(self, *table_configs):
        """Declare PS mode's sparse tables (TableConfigs)."""
        from ..ps import the_one_ps
        self._ps_engine = the_one_ps.from_env(list(table_configs))
        return self._ps_engine

    def init_server(self, dirname=None, **kwargs):
        """Start this process's server shard (every shard in-process for
        one server or no role maker), loading `dirname` if given."""
        eng = self._ps_engine
        if eng is None:
            raise RuntimeError("fleet.init_server: declare tables first "
                               "via fleet.ps_tables(*TableConfigs)")
        if eng.num_servers <= 1 or self._role_maker is None:
            eng.start_local()
        else:
            sid = self._role_maker.worker_index() \
                if self._role_maker.is_server() else 0
            eng.start_server(sid)
        if dirname:
            eng.load(dirname)
        return eng

    def run_server(self):
        """Serve until stop_worker (the RPC threads answer requests)."""
        if self._ps_engine is None:
            raise RuntimeError("fleet.run_server before init_server")
        self._ps_engine.run_server()

    def init_worker(self, scopes=None):
        """The trainer's PsClient: to the in-process server, or over RPC
        to the server processes named ps_server_<i>."""
        eng = self._ps_engine
        if eng is None:
            raise RuntimeError("fleet.init_worker: declare tables first "
                               "via fleet.ps_tables(*TableConfigs)")
        if eng.client is None:
            if eng.num_servers <= 1:
                if eng.servers:
                    from ..ps.service import LocalChannel, PsClient
                    eng.client = PsClient([LocalChannel(eng.servers[0])])
                else:
                    eng.start_local()
            else:
                from ..ps.the_one_ps import server_name
                eng.connect([server_name(i)
                             for i in range(eng.num_servers)])
        return eng.client

    def stop_worker(self):
        if self._ps_engine is not None:
            self._ps_engine.stop()

    def save_persistables(self, executor=None, dirname=None,
                          main_program=None, mode=0):
        """Save every table to `dirname` (the native checkpoint format)."""
        if self._ps_engine is not None and dirname:
            self._ps_engine.save(dirname)


fleet = _Fleet()
Fleet = _Fleet  # reference exports the class too
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
worker_num = lambda: fleet.worker_num  # noqa: E731
worker_index = fleet.worker_index
is_first_worker = fleet.is_first_worker
from . import elastic  # noqa: F401,E402


class Role:
    """reference: fleet/base/role_maker.py Role enum."""
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class UtilBase:
    """reference: fleet/utils/fleet_util.py UtilBase — cross-worker
    helpers for one controlling process."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        return input  # the controller's world is 1

    def barrier(self, comm_world="worker"):
        return None

    def all_gather(self, input, comm_world="worker"):
        return [input]

    def get_file_shard(self, files):
        return list(files)

    def print_on_rank(self, message, rank_id=0):
        if get_rank() == rank_id:
            print(message)


class PaddleCloudRoleMaker:
    """reference: fleet/base/role_maker.py PaddleCloudRoleMaker — reads the
    cluster layout from the environment (TRAINING_ROLE and
    PADDLE_PSERVERS_IP_PORT_LIST in PS mode)."""

    def __init__(self, is_collective=True, **kwargs):
        self._collective = bool(is_collective)
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._role = Role.WORKER
        if not self._collective:
            training_role = os.environ.get("TRAINING_ROLE", "TRAINER")
            if training_role.upper() in ("PSERVER", "SERVER"):
                self._role = Role.SERVER
                self._rank = int(os.environ.get(
                    "PADDLE_PSERVER_ID",
                    os.environ.get("PADDLE_TRAINER_ID", "0")))
            eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
            self._server_endpoints = [e for e in eps.split(",") if e]
        else:
            self._server_endpoints = []

    def worker_index(self):
        return self._rank

    def worker_num(self):
        return self._size

    def server_num(self):
        return len(self._server_endpoints) or 1

    def get_pserver_endpoints(self):
        return list(self._server_endpoints)

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def role(self):
        return self._role


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, is_collective=True, current_id=0, worker_num=1,
                 role=Role.WORKER, server_endpoints=None, **kwargs):
        self._collective = bool(is_collective)
        self._rank = current_id
        self._size = worker_num
        self._role = role
        self._server_endpoints = list(server_endpoints or [])


from ..dataset import (  # noqa: E402,F401
    MultiSlotDataGenerator, MultiSlotStringDataGenerator)
