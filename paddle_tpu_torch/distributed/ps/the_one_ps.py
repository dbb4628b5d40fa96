"""TheOnePs: the parameter-server runtime. reference:
paddle_tpu/distributed/ps/the_one_ps.py (`server_name` :26, `TheOnePs`
:33, `from_env` :113), after python/paddle/distributed/ps/the_one_ps.py
and fleet's PS-mode lifecycle (init_server/run_server/init_worker/
stop_worker).

Tables are declared explicitly (TableConfig). The transport is in-process
(`start_local`: every server shard beside the trainer) or the RPC layer
to server processes (`start_server` on the servers after rpc.init_rpc,
`connect` on the trainers). Only sparse embedding rows ride this path; the
dense model trains on the card.
"""

from __future__ import annotations

import os
import threading

from .service import (LocalChannel, PsClient, PsServer, RpcChannel,
                      TableConfig, serve_tables)

__all__ = ["TheOnePs", "TableConfig"]


def server_name(server_id: int) -> str:
    """RPC worker name contract for PS server processes: a server process
    must call rpc.init_rpc(name=server_name(i)) so trainers can route to
    it (fleet.init_worker connects by these names)."""
    return f"ps_server_{server_id}"


class TheOnePs:
    """PS lifecycle engine.

    Local mode (default): `start_local()` creates all server shards
    in-process; `client` routes to them directly: the single-host
    topology, and each host's own shard where every host runs one beside
    its trainer.

    RPC mode: server processes call `start_server(server_id)` after
    rpc.init_rpc; trainer processes call `connect([server worker names])`.
    """

    def __init__(self, table_configs: list[TableConfig],
                 num_servers: int = 1, served_name: str = "default"):
        self.configs = list(table_configs)
        self.num_servers = int(num_servers)
        self.served_name = served_name
        self.client: PsClient | None = None
        self.servers: list[PsServer] = []
        self._stop = threading.Event()

    def emb_dims(self) -> dict[int, int]:
        return {c.table_id: c.emb_dim for c in self.configs}

    # --- local (in-process shards) ---------------------------------------
    def start_local(self) -> PsClient:
        self.servers = [PsServer(s, self.num_servers, self.configs)
                        for s in range(self.num_servers)]
        self.client = PsClient([LocalChannel(s) for s in self.servers])
        return self.client

    # --- rpc (dedicated server hosts) ------------------------------------
    def start_server(self, server_id: int) -> PsServer:
        """Call on a server process AFTER
        rpc.init_rpc(name=server_name(server_id)) — trainers connect by
        that name (see server_name above)."""
        from .. import rpc as _rpc
        try:
            me = _rpc.get_worker_info()
        except Exception:
            me = None
        if me is not None and me.name != server_name(server_id):
            raise RuntimeError(
                f"PS server {server_id} must init_rpc with name "
                f"'{server_name(server_id)}', got '{me.name}' — trainers "
                "route by this name")
        server = PsServer(server_id, self.num_servers, self.configs)
        serve_tables(server, self.served_name)
        self.servers = [server]
        return server

    def run_server(self) -> None:
        """Block until stop() — requests are served by the RPC threads."""
        self._stop.wait()

    def connect(self, server_names: list[str]) -> PsClient:
        dims = self.emb_dims()
        self.client = PsClient([
            RpcChannel(n, self.served_name, dims) for n in server_names])
        return self.client

    # --- lifecycle --------------------------------------------------------
    def stop(self) -> None:
        self._stop.set()

    def save(self, dirname: str) -> None:
        if self.client is not None:
            self.client.save(dirname)
        elif self.servers:
            for s in self.servers:
                s.save(dirname)

    def load(self, dirname: str) -> None:
        if self.client is not None:
            self.client.load(dirname)
        elif self.servers:
            for s in self.servers:
                s.load(dirname)


def from_env(table_configs: list[TableConfig]) -> TheOnePs:
    """Build from the reference's PS cluster env layout
    (PADDLE_PSERVERS_IP_PORT_LIST / PADDLE_PSERVER_NUMS)."""
    eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
    n = int(os.environ.get("PADDLE_PSERVER_NUMS",
                           str(len(eps.split(",")) if eps else 1)))
    return TheOnePs(table_configs, num_servers=max(n, 1))
