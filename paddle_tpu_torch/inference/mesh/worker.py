"""Mesh worker process: one full ContinuousBatchingEngine behind the
frame transport.

Launched by ProcessReplicaPool (transport="socket") as
`python -m paddle_tpu_torch.inference.mesh.worker --connect HOST:PORT
--name replicaN --spec /path/spec.json`: a plain subprocess, rendezvous
over TCP. The spec is a JSON-safe engine recipe (callables cannot cross
a process): model config kwargs, engine kwargs, the weights' seed, the
device, the role, and the parent's TCPStore endpoint.

The worker owns its OWN mesh lease: it registers an ElasticManager over
the parent's TCPStore and runs the threaded heartbeat (`manager.start()`),
so membership is real cross-process lease-keeping — kill -9 this process
and the lease goes stale exactly like a lost node in an etcd registry.
The serve loop is serial: recv frame -> serve_request -> reply; request
pipelining (async KV imports overlapping the parent's pump) comes from
the parent writing ahead on the socket.

Exit paths: a "shutdown" frame (clean retire — reply first, then
deregister so the tombstone is ordered after the last reply), or the
parent/socket dying (the lease lapses by ttl; the parent writes the
tombstone on kill so membership converges immediately).

Port: reference paddle_tpu/inference/mesh/worker.py, which pins JAX to
the CPU. This worker imports no JAX: it builds its engine with the port's
LlamaForCausalLM on `spec["device"]` ("cuda" unless the spec names
another, as the tests name "cpu"), in `spec["config"]["dtype"]`;
`spec["threads"]`, when given, sets torch's intra-op threads.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))


def build_model(spec):
    """The spec's model: the port's LlamaForCausalLM of `spec["config"]`
    (its dtype included) on `spec["device"]`, weights from
    `paddle.seed(spec["seed"])`."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    paddle.seed(int(spec.get("seed", 0)))
    cfg = LlamaConfig(**spec.get("config", {}))
    model = LlamaForCausalLM(cfg, device=spec.get("device", "cuda"))
    model.eval()
    return model


def engine_kwargs(spec):
    """The spec's ContinuousBatchingEngine knobs (JSON lists back to
    tuples)."""
    kw = dict(spec.get("engine", {}))
    buckets = kw.get("prefill_buckets")
    if buckets is not None:
        kw["prefill_buckets"] = tuple(buckets)
    return kw


def build_engine(spec):
    """Engine from a JSON-safe recipe. Weights are deterministic by seed
    (the port's generators, `paddle.seed`): every worker built from the
    same spec holds the same model, the invariant disaggregated handoff
    relies on."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    return ContinuousBatchingEngine(build_model(spec), **engine_kwargs(spec))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--connect", required=True, help="parent HOST:PORT")
    ap.add_argument("--name", required=True)
    ap.add_argument("--spec", required=True, help="spec JSON path")
    args = ap.parse_args(argv)

    with open(args.spec) as f:
        spec = json.load(f)

    import torch

    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.inference.mesh.transport import (
        recv_frame, send_frame, serve_request)

    if spec.get("threads"):
        torch.set_num_threads(int(spec["threads"]))
    engine = build_engine(spec)
    exports = []
    if spec.get("role") == "prefill":
        engine.prefill_sink = exports.append

    # the worker's own lease over the parent's store, threaded beats —
    # real cross-process membership (beat failures counted, never fatal)
    manager = None
    st = spec.get("store") or {}
    if st.get("port"):
        try:
            store = TCPStore(host=st.get("host", "127.0.0.1"),
                             port=int(st["port"]), is_master=False,
                             timeout=10)
            manager = ElasticManager(
                store, node_id=spec.get("node_id", args.name),
                heartbeat_interval=float(
                    st.get("heartbeat_interval", 5.0)))
            manager.register()
            manager.start()
        except Exception:  # noqa: BLE001 — membership is the parent's
            manager = None  # problem to notice (stale lease), not ours

    # connect budget mirrors the parent's accept budget: spec override,
    # else the registered FLAGS_mesh_worker_accept_timeout_s default
    from paddle_tpu_torch.framework.flags import flag_value
    connect_timeout = spec.get("accept_timeout_s")
    if connect_timeout is None:
        connect_timeout = flag_value("mesh_worker_accept_timeout_s")
    host, port = args.connect.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)),
                                    timeout=float(connect_timeout))
    # the serve loop legitimately blocks forever waiting for its parent;
    # the connect budget must not double as an idle-read timeout
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        while True:
            kind, meta, payload = recv_frame(sock)
            rk, rm, rp = serve_request(engine, kind, meta, payload,
                                       exports=exports)
            send_frame(sock, rk, rm, rp)
            if kind == "shutdown":
                break
    finally:
        if manager is not None:
            manager.deregister()
        sock.close()


if __name__ == "__main__":
    main()
