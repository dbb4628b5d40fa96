#!/usr/bin/env python
"""The two-rank collective drill: one worker of a launch that joins the
process group and runs every eager collective once, then writes what it
got to `<out>.rank<r>` as JSON. The drill is the reference's two-process
worker's (tests/two_proc_worker.py:43-113): the store, all_reduce sum and
max, all_gather, broadcast, reduce_scatter, its stream form, scatter,
gather, p2p both ways and a batched p2p exchange.

    python3 -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --master 127.0.0.1:<port> --backend gloo --log_dir <dir> \\
        paddle_tpu_torch/tools/collective_drill.py <out> [--device cuda]

The tensors live on --device (default cuda; cpu when asked). Each rank's
expected values are in `expected(rank)`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402


def expected(rank):
    """What rank `rank` of two must get (the reference worker's values)."""
    out = {"store": "from-rank0", "all_reduce_sum": 3.0,
           "all_reduce_max": 2.0, "all_gather": [0.0, 1.0],
           "broadcast_src1": 15.0,
           "reduce_scatter": [3.0, 30.0][rank],
           "stream_reduce_scatter": [3.0, 30.0][rank],
           "scatter_from0": [100.0, 200.0][rank],
           "gather_dst1": [[], [7.0, 8.0]][rank],
           "batch_p2p": [109.0, 9.0][rank]}
    if rank == 0:
        out["p2p_roundtrip"] = [42.0, 43.0]
    else:
        out["p2p_recv"] = [41.0, 42.0]
    return out


def drill(device):
    import paddle_tpu_torch.distributed as dist

    def t(values):
        return torch.tensor(values, dtype=torch.float32, device=device)

    def vals(x):
        return [float(v) for v in x.cpu()]

    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    res = {"rank": rank, "world": world, "backend": dist.get_backend()}
    devices = set()

    store = dist.get_store()
    if rank == 0:
        store.set("greeting", b"from-rank0")
    res["store"] = store.get("greeting").decode()

    x = t([rank + 1.0])
    dist.all_reduce(x)
    res["all_reduce_sum"] = vals(x)[0]
    mx = t([rank + 1.0])
    dist.all_reduce(mx, op=dist.ReduceOp.MAX)
    res["all_reduce_max"] = vals(mx)[0]

    gathered = []
    dist.all_gather(gathered, t([float(rank)]))
    res["all_gather"] = [vals(g)[0] for g in gathered]

    b = t([rank * 10 + 5.0])
    dist.broadcast(b, src=1)
    res["broadcast_src1"] = vals(b)[0]

    # rank r contributes [r + 1, (r + 1) * 10]; the sum is [3, 30], and
    # rank r keeps element r
    rs_out = t([0.0])
    dist.reduce_scatter(rs_out, [t([rank + 1.0]), t([(rank + 1.0) * 10])])
    res["reduce_scatter"] = vals(rs_out)[0]
    st_out = t([0.0])
    dist.stream.reduce_scatter(st_out, t([rank + 1.0, (rank + 1.0) * 10]))
    res["stream_reduce_scatter"] = vals(st_out)[0]

    sc_out = t([0.0])
    dist.scatter(sc_out, [t([100.0]), t([200.0])] if rank == 0 else None,
                 src=0)
    res["scatter_from0"] = vals(sc_out)[0]

    ga = []
    dist.gather(t([rank + 7.0]), ga, dst=1)
    res["gather_dst1"] = [vals(g)[0] for g in ga]

    if rank == 0:
        dist.send(t([41.0, 42.0]), dst=1)
        back = t([0.0, 0.0])
        dist.recv(back, src=1)
        res["p2p_roundtrip"] = vals(back)
        devices.add(str(back.device))
    else:
        got = t([0.0, 0.0])
        dist.recv(got, src=0)
        dist.send(got + 1.0, dst=0)
        res["p2p_recv"] = vals(got)
        devices.add(str(got.device))

    bsend, brecv = t([rank * 100 + 9.0]), t([0.0])
    peer = 1 - rank
    dist.batch_isend_irecv([dist.P2POp(dist.isend, bsend, peer),
                            dist.P2POp(dist.irecv, brecv, peer)])
    res["batch_p2p"] = vals(brecv)[0]

    for z in (x, mx, b, rs_out, st_out, sc_out, brecv, *gathered, *ga):
        devices.add(str(z.device))
    res["devices"] = sorted(devices)
    dist.barrier()
    dist.destroy_process_group()
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="results go to <out>.rank<r>")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = drill(args.device)
    with open(f"{args.out}.rank{res['rank']}", "w") as f:
        json.dump(res, f)
    print(f"rank {res['rank']} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
