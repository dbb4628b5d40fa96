"""paddle_tpu_torch.distributed, the process layer, against the JAX
package's, on the CPU: the store (the port's server with the reference's
client, both built from the same C++), the collectives in a world of one,
the rank-order reduction, the single-process environment, the launcher's
arguments, and one two-process gloo launch whose drill values equal the
reference's `_reduce_stacked` on the same stacks. The reference's public
names the port still lacks are the ones ROADMAP Queue 1 item 2 lists."""

import json
import os
import socket
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as rdist
from paddle_tpu.distributed import collective as rcoll
import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import collective as coll
from paddle_tpu_torch.distributed import parallel_env
from paddle_tpu_torch.distributed.launch import _parse
from paddle_tpu_torch.distributed.launch import main as launch_main
from paddle_tpu_torch.tools import collective_drill
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
ROADMAP = (ROOT / "ROADMAP.md").read_text()


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_missing_names_are_queued():
    """Every public name of the reference's distributed the port lacks
    is in ROADMAP Queue 1 item 2, in backticks."""
    missing = _public(rdist) - _public(dist)
    item = ROADMAP[ROADMAP.index("2. **Distributed"):
                   ROADMAP.index("3. **Slice 4, step 6")]
    assert missing, "the reference's whole surface is ported: drop this"
    assert [n for n in sorted(missing) if f"`{n}`" not in item] == []
    assert _public(dist) - _public(rdist) == {"ResilientStore", "get_store"}


# -- the store ---------------------------------------------------------------

def test_tcp_store_api():
    master = dist.TCPStore("127.0.0.1", 0, is_master=True, world_size=1,
                           timeout=5)
    try:
        assert master.port > 0
        master.set("k", b"v1")
        master.set("s", "text")
        assert master.get("k") == b"v1" and master.get("s") == b"text"
        assert master.add("n", 2) == 2 and master.add("n", 5) == 7
        assert master.check("k") and not master.check("missing")
        master.wait("k")
        n = master.num_keys()
        assert master.delete_key("k") and not master.check("k")
        assert master.num_keys() == n - 1
        master.set("empty", b"")
        assert master.get("empty") == b""
        master.barrier()
        master.barrier()
    finally:
        master.close()


def test_tcp_store_timeouts():
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, timeout=0.2)
    try:
        with pytest.raises(TimeoutError, match="get"):
            store.get("never")
        with pytest.raises(TimeoutError, match="wait"):
            store.wait("never")
    finally:
        store.close()
    with pytest.raises(RuntimeError, match="cannot connect"):
        dist.TCPStore("127.0.0.1", store.port, timeout=0.2)


def test_store_is_the_references_wire_protocol():
    """The port's server with a reference client and the other way: the
    C++ is the same."""
    ours = dist.TCPStore("127.0.0.1", 0, is_master=True, world_size=2)
    theirs = rdist.TCPStore("127.0.0.1", ours.port, world_size=2)
    try:
        theirs.set("from_ref", b"hello")
        assert ours.get("from_ref") == b"hello"
        ours.set("from_port", b"\x00\x01bin")
        assert theirs.get("from_port") == b"\x00\x01bin"
        assert theirs.add("count", 3) == 3 and ours.add("count", 1) == 4
    finally:
        del theirs
        ours.close()


def test_resilient_store_retries_a_transient_failure():
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.resilience.retry import RetryPolicy
    inner = dist.TCPStore("127.0.0.1", 0, is_master=True, timeout=5)
    store = dist.ResilientStore(inner, policy=RetryPolicy(
        max_attempts=3, base_delay=0.0, max_delay=0.0))
    try:
        store.set("a", b"1")
        with faults.injected_faults("store.get:1:ConnectionError"):
            assert store.get("a") == b"1"
        assert store.port == inner.port and store.inner is inner
        assert store.add("c", 2) == 2 and store.check("a")
        store.wait("a")
        assert store.num_keys() >= 2 and store.delete_key("a")
        store.barrier()
    finally:
        inner.close()


# -- collectives in a world of one ---------------------------------------------

def _pair(values):
    return paddle.to_tensor(np.asarray(values, np.float32)), \
        torch.tensor(np.asarray(values, np.float32))


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod", "avg"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_reduce_stacked_equals_reference(op, dtype):
    """The reference reduces the numpy stack process_allgather returns,
    then keeps it as a JAX array (64-bit types become 32-bit)."""
    g = np.random.RandomState(3).randint(1, 6, (3, 4, 2)).astype(dtype)
    want = np.asarray(rcoll._reduce_stacked(g, op))
    got = coll._reduce_stacked(torch.from_numpy(g), op).numpy()
    assert got.dtype == np.asarray(jnp.asarray(want)).dtype
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_world_of_one_collectives_as_the_reference():
    r, p = _pair([1.0, 2.0])
    for mod, t in ((rdist, r), (dist, p)):
        mod.all_reduce(t)
        mod.broadcast(t, src=0)
        mod.reduce(t, dst=0, op=mod.ReduceOp.MAX)
    np.testing.assert_array_equal(p.numpy(), np.asarray(r._data))
    lists = {}
    for name, mod, t in (("r", rdist, r), ("p", dist, p)):
        gathered, objs, outs, gl = [], [], [], []
        mod.all_gather(gathered, t)
        mod.all_gather_object(objs, {"a": 1})
        mod.all_to_all(outs, [t])
        mod.gather(t, gl, dst=0)
        lists[name] = (len(gathered), objs, len(outs), len(gl))
        assert gathered[0] is t and outs[0] is t and gl[0] is t
    assert lists["r"] == lists["p"] == (1, [{"a": 1}], 1, 1)
    ro, po = _pair([0.0, 0.0])
    ri, pi = _pair([5.0, 6.0])
    rdist.reduce_scatter(ro, [ri])
    dist.reduce_scatter(po, [pi])
    np.testing.assert_array_equal(po.numpy(), np.asarray(ro._data))
    rdist.scatter(ro, [ri * 2])
    dist.scatter(po, [pi * 2])
    np.testing.assert_array_equal(po.numpy(), np.asarray(ro._data))
    rdist.alltoall_single(ri, ro)
    dist.alltoall_single(pi, po)
    np.testing.assert_array_equal(po.numpy(), np.asarray(ro._data))
    outs = []
    dist.alltoall([pi], outs)       # the reference's (in, out) order
    assert outs == [pi]
    assert dist.all_reduce(pi).wait() and dist.all_reduce(pi).is_completed()


def test_stream_forms_in_a_world_of_one():
    r, p = _pair([1.0, 2.0, 3.0])
    rout, pout = _pair([0.0, 0.0, 0.0])
    rdist.stream.all_gather(rout, r)
    dist.stream.all_gather(pout, p)
    np.testing.assert_array_equal(pout.numpy(), np.asarray(rout._data))
    rdist.stream.alltoall(rout, r * 2)
    dist.stream.alltoall(pout, p * 2)
    np.testing.assert_array_equal(pout.numpy(), np.asarray(rout._data))
    rdist.stream.reduce_scatter(rout, r * 3)
    dist.stream.reduce_scatter(pout, p * 3)
    np.testing.assert_array_equal(pout.numpy(), np.asarray(rout._data))
    dist.stream.all_reduce(p, use_calc_stream=True)
    with pytest.raises(RuntimeError, match="use_calc_stream"):
        dist.stream.all_reduce(p, sync_op=False, use_calc_stream=True)
    with pytest.raises(ValueError, match="both be tensors"):
        dist.stream.alltoall([p], p)
    assert dist.communication.stream is dist.stream


def test_sub_world_groups_p2p_and_split_raise():
    group = dist.new_group([0, 1])
    assert dist.get_group(group.id) is group and group.nranks == 2
    assert group.get_group_rank(1) == 1 and group.get_group_rank(5) == -1
    t = torch.ones(2)
    for fn in (lambda: dist.all_reduce(t, group=group),
               lambda: dist.all_gather([], t, group=group),
               lambda: dist.broadcast(t, group=group),
               lambda: dist.scatter(t, [t, t], group=group)):
        with pytest.raises(RuntimeError, match="over 2 ranks"):
            fn()
    dist.destroy_process_group(group)
    assert dist.get_group(group.id) is None
    for fn in (lambda: dist.send(t, 1), lambda: dist.recv(t, 1),
               lambda: dist.batch_isend_irecv([dist.P2POp(dist.isend, t,
                                                           1)])):
        with pytest.raises(NotImplementedError, match="cross-process"):
            fn()
    with pytest.raises(NotImplementedError, match="fleet.meta_parallel"):
        dist.split(t, (2, 2), "linear")


def test_single_process_environment_records_state():
    env = dist.init_parallel_env()
    assert dist.is_initialized() and dist.get_store() is None
    assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
    assert (env.rank, env.world_size, env.device_id, env.nrings) == \
        (0, 1, 0, 1)
    assert env.dev_id == env.device_id
    assert dist.get_group(0).ranks == [0] and dist.get_backend() is None
    dist.barrier()
    dist.destroy_process_group()
    assert not dist.is_initialized()


def test_nccl_takes_one_rank_per_card(monkeypatch):
    monkeypatch.setenv("PADDLE_LOCAL_SIZE", str(torch.cuda.device_count()
                                                 + 1))
    with pytest.raises(RuntimeError, match="one rank per card"):
        parallel_env._check_backend("nccl", 2)
    parallel_env._check_backend("gloo", 2)
    with pytest.raises(ValueError, match="gloo and nccl"):
        parallel_env._check_backend("mpi", 2)


def test_the_default_backend_is_nccl(monkeypatch):
    """Without --backend the ranks ask for NCCL; more ranks than cards
    raise before the rendezvous instead of moving to gloo."""
    for k in [k for k in os.environ if k.startswith("PADDLE_")]:
        monkeypatch.delenv(k)
    n = torch.cuda.device_count() + 2
    monkeypatch.setenv("PADDLE_MASTER", "127.0.0.1:1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(n))
    with pytest.raises(RuntimeError, match="one rank per card"):
        dist.init_parallel_env()
    assert not dist.is_initialized()


def test_launcher_arguments_as_the_reference():
    from paddle_tpu.distributed.launch import _parse as rparse
    argv = ["--nproc_per_node=2", "--master", "127.0.0.1:1234",
            "--log_level", "INFO", "--gpus", "0,1", "--run_mode", "collective",
            "--max_restart=0", "--log_dir", "logs", "train.py", "--lr", "1"]
    got, want = _parse(argv), rparse(argv)
    for key in ("nproc_per_node", "master", "max_restart", "log_dir",
                "script", "script_args", "nnodes", "rank"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.backend == "nccl"
    assert _parse(["--backend", "gloo", "t.py"]).backend == "gloo"
    called = []
    dist.spawn(lambda a, b: called.append(a + b), args=(2, 3))
    assert called == [5]


# -- two processes on the CPU --------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class TestTwoProcessGloo:
    @pytest.fixture(scope="class")
    def results(self, tmp_path_factory):
        """One launch of the drill through the launcher's entry point,
        shared by the class."""
        tmp = tmp_path_factory.mktemp("drill")
        with pytest.MonkeyPatch.context() as mp:
            for k in [k for k in os.environ if k.startswith("PADDLE_")]:
                mp.delenv(k)
            with pytest.raises(SystemExit) as done:
                launch_main([
                    "--nproc_per_node", "2", "--master",
                    f"127.0.0.1:{_free_port()}", "--backend", "gloo",
                    "--max_restart", "0", "--log_dir", str(tmp),
                    str(ROOT / "paddle_tpu_torch/tools/collective_drill.py"),
                    str(tmp / "out"), "--device", "cpu"])
        logs = "".join((tmp / f"worker.{r}.log").read_text()[-2000:]
                       for r in range(2)
                       if (tmp / f"worker.{r}.log").exists())
        assert done.value.code == 0, logs
        return [json.loads((tmp / f"out.rank{r}").read_text())
                for r in range(2)]

    def test_world_and_backend(self, results):
        for r, res in enumerate(results):
            assert (res["rank"], res["world"], res["backend"]) == \
                (r, 2, "gloo")
            assert res["devices"] == ["cpu"]

    def test_drill_values_are_the_reference_drills(self, results):
        for r, res in enumerate(results):
            want = collective_drill.expected(r)
            assert {k: res[k] for k in want} == want

    def test_reductions_equal_the_references_on_the_same_stacks(self,
                                                                results):
        def ref(stack, op):
            return rcoll._reduce_stacked(np.asarray(stack, np.float32), op)
        ranks = [[1.0], [2.0]]
        rs = [[1.0, 10.0], [2.0, 20.0]]
        for r, res in enumerate(results):
            assert res["all_reduce_sum"] == float(ref(ranks, "sum")[0])
            assert res["all_reduce_max"] == float(ref(ranks, "max")[0])
            assert res["reduce_scatter"] == float(ref(rs, "sum")[r])
            assert res["stream_reduce_scatter"] == float(ref(rs, "sum")[r])

    def test_store_and_p2p(self, results):
        assert [res["store"] for res in results] == ["from-rank0"] * 2
        assert results[0]["p2p_roundtrip"] == [42.0, 43.0]
        assert results[1]["p2p_recv"] == [41.0, 42.0]
        assert [res["batch_p2p"] for res in results] == [109.0, 9.0]
