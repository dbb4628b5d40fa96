"""The port's parameter-server stack against the JAX package's: the
accessor rules on the native store (csrc/ps_table.cc) and the numpy spec,
tables saved by one package and loaded by the other, the entry gates,
client routing, the geo cache, PsEmbedding's push and PsBatch's bracket,
the slot datasets parsing the same files as the reference's, the data
generators, and rpc over the port's TCPStore (one worker calling itself,
and an RpcChannel to the tables it serves). Rows are float32; the native
rules are the same C++ in both packages, so rows compare exactly; the
numpy spec and the device-gathered gradients within 1e-6."""

import socket

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import dataset as rds
from paddle_tpu.distributed import ps as rps
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.convert import load_reference_table
from paddle_tpu_torch.distributed import dataset as ds
from paddle_tpu_torch.distributed import ps, rpc
from paddle_tpu_torch.distributed.ps import service
from torch_one_thread import one_torch_thread  # noqa: F401

RULES = ["SparseNaiveSGDRule", "SparseAdaGradRule", "SparseAdamRule"]
IDS = np.array([3, 11, 3, 2**48 + 7], np.uint64)


def _acc(pkg, rule, **kw):
    return pkg.CtrAccessor(getattr(pkg, rule)(learning_rate=0.05), **kw)


def _train(table, steps=4, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        table.push(IDS, rng.randn(IDS.size, 16).astype(np.float32))
    return table


@pytest.mark.parametrize("rule", RULES)
def test_rules_match_reference_and_spec(rule):
    ref = _train(rps.SparseTable(16, _acc(rps, rule)))
    port = _train(ps.SparseTable(16, _acc(ps, rule)))
    spec = _train(ps.SparseTable(16, _acc(ps, rule), use_native=False))
    assert port._native
    np.testing.assert_array_equal(port.pull(IDS), ref.pull(IDS))
    np.testing.assert_allclose(spec.pull(IDS), port.pull(IDS), atol=2e-6)
    np.testing.assert_array_equal(ps.accessor.deterministic_init_batch(
        IDS, 16, 1e-4), rps.accessor.deterministic_init_batch(IDS, 16, 1e-4))


@pytest.mark.parametrize("rule", ["SparseAdaGradRule", "SparseAdamRule"])
def test_tables_load_across_packages(tmp_path, rule):
    """Each package loads the other's checkpoint and trains on exactly as
    the saver would have (optimizer slots included)."""
    for saver, loader in ((rps, ps), (ps, rps)):
        path = str(tmp_path / f"{saver.__name__}.{rule}")
        _train(saver.SparseTable(16, _acc(saver, rule))).save(path)
        fresh = loader.SparseTable(16, _acc(loader, rule))
        if loader is ps:
            load_reference_table(fresh, path)
        else:
            fresh.load(path)
        both = [_train(fresh, 2, seed=1),
                _train(_train(saver.SparseTable(16, _acc(saver, rule))), 2,
                       seed=1)]
        np.testing.assert_array_equal(both[0].pull(IDS), both[1].pull(IDS))
        assert len(both[0]) == len(both[1]) == 3
    with pytest.raises(ValueError, match="numpy store"):
        load_reference_table(ps.SparseTable(16, _acc(ps, rule)),
                             str(tmp_path / "missing"))


def test_entry_gates_decay_and_shrink_match_reference():
    out = []
    for pkg in (rps, ps):
        t = pkg.SparseTable(4, _acc(pkg, "SparseNaiveSGDRule",
                                    entry=pkg.CountFilterEntry(2)))
        ids = np.array([1, 2, 1, 5], np.uint64)
        g = np.ones((4, 4), np.float32)
        seen = []
        for _ in range(3):
            t.push(ids, g)
            seen.append(sorted(t.keys().tolist()))
        t.add_show_click(np.array([1, 2], np.uint64), [3.0, 0.0], [1.0, 0.0])
        t.decay(0.5)
        for _ in range(7):
            t.decay()
        shrunk = t.shrink()
        p = pkg.ProbabilityEntry(0.5)
        out.append((seen, shrunk, sorted(t.keys().tolist()),
                    t.pull(np.array([1, 2, 9], np.uint64)).tolist(),
                    [p.admit(i, 1) for i in range(64)]))
    assert out[0] == out[1]


def test_client_routing_and_geo_cache_match_reference():
    cfgs = {pkg: [pkg.TableConfig(0, 4, _acc(pkg, "SparseAdaGradRule"))]
            for pkg in (rps, ps)}
    ids = np.arange(40, dtype=np.uint64) * 7919
    np.testing.assert_array_equal(service.owner_of(ids, 3),
                                  rps.service.owner_of(ids, 3))
    rows = []
    for pkg in (rps, ps):
        client = pkg.TheOnePs(cfgs[pkg], num_servers=3).start_local()
        client.push(0, np.concatenate([ids, ids[:5]]),
                    np.ones((45, 4), np.float32))
        geo = pkg.GeoWorkerCache(client, 0, 4, geo_step=2)
        for _ in range(3):
            geo.push(ids[:6], np.full((6, 4), 0.5, np.float32))
        rows.append((client.pull(0, ids), [s[0] for s in client.stats()],
                     geo.pull(ids[:6])))
    for a, b in zip(*rows):
        np.testing.assert_array_equal(a, b)


def test_ps_embedding_and_batch_push_like_reference():
    """PsEmbedding's backward and PsBatch's complete push the rows' summed
    gradients: the tables end as the reference's eager PsEmbedding leaves
    its own (the grad of sum(e^2) is 2e, summed by unique id)."""
    import paddle_tpu as paddle
    batches = [np.array([[1, 2], [2, 3]], np.int64),
               np.array([[3, 3], [4, 1]], np.int64)]
    want_client = rps.TheOnePs([rps.TableConfig(
        0, 4, _acc(rps, "SparseNaiveSGDRule"))], 2).start_local()
    emb = rps.PsEmbedding(4, want_client)
    for b in batches:
        (emb(paddle.to_tensor(b)) ** 2).sum().backward()
    ids = np.array([1, 2, 3, 4], np.uint64)
    want = want_client.pull(0, ids)
    for use_batch in (False, True):
        client = ps.TheOnePs([ps.TableConfig(
            0, 4, _acc(ps, "SparseNaiveSGDRule"))], 2).start_local()
        emb = ps.PsEmbedding(4, client, device="cpu")
        batch = ps.PsBatch(client, 0, 4, capacity=8, device="cpu")
        for b in batches:
            if use_batch:
                rows, inv = batch.prepare(b)
                rows.requires_grad_()
                (rows[inv] ** 2).sum().backward()
                batch.complete(rows.grad)
            else:
                (emb(torch.from_numpy(b)) ** 2).sum().backward()
        np.testing.assert_allclose(client.pull(0, ids), want, atol=1e-6)
    with pytest.raises(ValueError, match="capacity"):
        ps.PsBatch(client, 0, 4, capacity=2, device="cpu").prepare(
            np.array([1, 2, 3]))
    with pytest.raises(RuntimeError, match="before prepare"):
        batch.complete(np.zeros((8, 4), np.float32))


# -- the slot datasets -------------------------------------------------------

class _FloatVar:
    def __init__(self, name):
        self.name, self.dtype = name, "float32"


def _files(tmp_path):
    rows = [(1, [3, 5], [7]), (0, [2], [9, 11, 13]), (1, [1, 1, 2], [4])]
    lines = [" ".join(["1", str(lab), str(len(a))] + [str(i) for i in a]
                      + [str(len(b))] + [str(i) for i in b])
             for lab, a, b in rows]
    lines.insert(1, "2 1 1 0")              # malformed: skipped
    paths = []
    for i, chunk in enumerate((lines[:2], lines[2:])):
        p = tmp_path / f"part{i}.txt"
        p.write_text("\n".join(chunk) + "\n")
        paths.append(str(p))
    return paths


def _read(mod, paths, cls, batch, **kw):
    d = getattr(mod, cls)()
    d.init(batch_size=batch, use_var=[_FloatVar("label"), "s1", "s2"], **kw)
    d.set_filelist(paths)
    if cls == "InMemoryDataset":
        d.load_into_memory()
    return [{k: (v[0].tolist(), v[0].dtype.str, v[1].tolist())
             for k, v in b.items()} for b in d]


@pytest.mark.parametrize("cls,batch,pipe", [
    ("InMemoryDataset", 2, "cat"), ("QueueDataset", 2, "cat"),
    ("InMemoryDataset", 3, "tr 9 8")])
def test_datasets_parse_as_the_reference(tmp_path, cls, batch, pipe):
    paths = _files(tmp_path)
    got = _read(ds, paths, cls, batch, pipe_command=pipe)
    assert got == _read(rds, paths, cls, batch, pipe_command=pipe)
    assert len(got) == -(-3 // batch)


def test_generators_and_dataset_names(tmp_path):
    def gen(mod):
        class Gen(mod.MultiSlotDataGenerator):
            def generate_sample(self, line):
                def it():
                    v = [int(x) for x in line.split()]
                    yield [("label", [v[0]]), ("ids", v[1:])]
                return it
        return Gen().run_from_memory(["1 4 5", "0 6"])
    assert gen(ds) == gen(rds) == ["1 1 2 4 5", "1 0 1 6"]
    assert dist.InMemoryDataset is ds.InMemoryDataset
    assert dist.fleet.MultiSlotStringDataGenerator is \
        ds.MultiSlotStringDataGenerator
    with pytest.raises(RuntimeError, match="streams"):
        ds.QueueDataset().load_into_memory()


# -- rpc ---------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _div(a, b):
    return a / b


def test_rpc_round_trip_and_rpc_channel():
    rpc.init_rpc("worker0", rank=0, world_size=1,
                 master_endpoint=f"127.0.0.1:{_free_port()}")
    try:
        info = rpc.get_worker_info()
        assert (info.name, info.rank) == ("worker0", 0)
        assert rpc.rpc_sync("worker0", max, args=((3, 1, 2),)) == 3
        assert rpc.rpc_async("worker0", sum, args=([1, 2, 3],)).wait() == 6
        assert [w.name for w in rpc.get_all_worker_infos()] == ["worker0"]
        with pytest.raises(ZeroDivisionError):
            rpc.rpc_sync("worker0", _div, args=(1, 0))
        # the tables this worker serves, through the TCP channel
        cfgs = [ps.TableConfig(0, 4, _acc(ps, "SparseAdaGradRule"))]
        eng = ps.TheOnePs(cfgs, num_servers=1)
        with pytest.raises(RuntimeError, match="ps_server_0"):
            eng.start_server(0)
        local = ps.TheOnePs(cfgs).start_local()
        ps.serve_tables(ps.PsServer(0, 1, cfgs), "t")
        remote = ps.PsClient([ps.RpcChannel("worker0", "t", {0: 4})])
        ids = np.array([5, 9, 5], np.uint64)
        for client in (local, remote):
            client.push(0, ids, np.ones((3, 4), np.float32))
        np.testing.assert_array_equal(remote.pull(0, ids),
                                      local.pull(0, ids))
        assert remote.stats() == [{0: 2}]
    finally:
        rpc.shutdown()
