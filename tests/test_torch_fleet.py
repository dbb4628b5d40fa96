"""The port's fleet against the JAX package's on the CPU (the reference on
its 8 virtual devices): the topology and the hybrid group, the fleet
facade and its parameter-server paths, the tensor- and sequence-parallel
layers forward and backward on the same weights, PipelineLayer with
PipelineParallel.train_batch/eval_batch, the meta optimizers, recompute,
the role makers, and ElasticManager on the port's TCPStore."""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu import optimizer as ropt
from paddle_tpu.distributed import fleet as rfleet
from paddle_tpu.distributed.fleet import meta_parallel as rmp
from paddle_tpu.distributed.fleet.utils import sequence_parallel_utils as rspu
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.distributed import TCPStore
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import elastic
from paddle_tpu_torch.distributed.fleet import meta_parallel as mp
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.distributed.fleet.utils import \
    sequence_parallel_utils as spu
from paddle_tpu_torch.distributed.placement import chunk_map
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
TOL = 1e-5


def _strategy(mod, **degrees):
    st = mod.DistributedStrategy()
    st.hybrid_configs.update({f"{k}_degree": v for k, v in degrees.items()})
    st.pipeline_configs["accumulate_steps"] = 4
    return st


@pytest.fixture()
def fleets():
    """(reference hcg, port hcg) for mp 2 x pp 2 x dp 2, then reset."""
    rfleet.fleet.init(is_collective=True,
                      strategy=_strategy(rfleet, mp=2, pp=2, dp=2))
    fleet.fleet.init(is_collective=True,
                     strategy=_strategy(fleet, mp=2, pp=2, dp=2),
                     device=CPU)
    yield rfleet.get_hybrid_communicate_group(), \
        fleet.get_hybrid_communicate_group()
    rfleet._hcg = None
    fleet._hcg = None


def _copy(ref_layer, port_layer):
    state = {k: np.asarray(v._data) for k, v in ref_layer.state_dict().items()}
    missing, unexpected = port_layer.set_state_dict(state)
    assert not missing and not unexpected
    return state


def test_topology_matches_reference():
    names = ["pp", "mp", "sep", "sharding", "dp"]
    dims = [2, 2, 1, 1, 2]
    r = rfleet.CommunicateTopology(names, dims)
    p = fleet.CommunicateTopology(names, dims)
    assert p.get_hybrid_group_names() == r.get_hybrid_group_names()
    assert p.world_size() == r.world_size() == 8
    for n in names:
        assert p.get_dim(n) == r.get_dim(n)
        assert p.get_comm_list(n) == r.get_comm_list(n)
        for i in range(p.get_dim(n)):
            assert p.get_axis_list(n, i) == r.get_axis_list(n, i)
    for rank in range(8):
        assert tuple(p.get_coord(rank)) == tuple(r.get_coord(rank))
    assert p.get_rank(pp=1, mp=0, sep=0, sharding=0, dp=1) == \
        r.get_rank(pp=1, mp=0, sep=0, sharding=0, dp=1)


def test_hybrid_group_and_facade(fleets):
    rh, ph = fleets
    for q in ("get_data_parallel_world_size", "get_model_parallel_world_size",
              "get_pipe_parallel_world_size", "get_sep_parallel_world_size",
              "get_sharding_parallel_world_size", "get_data_parallel_rank",
              "get_model_parallel_rank", "get_stage_id",
              "get_sep_parallel_rank", "get_sharding_parallel_rank",
              "get_global_rank", "get_data_parallel_group_src_rank",
              "get_model_parallel_group_src_rank", "get_p2p_groups"):
        assert getattr(ph, q)() == getattr(rh, q)(), q
    assert ph.mesh.shape == list(rh.mesh.devices.shape)
    assert ph.mesh.dim_names == list(rh.mesh.axis_names)
    assert ph.get_mesh() is ph.mesh and ph.topology().world_size() == 8
    assert ph.get_model_parallel_group().axis_name == "mp"
    assert ph.get_check_parallel_group().axis_name == "mp"
    for q in ("data", "pipe", "sep", "sharding"):
        assert getattr(ph, f"get_{q}_parallel_group")().nranks == \
            getattr(rh, f"get_{q}_parallel_group")().nranks
    assert ph.get_rank_from_stage(1) == 1
    assert fleet.fleet.get_hybrid_communicate_group() is ph
    assert fleet.worker_num() == 1 and fleet.worker_index() == 0
    assert fleet.is_first_worker()
    fleet.fleet.barrier_worker()
    net = pnn.Linear(4, 4, device=CPU)
    assert isinstance(fleet.distributed_model(net), mp.TensorParallel)
    pipe = mp.PipelineLayer([mp.LayerDesc(pnn.Linear, 4, 4, device=CPU)],
                            num_stages=2)
    assert isinstance(fleet.distributed_model(pipe), mp.PipelineParallel)
    opt = fleet.distributed_optimizer(
        popt.SGD(0.1, parameters=net.parameters()))
    assert opt.get_lr() == 0.1
    assert isinstance(opt, fleet.meta_optimizers.HybridParallelOptimizer)


def test_parameter_server_paths_raise(tmp_path, monkeypatch):
    """The PS lifecycle before its tables are declared raises as the
    reference's does; then init(is_collective=False), ps_tables,
    init_server, init_worker, a push, save_persistables and stop_worker
    run over TheOnePs and the saved shard equals the reference's."""
    from paddle_tpu.distributed import ps as rps
    from paddle_tpu_torch.distributed import ps
    monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
    for name in ("init_server", "run_server", "init_worker"):
        for f in (fleet.fleet, rfleet.fleet):
            f._ps_engine = None
            with pytest.raises(RuntimeError, match="ps_tables|init_server"):
                getattr(f, name)()
    for f, pkg in ((fleet, ps), (rfleet, rps)):
        f.fleet.init()              # is_collective=False: PS mode
        f.fleet.ps_tables(pkg.TableConfig(0, 4, pkg.CtrAccessor(
            pkg.SparseAdaGradRule(0.5))))
        f.fleet.init_server()
        client = f.fleet.init_worker()
        client.push(0, np.array([1, 2, 1], np.uint64),
                    np.ones((3, 4), np.float32))
        f.fleet.save_persistables(dirname=str(tmp_path / pkg.__name__))
        f.fleet.stop_worker()
    shard = "table0.shard0"
    assert (tmp_path / ps.__name__ / shard).read_bytes() == \
        (tmp_path / rps.__name__ / shard).read_bytes()
    for cls in (fleet.MultiSlotDataGenerator,
                fleet.MultiSlotStringDataGenerator):
        with pytest.raises(NotImplementedError, match="generate_sample"):
            cls().run_from_memory(["1 2"])


def test_role_makers_and_util(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", "a:1,b:2")
    for kw in (dict(is_collective=True), dict(is_collective=False)):
        r = rfleet.PaddleCloudRoleMaker(**kw)
        p = fleet.PaddleCloudRoleMaker(**kw)
        for q in ("worker_index", "worker_num", "server_num",
                  "get_pserver_endpoints", "is_worker", "is_server", "role"):
            assert getattr(p, q)() == getattr(r, q)(), (kw, q)
    u = fleet.UserDefinedRoleMaker(current_id=1, worker_num=2,
                                   role=fleet.Role.SERVER,
                                   server_endpoints=["x:1"])
    assert (u.worker_index(), u.worker_num(), u.is_server(), u.role(),
            u.server_num()) == (1, 2, True, fleet.Role.SERVER, 1)
    util = fleet.UtilBase()
    assert util.all_reduce(3) == 3 and util.all_gather(3) == [3]
    assert util.get_file_shard(("a", "b")) == ["a", "b"]
    assert util.barrier() is None
    util.print_on_rank("hello", 0)


def test_tensor_parallel_layers_match_reference(fleets):
    rh, ph = fleets
    paddle.seed(0)
    r_emb = rmp.VocabParallelEmbedding(64, 16)
    r_col = rmp.ColumnParallelLinear(16, 32, gather_output=False)
    r_row = rmp.RowParallelLinear(32, 16, input_is_parallel=True)
    r_gat = rmp.ColumnParallelLinear(16, 8)
    r_row2 = rmp.RowParallelLinear(8, 4, has_bias=False)
    p_emb = mp.VocabParallelEmbedding(64, 16)
    p_col = mp.ColumnParallelLinear(16, 32, gather_output=False)
    p_row = mp.RowParallelLinear(32, 16, input_is_parallel=True)
    p_gat = mp.ColumnParallelLinear(16, 8)
    p_row2 = mp.RowParallelLinear(8, 4, has_bias=False)
    pairs = [(r_emb, p_emb), (r_col, p_col), (r_row, p_row), (r_gat, p_gat),
             (r_row2, p_row2)]
    for r, p in pairs:
        _copy(r, p)
        for name, t in p.named_parameters():
            rt = getattr(r, name)._data
            want = {d.id: idx for d, idx in
                    rt.sharding.devices_indices_map(rt.shape).items()}
            got = chunk_map(t.process_mesh, t.placements, t.shape) \
                if hasattr(t, "process_mesh") else \
                {0: (slice(None),) * t.ndim}    # unmarked: one whole block
            assert got == want, name
    ids = np.random.RandomState(0).randint(0, 64, (2, 5))
    labels = np.random.RandomState(1).randint(0, 8, (2, 5))

    def run(mod, emb, col, row, gat, row2, x, y, ce):
        h = emb(x)
        h = row(mod.nn.functional.relu(col(h)))
        logits = gat(h)
        return logits, ce(logits, y), row2(logits)

    rce = rmp.ParallelCrossEntropy()
    pce = mp.ParallelCrossEntropy()
    rl, rloss, rz = run(paddle, r_emb, r_col, r_row, r_gat, r_row2,
                        paddle.Tensor(jnp.asarray(ids)),
                        paddle.Tensor(jnp.asarray(labels)), rce)
    pl, ploss, pz = run(pt, p_emb, p_col, p_row, p_gat, p_row2,
                        torch.as_tensor(ids), torch.as_tensor(labels), pce)
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(rl._data),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ploss.detach().numpy(),
                               np.asarray(rloss._data), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pz.detach().numpy(), np.asarray(rz._data),
                               rtol=TOL, atol=TOL)
    # marks on the activations
    h = p_col(p_emb(torch.as_tensor(ids)))
    assert h.placements[ph.mesh.dim_names.index("mp")] == pt.distributed.Shard(2)
    assert p_gat(p_row(h)).placements == [pt.distributed.Replicate()] * 5
    # backward against the reference's tape
    (rloss.sum() + rz.sum()).backward()
    (ploss.sum() + pz.sum()).backward()
    for r, p in pairs:
        for name, t in p.named_parameters():
            np.testing.assert_allclose(
                t.grad.numpy(), np.asarray(getattr(r, name).grad._data),
                rtol=1e-4, atol=1e-5, err_msg=name)
    wrapped = mp.TensorParallel(p_gat, ph)
    assert set(wrapped.state_dict()) == {"weight", "bias"}
    wrapped.set_state_dict(p_gat.state_dict())
    assert isinstance(mp.ShardingParallel(p_gat, ph), mp.TensorParallel)
    assert isinstance(mp.SegmentParallel(p_gat, ph), mp.TensorParallel)


class _SPBlock:
    """scatter -> column (gathers seq, shards feature) -> relu -> row
    (reduce-scatters back) -> all_gather, in either package."""

    @staticmethod
    def build(nn, sp, h, ffn):
        class Block(nn.Layer):
            def __init__(self):
                super().__init__()
                self.col = sp.ColumnSequenceParallelLinear(h, ffn)
                self.row = sp.RowSequenceParallelLinear(ffn, h)

            def forward(self, x):
                x = sp.scatter(x)
                y = nn.functional.relu(self.col(x))
                return sp.all_gather(self.row(y))
        return Block()


def test_sequence_parallel_block_matches_reference(fleets):
    _, ph = fleets
    paddle.seed(1)
    rb = _SPBlock.build(rnn, rspu, 8, 16)
    pb = _SPBlock.build(pnn, spu, 8, 16)
    _copy(rb, pb)
    x = np.random.RandomState(1).randn(4, 2, 8).astype(np.float32)
    rout = rb(paddle.Tensor(jnp.asarray(x)))
    pout = pb(torch.as_tensor(x))
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(rout._data),
                               rtol=TOL, atol=TOL)
    ((rout * rout).mean()).backward()
    ((pout * pout).mean()).backward()
    for name, t in pb.named_parameters():
        layer, attr = name.split(".")
        want = getattr(getattr(rb, layer), attr).grad._data
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    mp_axis = ph.mesh.dim_names.index("mp")
    assert spu.scatter(torch.ones(4, 2, 8)).placements[mp_axis] == \
        pt.distributed.Shard(0)
    assert spu.all_gather(torch.ones(4, 2, 8)).placements[mp_axis] == \
        pt.distributed.Replicate()
    assert spu.reduce_scatter(torch.ones(4, 2, 8)).placements[mp_axis] == \
        pt.distributed.Shard(0)
    assert pb.col.weight.placements[mp_axis] == pt.distributed.Shard(1)
    assert pb.row.weight.placements[mp_axis] == pt.distributed.Shard(0)


def test_sequence_parallel_spellings_and_marks(fleets):
    x = torch.ones(4, 2, 2)
    for op in (spu.ScatterOp, spu.GatherOp, spu.AllGatherOp,
               spu.ReduceScatterOp):
        assert torch.equal(op.apply(x), x) and torch.equal(op(x), x)
    ln = pnn.LayerNorm(4, device=CPU)
    spu.mark_as_sequence_parallel_parameter(ln.weight)
    assert spu.is_sequence_parallel_parameter(ln.weight)
    assert not spu.is_sequence_parallel_parameter(ln.bias)
    assert spu.register_sequence_parallel_allreduce_hooks(ln) == [ln.weight]
    with pytest.warns(RuntimeWarning, match="no parameter is marked"):
        spu.register_sequence_parallel_allreduce_hooks(
            pnn.Linear(2, 2, device=CPU))
    with pytest.raises(ValueError, match="gather_output"):
        spu.ColumnSequenceParallelLinear(4, 8, gather_output=True)
    row = spu.RowSequenceParallelLinear(4, 4, input_is_parallel=False)
    assert row(torch.ones(2, 1, 4)).shape == (2, 1, 4)


def _pipe(nn, mp_mod, **kw):
    return mp_mod.PipelineLayer(
        [mp_mod.LayerDesc(nn.Linear, 8, 16, **kw), nn.ReLU(),
         mp_mod.LayerDesc(nn.Linear, 16, 16, **kw),
         mp_mod.LayerDesc(nn.Linear, 16, 4, **kw)],
        num_stages=2, loss_fn=nn.CrossEntropyLoss())


def test_pipeline_parallel_train_batch_matches_reference(fleets):
    rh, ph = fleets
    paddle.seed(2)
    rpipe = _pipe(rnn, rmp)
    ppipe = _pipe(pnn, mp, device=CPU)
    _copy(rpipe, ppipe)
    assert ppipe.num_stages == 2 and len(ppipe.get_stage_fns()) == 2
    rpp = rmp.PipelineParallel(rpipe, rh, _strategy(rfleet, pp=2))
    ppp = mp.PipelineParallel(ppipe, ph, _strategy(fleet, pp=2))
    ropt_ = ropt.AdamW(1e-2, parameters=rpipe.parameters())
    popt_ = popt.AdamW(1e-2, parameters=ppipe.parameters())
    rs = np.random.RandomState(3)
    got, want = [], []
    for _ in range(3):
        x = rs.randn(8, 8).astype(np.float32)
        y = rs.randint(0, 4, (8,))
        want.append(float(rpp.train_batch(
            (paddle.Tensor(jnp.asarray(x)), paddle.Tensor(jnp.asarray(y))),
            ropt_)._data))
        got.append(float(ppp.train_batch((torch.as_tensor(x),
                                          torch.as_tensor(y)), popt_)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    for k, v in rpipe.state_dict().items():
        np.testing.assert_allclose(ppipe.state_dict()[k].numpy(),
                                   np.asarray(v._data), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    x = rs.randn(8, 8).astype(np.float32)
    y = rs.randint(0, 4, (8,))
    ev = ppp.eval_batch((torch.as_tensor(x), torch.as_tensor(y)))
    rev = rpp.eval_batch((paddle.Tensor(jnp.asarray(x)),
                          paddle.Tensor(jnp.asarray(y))))
    np.testing.assert_allclose(float(ev), float(rev._data), rtol=1e-4)
    # stage functions compose to the whole layer
    xt = torch.as_tensor(x)
    h = xt
    for fn in ppipe.get_stage_fns():
        h = fn(h)
    torch.testing.assert_close(h, ppp(xt))
    assert set(ppp.state_dict()) == set(ppipe.state_dict())


def test_shared_layer_desc_ties_one_layer():
    pipe = mp.PipelineLayer(
        [mp.SharedLayerDesc("emb", pnn.Linear, None, "weight", 4, 4,
                            device=CPU),
         mp.SharedLayerDesc("emb", pnn.Linear, lambda l, x: x @ l.weight,
                            "weight", 4, 4, device=CPU)])
    (a, _), (b, f) = pipe.run_function
    assert a is b and f is not None
    x = torch.ones(2, 4)
    torch.testing.assert_close(pipe(x), a(x) @ a.weight)
    with pytest.raises(TypeError):
        mp.PipelineLayer([3])


def test_sharding_optimizers_mark_their_states(fleets):
    rh, ph = fleets
    net = pnn.Linear(4, 6, device=CPU)
    opt = fleet.meta_optimizers.DygraphShardingOptimizer(
        popt.AdamW(1e-2, parameters=net.parameters()), ph)
    net(torch.ones(2, 4)).sum().backward()
    opt.step()
    opt.clear_grad()
    dp = ph.mesh.dim_names.index("dp")
    st = opt._accumulators[id(net.weight)]
    assert st["moment1"].placements[dp] == pt.distributed.Shard(0)
    hopt = fleet.meta_optimizers.HybridParallelOptimizer(
        popt.SGD(0.5, parameters=net.parameters()), ph)
    w = net.weight.detach().clone()
    hopt.minimize(net(torch.ones(2, 4)).sum())
    assert not torch.equal(net.weight, w)


def test_recompute_matches_plain_and_replays_dropout():
    lin = pnn.Linear(8, 8, device=CPU)
    drop = pnn.Dropout(0.5)

    def block(x):
        return drop(torch.tanh(lin(x)))

    x = torch.randn(4, 8, requires_grad=True)
    pt.seed(0)
    plain = block(x)
    plain.sum().backward()
    g_plain = (x.grad.clone(), lin.weight.grad.clone())
    x.grad = None
    lin.weight.grad = None
    lin.bias.grad = None
    pt.seed(0)
    out = recompute(block, x)
    torch.testing.assert_close(out, plain)
    out.sum().backward()
    torch.testing.assert_close(x.grad, g_plain[0])
    torch.testing.assert_close(lin.weight.grad, g_plain[1])
    fns = [pnn.Linear(8, 8, device=CPU) for _ in range(4)]
    y = fleet.utils.recompute_sequential({"segments": 2}, fns, x)
    want = x
    for f in fns:
        want = f(want)
    torch.testing.assert_close(y, want)


def test_elastic_membership_on_the_port_store():
    store = TCPStore("127.0.0.1", 0, is_master=True, world_size=1,
                     timeout=10)
    try:
        a = elastic.ElasticManager(store, node_id="nodeA", np_range=(2, 3),
                                   heartbeat_interval=0.2)
        b = elastic.ElasticManager(store, node_id="nodeB", np_range=(2, 3),
                                   heartbeat_interval=0.2)
        a.register()
        b.register()
        assert set(a.alive_nodes()) == {"nodeA", "nodeB"}
        assert a.health() == elastic.ElasticStatus.COMPLETED
        b.deregister()
        assert set(a.alive_nodes()) == {"nodeA"}
        assert a.health() == elastic.ElasticStatus.HOLD
        changes = []
        c = elastic.ElasticManager(store, node_id="n1", np_range=(1, 3),
                                   heartbeat_interval=0.2,
                                   on_change=changes.append)
        c.register()
        c.start()

        def joiner():
            time.sleep(0.4)
            elastic.ElasticManager(store, node_id="n2", np_range=(1, 3),
                                   heartbeat_interval=0.2).register()

        th = threading.Thread(target=joiner)
        th.start()
        status = c.watch(poll=0.2, max_wait=5)
        th.join()
        c.stop()
        assert status == elastic.ElasticStatus.RESTART
        assert changes and "n2" in changes[0]
        assert c.restarts == 1
    finally:
        store.close()
