"""The port's DTensor layer against the JAX package's on the CPU (the
reference on its 8 virtual devices): placements, ProcessMesh and its chunk
map (key by key against NamedSharding.devices_indices_map), the nine
functions of distributed/api.py, Engine / DistModel / to_static, the
auto-tuner and the distributed package's shims."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.distributed as rdist
from paddle_tpu import nn as rnn
from paddle_tpu import optimizer as ropt
from paddle_tpu.distributed import placement as rplace
import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.distributed import placement
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"


def _ref_map(mesh_shape, names, placements, shape):
    """The reference's chunk map: {device id: tuple of slices}."""
    mesh = rdist.ProcessMesh(shape=mesh_shape, dim_names=names)
    sh = rplace.named_sharding(mesh, placements, len(shape))
    return {d.id: idx for d, idx in sh.devices_indices_map(shape).items()}


def _port_map(mesh_shape, names, placements, shape):
    mesh = dist.ProcessMesh(shape=mesh_shape, dim_names=names, device=CPU)
    return placement.chunk_map(mesh, placements, shape)


def _both(*args):
    """The same placements built in each package."""
    out = []
    for m in (rdist, dist):
        out.append([m.Shard(a) if k == "s" else m.Replicate() if k == "r"
                    else m.Partial() for k, a in args])
    return out


CHUNK_CASES = [
    # (mesh shape, names, placements per axis, tensor shape)
    ([8], ["x"], [("s", 0)], (16, 4)),
    ([8], ["x"], [("s", 1)], (3, 16)),
    ([8], ["x"], [("r", 0)], (5, 7)),
    ([8], ["x"], [("p", 0)], (8,)),
    ([2, 4], ["a", "b"], [("s", 0), ("s", 1)], (8, 8)),
    ([2, 4], ["a", "b"], [("s", 1), ("s", 0)], (8, 8)),
    ([4, 2], ["a", "b"], [("s", 0), ("r", 0)], (12, 3)),
    ([4, 2], ["a", "b"], [("s", 0), ("s", 0)], (16, 2)),   # one dim, 2 axes
    ([2, 4], ["a", "b"], [("s", 1), ("s", 1)], (3, 8, 2)),
    ([1, 8], ["a", "b"], [("s", 0), ("s", 1)], (4, 8)),     # an axis of 1
    ([2, 2, 2], ["x", "y", "z"], [("s", 0), ("s", 1), ("s", 2)], (4, 6, 8)),
    ([2, 2, 2], ["x", "y", "z"], [("s", 2), ("r", 0), ("s", 2)], (2, 2, 8)),
    ([2, 2, 2], ["x", "y", "z"], [("s", 0), ("s", 0), ("s", 0)], (16,)),
    ([2, 2, 2], ["x", "y", "z"], [("p", 0), ("s", 1), ("r", 0)], (3, 4)),
]


@pytest.mark.parametrize("mesh_shape,names,kinds,shape", CHUNK_CASES)
def test_chunk_map_is_devices_indices_map(mesh_shape, names, kinds, shape):
    rp, pp = _both(*kinds)
    want = _ref_map(mesh_shape, names, rp, shape)
    got = _port_map(mesh_shape, names, pp, shape)
    assert set(got) == set(want)
    for pid in want:
        assert got[pid] == want[pid], pid


@pytest.mark.parametrize("mesh_shape,names,kinds,shape", [
    ([8], ["x"], [("s", 0)], (12, 4)),
    ([2, 4], ["a", "b"], [("r", 0), ("s", 1)], (8, 6)),
    ([4, 2], ["a", "b"], [("s", 0), ("s", 0)], (12,)),
])
def test_a_dim_that_does_not_divide_raises(mesh_shape, names, kinds, shape):
    rp, pp = _both(*kinds)
    mesh = rdist.ProcessMesh(shape=mesh_shape, dim_names=names)
    with pytest.raises(ValueError):
        rdist.shard_tensor(paddle.Tensor(jnp.zeros(shape)), mesh, rp)
    with pytest.raises(ValueError):
        _port_map(mesh_shape, names, pp, shape)
    pmesh = dist.ProcessMesh(shape=mesh_shape, dim_names=names, device=CPU)
    with pytest.raises(ValueError):
        dist.shard_tensor(torch.zeros(shape), pmesh, pp)


def test_to_partition_spec_and_its_inversion():
    for kinds, nd in [([("s", 0), ("s", 1)], 2), ([("s", 1), ("s", 1)], 3),
                      ([("r", 0), ("p", 0)], 1), ([("s", 2), ("s", 0)], 4)]:
        rp, pp = _both(*kinds)
        assert placement.to_partition_spec(pp, nd) == \
            rplace.to_partition_spec(rp, nd)
        assert placement.to_partition_spec(pp) == rplace.to_partition_spec(rp)
    mesh = dist.ProcessMesh(shape=[2, 2, 2], dim_names=["x", "y", "z"],
                            device=CPU)
    spec = placement.P(("x", "z"), None, "y")
    pl = placement.spec_to_placements(spec, mesh, 3)
    assert pl == [dist.Shard(0), dist.Shard(2), dist.Shard(0)]
    assert placement.to_partition_spec(pl, 3) == [(0, 2), None, 1]
    with pytest.raises(ValueError, match="order"):
        placement.spec_to_placements(placement.P(("z", "x")), mesh, 1)


def test_process_mesh_matches_reference():
    r = rdist.ProcessMesh(shape=[2, 4], dim_names=["dp", "mp"])
    p = dist.ProcessMesh(shape=[2, 4], dim_names=["dp", "mp"], device=CPU)
    assert (p.shape, p.ndim, p.dim_names, p.process_ids) == \
        (r.shape, r.ndim, r.dim_names, r.process_ids)
    assert p.get_dim_size("mp") == r.get_dim_size("mp") == 4
    for index in (None, 1):
        rs, ps = r.get_mesh_with_dim("mp", index), \
            p.get_mesh_with_dim("mp", index)
        assert (ps.shape, ps.dim_names) == (rs.shape, rs.dim_names)
        ids = np.vectorize(lambda d: d.id)(rs.mesh.devices)
        np.testing.assert_array_equal(ps.mesh, ids)
    assert p == dist.ProcessMesh(shape=[2, 4], dim_names=["dp", "mp"],
                                 device=CPU)
    assert repr(p) == repr(r)
    assert dist.ProcessMesh([[0, 1], [2, 3]], device=CPU).dim_names == \
        ["d0", "d1"]
    assert p.device_of(5) == torch.device("cpu")
    with p:
        assert dist.get_mesh() is p
    assert dist.get_mesh() is None
    dist.set_mesh(p)
    assert dist.get_mesh() is p
    dist.set_mesh(None)
    assert placement.build_mesh([4], ["x"], device=CPU).shape == [4]


def test_process_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.ProcessMesh(shape=[2], dim_names=["x"])


def _pair_tensor(shape, seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return paddle.Tensor(jnp.asarray(x)), torch.as_tensor(x)


def test_shard_reshard_unshard_values_and_marks():
    rm = rdist.ProcessMesh(shape=[2, 4], dim_names=["x", "y"])
    pm = dist.ProcessMesh(shape=[2, 4], dim_names=["x", "y"], device=CPU)
    rx, px = _pair_tensor((8, 8))
    rp, pp = _both(("s", 0), ("s", 1))
    rt, ptt = rdist.shard_tensor(rx, rm, rp), dist.shard_tensor(px, pm, pp)
    assert ptt.placements == pp and ptt.process_mesh is pm
    np.testing.assert_array_equal(ptt.numpy(), np.asarray(rt._data))
    r2p, p2p = _both(("r", 0), ("s", 0))
    rr, pr = rdist.reshard(rt, rm, r2p), dist.reshard(ptt, pm, p2p)
    assert pr is not ptt and pr.placements == p2p and \
        ptt.placements == pp
    np.testing.assert_array_equal(pr.numpy(), np.asarray(rr._data))
    ru, pu = rdist.unshard_dtensor(rr), dist.unshard_dtensor(pr)
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ru._data))
    assert not hasattr(pu, "placements") and not hasattr(ru, "placements")
    # autograd passes through reshard
    w = px.clone().requires_grad_(True)
    dist.reshard(dist.shard_tensor(w, pm, pp), pm, p2p).sum().backward()
    assert w.grad is None      # shard_tensor of a non-Parameter detaches
    w2 = px.clone().requires_grad_(True)
    dist.reshard(w2, pm, p2p).mul(2).sum().backward()
    torch.testing.assert_close(w2.grad, torch.full_like(px, 2.0))


def test_partial_to_replicate_is_the_identity():
    """reference: tests/test_auto_parallel.py:167-174."""
    mesh = dist.ProcessMesh(shape=[4], dim_names=["mp"], device=CPU)
    x = torch.arange(8, dtype=torch.float32)
    t = dist.shard_tensor(x, mesh, [dist.Partial()])
    assert t.placements[0].is_partial()
    r = dist.reshard(t, mesh, [dist.Replicate()])
    assert torch.equal(r, x) and r.placements[0].is_replicate()


def test_shard_tensor_forms():
    mesh = dist.ProcessMesh(shape=[2, 2], dim_names=["dp", "mp"], device=CPU)
    # a Parameter is marked in place
    p = torch.nn.Parameter(torch.ones(4, 2))
    out = dist.shard_tensor(p, mesh, [dist.Shard(0), dist.Replicate()])
    assert out is p and p.placements[0] == dist.Shard(0)
    # the legacy DistAttr form, as the reference reads it
    attr = dist.DistAttr(mesh, ["mp", None])
    t = dist.shard_tensor(torch.zeros(4, 3), dist_attr=attr)
    assert t.placements == [dist.Replicate(), dist.Shard(0)]
    t = dist.shard_tensor(torch.zeros(4, 3), attr)
    assert t.placements == [dist.Replicate(), dist.Shard(0)]
    ref = rdist.shard_tensor(paddle.Tensor(jnp.zeros((4, 3))), rdist.DistAttr(
        rdist.ProcessMesh(shape=[2, 2], dim_names=["dp", "mp"]),
        ["mp", None]))
    assert [repr(x) for x in ref.placements] == [repr(x) for x in
                                                 t.placements]
    # numpy input, dtype and stop_gradient
    t = dist.shard_tensor(np.ones(4), mesh, [dist.Shard(0), dist.Replicate()],
                          dtype="float32", stop_gradient=False)
    assert t.dtype == torch.float32 and t.requires_grad
    assert repr(attr).startswith("DistAttr(")
    # from a function and from a local tensor
    t = dist.dtensor_from_fn(torch.ones, mesh, [dist.Shard(1),
                                                dist.Replicate()], 2, 4)
    assert t.shape == (2, 4) and t.placements[0] == dist.Shard(1)
    t = dist.dtensor_from_local(torch.ones(4), mesh,
                                [dist.Replicate(), dist.Shard(0)])
    assert t.placements[1] == dist.Shard(0)


def test_shard_layer_hooks_and_optimizer():
    mesh = dist.ProcessMesh(shape=[2], dim_names=["x"], device=CPU)
    net = pt.nn.Linear(4, 2, device=CPU)
    calls = []
    dist.shard_layer(net, mesh,
                     input_fn=lambda inputs, m: calls.append("in") or inputs,
                     output_fn=lambda out, m: calls.append("out") or out * 2)
    assert all(p.placements == [dist.Replicate()] for p in net.parameters())
    x = torch.randn(3, 4)
    torch.testing.assert_close(net(x), 2 * (x @ net.weight + net.bias))
    assert calls == ["in", "out"]

    def shard_fn(name, sub, m):
        if isinstance(sub, pt.nn.Linear):
            dist.shard_tensor(sub.weight, m, [dist.Shard(1)])
    dist.shard_layer(net, mesh, shard_fn)
    assert net.weight.placements == [dist.Shard(1)]

    opt = pt.optimizer.AdamW(1e-2, parameters=net.parameters())
    seen = []

    def state_fn(key, param, state):
        seen.append(key)
        return dist.shard_tensor(state, mesh, [dist.Shard(0)])
    sopt = dist.shard_optimizer(opt, state_fn)
    net(x).sum().backward()
    sopt.step()
    sopt.clear_grad()
    assert all(p.grad is None for p in net.parameters())
    st = opt._accumulators[id(net.weight)]
    assert sorted(set(seen)) == ["moment1", "moment2"]
    assert st["moment1"].placements == [dist.Shard(0)]
    assert sopt.get_lr() == 1e-2


def test_shard_dataloader_and_to_distributed():
    mesh = dist.ProcessMesh(shape=[2, 2], dim_names=["dp", "mp"], device=CPU)
    batches = [(torch.ones(8, 3), torch.zeros(8)), (torch.ones(8, 3),
                                                    torch.zeros(8))]
    dl = dist.shard_dataloader(batches, mesh, shard_dims="dp")
    assert len(dl) == 2
    x, y = next(iter(dl))
    assert x.placements == [dist.Shard(0), dist.Replicate()]
    assert next(iter(dist.shard_dataloader(batches, mesh)))[0] is \
        batches[0][0]
    net = pt.nn.Sequential(pt.nn.Linear(3, 4, device=CPU),
                           pt.nn.BatchNorm1D(4, device=CPU))
    opt = pt.optimizer.Adam(1e-2, parameters=net.parameters())
    model, o, dl = dist.to_distributed(net, opt, batches, device_num=8)
    assert o is opt and model is net
    p = next(iter(model.parameters()))
    assert p.process_mesh.dim_names == ["dp"] and \
        p.process_mesh.shape == [8] and p.placements == [dist.Replicate()]
    assert net[1]._mean.placements == [dist.Replicate()]
    x, y = next(iter(dl))
    assert x.placements == [dist.Shard(0)]
    loss = model(x).sum()
    loss.backward()
    opt.step()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device_num"):
            dist.to_distributed(net)


# -- Engine / DistModel, against the reference's -----------------------------

def _mlp_pair():
    paddle.seed(0)
    ref = rnn.Sequential(rnn.Linear(8, 32), rnn.ReLU(), rnn.Linear(32, 4))
    port = pt.nn.Sequential(pt.nn.Linear(8, 32, device=CPU), pt.nn.ReLU(),
                            pt.nn.Linear(32, 4, device=CPU))
    load_reference_state(port, {k: np.asarray(v._data)
                                for k, v in ref.state_dict().items()})
    return ref, port


def _xy(n=32, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 8).astype(np.float32)
    y = np.argmax(x @ rs.randn(8, 4).astype(np.float32), 1).astype(np.int64)
    return x, y


class _Batches:
    """An iterable loader (no __getitem__): Engine uses it as it is."""

    def __init__(self, pairs):
        self._pairs = pairs

    def __iter__(self):
        return iter(self._pairs)


@pytest.fixture(scope="module")
def engine_reference():
    """The reference Engine's fit/evaluate/predict on its 8 devices."""
    x, y = _xy()
    ref, _ = _mlp_pair()
    st = rdist.Strategy()
    st.sharding.enable, st.sharding.stage, st.sharding.degree = True, 2, 2
    eng = rdist.Engine(ref, rnn.CrossEntropyLoss(),
                       ropt.Adam(1e-2, parameters=ref.parameters()),
                       strategy=st)
    pairs = [(jnp.asarray(x[i:i + 16]), jnp.asarray(y[i:i + 16]))
             for i in (0, 16)]
    hist = eng.fit(_Batches(pairs), epochs=2)
    ev = eng.evaluate(_Batches(pairs))
    pred = eng.predict(_Batches([p[0] for p in pairs]))
    return dict(hist=list(hist["loss"]), ev=ev["loss"], pred=pred,
                state={k: np.asarray(v._data)
                       for k, v in ref.state_dict().items()})


def test_engine_fit_evaluate_predict_match_reference(engine_reference):
    want = engine_reference
    x, y = _xy()
    _, port = _mlp_pair()
    st = dist.Strategy()
    st.sharding.enable, st.sharding.stage, st.sharding.degree = True, 2, 2
    st.dp_degree = 4           # the reference's 8 devices: dp 4 x sharding 2
    eng = dist.Engine(port, pt.nn.CrossEntropyLoss(),
                      pt.optimizer.Adam(1e-2, parameters=port.parameters()),
                      strategy=st)
    pairs = [(torch.as_tensor(x[i:i + 16]), torch.as_tensor(y[i:i + 16]))
             for i in (0, 16)]
    hist = eng.fit(_Batches(pairs), epochs=2)
    np.testing.assert_allclose(hist["loss"], want["hist"], rtol=1e-4,
                               atol=1e-5)
    assert eng._process_mesh().get_dim_size("sharding") == 2
    assert eng._process_mesh().get_dim_size("dp") == 4
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want["state"][k], rtol=1e-4,
                                   atol=1e-5)
    assert np.isclose(eng.evaluate(_Batches(pairs))["loss"], want["ev"],
                      rtol=1e-4)
    pred = eng.predict(_Batches([p[0] for p in pairs]))
    for a, b in zip(pred, want["pred"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert eng.main_program is not None


def test_engine_on_a_dataset_with_recompute_and_amp(tmp_path):
    x, y = _xy(64)

    class DS:
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return x[i], y[i]
    _, port = _mlp_pair()
    st = dist.Strategy()
    st.recompute.enable = True
    st.mp_degree = 2
    eng = dist.Engine(port, pt.nn.CrossEntropyLoss(),
                      pt.optimizer.Adam(1e-2, parameters=port.parameters()),
                      strategy=st)
    assert eng.main_program is None
    eng.prepare()
    hist = eng.fit(DS(), epochs=3, batch_size=16)
    assert hist["loss"][-1] < hist["loss"][0]
    assert eng.predict(DS(), batch_size=16, steps=1)[0].shape == (16, 4)
    assert np.isfinite(eng.evaluate(DS(), batch_size=16, steps=2)["loss"])
    path = str(tmp_path / "ck")
    eng.save(path)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    _, port2 = _mlp_pair()
    eng2 = dist.Engine(port2, pt.nn.CrossEntropyLoss(),
                       pt.optimizer.Adam(1e-2,
                                         parameters=port2.parameters()))
    eng2.load(path)
    for k, v in port2.state_dict().items():
        assert torch.equal(v, before[k])
    # amp casts the floating state to bf16 for the step, as the reference
    st = dist.Strategy()
    st.amp.enable = True
    _, port3 = _mlp_pair()
    eng3 = dist.Engine(port3, pt.nn.CrossEntropyLoss(),
                       pt.optimizer.Adam(1e-2,
                                         parameters=port3.parameters()),
                       strategy=st)
    tr = eng3._ensure_trainer()
    assert {t.dtype for t in tr.params.values()} == {torch.bfloat16}


def test_dist_model_matches_reference():
    x, y = _xy(16)
    ref, port = _mlp_pair()
    rdm = rdist.to_static(ref, loss=rnn.CrossEntropyLoss(),
                          optimizer=ropt.Adam(1e-2,
                                              parameters=ref.parameters()))
    pdm = dist.to_static(port, loss=pt.nn.CrossEntropyLoss(),
                         optimizer=pt.optimizer.Adam(
                             1e-2, parameters=port.parameters()),
                         mesh=dist.ProcessMesh(shape=[8], dim_names=["dp"],
                                               device=CPU))
    rx, ry = jnp.asarray(x), jnp.asarray(y)
    px, py = torch.as_tensor(x), torch.as_tensor(y)
    want = [float(rdm(rx, ry)) for _ in range(4)]
    got = [float(pdm(px, py)) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    rdm.eval()
    pdm.eval()
    assert np.isclose(float(pdm(px, py)), float(rdm(rx, ry)), rtol=1e-4)
    rdm.predict()
    pdm.predict()
    np.testing.assert_allclose(pdm(px).numpy(), np.asarray(rdm(rx)),
                               rtol=1e-4, atol=1e-5)
    assert set(pdm.state_dict()) == set(rdm.state_dict())
    assert pdm.engine is pdm._engine and pdm.train() is pdm


# -- the auto-tuner -----------------------------------------------------------

TUNER = dict(num_devices=8, global_batch_size=64, num_layers=24,
             hidden_size=2048, num_attention_heads=16, seq_length=2048,
             vocab_size=32000, hbm_bytes=80e9, peak_flops=989e12,
             ici_bandwidth=4.5e11)


@pytest.mark.parametrize("extra", [{}, dict(hbm_bytes=16e9),
                                   dict(candidates={"micro_batch_size": [1, 2],
                                                    "use_recompute": [True]},
                                        task_limit=5)])
def test_auto_tuner_ranks_as_reference(extra):
    kw = {**TUNER, **extra}
    ref = rdist.AutoTuner(rdist.TunerConfig(**kw))
    port = dist.AutoTuner(dist.TunerConfig(**kw))
    assert port.search_all() == ref.search_all()
    assert port.pruned_cfgs == ref.pruned_cfgs
    assert port.search_once() == ref.search_once()
    t = lambda c: c["estimated_step_time"] * (1 + c["mp_degree"])  # noqa
    rbest = rdist.AutoTuner(rdist.TunerConfig(**kw), measure_fn=t).tune(4)
    pbest = dist.AutoTuner(dist.TunerConfig(**kw), measure_fn=t).tune(4)
    assert pbest == rbest


def test_tuner_defaults_are_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults read it")
    kw = {k: v for k, v in TUNER.items()
          if k not in ("hbm_bytes", "peak_flops", "ici_bandwidth")}
    with pytest.raises(RuntimeError, match="hbm_bytes"):
        dist.TunerConfig(**kw)
    with pytest.raises(RuntimeError, match="peak_flops"):
        dist.TunerConfig(**kw, hbm_bytes=80e9)
    cfg = dist.TunerConfig(**kw, hbm_bytes=80e9, peak_flops=1e15,
                           ici_bandwidth=1e11)
    assert (cfg.hbm_bytes, cfg.peak_flops, cfg.ici_bandwidth) == \
        (80e9, 1e15, 1e11)


# -- the package's shims -------------------------------------------------------

def test_distributed_shims_behave_as_reference():
    for name in ("gloo_init_parallel_env", "gloo_barrier", "gloo_release"):
        for mod in (rdist, dist):
            with pytest.raises(NotImplementedError):
                getattr(mod, name)()
    assert dist.is_available() is torch.distributed.is_available()
    t = torch.ones(2)
    assert dist.wait(t) is t
    objs = [1, {"a": 2}]
    assert dist.broadcast_object_list(objs) is objs
    out = [None, None]
    assert dist.scatter_object_list(out, [7, 8]) == [7] == \
        rdist.scatter_object_list([None], [7, 8])
    assert dist.scatter_object_list(out, None) == []
    scaler = object()
    assert dist.shard_scaler(scaler) is scaler
    for name in ("kRedSum", "kRedMax", "kRedMin", "kRedProd", "kRedAvg"):
        assert getattr(dist.ReduceType, name) == \
            getattr(rdist.ReduceType, name)
    for name in ("DATA_PARALLEL", "TENSOR_PARALLEL", "PIPELINE_PARALLEL",
                 "SHARDING_PARALLEL"):
        assert getattr(dist.ParallelMode, name) == \
            getattr(rdist.ParallelMode, name)
    assert [dist.ShardingStage1().stage, dist.ShardingStage2.stage,
            dist.ShardingStage3.stage] == [1, 2, 3]
    with pytest.raises(NotImplementedError, match="fleet.meta_parallel"):
        dist.split(t, (2, 2), "linear")
    assert jax.devices()   # the reference ran on its virtual devices
