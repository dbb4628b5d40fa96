"""The port's distributed checkpoint against the JAX package's on the CPU
(the reference on its 8 virtual devices): for the same state and layout
the two write the same files, byte for byte, metadata.json included; each
loads the other's directory onto another layout; a load opens only the
chunks it needs; corruption, a non-owner process, a kill between the
chunk writes and the metadata, a transient write fault and an async save
behave as the reference promises. Then distributed.io, group sharding,
DataParallel and SyncBatchNorm."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

import paddle_tpu as paddle
import paddle_tpu.distributed as rdist
from paddle_tpu.distributed import checkpoint as rckpt
import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.resilience import faults
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"


def _ref_put(value, mesh_shape, names, spec):
    devs = np.asarray(jax.devices()[:int(np.prod(mesh_shape))]) \
        .reshape(mesh_shape)
    return jax.device_put(jnp.asarray(value),
                          NamedSharding(Mesh(devs, tuple(names)), JP(*spec)))


def _port_put(value, mesh_shape, names, spec):
    """The same layout as marks on a port tensor."""
    from paddle_tpu_torch.distributed.placement import P, spec_to_placements
    mesh = dist.ProcessMesh(shape=mesh_shape, dim_names=names, device=CPU)
    t = torch.as_tensor(value) if not isinstance(value, torch.Tensor) \
        else value
    return dist.shard_tensor(t, mesh, spec_to_placements(P(*spec), mesh,
                                                         t.ndim))


def _bf16_pair(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    t = torch.as_tensor(x).bfloat16()
    return jnp.asarray(x).astype(jnp.bfloat16), t


def _state(layout):
    """(reference state, port state) of one layout case."""
    rs = np.random.RandomState(0)
    w = rs.randn(8, 8).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    n = np.arange(12, dtype=np.int32).reshape(3, 4)
    jb, tb = _bf16_pair((4, 6), 1)
    if layout == "2d":
        m, names = (2, 4), ("x", "y")
        specs = {"w": ("x", "y"), "b": ("y",), "n": (), "h": (None, "x")}
    elif layout == "two_axes":
        m, names = (4, 2), ("a", "b")
        specs = {"w": (("a", "b"), None), "b": ("a",), "n": (), "h": ("b",)}
    else:   # three axes
        m, names = (2, 2, 2), ("p", "q", "r")
        specs = {"w": ("q", ("p", "r")), "b": (("p", "q", "r"),),
                 "n": (None, "q"), "h": ("p", "q")}
    vals = {"w": w, "b": b, "n": n}
    ref = {k: _ref_put(v, m, names, specs[k]) for k, v in vals.items()}
    ref["h"] = _ref_put(jb, m, names, specs["h"])
    port = {k: _port_put(v, m, names, specs[k]) for k, v in vals.items()}
    port["h"] = _port_put(tb, m, names, specs["h"])
    return ref, port


def _files(path):
    return {f: (path / f).read_bytes() for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("layout", ["2d", "two_axes", "three_axes"])
def test_files_are_byte_equal_to_the_references(layout, tmp_path):
    ref, port = _state(layout)
    rckpt.save_state_dict(ref, str(tmp_path / "ref"))
    ckpt.save_state_dict(port, str(tmp_path / "port"))
    want, got = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f
    meta = json.loads(want["metadata.json"])
    # each distinct chunk once: the data files hold each element once
    for k, a in meta["arrays"].items():
        n = sum(np.prod([b - a0 for a0, b in c["bounds"]])
                for c in a["chunks"])
        assert n == np.prod(a["shape"]), k


def test_plain_tensors_write_one_chunk_each(tmp_path):
    x = np.arange(10, dtype=np.float32)
    rckpt.save_state_dict({"x": jnp.asarray(x)}, str(tmp_path / "ref"))
    ckpt.save_state_dict({"x": torch.as_tensor(x)}, str(tmp_path / "port"))
    assert _files(tmp_path / "ref") == _files(tmp_path / "port")
    ckpt.save_state_dict({"x": x}, str(tmp_path / "np"))
    assert _files(tmp_path / "ref") == _files(tmp_path / "np")


def test_each_package_loads_the_others_directory(tmp_path):
    ref, port = _state("2d")
    rckpt.save_state_dict(ref, str(tmp_path / "ref"))
    ckpt.save_state_dict(port, str(tmp_path / "port"))
    # the port loads the reference's onto another layout and onto plain
    # tensors
    for target in ({k: _port_put(torch.zeros_like(v), (4, 2), ("u", "v"),
                                 ("u",) if v.shape[0] % 4 == 0
                                 else (None, "v"))
                    for k, v in port.items()},
                   {k: torch.zeros_like(v) for k, v in port.items()}):
        ckpt.load_state_dict(target, str(tmp_path / "ref"))
        for k, v in port.items():
            assert torch.equal(target[k], v), k
    # the reference loads the port's onto its own other layout; bfloat16
    # is left out: numpy has no cast from the '<V2' words it reads to
    # ml_dtypes' bfloat16, so the reference cannot load its own bfloat16
    # chunks either (ROADMAP Queue 3)
    rtarget = {k: _ref_put(jnp.zeros(v.shape, v.dtype), (8,), ("z",),
                           (None,)) for k, v in ref.items() if k != "h"}
    rckpt.load_state_dict(rtarget, str(tmp_path / "port"))
    for k, v in rtarget.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(ref[k]))
    # non-tensor entries come back as CPU tensors
    loose = {"w": None}
    ckpt.load_state_dict(loose, str(tmp_path / "port"))
    assert torch.equal(loose["w"], port["w"])


def test_a_load_opens_only_the_chunks_it_needs(tmp_path):
    _, port = _state("two_axes")
    ckpt.save_state_dict(port, str(tmp_path))
    meta = json.load(open(tmp_path / "metadata.json"))
    target = {"w": torch.zeros(8, 8)}
    ckpt.load_state_dict(target, str(tmp_path))
    files = {c["file"] for c in meta["arrays"]["w"]["chunks"]}
    assert ckpt.last_load_stats["files"] == len(files) == 8
    assert ckpt.last_load_stats["bytes"] == 8 * 8 * 4
    assert torch.equal(target["w"], port["w"])
    full = {k: torch.zeros_like(v) for k, v in port.items()}
    ckpt.load_state_dict(full, str(tmp_path))
    assert ckpt.last_load_stats["bytes"] == sum(
        v.numel() * v.element_size() for v in port.values())


def test_corruption_names_the_file(tmp_path):
    _, port = _state("2d")
    ckpt.save_state_dict(port, str(tmp_path))
    meta = json.load(open(tmp_path / "metadata.json"))
    chunk = meta["arrays"]["w"]["chunks"][3]["file"]
    data = bytearray((tmp_path / chunk).read_bytes())
    data[-1] ^= 0xFF
    (tmp_path / chunk).write_bytes(bytes(data))
    with pytest.raises(ckpt.CheckpointCorruptionError, match=chunk) as e:
        ckpt.load_state_dict({"w": torch.zeros(8, 8)}, str(tmp_path))
    assert e.value.file == chunk and "sha256" in e.value.reason
    with pytest.raises(rckpt.CheckpointCorruptionError, match=chunk):
        rckpt.load_state_dict({"w": jnp.zeros((8, 8))}, str(tmp_path))
    # the other arrays still load
    ckpt.load_state_dict({"b": torch.zeros(16)}, str(tmp_path))
    (tmp_path / chunk).write_bytes(bytes(data[:40]))
    with pytest.raises(ckpt.CheckpointCorruptionError, match=chunk):
        ckpt.load_state_dict({"w": torch.zeros(8, 8)}, str(tmp_path))
    os.unlink(tmp_path / chunk)
    with pytest.raises(ckpt.CheckpointCorruptionError, match="missing"):
        ckpt.load_state_dict({"w": torch.zeros(8, 8)}, str(tmp_path))


def test_mismatches_raise(tmp_path):
    ckpt.save_state_dict({"w": torch.zeros(4, 3)}, str(tmp_path))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_state_dict({"w": torch.zeros(5, 3)}, str(tmp_path))
    with pytest.raises(KeyError, match="missing key"):
        ckpt.load_state_dict({"v": torch.zeros(4, 3)}, str(tmp_path))
    meta = json.load(open(tmp_path / "metadata.json"))
    meta["version"] = 2
    json.dump(meta, open(tmp_path / "metadata.json", "w"))
    with pytest.raises(ValueError, match="version 2"):
        ckpt.load_state_dict({"w": torch.zeros(4, 3)}, str(tmp_path))


def test_non_owner_process_writes_nothing(tmp_path, monkeypatch):
    """Every chunk belongs to process 0; another process writes no data
    file and no metadata, as the reference's."""
    _, port = _state("2d")
    monkeypatch.setattr(ckpt, "get_rank", lambda *a, **k: 1)
    ckpt.save_state_dict(port, str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_kill_between_chunks_and_metadata_keeps_previous(tmp_path):
    v1 = {"w": torch.full((4, 4), 1.0), "b": torch.full((4,), 10.0)}
    ckpt.save_state_dict(v1, str(tmp_path))
    v2 = {"w": torch.full((4, 4), 2.0), "b": torch.full((4,), 20.0)}
    with faults.injected_faults("ckpt.metadata_replace:1:RuntimeError"):
        with pytest.raises(RuntimeError, match="injected fault"):
            ckpt.save_state_dict(v2, str(tmp_path))
    assert any(f.startswith("s1_") for f in os.listdir(tmp_path))
    target = {"w": torch.zeros(4, 4), "b": torch.zeros(4)}
    ckpt.load_state_dict(target, str(tmp_path))
    assert torch.equal(target["w"], v1["w"]) and \
        torch.equal(target["b"], v1["b"])
    # the next committed saves collect the stale seqs, one save late
    for i in range(3):
        ckpt.save_state_dict({"w": torch.full((4, 4), float(i))},
                             str(tmp_path))
    names = os.listdir(tmp_path)
    assert not any(f.startswith(("s0_", "s1_")) for f in names)
    assert any(f.startswith("s3_") for f in names)
    meta = json.load(open(tmp_path / "metadata.json"))
    assert meta["save_seq"] == 3 and meta["version"] == 4


def test_transient_chunk_write_fault_is_retried(tmp_path):
    with faults.injected_faults("ckpt.chunk_write:1:OSError"):
        ckpt.save_state_dict({"w": torch.arange(8.0)}, str(tmp_path))
        assert faults.injected_counts() == {"ckpt.chunk_write": 1}
    target = {"w": torch.zeros(8)}
    ckpt.load_state_dict(target, str(tmp_path))
    assert torch.equal(target["w"], torch.arange(8.0))


def test_async_save_then_load(tmp_path):
    pt.seed(0)
    m = pt.nn.Linear(4, 3, device=CPU)
    ckpt.save_state_dict(m.state_dict(), str(tmp_path), async_save=True)
    pt.seed(1)
    m2 = pt.nn.Linear(4, 3, device=CPU)
    ckpt.load_state_dict(m2.state_dict(keep_vars=True), str(tmp_path))
    for k, v in m.state_dict().items():
        assert torch.equal(v, m2.state_dict()[k])
    assert dist.save_state_dict is ckpt.save_state_dict
    assert dist.load_state_dict is ckpt.load_state_dict


# -- distributed.io, group sharding, DataParallel, SyncBatchNorm ------------

def test_io_persistables_round_trip(tmp_path):
    m = pt.nn.Linear(3, 2, device=CPU)
    dist.io.save_persistables(None, str(tmp_path), m)
    m2 = pt.nn.Linear(3, 2, device=CPU)
    state = dist.io.load_persistables(None, str(tmp_path), m2)
    assert set(state) == {"weight", "bias"}
    assert torch.equal(m2.weight, m.weight)
    assert not dist.io.is_persistable(m.weight)
    dist.io.save_persistables(None, str(tmp_path / "e"), None, "x.pd")
    assert dist.io.load_persistables(None, str(tmp_path / "e"),
                                     filename="x.pd") == {}


def test_group_sharded_parallel_and_save(tmp_path):
    net = pt.nn.Linear(4, 4, device=CPU)
    opt = pt.optimizer.AdamW(1e-2, parameters=net.parameters())
    model, sopt, scaler = dist.group_sharded_parallel(net, opt, "p_g_os")
    assert model is net and scaler is None and sopt._stage == 3
    rnet = paddle.nn.Linear(4, 4)
    _, rsopt, _ = rdist.group_sharded_parallel(
        rnet, paddle.optimizer.AdamW(1e-2, parameters=rnet.parameters()),
        "os_g")
    assert rsopt._stage == dist.group_sharded_parallel(
        net, opt, "os_g")[1]._stage == 2
    net(torch.ones(2, 4)).sum().backward()
    sopt.step()
    sopt.clear_grad()
    dist.save_group_sharded_model(net, str(tmp_path), sopt)
    assert sorted(os.listdir(tmp_path)) == ["model.pdopt", "model.pdparams"]
    net2 = pt.nn.Linear(4, 4, device=CPU)
    net2.set_state_dict(pt.load(str(tmp_path / "model.pdparams")))
    assert torch.equal(net2.weight, net.weight)
    opt2 = pt.optimizer.AdamW(1e-2, parameters=net2.parameters())
    opt2.set_state_dict(pt.load(str(tmp_path / "model.pdopt")))
    assert torch.equal(opt2._accumulators[id(net2.weight)]["moment1"],
                       opt._accumulators[id(net.weight)]["moment1"])


def _convnet(nn, **kw):
    return nn.Sequential(nn.Conv2D(3, 4, 3, **kw), nn.BatchNorm2D(4, **kw),
                         nn.ReLU(), nn.Conv2D(4, 2, 1, **kw),
                         nn.BatchNorm2D(2, **kw))


def test_data_parallel_and_sync_batch_norm_match_reference():
    paddle.seed(0)
    ref = _convnet(paddle.nn)
    port = _convnet(pt.nn, device=CPU)
    port.set_state_dict({k: np.asarray(v._data)
                         for k, v in ref.state_dict().items()})
    plain = _convnet(pt.nn, device=CPU)
    plain.set_state_dict(port.state_dict())
    ref = paddle.DataParallel(paddle.nn.SyncBatchNorm.convert_sync_batchnorm(
        ref))
    port = pt.DataParallel(pt.nn.SyncBatchNorm.convert_sync_batchnorm(port))
    assert type(port._layers[1]).__name__ == "SyncBatchNorm"
    assert set(port.state_dict()) == set(ref.state_dict())
    x = np.random.RandomState(0).randn(4, 3, 6, 6).astype(np.float32)
    out = port(torch.as_tensor(x))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(ref(paddle.Tensor(
                                   jnp.asarray(x)))._data),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out, plain(torch.as_tensor(x)))
    for k, v in port.state_dict().items():   # running stats moved alike
        torch.testing.assert_close(v, plain.state_dict()[k])
    with port.no_sync():
        port.scale_loss(out.sum()).backward()
    port.apply_collective_grads()
    port.set_state_dict(plain.state_dict())
    assert port._layers[1].weight.grad is not None
