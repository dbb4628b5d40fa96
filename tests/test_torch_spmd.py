"""The port's mesh trainer (parallel/spmd.py) against the JAX package's on
the CPU, the reference on its 8 virtual devices: the mesh, the sharding
rules, the ZeRO axis, and SpmdTrainer on llama_tiny (2 layers, hidden 64)
at ZeRO stages 0-3 on dp2 x sharding4 and dp2 x mp2 x sharding2. Every
parameter's and optimizer state's chunk map equals the reference's
sharding key by key; the losses and parameters after three AdamW steps
agree within the tolerances of the Llama training parity
(tests/test_torch_llama.py, tests/test_torch_training.py); and the port's
stages and meshes agree bit for bit, since placements change no
arithmetic."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu import optimizer as ropt
from paddle_tpu.parallel import spmd as rspmd
import paddle_tpu_torch as pt
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.distributed.placement import P, chunk_map
from paddle_tpu_torch.parallel import spmd
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"
LOSS_RTOL = 1e-4      # test_torch_training.py's imperative training parity
TOL = 1e-4            # test_torch_llama.py's fp32 parity
KW = dict(hidden_size=64, intermediate_size=128)
MESHES = {"dp2_sharding4": dict(dp=2, sharding=4),
          "dp2_mp2_sharding2": dict(dp=2, mp=2, sharding=2)}
STEPS = 3


def _ref_map(arr):
    return {d.id: idx for d, idx in
            arr.sharding.devices_indices_map(arr.shape).items()}


def _port_map(t):
    return chunk_map(t.process_mesh, t.placements, t.shape)


@pytest.fixture(scope="module")
def weights():
    paddle.seed(0)
    ref = paddle.models.llama_tiny(**KW)
    return {k: np.asarray(v._data) for k, v in ref.state_dict().items()}


def _ref_model(weights):
    m = paddle.models.llama_tiny(**KW)
    for k, v in m.state_dict().items():
        v._data = jnp.asarray(weights[k])
    return m


def _port_model(weights):
    m = pt.models.llama_tiny(device=CPU, **KW)
    load_reference_state(m, weights)
    return m


def _ids():
    return np.random.RandomState(0).randint(0, 512, (8, 16))


@pytest.fixture(scope="module")
def reference(weights):
    """{(mesh, stage): (param maps, state maps, losses, params)}; the
    steps run at stages 0 and 3 (one compile each)."""
    out = {}
    x = paddle.Tensor(_ids())
    for mname, mkw in MESHES.items():
        for stage in range(4):
            m = _ref_model(weights)
            tr = rspmd.SpmdTrainer(
                m, ropt.AdamW(1e-3, parameters=m.parameters()),
                rspmd.create_mesh(**mkw), rspmd.LLAMA_SHARDING_RULES,
                sharding_stage=stage)
            pmaps = {n: _ref_map(a) for n, a in tr.params.items()}
            smaps = {(n, k): _ref_map(v) for n, st in tr.opt_state.items()
                     for k, v in st.items()}
            losses = params = None
            if stage in (0, 3):
                losses = [float(tr.step((x, x))) for _ in range(STEPS)]
                params = {n: np.asarray(a) for n, a in tr.params.items()}
            out[mname, stage] = (pmaps, smaps, losses, params)
    return out


@pytest.fixture(scope="module")
def port_runs(weights):
    out = {}
    x = torch.as_tensor(_ids())
    for mname, mkw in MESHES.items():
        for stage in range(4):
            m = _port_model(weights)
            tr = spmd.SpmdTrainer(
                m, optimizer.AdamW(1e-3, parameters=m.parameters()),
                spmd.create_mesh(**mkw, device=CPU),
                spmd.LLAMA_SHARDING_RULES, sharding_stage=stage)
            pmaps = {n: _port_map(a) for n, a in tr.params.items()}
            smaps = {(n, k): _port_map(v) for n, st in tr.opt_state.items()
                     for k, v in st.items()}
            losses = [tr.step((x, x)) for _ in range(STEPS)]
            assert all(isinstance(v, torch.Tensor) for v in losses)
            out[mname, stage] = (pmaps, smaps, [float(v) for v in losses],
                                 {n: a.detach().clone()
                                  for n, a in tr.params.items()}, tr)
    return out


CELLS = [(m, s) for m in MESHES for s in range(4)]


@pytest.mark.parametrize("mesh,stage", CELLS)
def test_chunk_maps_equal_the_references_shardings(mesh, stage, reference,
                                                   port_runs):
    rp, rs, _, _ = reference[mesh, stage]
    pp, ps, *_ = port_runs[mesh, stage]
    assert set(pp) == set(rp) and set(ps) == set(rs)
    for key in rp:
        assert pp[key] == rp[key], key
    for key in rs:
        assert ps[key] == rs[key], key


@pytest.mark.parametrize("mesh,stage", CELLS)
def test_losses_and_params_match_the_reference(mesh, stage, reference,
                                               port_runs):
    _, _, losses, params = reference[mesh, 0 if stage < 3 else 3]
    _, _, got, got_params, _ = port_runs[mesh, stage]
    np.testing.assert_allclose(got, losses, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    for n, want in params.items():
        np.testing.assert_allclose(got_params[n].numpy(), want, rtol=TOL,
                                   atol=TOL, err_msg=n)


def test_stages_and_meshes_agree_bit_for_bit(port_runs):
    _, _, base_losses, base, _ = port_runs["dp2_sharding4", 0]
    for key, (_, _, losses, params, _) in port_runs.items():
        assert losses == base_losses, key
        for n, t in params.items():
            assert torch.equal(t, base[n]), (key, n)


def test_stage_marks_partition_what_each_stage_says(port_runs):
    """Stage 3 partitions the parameters, stage >= 1 the states, over the
    sharding axis; below, each keeps its parameter's spec."""
    for (mesh, stage), (*_, tr) in port_runs.items():
        for n, a in tr.params.items():
            zero = tr._zero_specs[n]
            assert ("sharding" in a.partition_spec) == \
                (stage >= 3 and "sharding" in zero), (mesh, stage, n)
            for v in tr.opt_state[n].values():
                want = zero if stage >= 1 else a.partition_spec
                assert v.partition_spec == want, (mesh, stage, n)


def test_sync_to_model_copies_the_trained_tensors(port_runs, weights):
    *_, params, tr = port_runs["dp2_mp2_sharding2", 3]
    model = tr.model
    assert torch.equal(model.lm_head.weight, torch.tensor(
        weights["lm_head.weight"]))          # untouched until the sync
    tr.sync_to_model()
    for n, t in model.state_dict().items():
        assert torch.equal(t, params[n])
    assert model.lm_head.weight.placements == \
        tr.params["lm_head.weight"].placements
    tr.params["lm_head.weight"].data.add_(1.0)   # a copy, not an alias
    assert torch.equal(model.lm_head.weight, params["lm_head.weight"])


def test_clip_and_remat_match_the_reference(weights):
    """ClipGradByGlobalNorm through the functional mirror, and remat as
    one checkpoint around the loss, at stage 2."""
    x = _ids()
    m = _ref_model(weights)
    tr = rspmd.SpmdTrainer(
        m, ropt.AdamW(1e-3, parameters=m.parameters(),
                      grad_clip=rnn.ClipGradByGlobalNorm(0.5)),
        rspmd.create_mesh(**MESHES["dp2_sharding4"]),
        rspmd.LLAMA_SHARDING_RULES, remat=True, sharding_stage=2)
    want = [float(tr.step((paddle.Tensor(x), paddle.Tensor(x))))
            for _ in range(2)]
    m = _port_model(weights)
    ptr = spmd.SpmdTrainer(
        m, optimizer.AdamW(1e-3, parameters=m.parameters(),
                           grad_clip=pt.nn.ClipGradByGlobalNorm(0.5)),
        spmd.create_mesh(**MESHES["dp2_sharding4"], device=CPU),
        spmd.LLAMA_SHARDING_RULES, remat=True, sharding_stage=2)
    got = [float(ptr.step((torch.as_tensor(x), torch.as_tensor(x))))
           for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for n, a in tr.params.items():
        np.testing.assert_allclose(ptr.params[n].detach().numpy(),
                                   np.asarray(a), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("clip", ["norm", "value"])
def test_per_tensor_clips_match_the_eager_clip(clip, weights):
    """The functional clips give what nn.ClipGradByNorm/ByValue give."""
    g = [torch.randn(4, 3), torch.randn(5)]
    c = pt.nn.ClipGradByNorm(0.5) if clip == "norm" else \
        pt.nn.ClipGradByValue(0.3)
    want = [w for _, w in c([(None, x) for x in g])]
    for a, b in zip(spmd._clip(c, g), want):
        torch.testing.assert_close(a, b)


def test_create_mesh_and_rules_match_reference():
    m = spmd.create_mesh(dp=2, mp=2, sharding=2, device=CPU)
    r = rspmd.create_mesh(dp=2, mp=2, sharding=2)
    assert m.dim_names == list(r.axis_names)
    assert m.shape == list(r.devices.shape)
    np.testing.assert_array_equal(
        m.mesh, np.vectorize(lambda d: d.id)(r.devices))
    with pytest.raises(ValueError, match="need 8 devices"):
        spmd.create_mesh(dp=8, devices=[0, 1], device=CPU)
    for rules, rrules in ((spmd.LLAMA_SHARDING_RULES,
                           rspmd.LLAMA_SHARDING_RULES),
                          (spmd.GPT_SHARDING_RULES, rspmd.GPT_SHARDING_RULES),
                          (spmd.DP_ONLY_RULES, rspmd.DP_ONLY_RULES)):
        assert [(p, tuple(s)) for p, s in rules] == \
            [(p, tuple(s)) for p, s in rrules]
    for name in ("gpt.h.0.attn.qkv_proj.bias", "llama.norm.weight", "x"):
        assert tuple(spmd.spec_for(name, spmd.GPT_SHARDING_RULES)) == \
            tuple(rspmd.spec_for(name, rspmd.GPT_SHARDING_RULES))


def test_shard_params_by_rules_drops_what_does_not_divide():
    shapes = {"wte.weight": (6, 8), "h.0.qkv_proj.weight": (8, 24),
              "h.0.qkv_proj.bias": (24,), "h.0.out_proj.weight": (8, 8),
              "h.0.fc1.weight": (8, 3), "h.0.fc1.bias": (3,),
              "ln.weight": (8,)}
    rs = np.random.RandomState(0)
    arrs = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    r = rspmd.shard_params_by_rules(
        {k: jnp.asarray(v) for k, v in arrs.items()},
        rspmd.create_mesh(dp=2, mp=4), rspmd.GPT_SHARDING_RULES)
    p = spmd.shard_params_by_rules(
        {k: torch.as_tensor(v) for k, v in arrs.items()},
        spmd.create_mesh(dp=2, mp=4, device=CPU), spmd.GPT_SHARDING_RULES)
    for k in shapes:
        assert _port_map(p[k]) == _ref_map(r[k]), k
        assert tuple(p[k].partition_spec) == tuple(r[k].sharding.spec) + \
            (None,) * (len(shapes[k]) - len(r[k].sharding.spec)), k
        np.testing.assert_array_equal(p[k].numpy(), arrs[k])


@pytest.mark.parametrize("spec,shape", [
    ((None, "mp"), (8, 16)), (("mp", None), (8, 16)), ((), (4,)),
    ((None, None), (3, 8)), (("mp", "dp"), (8, 8)), ((), (2, 5)),
    ((None,), (6, 4, 8))])
def test_with_zero_axis_matches_reference(spec, shape):
    r = rspmd._with_zero_axis(JP(*spec), shape,
                              rspmd.create_mesh(dp=2, sharding=4))
    p = spmd._with_zero_axis(P(*spec), shape,
                             spmd.create_mesh(dp=2, sharding=4, device=CPU))
    assert tuple(p) == tuple(r)
