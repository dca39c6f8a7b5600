"""The port's sharding rules (``repro_torch.runtime.sharding``), mesh shapes
(``launch.mesh.MeshShape``) and elastic plans (``runtime.elastic``) against
the JAX package's, without ranks: JAX's ``base_rules``/``spec_for`` read only
``mesh.axis_names`` and ``mesh.shape[name]``, so both sides are handed the
same ``MeshShape``.

  * ``base_rules`` for (data, model) and (pod, data, model) under every
    ``fsdp``/``zero_weights_on_pod``/``cache_shard`` setting;
  * every parameter leaf of every arch in the registry at 16x16 and
    2x16x16, and the caches and a batch at (2, 2) and (1, 4): the per-dim
    mesh entries equal JAX's ``PartitionSpec`` entries;
  * ``MeshPlan`` field-equal to JAX's on tests/test_substrates.py's elastic
    case and tests/test_property.py's strategy;
  * the K1/K2 block rule: a reduced danube leaf whose (1, 2) shard splits a
    128-block is re-laid out (``daemon_step.block_layout``) so that each
    rank quantises whole blocks; per-rank codes, scales and residual put
    together equal the one-device fold, where the split shard's would not;
  * on one in-process gloo rank, a (1, 1) mesh: the ``train`` driver's
    losses equal the unsharded run's, and ``serve``'s tokens and logits too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")
import torch.distributed as dist
from conftest import given, settings, st  # hypothesis-or-fallback shim
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.runtime import elastic as jax_elastic
from repro.runtime import sharding as jax_shd

from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.movement import daemon_step as ds
from repro_torch.kernels.block_quant import ref as bq_ref
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as M
from repro_torch.models import nn
from repro_torch.runtime import elastic
from repro_torch.runtime import sharding as shd

MESHES = {
    "16x16": MeshShape(("data", "model"), (16, 16)),
    "2x16x16": MeshShape(("pod", "data", "model"), (2, 16, 16)),
}
SMALL = {
    "2x2": MeshShape(("data", "model"), (2, 2)),
    "1x4": MeshShape(("data", "model"), (1, 4)),
}


def _walk(ours, theirs, path=""):
    """(path, our leaf, their leaf) of two spec trees with the same keys."""
    if isinstance(ours, dict):
        assert sorted(ours) == sorted(theirs), path
        for k in sorted(ours):
            yield from _walk(ours[k], theirs[k], f"{path}/{k}")
    else:
        yield path, ours, theirs


@pytest.mark.parametrize("mesh", list(MESHES.values()) + list(SMALL.values()),
                         ids=list(MESHES) + list(SMALL))
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("zero_weights_on_pod", [False, True])
@pytest.mark.parametrize("cache_shard", ["seq", "dh"])
def test_base_rules_match_jax(mesh, fsdp, zero_weights_on_pod, cache_shard):
    kw = dict(fsdp=fsdp, zero_weights_on_pod=zero_weights_on_pod, cache_shard=cache_shard)
    assert shd.base_rules(mesh, **kw) == jax_shd.base_rules(mesh, **kw)


@pytest.mark.parametrize("mesh", list(MESHES.values()), ids=list(MESHES))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_specs_match_jax(arch, mesh):
    rules = shd.base_rules(mesh, fsdp=True)
    ours, theirs = M.model_specs(get_config(arch)), JM.model_specs(jax_get_config(arch))
    n = 0
    for path, s, t in _walk(ours, theirs):
        assert tuple(s.shape) == tuple(t.shape) and tuple(s.axes) == tuple(t.axes), path
        want = tuple(jax_shd.spec_for(mesh, rules, t.axes, t.shape))
        assert shd.spec_for(mesh, rules, s.axes, s.shape) == want, path
        n += 1
    assert n == len(nn.tree_leaves(ours))


@pytest.mark.parametrize("mesh", list(SMALL.values()), ids=list(SMALL))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_cache_and_batch_specs_match_jax(arch, mesh, monkeypatch):
    rules = shd.base_rules(mesh, fsdp=True)
    cfg = get_config(arch)
    ours, theirs = M.cache_specs(cfg, 4, 64), JM.cache_specs(jax_get_config(arch), 4, 64)
    for path, s, t in _walk(ours, theirs):
        want = tuple(jax_shd.spec_for(mesh, rules, t.axes, t.shape))
        assert shd.spec_for(mesh, rules, s.axes, s.shape) == want, path
    # JAX's batch_sharding wraps each spec in a NamedSharding, which needs
    # devices: its entries are read through a stub
    monkeypatch.setattr(jax_shd, "NamedSharding", lambda m, spec: tuple(spec))
    batch = {"tokens": np.zeros((4, 64), np.int32), "labels": np.zeros((4, 64), np.int32),
             "odd": np.zeros((3, 5), np.float32), "scalar": np.zeros((), np.float32)}
    got = nn.tree_map(lambda s: s.spec, shd.batch_sharding(mesh, rules, batch))
    assert got == jax_shd.batch_sharding(mesh, rules, batch)


def test_placements_follow_the_entries():
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert shd.placements_for(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements_for(mesh, ()) == (Replicate(),) * 3
    assert shd.placements_for(MeshShape(("data", "model"), (2, 2)), (None, "data")) == (
        Shard(1), Replicate())


def _plan_fields(plan):
    return (plan.pods, plan.data, plan.model, plan.used_chips, plan.spare_chips, plan.shape,
            plan.axes)


def test_elastic_plan_matches_jax():
    """tests/test_substrates.py's case: 512 chips, then a host lost."""
    ours = elastic.plan_mesh(512, model_degree=16, global_batch=256, chips_per_pod=256)
    theirs = jax_elastic.plan_mesh(512, model_degree=16, global_batch=256, chips_per_pod=256)
    assert _plan_fields(ours) == _plan_fields(theirs)
    for lost in (8, 16, 256):
        assert _plan_fields(elastic.replan_after_failure(ours, lost, 256)) == _plan_fields(
            jax_elastic.replan_after_failure(theirs, lost, 256))
    with pytest.raises(ValueError, match="need >= 16"):
        elastic.plan_mesh(8)


@settings(max_examples=30, deadline=None)
@given(chips=st.integers(16, 4096), batch=st.sampled_from([64, 128, 256, 512]))
def test_elastic_plan_matches_jax_on_the_property_strategy(chips, batch):
    """tests/test_property.py's strategy."""
    ours = elastic.plan_mesh(chips, model_degree=16, global_batch=batch)
    assert _plan_fields(ours) == _plan_fields(
        jax_elastic.plan_mesh(chips, model_degree=16, global_batch=batch))
    lost = chips // 7
    if chips - lost >= 16:
        assert _plan_fields(elastic.replan_after_failure(ours, lost, batch)) == _plan_fields(
            jax_elastic.replan_after_failure(
                jax_elastic.plan_mesh(chips, model_degree=16, global_batch=batch), lost, batch))


def test_dp_degree_is_the_dry_runs():
    """JAX's dry run passes n_dp = devices // model to auto_microbatches."""
    assert steps.dp_degree(MESHES["16x16"]) == 16
    assert steps.dp_degree(MESHES["2x16x16"]) == 32
    assert steps.dp_degree(SMALL["1x4"]) == 1


class _Mesh:
    """A DeviceMesh's sizes and one rank's coordinates."""

    def __init__(self, sizes, coords=None):
        self.sizes, self.coords = sizes, coords

    def size(self, i=None):
        return self.sizes[i]

    def get_local_rank(self, i):
        return self.coords[i]


class _Leaf:
    """What ``block_layout`` reads of a DTensor."""

    def __init__(self, shape, mesh, placements):
        self.shape, self.ndim = torch.Size(shape), len(shape)
        self.device_mesh, self.placements = mesh, tuple(placements)


def _per_rank(x, sizes, placements, fn):
    """``fn`` on each rank's block of ``x`` under ``placements``, the blocks
    put back together."""
    out = torch.empty_like(x)
    for coords in np.ndindex(*sizes):
        mesh = _Mesh(sizes, coords)
        view = shd.local_slice(out, mesh, placements)
        view.copy_(fn(shd.local_slice(x, mesh, placements)))
    return out


def test_block_rule_on_a_shard_that_splits_a_block():
    """Reduced danube's ``w_gate`` (2, 64, 128) at (1, 2): ``mlp`` splits its
    last dim into 64-element shards, half a block each.  ``block_layout``
    moves that mesh dim to the layers dim; the per-rank fold there equals the
    one-device fold bit for bit (codes, scales, residual); quantising the
    split shards as they lie would not."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    spec = M.model_specs(cfg)["seg0"]["ffn"]["w_gate"]
    assert tuple(spec.shape) == (2, 64, 128)
    mesh = MeshShape(("data", "model"), (1, 2))
    placements = shd.placements_for(mesh, shd.spec_for(mesh, shd.base_rules(mesh), spec.axes,
                                                       spec.shape))
    assert placements == (Shard(1), Shard(2))
    layout = ds.block_layout(_Leaf(spec.shape, _Mesh((1, 2)), placements))
    assert layout == (Shard(1), Shard(0))
    # the leaf and layouts that keep whole blocks stay where they lie
    assert ds.block_layout(_Leaf((64, 256), _Mesh((1, 2)), (Shard(0), Shard(1)))) == (
        Shard(0), Shard(1))
    # nothing to move the split to: replicated
    assert ds.block_layout(_Leaf((3, 128), _Mesh((1, 2)), (Replicate(), Shard(1)))) == (
        Replicate(), Replicate())

    g = torch.from_numpy(np.random.default_rng(0).normal(size=spec.shape).astype(np.float32))
    q, s = bq_ref.quantize_ref(g.reshape(-1, 128))
    want_codes, want_scales = q.reshape(g.shape), s.reshape(*g.shape[:-1], 1)
    want_deq = bq_ref.dequantize_ref(q, s, torch.float32).reshape(g.shape)

    def codes(x):
        return bq_ref.quantize_ref(x.reshape(-1, 128))[0].reshape(x.shape)

    def deq(x):
        return bq_ref.dequantize_ref(*bq_ref.quantize_ref(x.reshape(-1, x.shape[-1])),
                                     torch.float32).reshape(x.shape)

    assert torch.equal(_per_rank(g, (1, 2), layout, codes), want_codes)
    got_deq = _per_rank(g, (1, 2), layout, deq)
    assert torch.equal(got_deq, want_deq)
    assert torch.equal(g - got_deq, g - want_deq)  # the residual
    scales = torch.empty_like(want_scales)
    for coords in np.ndindex(1, 2):
        m = _Mesh((1, 2), coords)
        blk = shd.local_slice(g, m, layout)
        shd.local_slice(scales, m, layout).copy_(
            bq_ref.quantize_ref(blk.reshape(-1, 128))[1].reshape(*blk.shape[:-1], 1))
    assert torch.equal(scales, want_scales)
    # the split shards, each quantised as its own half-block, give other values
    assert not torch.equal(_per_rank(g, (1, 2), placements, lambda x: bq_ref.dequantize_ref(
        *bq_ref.quantize_ref(x.reshape(-1, 64), 64), torch.float32).reshape(x.shape)), want_deq)


@pytest.fixture
def world1(tmp_path):
    """This process as the only rank of a gloo group."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("movement", ["baseline", "daemon"])
def test_train_on_a_one_rank_mesh_matches_one_device(world1, movement):
    from repro_torch.launch.train import train

    kw = dict(reduced=True, steps=3, global_batch=4, seq_len=32, movement=movement,
              log_every=100, device="cpu")
    _, _, want = train("h2o-danube-1.8b", **kw)
    params, state, got = train("h2o-danube-1.8b", mesh_shape=(1, 1), **kw)
    print(f"{movement}: mesh (1, 1) {got}; one device {want}")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert all(nn.is_dtensor(p) for p in nn.tree_leaves(params))
    assert nn._MESH is None  # train() deactivated its rules


def test_serve_on_a_one_rank_mesh_matches_one_device(world1):
    from repro_torch.launch.serve import serve

    kw = dict(reduced=True, batch=2, prompt_len=32, gen_tokens=4, device="cpu",
              return_logits=True)
    want = serve("h2o-danube-1.8b", **kw)
    got = serve("h2o-danube-1.8b", mesh_shape=(1, 1), **kw)
    assert (got["tokens"] == want["tokens"]).all()
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"].numpy(), atol=1e-5)


def test_a_mesh_of_another_size_raises(world1):
    from repro_torch.launch.mesh import make_mesh

    with pytest.raises(ValueError, match=r"world size 4, have 1"):
        make_mesh((2, 2), device="cpu")


def test_abstract_state_matches_jax():
    """``init_abstract`` (JAX's ``ShapeDtypeStruct`` tree) and
    ``state_shardings`` of the DaeMon state: shapes and dtypes leaf for leaf,
    the step replicated, everything else laid out as the parameters."""
    import jax

    from repro.core import movement as jax_mv
    from repro.models import nn as jnn

    cfg = get_config("h2o-danube-1.8b").reduced()
    master = nn.init_params(M.model_specs(cfg), torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    ours = ds.init_abstract(master)
    jmaster = jnn.init_params(JM.model_specs(jax_get_config("h2o-danube-1.8b").reduced()),
                              jax.random.key(0))
    theirs = jax_mv.daemon_step.init_abstract(jmaster)
    assert ours.adam.step == (tuple(theirs.adam.step.shape), torch.int32)
    for tree_o, tree_t in [(ours.master, theirs.master), (ours.adam.m, theirs.adam.m),
                           (ours.residual, theirs.residual)]:
        for path, o, t in _walk(tree_o, tree_t):
            assert o.shape == tuple(t.shape) and str(o.dtype).split(".")[-1] == str(t.dtype), path
    mesh = MeshShape(("data", "model"), (2, 2))
    psh = shd.sharding_for_specs(mesh, shd.base_rules(mesh), M.model_specs(cfg))
    ssh = ds.state_shardings(psh)
    assert ssh.adam.step is None and ssh.master is psh and ssh.residual is psh
