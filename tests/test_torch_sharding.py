"""The port's sharding rules against the JAX package's, on the CPU.

``repro_torch.distributed.sharding``'s ``tree_specs``, ``batch_spec`` and
``cache_specs`` equal ``repro.distributed.sharding``'s on every dense
architecture the port runs (smollm-360m, deepseek-7b, qwen1.5-4b,
gemma-2b) and on the meshes 1x1, 2x1, 1x2, 2x2, 4x2, 1x3, 1x16 and
(pod 2, data 2, model 2) with ``multipod_rules``.  The reference's
``spec_for`` reads only ``mesh.shape``, so a stand-in with a ``shape``
dict runs it without devices (its ``cache_specs`` wraps each spec in a
``NamedSharding``, replaced here by the spec itself).  The port's logical
axes are the reference's ``model_axes``, and ``local_shape`` /
``shard_of`` / ``mesh_coords`` cut what GSPMD would.
"""

import types

import jax
import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config
from repro.distributed import sharding as jax_sharding
from repro.models.transformer import init_model as jax_init
from repro.models.transformer import model_axes as jax_model_axes
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import axes_to_jax_tree, params_to_jax_tree

ARCHS = ["smollm-360m", "deepseek-7b", "qwen1.5-4b", "gemma-2b"]
MESHES = {
    "1x1": {"data": 1, "model": 1}, "2x1": {"data": 2, "model": 1},
    "1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2},
    "4x2": {"data": 4, "model": 2}, "1x3": {"data": 1, "model": 3},
    "1x16": {"data": 1, "model": 16},
    "2x2x2": {"pod": 2, "data": 2, "model": 2},
}


def _stand_in(shape):
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _tuples(tree):
    """A tree of the reference's ``PartitionSpec``s as plain tuples."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    jcfg, cfg = jax_config(name), get_config(name)
    shapes = jax.eval_shape(lambda k: jax_init(jcfg, k)[0], jax.random.PRNGKey(0))
    return name, jcfg, cfg, jax_model_axes(jcfg), shapes


def test_port_axes_are_the_references(arch):
    _, _, cfg, jaxes, _ = arch
    assert axes_to_jax_tree(T.model_axes(cfg)) == jaxes
    names = {n for n, _ in T.init_model(cfg, device="meta").named_parameters()}
    assert set(T.model_axes(cfg)) == names


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tree_specs_equal_the_references(arch, mesh):
    _, _, cfg, jaxes, shapes = arch
    want = _tuples(jax_sharding.tree_specs(_stand_in(MESHES[mesh]), jaxes, shapes))
    port_shapes = params_to_jax_tree(dict(T.init_model(cfg, device="meta")
                                          .named_parameters()))
    got = SH.tree_specs(MESHES[mesh], axes_to_jax_tree(T.model_axes(cfg)), port_shapes)
    assert got == want
    # the per-layer specs the port shards by: the stacked ones without "layers"
    specs = T.param_specs(cfg, MESHES[mesh])
    assert specs["blocks.0.attn.wq"] == want["blocks"]["attn"]["wq"][1:]
    assert specs["embed"] == want["embed"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_batch_spec_equals_the_references(mesh, ndim):
    m = MESHES[mesh]
    for rules in (None, SH.multipod_rules(SH.ACT_RULES)):
        jrules = None if rules is None else jax_sharding.multipod_rules(
            jax_sharding.ACT_RULES)
        want = tuple(jax_sharding.batch_spec(_stand_in(m), ndim, jrules))
        assert SH.batch_spec(m, ndim, rules) == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_specs_equal_the_references(arch, mesh, monkeypatch):
    _, jcfg, cfg, _, _ = arch
    monkeypatch.setattr(jax_sharding, "NamedSharding", lambda mesh, spec: tuple(spec))
    m = MESHES[mesh]
    shape = (cfg.n_layers, 16, 64, cfg.n_kv_heads, cfg.head_dim_)
    cache = {"k": jax.ShapeDtypeStruct(shape, np.float32),
             "v": jax.ShapeDtypeStruct(shape, np.float32),
             "len": jax.ShapeDtypeStruct((), np.int32)}
    rules = SH.multipod_rules(SH.ACT_RULES) if "pod" in m else None
    jrules = jax_sharding.multipod_rules(jax_sharding.ACT_RULES) if "pod" in m else None
    for seq_shard in (False, True):
        want = jax_sharding.cache_specs(_stand_in(m), cache, jcfg,
                                        seq_shard=seq_shard, rules=jrules)
        got = SH.cache_specs(m, cache, cfg, seq_shard=seq_shard, rules=rules)
        assert got == want, (mesh, seq_shard)


def test_smollm_specs_on_2x2_are_the_issue_of_heads_that_do_not_divide():
    specs = T.param_specs(get_config("smollm-360m"), MESHES["2x2"])
    assert specs["embed"] == ("model", "data")
    assert specs["blocks.0.attn.wq"] == ("data", None, None)        # 15 heads
    assert specs["blocks.0.ff.wi_gate"] == ("data", "model")
    assert specs["blocks.0.ff.wo"] == ("model", "data")
    assert specs["blocks.0.attn.wo"] == (None, None, "data")
    k = T.cache_layout(get_config("smollm-360m"),
                       T.RunCfg(mesh=SH.Mesh(MESHES["2x2"], {"data": 0, "model": 0})),
                       8)["k"]
    assert k == (None, "data", None, None, "model")                 # head_dim cut


@pytest.mark.parametrize("mesh", ["2x2", "1x3", "4x2", "2x2x2"])
def test_shards_tile_the_whole(mesh):
    shape = MESHES[mesh]
    full = np.arange(12 * 6 * 4).reshape(12, 6, 4)
    axes = list(shape)
    spec = (axes[0], None, axes[-1]) if shape[axes[-1]] in (1, 2, 4) else (axes[0], None, None)
    if mesh == "2x2x2":
        spec = (("pod", "data"), None, "model")
    n = int(np.prod(list(shape.values())))
    seen = np.zeros(full.shape, int)
    for rank in range(n):
        m = SH.Mesh(shape, SH.mesh_coords(rank, shape))
        block = SH.shard_of(full, spec, m)
        assert block.shape == SH.local_shape(full.shape, spec, shape)
        seen[np.isin(full, block)] += 1
    replicas = n // int(np.prod([SH.shard_index(e, m)[1] for e in spec]))
    assert (seen == replicas).all()


def test_mesh_coords_are_row_major_as_the_ranks():
    from repro_torch.dist import coords_of

    shape = {"pod": 2, "data": 2, "model": 2}
    for rank in range(8):
        c = SH.mesh_coords(rank, shape)
        u, v = coords_of(rank, 2)
        assert (c["pod"] * 2 + c["data"], c["model"]) == (u, v)
    assert M.rank_layout(shape) == {"pu": 4, "pv": 2, "u_sizes": (2, 2)}
    assert M.rank_layout({"data": 2, "model": 2}) == {"pu": 2, "pv": 2}
    assert M.mesh_axes(shape) == (("pod", "data"), ("model",))
    # RunCfg reads its axes off the mesh; per_pod leaves out the pod axis
    mesh = SH.Mesh(shape=shape, coords=SH.mesh_coords(5, shape))
    run = T.RunCfg(mesh=mesh)
    assert (run.data_axes, run.model_axes) == (("pod", "data"), ("model",))
    assert T.RunCfg(mesh=mesh, per_pod=True).data_axes == ("data",)
    assert M.parse_mesh_arg("4x2") == (4, 2)
    with pytest.raises(SystemExit):
        M.parse_mesh_arg("4by2")


def test_int8_compression_is_the_references():
    import jax.numpy as jnp

    from repro.distributed import compression as jcomp
    from repro_torch.distributed import compression as comp

    rng = np.random.RandomState(3)
    grads = {"a": rng.randn(7, 5).astype(np.float32),
             "b": (1e-3 * rng.randn(11)).astype(np.float32)}
    res = {k: (1e-2 * rng.randn(*v.shape)).astype(np.float32) for k, v in grads.items()}
    for k, g in grads.items():
        q, s_ = comp.quantize_int8(torch.from_numpy(g))
        jq, js = jcomp.quantize_int8(jnp.asarray(g))
        assert np.array_equal(q.numpy(), np.asarray(jq)) and float(s_) == float(js)
        assert np.array_equal(comp.dequantize_int8(q, s_).numpy(),
                              np.asarray(jcomp.dequantize_int8(jq, js)))
    qt, rt = comp.compress_with_feedback(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in res.items()})
    jqt, jrt = jcomp.compress_with_feedback(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in res.items()})
    back = comp.decompress(qt, {k: torch.from_numpy(v) for k, v in grads.items()})
    jback = jcomp.decompress(jqt, {k: jnp.asarray(v) for k, v in grads.items()})
    for k in grads:
        assert np.array_equal(qt[k][0].numpy(), np.asarray(jqt[k][0]))
        assert np.allclose(rt[k].numpy(), np.asarray(jrt[k]), rtol=0, atol=1e-7)
        assert np.array_equal(back[k].numpy(), np.asarray(jback[k]))
    # one device: the pod sync is the quantize-dequantize round trip
    synced, r2 = comp.pod_sync_compressed(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        comp.init_residuals({k: torch.from_numpy(v) for k, v in grads.items()}))
    for k, g in grads.items():
        q, s_ = comp.quantize_int8(torch.from_numpy(g))
        assert torch.equal(synced[k], comp.dequantize_int8(q, s_))
        assert torch.equal(r2[k], torch.from_numpy(g) - synced[k])
    # a block's leaves are the layers of one reference tensor: one scale
    layers = {f"blocks.{i}.ff.wo": ((i + 1) * rng.randn(3, 4)).astype(np.float32)
              for i in range(2)}
    synced, _ = comp.pod_sync_compressed(
        {k: torch.from_numpy(v) for k, v in layers.items()},
        comp.init_residuals({k: torch.from_numpy(v) for k, v in layers.items()}))
    jq, js = jcomp.quantize_int8(jnp.asarray(np.stack(list(layers.values()))))
    want = np.asarray(jcomp.dequantize_int8(jq, js))
    for i, k in enumerate(layers):
        assert np.array_equal(synced[k].numpy(), want[i])
