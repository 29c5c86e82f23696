"""The port's sharding planners against the JAX package's, leaf by leaf.

``accelerate_tpu_torch/parallel/sharding.py`` ports ``plan_param_shardings``,
``plan_zero_shardings``, ``local_leaf_shape``, ``data_parallel_degree`` and
``local_batch_size_for`` as pure functions of shapes and axis sizes. Every
case here feeds the same shapes to both packages (JAX on meshes of the
repo's virtual CPU devices) and asserts that the port picks the same dims
and the same axes for every leaf: the tiny Llama's tree and Llama-3-8B's
shapes, with and without the model's rules, on fsdp 2/4/8, dp 2 x fsdp 2,
ZeRO over dp 4 with and without fsdp, several ``min_shard_size`` gates, a
rule that relaxes, and scalars and odd shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from accelerate_tpu.models.llama import Llama as JLlama
from accelerate_tpu.models.llama import LlamaConfig as JConfig
from accelerate_tpu.parallel import sharding as jsh
from accelerate_tpu.parallel.mesh import ParallelismConfig as JParallelismConfig

import accelerate_tpu_torch as T
from accelerate_tpu_torch.parallel import sharding as tsh

MESHES = {
    "fsdp2": dict(fsdp_size=2, dp_size=1),
    "fsdp4": dict(fsdp_size=4, dp_size=1),
    "fsdp8": dict(fsdp_size=8, dp_size=1),
    "dp2xfsdp2": dict(fsdp_size=2, dp_size=2),
    "dp4": dict(fsdp_size=1, dp_size=4),
    "dp4xfsdp2": dict(fsdp_size=2, dp_size=4),
}


def _mesh(name):
    kw = MESHES[name]
    n = kw["fsdp_size"] * kw["dp_size"]
    return JParallelismConfig(**kw).build_mesh(jax.devices()[:n])


def _sizes(mesh):
    return {k: int(v) for k, v in mesh.shape.items()}


def _shape_tree(cfg):
    """The Llama parameter tree as shapes only (meta tensors), and the
    same tree as JAX ShapeDtypeStructs."""
    model = T.Llama(cfg, device="cpu")
    model.device = torch.device("meta")
    port = model.init()
    return port, jax.tree_util.tree_map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32), port)


TREES = {
    "tiny": lambda: _shape_tree(T.LlamaConfig.tiny()),
    "llama3_8b": lambda: _shape_tree(T.LlamaConfig.llama3_8b()),
}

ODD = {"scalar": (), "odd": (7, 9), "vec": (12,), "mixed": (3, 8, 5), "wide": (6, 40, 4),
       "tall": (64, 2048), "square": (128, 128)}


def _odd_tree():
    port = {k: torch.empty(s, device="meta") for k, s in ODD.items()}
    return port, {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in ODD.items()}


def _jax_specs(tree):
    return [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda s: hasattr(s, "spec"))]


def _port_specs(tree):
    return [s for _, s in tsh._walk(tree)]


def _jax_rules(rules):
    return None if rules is None else [(pat, P(*spec)) for pat, spec in rules]


LLAMA_RULES = T.Llama(T.LlamaConfig.tiny(), device="cpu").sharding_rules()


def test_port_llama_rules_are_jax_rules():
    jrules = JLlama(JConfig.tiny()).sharding_rules()
    assert [(pat, tuple(spec)) for pat, spec in jrules] == [
        (pat, tuple(spec)) for pat, spec in LLAMA_RULES]


@pytest.mark.parametrize("with_rules", [True, False], ids=["rules", "auto"])
@pytest.mark.parametrize("min_shard", [2**14, 1, 2**20])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("tree", sorted(TREES))
def test_param_plan_matches_jax_leaf_by_leaf(tree, mesh_name, min_shard, with_rules):
    port, jtree = TREES[tree]()
    mesh = _mesh(mesh_name)
    rules = LLAMA_RULES if with_rules else None
    want = _jax_specs(jsh.plan_param_shardings(jtree, mesh, rules=_jax_rules(rules),
                                               min_shard_size=min_shard))
    got = _port_specs(tsh.plan_param_shardings(port, _sizes(mesh), rules=rules,
                                               min_shard_size=min_shard))
    assert got == want


@pytest.mark.parametrize("with_rules", [True, False], ids=["rules", "auto"])
@pytest.mark.parametrize("min_shard", [2**10, 1, 2**16])
@pytest.mark.parametrize("mesh_name", ["dp4", "dp2xfsdp2", "dp4xfsdp2"])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_zero_plan_matches_jax_leaf_by_leaf(tree, mesh_name, min_shard, with_rules):
    port, jtree = TREES[tree]()
    mesh = _mesh(mesh_name)
    rules = LLAMA_RULES if with_rules else None
    jbase = jsh.plan_param_shardings(jtree, mesh, rules=_jax_rules(rules))
    want = _jax_specs(jsh.plan_zero_shardings(jtree, jbase, mesh, min_shard_size=min_shard))
    sizes = _sizes(mesh)
    base = tsh.plan_param_shardings(port, sizes, rules=rules)
    assert _port_specs(base) == _jax_specs(jbase)
    got = _port_specs(tsh.plan_zero_shardings(port, base, sizes, min_shard_size=min_shard))
    assert got == want
    # Local shapes of every leaf under the ZeRO plan.
    jz = jsh.plan_zero_shardings(jtree, jbase, mesh, min_shard_size=min_shard)
    for (_, leaf), spec, jspec in zip(tsh._walk(port), got, jax.tree_util.tree_leaves(
            jz, is_leaf=lambda s: hasattr(s, "spec"))):
        assert tsh.local_leaf_shape(leaf.shape, spec, sizes) == jsh.local_leaf_shape(
            tuple(leaf.shape), jspec)


ODD_RULES = [
    (r"mixed", ("pp", "fsdp", "dp")),       # 8 divides fsdp x dp only partly: relaxes
    (r"wide", (None, ("fsdp", "dp"), None)),  # 40 over fsdp x dp: relaxes at 8
    (r"odd", ("fsdp",)),                     # 7 divides by nothing: the auto plan
]


@pytest.mark.parametrize("zero_rules", [False, True], ids=["auto_zero", "zero_rules"])
@pytest.mark.parametrize("mesh_name", ["fsdp4", "dp2xfsdp2", "dp4xfsdp2", "dp4", "fsdp8"])
def test_rules_relax_and_odd_shapes_match_jax(mesh_name, zero_rules):
    port, jtree = _odd_tree()
    mesh = _mesh(mesh_name)
    sizes = _sizes(mesh)
    jbase = jsh.plan_param_shardings(jtree, mesh, rules=_jax_rules(ODD_RULES), min_shard_size=16)
    base = tsh.plan_param_shardings(port, sizes, rules=ODD_RULES, min_shard_size=16)
    assert _port_specs(base) == _jax_specs(jbase)
    zr = [(r"square", ("dp", "fsdp")), (r"vec", ("dp",))] if zero_rules else None
    want = _jax_specs(jsh.plan_zero_shardings(jtree, jbase, mesh, rules=_jax_rules(zr),
                                              min_shard_size=16))
    got = _port_specs(tsh.plan_zero_shardings(port, base, sizes, rules=zr, min_shard_size=16))
    assert got == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_data_parallel_degree_and_local_batch(mesh_name):
    mesh = _mesh(mesh_name)
    sizes = _sizes(mesh)
    n = jsh.data_parallel_degree(mesh)
    assert tsh.data_parallel_degree(sizes) == n
    assert tsh.local_batch_size_for(4 * n, sizes) == 4
    with pytest.raises(ValueError, match="not divisible"):
        tsh.local_batch_size_for(4 * n + 1, sizes)
    with pytest.raises(ValueError, match="not divisible"):
        jsh.local_batch_size_for(4 * n + 1, mesh)


def test_llama3_8b_fsdp4_layout():
    """The layout the four-card test trains: every projection and the two
    vocab tables split four ways on one dim, the norms replicated."""
    port, _ = TREES["llama3_8b"]()
    specs = dict(tsh._walk(tsh.plan_param_shardings(port, {"fsdp": 4}, rules=LLAMA_RULES)))
    assert specs["layers/mlp/w_up"] == ("pp", "fsdp", "tp")
    assert specs["layers/mlp/w_down"] == ("pp", "tp", "fsdp")
    assert specs["embed/weight"] == ("tp", "fsdp")
    assert specs["lm_head/weight"] == ("fsdp", "tp")
    assert specs["layers/input_norm/weight"] == ("pp",) and specs["final_norm/weight"] == ()
    shapes = dict(tsh._walk(port))
    total = sum(int(np.prod(t.shape)) for t in shapes.values())
    local = sum(int(np.prod(tsh.local_leaf_shape(shapes[k].shape, s, {"fsdp": 4})))
                for k, s in specs.items())
    replicated = sum(int(np.prod(shapes[k].shape)) for k, s in specs.items()
                     if not tsh.spec_axes(s) & {"fsdp"})
    assert local == (total - replicated) // 4 + replicated
