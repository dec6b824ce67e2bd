"""The port's sharding spec trees against the JAX package's, entry for entry.

For every registered arch: ``lm.param_specs``, ``lm.cache_specs`` (the
reference's ``spec_for(kind, stacked)(ndim)`` function), ``steps.
cache_specs``, ``input_spec_shardings`` for every shape, ``state_specs``
(AdamW plain and with int8 moments) and ``opt_specs``; then
``make_shardings`` + ``sanitize_shardings`` over the reference's (16, 16)
and (2, 16, 16) layouts applied to ``abstract_params``: the port's dry
process mesh (``launch.mesh.make_production_mesh`` of a dry world) against
JAX's ``NamedSharding`` on an ``AbstractMesh`` (no 256 devices needed),
spec for spec and each leaf's local shard shape.
"""
import jax
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import list_configs
from repro.launch import steps as JS
from repro.models import lm as JLM
from repro.optim import AdamWConfig as JAdamW
from repro.optim import opt_specs as j_opt_specs
from repro.runtime.elastic import make_shardings as j_make, sanitize_shardings as j_sanitize

import torch

from repro_torch.configs import get_config
from repro_torch.core.sharding import NamedSharding, PartitionSpec
from repro_torch.core.world import World
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_production_mesh, production_layout
from repro_torch.models import lm as PLM
from repro_torch.optim import AdamWConfig, opt_specs
from repro_torch.runtime.elastic import make_shardings, sanitize_shardings
from repro_torch.tree import leaves

ARCHS = list_configs()
KINDS = ("attn", "attn_local", "attn_global", "moe", "shared_attn", "cross_attn",
         "mla_dense", "mla_moe", "mamba", "mlstm", "slstm")


def norm(t):
    """A spec tree of either package as plain Python: specs as ("P", entries),
    NamedTuples as (type name, fields), dicts as dicts."""
    if isinstance(t, (JP, PartitionSpec)):
        return ("P", tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                           for e in t))
    if isinstance(t, dict):
        return {k: norm(v) for k, v in t.items()}
    if isinstance(t, tuple):
        return (type(t).__name__, [norm(v) for v in t])
    return t


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match(arch):
    jc, pc = j_get_config(arch), get_config(arch)
    assert norm(PLM.param_specs(pc)) == norm(JLM.param_specs(jc))
    assert norm(PS.cache_specs(pc)) == norm(JS.cache_specs(jc))
    j_for, p_for = JLM.cache_specs(jc), PLM.cache_specs(pc)
    for kind in KINDS:
        for stacked in (False, True):
            for ndim in range(5):
                assert norm(p_for(kind, stacked)(ndim)) == \
                    norm(j_for(kind, stacked)(ndim)), (kind, stacked, ndim)
    assert PLM.batch_axes_static() == JLM.batch_axes_static()


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_state_specs_match(arch):
    jc, pc = j_get_config(arch), get_config(arch)
    assert PS.BATCH_AXES == JS.BATCH_AXES
    assert norm(PS.batch_spec(None, None)) == norm(JS.batch_spec(None, None))
    for shape in J_SHAPES:
        assert norm(PS.input_spec_shardings(pc, shape)) == \
            norm(JS.input_spec_shardings(jc, shape)), shape
    for q in ({}, {"quantized_v": True}, {"quantized_m": True, "quantized_v": True}):
        j_ps, j_os = JS.state_specs(jc, JAdamW(**q))
        p_ps, p_os = PS.state_specs(pc, AdamWConfig(**q))
        assert norm(p_ps) == norm(j_ps)
        assert norm(p_os) == norm(j_os), q
        assert norm(opt_specs(p_ps, AdamWConfig(**q))) == \
            norm(j_opt_specs(j_ps, JAdamW(**q)))


def _dry_mesh(multi_pod: bool):
    shape, _ = production_layout(multi_pod)
    n = 1
    for s in shape:
        n *= s
    return make_production_mesh(World("dry", 0, n, torch.device("cpu")),
                                multi_pod=multi_pod)


@pytest.fixture(scope="module")
def abstract():
    """{arch: (JAX abstract params, port abstract params)}, built once."""
    return {a: (JLM.abstract_params(j_get_config(a)),
                PLM.abstract_params(get_config(a))) for a in ARCHS}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_over_the_production_layouts_match(abstract, arch, multi_pod):
    shape, axes = production_layout(multi_pod)
    jmesh = AbstractMesh(shape, axes)
    pmesh = _dry_mesh(multi_pod)
    assert pmesh.devices.shape == shape and pmesh.axis_names == axes
    jparams, pparams = abstract[arch]
    jsh = j_sanitize(j_make(jmesh, JLM.param_specs(j_get_config(arch))), jparams)
    psh = sanitize_shardings(make_shardings(pmesh, PLM.param_specs(get_config(arch))),
                             pparams)
    jl = jax.tree.leaves(jsh, is_leaf=lambda x: hasattr(x, "spec"))
    pl = leaves(psh, is_leaf=lambda x: isinstance(x, NamedSharding))
    ja, pa = jax.tree.leaves(jparams), leaves(pparams)
    assert len(jl) == len(pl) == len(ja) == len(pa)
    for j, p, av, pv in zip(jl, pl, ja, pa):
        assert tuple(pv.shape) == tuple(av.shape)
        assert norm(p.spec) == norm(j.spec), (arch, av.shape)
        assert p.shard_shape(pv.shape) == tuple(j.shard_shape(av.shape))
