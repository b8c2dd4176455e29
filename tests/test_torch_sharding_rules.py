"""The port's LM sharding rules (``runtime.sharding``) against the
reference's, on the reference's abstract parameters (``ShapeDtypeStruct``s:
nothing allocated) and the port's ``meta`` models: every leaf of all ten
architectures at full width, at tp 16 and 8, one and two pods, FSDP off and
on, ZeRO-1 off and on; the serve caches of every family with sequence
sharding off and on. The reference reads its axis sizes from its module
global ``_AXIS_SIZES``, set here through ``monkeypatch`` (restored after
each test); the port reads them from its mesh argument. Specs compare
exactly, as tuples."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import ARCH_IDS, get_config as ref_config
from repro.models import model as RM
from repro.runtime import sharding as RS
from repro_torch.configs.base import get_config
from repro_torch.models.convert import reference_shapes
from repro_torch.models.transformer import Transformer
from repro_torch.runtime import sharding as TS

MESHES = [((16,), ("data",)), ((2, 16), ("pod", "data"))]


def _flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {RS._path_str(p): (tuple(x) if isinstance(x, P)
                              else tuple(x.shape)) for p, x in leaves}


def _mesh(monkeypatch, dshape, dnames, tp):
    shape, names = dshape + (tp,), dnames + ("model",)
    monkeypatch.setattr(RS, "_AXIS_SIZES", dict(zip(names, shape)))
    return TS.make_mesh(shape, names, ["meta"])


@pytest.mark.parametrize("tp", [16, 8])
@pytest.mark.parametrize("dshape,dnames", MESHES)
def test_param_and_opt_specs_match_reference(monkeypatch, tp, dshape, dnames):
    mesh = _mesh(monkeypatch, dshape, dnames, tp)
    n_leaves = 0
    for arch in ARCH_IDS:
        ap = RM.abstract_params(ref_config(arch), tp=tp, dtype=jnp.bfloat16)
        model = Transformer(get_config(arch), tp=tp, device="meta",
                            dtype=torch.bfloat16)
        assert reference_shapes(model) == _flat(ap), arch
        for fsdp in ((), TS.data_axes(mesh)):
            ref = RS.param_specs(ap, fsdp)
            got = TS.param_specs(reference_shapes(model), mesh, fsdp)
            want = _flat(ref)
            assert got == want, (arch, tp, fsdp, {
                k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                if got.get(k) != want.get(k)})
            n_leaves += len(got)
            for zero1 in (False, True):
                ro = RS.opt_state_specs(ref, zero1)
                to = TS.opt_state_specs(got, zero1)
                assert to.m == _flat(ro.m) and to.v == _flat(ro.v)
                assert to.step == tuple(ro.step)
    assert n_leaves == 330         # 165 leaves over the ten archs, twice


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen2_moe_a2_7b",
                                  "rwkv6_3b", "zamba2_7b"])
def test_cache_specs_match_reference(monkeypatch, arch, seq_shard):
    """Attention, MoE, SSM and hybrid caches (one arch a family)."""
    for (dshape, dnames), tp in zip(MESHES, (16, 8)):
        mesh = _mesh(monkeypatch, dshape, dnames, tp)
        rmesh = jax.sharding.AbstractMesh(mesh.shape, mesh.axis_names)
        acache = RM.abstract_cache(ref_config(arch), 4, 64, tp=tp,
                                   dtype=jnp.bfloat16)
        model = Transformer(get_config(arch), tp=tp, device="meta",
                            dtype=torch.bfloat16)
        cache = model.init_cache(4, 64)
        shapes = {k: tuple(v.shape) for k, v in cache.items()
                  if isinstance(v, torch.Tensor)}
        assert shapes == {k: v for k, v in _flat(acache).items()
                          if k != "pos"}
        want = _flat(RS.cache_specs(acache, rmesh, seq_shard=seq_shard))
        assert TS.cache_specs(cache, mesh, seq_shard) == want
    assert TS.batch_spec(mesh) == tuple(RS.batch_spec(rmesh))
    assert TS.activation_spec(mesh) == tuple(RS.activation_spec(rmesh))


def test_shard_shape_and_shard_tensor_tile_the_tensor():
    """Every position's slice has ``shard_shape``'s shape (short only at an
    uneven last shard) and the slices tile the tensor."""
    mesh = TS.make_mesh((2, 3, 2), ("pod", "data", "model"), ["cpu"])
    t = torch.arange(12 * 5 * 8).reshape(12, 5, 8)
    for spec in [(("pod", "data"), None, "model"), ("model", "data", None),
                 (None, None, None), ("data", None, ("pod", "model"))]:
        size = TS.shard_shape(t.shape, spec, mesh)
        seen = torch.zeros_like(t)
        for c in mesh.coords():
            piece = TS.shard_tensor(t, spec, mesh, c)
            assert all(a <= b for a, b in zip(piece.shape, size))
            idx = TS.shard_index(spec + (None,) * 0, mesh, c)
            sl = tuple(slice(i * n, i * n + m) for i, n, m
                       in zip(idx, size, piece.shape))
            np.testing.assert_array_equal(piece.numpy(), t[sl].numpy())
            seen[sl] += 1
        # replicated dims are held by every position of the other axes
        reps = mesh.size // int(np.prod([TS._n(mesh, e) for e in spec]))
        assert bool((seen == reps).all()), spec
    assert TS.shard_shape((10,), ("data",), mesh) == (4,)
