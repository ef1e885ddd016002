"""The port's sharding rules (``repro_torch.train.sharding``) against
``repro.train.sharding``'s, spec for spec.

For every parameter leaf of all ten configs (full shapes from the
reference's ``jax.eval_shape``, reduced shapes from both packages' trees),
on stand-in meshes of shape (1, 1), (2, 4) and (2, 2, 4) (the reference
reads only ``axis_names`` and ``devices.shape``), the port's
``param_spec`` / ``make_param_shardings``, ``make_batch_shardings``,
``make_cache_shardings`` and ``data_spec`` equal the reference's
``PartitionSpec`` entry for entry.  The reference wraps each spec in a
``NamedSharding``, which needs a real mesh of that many devices, so here
it is swapped (``monkeypatch``) for a holder of the spec.  A mesh of more
than one device is refused by ``set_activation_axes``, ``launch.mesh``
and the production mesh.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import sharding  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

MESHES = {(1, 1): ("data", "model"), (2, 4): ("data", "model"),
          (2, 2, 4): ("pod", "data", "model")}


class _Mesh:
    """A stand-in with the two attributes the rules read."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=object)


class _Spec:
    """Holds a spec where the reference would build a ``NamedSharding``."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.fixture
def jsharding(monkeypatch):
    from repro.train import sharding as js

    monkeypatch.setattr(js, "NamedSharding", _Spec)
    return js


def _at(tree, path):
    """The node of a port tree at ``path`` (``repro_torch.tree``'s keys)."""
    for k in path:
        if isinstance(tree, dict):
            tree = tree[k]
        elif hasattr(tree, "_fields"):
            tree = getattr(tree, k)
        else:
            tree = tree[int(k[1:-1])]
    return tree


def _jax_specs(tree) -> list:
    import jax

    return [s.spec for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, _Spec))]


def _full_shapes(arch):
    import jax

    from repro.configs import get_config as jget
    from repro.models.lm import init_params

    return jax.eval_shape(lambda k: init_params(jget(arch), k), jax.random.PRNGKey(0))


@pytest.mark.parametrize("shape", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch, shape, jsharding):
    mesh = _Mesh(shape, MESHES[shape])
    cfg = get_config(arch).reduced()
    reduced = lm.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    for params in (_full_shapes(arch), reduced):
        want = _jax_specs(jsharding.make_param_shardings(params, mesh))
        got_tree = sharding.make_param_shardings(params, mesh)
        flat = flatten_with_path(params)
        assert len(flat) == len(want)
        fsdp = tuple(a for a in ("pod", "data") if a in mesh.axis_names) or None
        for (path, x), w in zip(flat, want, strict=True):
            assert _at(got_tree, path) == w, (arch, shape, path)
            assert sharding.param_spec(path, tuple(x.shape), mesh, fsdp, "model") == w
            assert len(w) == len(x.shape)
    assert sharding.data_spec(mesh) == tuple(jsharding.data_spec(mesh))


@pytest.mark.parametrize("shape", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_and_cache_specs_match_reference(arch, shape, jsharding):
    """Batches of 1 and 8 rows (with and without sequence sharding), and the
    caches of the full config (the reference's ``eval_shape``) and of the
    reduced one (both packages' ``init_caches``)."""
    import jax

    from repro.configs import get_config as jget
    from repro.models.lm import init_caches as jinit_caches

    mesh = _Mesh(shape, MESHES[shape])
    for b in (1, 8):
        batch = {"tokens": np.zeros((b, 64), np.int32), "labels": np.zeros((b, 64), np.int32),
                 "frontend": np.zeros((b, 16, 32), np.float32)}
        for shard_seq in (False, True):
            want = _jax_specs(jsharding.make_batch_shardings(batch, mesh, shard_seq=shard_seq))
            got = sharding.make_batch_shardings(batch, mesh, shard_seq=shard_seq)
            assert [got[k] for k in sorted(batch)] == want
    full = jax.eval_shape(lambda: jinit_caches(jget(arch), 16, 4096))
    want = _jax_specs(jsharding.make_cache_shardings(full, mesh))
    got = sharding.make_cache_shardings(full, mesh)
    assert [_at(got, p) for p, _ in flatten_with_path(full)] == want
    cfg = get_config(arch).reduced()
    mine = lm.init_caches(cfg, 4, 32, device="cpu")
    want = _jax_specs(jsharding.make_cache_shardings(jinit_caches(jget(arch).reduced(), 4, 32),
                                                     mesh))
    got = sharding.make_cache_shardings(mine, mesh)
    assert [_at(got, p) for p, _ in flatten_with_path(mine)] == want


def test_gather_weight_and_constrain_return_their_input():
    w = torch.ones(4, 6)
    assert sharding.gather_weight(w) is w
    assert sharding.gather_weight(w, col_parallel=False) is w
    assert sharding.constrain(w, ("dp", "tp")) is w


@pytest.mark.parametrize("shape", [(2, 4), (2, 2, 4), (1, 2)])
def test_a_mesh_of_more_than_one_device_is_refused(shape):
    axes = MESHES.get(shape, ("data", "model"))
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        sharding.set_activation_axes(_Mesh(shape, axes))
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        tmesh.make_mesh(shape, axes, "cpu")


def test_production_mesh_is_refused_and_a_local_mesh_has_one_device():
    for multi_pod in (False, True):
        with pytest.raises(NotImplementedError, match="more than one device"):
            tmesh.make_production_mesh(multi_pod=multi_pod)
    m = tmesh.make_local_mesh("cpu")
    assert m.axis_names == ("data", "model") and m.devices.shape == (1, 1)
    assert m.devices[0, 0] == torch.device("cpu")
    sharding.set_activation_axes(m)
    from repro_torch.launch.train import parse_mesh

    assert parse_mesh("1", "cpu").axis_names == ("data",)
    assert parse_mesh("1x1x1", "cpu").devices.shape == (1, 1, 1)
    with pytest.raises(ValueError, match="rank"):
        tmesh.make_mesh((1, 1), ("data",), "cpu")


def test_a_mesh_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_local_mesh()


def test_reference_param_spec_shapes_on_the_port():
    """The reference's ``test_param_specs_shapes`` on the port: every leaf of
    reduced mixtral gets a spec no longer than its rank."""
    cfg = get_config("mixtral-8x7b").reduced()
    p = lm.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    sh = sharding.make_param_shardings(p, tmesh.make_mesh((1, 1), ("data", "model"), "cpu"))
    for path, x in flatten_with_path(p):
        assert len(_at(sh, path)) <= len(x.shape) or len(x.shape) == 0
