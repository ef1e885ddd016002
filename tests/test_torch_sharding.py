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
it is swapped (``monkeypatch``) for a holder of the spec.

A mesh of more than one device is a ``DeviceMesh``: ``launch.mesh`` builds
it over a process group of as many ranks and refuses it without one.  Here
the group is torch's ``fake`` backend (one process standing for 256 or 512
ranks, which runs nothing), and the placements of every leaf of the ten
full configs on the production meshes are read off shapes alone, held to
the specs entry for entry.  ``constrain`` and ``gather_weight`` are the
identity with no axes set and redistribute a DTensor with them.
"""
import contextlib

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


@contextlib.contextmanager
def fake_group(world: int):
    """torch's ``fake`` process group of ``world`` ranks in this process
    (this one rank 0), and the activation axes unset after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        sharding.set_activation_axes(None)
        dist.destroy_process_group()


def test_gather_weight_and_constrain_return_their_input():
    """With no axes set both are the identity, as the reference's are; on a
    (2, 4) mesh of a fake group a DTensor is redistributed to the tags'
    placements (dp on its rows, tp on its columns), a plain tensor and
    tags that all degrade leave it as it was."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    w = torch.ones(4, 6)
    sharding.set_activation_axes(None)
    assert sharding.gather_weight(w) is w
    assert sharding.gather_weight(w, col_parallel=False) is w
    assert sharding.constrain(w, ("dp", "tp")) is w
    with fake_group(8):
        mesh = tmesh.make_mesh((2, 4), ("data", "model"), "cpu")
        sharding.set_activation_axes(mesh)
        assert sharding.constrain(w, ("dp", "tp")) is w  # nothing placed
        x = DTensor.from_local(torch.arange(24.0).reshape(4, 6), mesh,
                               [Replicate(), Replicate()], run_check=False)
        assert sharding.constrain(x, (None, None)) is x
        assert sharding.constrain(x, ("dp", "tp")).placements == (Shard(0), Replicate())
        y = sharding.constrain(x, ("tp", "dp"))
        assert y.placements == (Shard(1), Shard(0)) and y.to_local().shape == (1, 3)
        # rank 0's shard (a fake group runs no collective; from replicated
        # to sharded is a local slice)
        assert torch.equal(y.to_local(), x.to_local()[:1, :3])
        assert sharding.gather_weight(x) is x  # 6 columns over 4: degrades
        wt = DTensor.from_local(torch.ones(4, 2), mesh, [Shard(0), Shard(1)], run_check=False)
        g = sharding.gather_weight(wt)
        assert g.placements == (Replicate(), Shard(1)) and g.to_local().shape == (8, 2)
        g = sharding.gather_weight(wt, col_parallel=False)
        assert g.placements == (Replicate(), Shard(0)) and g.to_local().shape == (2, 8)


@pytest.mark.parametrize("shape", [(2, 4), (2, 2, 4), (1, 2)])
def test_a_mesh_of_more_than_one_device_is_refused(shape):
    """Without a process group of its size, ``make_mesh`` refuses a mesh of
    more than one device, naming both numbers (it never falls back to one
    device); under a fake group of that size it is a ``DeviceMesh`` whose
    axis names and shape the rules and ``set_activation_axes`` read."""
    from torch.distributed.device_mesh import DeviceMesh

    axes = MESHES.get(shape, ("data", "model"))
    n = int(np.prod(shape))
    with pytest.raises(RuntimeError, match=f"process group of {n} ranks; this process has "
                                           "no initialised process group"):
        tmesh.make_mesh(shape, axes, "cpu")
    with fake_group(n + 1):
        with pytest.raises(RuntimeError, match=f"needs a process group of {n} ranks; this "
                                               f"process has a process group of {n + 1} ranks"):
            tmesh.make_mesh(shape, axes, "cpu")
    with fake_group(n):
        mesh = tmesh.make_mesh(shape, axes, "cpu")
        assert isinstance(mesh, DeviceMesh) and mesh.mesh_dim_names == axes
        assert sharding.axis_names(mesh) == axes and sharding.mesh_shape(mesh) == shape
        sharding.set_activation_axes(mesh)
        dp = tuple(a for a in ("pod", "data") if a in axes)
        assert sharding._ACT["dp"] == dp and sharding._ACT["tp"] == "model"
        assert sharding.dp_size() == int(np.prod(shape[:-1]))
        assert sharding.tp_size() == shape[-1]
        assert sharding.data_spec(mesh) == sharding.data_spec(_Mesh(shape, axes))


def test_production_mesh_is_refused_and_a_local_mesh_has_one_device():
    """The production meshes need a group of 256 or 512 ranks: refused
    without, a ``DeviceMesh`` of (16, 16) and (2, 16, 16) under a fake
    group.  A local mesh is the one-device record."""
    for multi_pod, n, shape in ((False, 256, (16, 16)), (True, 512, (2, 16, 16))):
        with pytest.raises(RuntimeError, match=f"process group of {n} ranks"):
            tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
        with fake_group(n):
            mesh = tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
            assert tuple(mesh.shape) == shape and mesh.device_type == "cpu"
            assert mesh.mesh_dim_names == (("pod",) if multi_pod else ()) + ("data", "model")
    m = tmesh.make_local_mesh("cpu")
    assert m.axis_names == ("data", "model") and m.devices.shape == (1, 1)
    assert m.devices[0, 0] == torch.device("cpu")
    sharding.set_activation_axes(m)
    sharding.set_activation_axes(None)
    from repro_torch.launch.train import parse_mesh

    assert parse_mesh("1", "cpu").axis_names == ("data",)
    assert parse_mesh("1x1x1", "cpu").devices.shape == (1, 1, 1)
    with pytest.raises(ValueError, match="rank"):
        tmesh.make_mesh((1, 1), ("data",), "cpu")


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_production_placements_equal_the_specs(arch, multi_pod):
    """Every leaf of the full config (``meta`` stand-ins: only shapes are
    read) on the production mesh of a fake group: its placements shard
    tensor dim d on exactly the mesh dims its spec's entry d names, and
    rank 0's shard has each dim divided by the product of their sizes."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.launch.dryrun import params_struct

    params = params_struct(get_config(arch))
    with fake_group(512 if multi_pod else 256):
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
        names, sizes = mesh.mesh_dim_names, dict(zip(mesh.mesh_dim_names, mesh.shape))
        specs = sharding.make_param_shardings(params, mesh)
        n_sharded = 0
        for path, x in flatten_with_path(params):
            spec = _at(specs, path)
            pl = sharding.placements(spec, mesh)
            want = [Replicate()] * len(names)
            local = list(x.shape)
            for d, entry in enumerate(spec):
                for a in () if entry is None else (entry,) if isinstance(entry, str) else entry:
                    want[names.index(a)] = Shard(d)
                    local[d] //= sizes[a]
            assert pl == tuple(want), (arch, path, spec, pl)
            got, _ = compute_local_shape_and_global_offset(tuple(x.shape), mesh, pl)
            assert tuple(got) == tuple(local), (arch, path, spec)
            n_sharded += any(p.is_shard() for p in pl)
        assert n_sharded > 0


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


def test_a_one_device_step_runs_no_dtensor(tmp_path, capsys):
    """On one device nothing is placed: granite-3-2b's reduced train step
    (two microbatches) and ``launch.train --mesh 1x1`` call no torch
    function with a DTensor argument, the 1 x 1 mesh's activation axes set
    (the mode that looks does see one on a placed tensor)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.overrides import TorchFunctionMode
    from torch.utils._pytree import tree_leaves

    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import train as launch_train
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.train.step import make_train_step

    calls = []

    class Seen(TorchFunctionMode):
        """Records every torch function called with a DTensor argument."""

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if any(isinstance(x, DTensor) for x in tree_leaves((args, kwargs or {}))):
                calls.append(func)
            return func(*args, **(kwargs or {}))

    cfg = get_config("granite-3-2b").reduced()
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_for_step(
        DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4), 0).items()}
    try:
        sharding.set_activation_axes(tmesh.make_local_mesh("cpu"))
        opt_cfg = OptConfig()
        with Seen():
            make_train_step(cfg, opt_cfg, 2)(params, init_opt_state(opt_cfg, params), batch)
            assert launch_train.main(["--reduced", "--device", "cpu", "--mesh", "1x1",
                                      "--steps", "1", "--seq-len", "16", "--ckpt-dir",
                                      str(tmp_path)]) == 0
    finally:
        sharding.set_activation_axes(None)
    assert calls == []
    assert "[train] done at step 1" in capsys.readouterr().out
    with fake_group(2):
        mesh = tmesh.make_mesh((2,), ("data",), "cpu")
        x = DTensor.from_local(torch.ones(2), mesh, [Replicate()], run_check=False)
        with Seen():
            x + 1
    assert calls
