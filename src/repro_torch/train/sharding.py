"""Parameter and activation sharding rules (a port of
``repro.train.sharding``: DP x FSDP x TP on the production mesh), and their
application across devices as DTensor placements.

Megatron-style tensor parallelism over the ``model`` axis (column-parallel
in-projections, row-parallel out-projections), ZeRO/FSDP-style parameter and
optimiser-state sharding over the data axes (('pod', 'data') when present).
MoE expert tensors go expert-parallel over ``model`` when the expert count
divides it, else tensor-parallel inside each expert.  An axis that does not
divide its dim is dropped (``_fit``).

The rules read only a mesh's axis names and shape, so they take either kind
of mesh: a ``torch.distributed`` ``DeviceMesh`` (``mesh_dim_names`` and its
``.mesh`` of ranks) or a record with ``axis_names`` and a ``devices`` array
(``launch.mesh.Mesh``, a JAX mesh, a stand-in).  They give each leaf's spec
as a tuple of axis names: the reference's ``PartitionSpec``, entry for entry
(an entry ``None``, an axis name, or a tuple of two or more names).

Applying a spec is ``placements``: each mesh dim gets ``Shard(d)`` for the
tensor dim ``d`` whose entry names it, else ``Replicate()``; an entry of two
names shards its dim over both mesh dims, major first, as JAX does.
``place`` turns a tree of full tensors into DTensors on a ``DeviceMesh``
(every rank holds the same full leaf and keeps its shard), ``gather`` turns
them back.  ``set_activation_axes`` sets the reference's logical axes, and
``constrain`` and ``gather_weight`` redistribute a DTensor to the
placements their tags name.  A plain tensor passes through both unchanged:
a one-device run (``launch.mesh.make_local_mesh``, ``--mesh 1x1``) places
nothing and runs no DTensor.  A step over placed tensors runs under
``spmd``; its gradients come back on their parameters' placements
(``like``) and its microbatches are the global batch's rows (``rows``),
as the reference's are.  A function that is local along the dims the
activation axes shard (attention, the SSM scans, the MoE's groups and
experts) runs on each rank's shards through ``shard_local``, with no
DTensor op inside; the layers read the axes' sizes through ``dp_size``
and ``tp_size``.

The dry run's counted half (``launch.calibrate.calibrated_cost``,
``launch.dryrun.lower_cell``) places its stand-ins by these specs on the
production meshes (``meta`` shards under a ``fake`` group) and counts one
rank's program (``core.cost.count_cost``); its analytic half reads a mesh's
axis sizes only and takes any mesh.
"""
from __future__ import annotations

import contextlib

from repro_torch.tree import flatten_with_path, map_with_path, unflatten

# the reference's logical activation axes, and the mesh they were set from
_ACT = {"mesh": None, "dp": None, "tp": None, "dp_size": 1, "tp_size": 1}


def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` (else a record of names and
    devices)."""
    return hasattr(mesh, "mesh_dim_names")


def axis_names(mesh) -> tuple:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, else its
    ``axis_names``."""
    return tuple(mesh.mesh_dim_names if is_device_mesh(mesh) else mesh.axis_names)


def mesh_shape(mesh) -> tuple:
    """A mesh's shape: a ``DeviceMesh``'s ``.mesh`` of ranks, else its
    ``devices`` array."""
    devices = mesh.mesh if hasattr(mesh, "mesh") else mesh.devices
    return tuple(int(d) for d in devices.shape)


def mesh_size(mesh) -> int:
    """Devices of ``mesh``."""
    n = 1
    for d in mesh_shape(mesh):
        n *= d
    return n


def set_activation_axes(mesh) -> None:
    """Configure the logical activation axes ('dp', 'tp') for ``constrain``
    from ``mesh`` (either kind), as the reference does: ``dp`` the data axes
    present, ``tp`` 'model' where present, and their sizes.  ``None`` sets
    none, and ``constrain`` is the identity."""
    if mesh is None:
        _ACT.update(mesh=None, dp=None, tp=None, dp_size=1, tp_size=1)
        return
    sizes = _sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes) or None
    dp_size = 1
    for a in dp or ():
        dp_size *= sizes[a]
    _ACT.update(mesh=mesh, dp=dp, tp="model" if "model" in sizes else None,
                dp_size=dp_size, tp_size=sizes.get("model", 1))


def activation_mesh():
    """The mesh the activation axes were set from (``None`` where none
    were)."""
    return _ACT["mesh"]


def dp_size() -> int:
    """The data axes' device count of the activation axes set (1 where
    none are)."""
    return _ACT["dp_size"]


def tp_size() -> int:
    """The 'model' axis' device count of the activation axes set (1 where
    none is)."""
    return _ACT["tp_size"]


def _dtensor():
    import torch.distributed.tensor as dt

    return dt


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (placed on a ``DeviceMesh``)."""
    return isinstance(x, _dtensor().DTensor)


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of a leaf whose spec is ``spec`` on the
    ``DeviceMesh`` ``mesh``: ``Shard(d)`` on each mesh dim that entry ``d``
    names, ``Replicate()`` on the others.  An entry of several names shards
    its dim over those mesh dims, the first named the major one, which
    DTensor's default order (by mesh dim) gives where the names come in the
    mesh's order."""
    dt = _dtensor()
    names = axis_names(mesh)
    out = [dt.Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's order {names}")
        for i in idx:
            if out[i] != dt.Replicate():
                raise ValueError(f"mesh axis {names[i]} shards two dims in {spec}")
            out[i] = dt.Shard(d)
    return tuple(out)


def spec_at(spec_tree, path: tuple) -> tuple:
    """The spec at ``path`` (``repro_torch.tree``'s keys) of a tree of specs
    made by the rules below: specs are tuples, so the tree's own leaves
    cannot be told from its nodes by ``flatten_with_path``."""
    node = spec_tree
    for k in path:
        if isinstance(node, dict):
            node = node[k]
        elif hasattr(node, "_fields"):
            node = getattr(node, k)
        else:
            node = node[int(k[1:-1])]
    return node


def place(tree, spec_tree, mesh):
    """``tree``'s tensors as DTensors on the ``DeviceMesh`` ``mesh``, each
    placed by its spec in ``spec_tree`` (``make_param_shardings``,
    ``make_batch_shardings``, ``make_cache_shardings``).  Every rank holds
    the same full leaf (drawn from the same seeded generator, or read from
    the same file) and keeps its shard: nothing is sent."""
    dt = _dtensor()
    out = []
    for path, x in flatten_with_path(tree):
        out.append(dt.distribute_tensor(x, mesh, placements(spec_at(spec_tree, path), mesh),
                                        src_data_rank=None))
    return unflatten(tree, out)


def full(x):
    """A DTensor gathered into a full tensor on every rank; a plain tensor
    as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def gather(tree):
    """``tree`` with every DTensor gathered into a full tensor (``full``)."""
    return map_with_path(lambda _, x: full(x), tree)


def is_placed(tree) -> bool:
    """Whether a leaf of ``tree`` is a DTensor."""
    return any(is_dtensor(x) for _, x in flatten_with_path(tree))


def spmd(tree):
    """The context a step runs its DTensor ops under when ``tree`` (its
    parameters) is placed: plain tensors made inside the step (positions,
    masks, zero rows, the learning rate) take part as replicated DTensors.
    A plain tree runs under no context; so does a step inside another."""
    if not is_placed(tree):
        return contextlib.nullcontext()
    return _implicit_replication()


@contextlib.contextmanager
def _implicit_replication():
    from torch.distributed.tensor.experimental import implicit_replication

    # torch's context turns the switch off on exit, also inside an outer one
    if getattr(_dtensor().DTensor._op_dispatcher, "_allow_implicit_replication", False):
        yield
        return
    with implicit_replication():
        yield


def like(g, p):
    """``g`` (a gradient) redistributed to the placements of ``p`` (its
    parameter) where both are DTensors and differ: a reduce-scatter for a
    partial sum over an FSDP dim.  Otherwise ``g``."""
    if is_dtensor(g) and is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def rows(x, k: int, parts: int):
    """Rows ``k·n:(k+1)·n`` of ``x``, n = rows / ``parts``: the ``k``-th
    microbatch, the reference's (it reshapes the global batch).  A DTensor
    is gathered (a batch of tokens and labels is small), sliced, and placed
    again as it was, so that the microbatch holds the same rows as one
    device's: the MoE's groups, and the tokens its capacity drops, follow
    them."""
    if is_dtensor(x):
        n = x.shape[0] // parts
        return _dtensor().distribute_tensor(x.full_tensor()[k * n:(k + 1) * n], x.device_mesh,
                                            x.placements, src_data_rank=None)
    n = x.shape[0] // parts
    return x[k * n:(k + 1) * n]


def _redistribute(x, entries):
    """``x`` (a DTensor) redistributed to the placements of the spec
    ``entries`` on its own mesh; ``x`` where it already has them."""
    mesh = x.device_mesh
    want = placements(tuple(entries), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def _tag_spec(shape, tags) -> tuple:
    """The spec the logical ``tags`` ('dp', 'tp', None per dim) name for a
    tensor of ``shape`` under the activation axes set: a tag whose axes are
    unset or do not divide its dim degrades to ``None``."""
    spec = []
    for dim, t in zip(shape, tags):
        if t == "dp" and _ACT["dp"] and dim % _ACT["dp_size"] == 0:
            spec.append(_ACT["dp"])
        elif t == "tp" and _ACT["tp"] and dim % _ACT["tp_size"] == 0:
            spec.append(_ACT["tp"])
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x, tags):
    """The reference's ``with_sharding_constraint`` with logical tags ('dp',
    'tp', None) per dim: a DTensor is redistributed on its mesh to the data
    axes on each 'dp' dim and 'model' on each 'tp' dim, a tag whose axes are
    unset or do not divide its dim degrading to replication.  The identity
    where no axis is set, where every tag degrades, and on a plain tensor
    (nothing is placed)."""
    if _ACT["dp"] is None and _ACT["tp"] is None:
        return x
    spec = _tag_spec(x.shape, tags)
    if all(s is None for s in spec) or not is_dtensor(x):
        return x
    return _redistribute(x, spec)


def redistribute(x, tags):
    """``x`` redistributed to the spec its logical ``tags`` name
    (``constrain``'s rules), also where every tag degrades: then to
    replication, partial sums reduced.  For a reshape that splits a dim a
    mesh dim shards unevenly, which a DTensor cannot view.  A plain tensor,
    or no axes set, as it is."""
    if not is_dtensor(x) or (_ACT["dp"] is None and _ACT["tp"] is None):
        return x
    return _redistribute(x, _tag_spec(x.shape, tags))


def shard_local(fn, args, out_tags, out_shape):
    """``fn`` run on each rank's shards, where the first tensor of ``args``
    is a DTensor and activation axes are set; else ``fn(*args)``.  ``args``
    are (tensor or None, tags) pairs: each tensor (a plain one taken as
    replicated) is redistributed to the spec its tags name
    (``constrain``'s rules), and ``fn`` gets the local shards.  Its output,
    of global shape ``out_shape``, becomes a DTensor placed by
    ``out_tags``; an output that is a tuple takes a tuple of each.  For a
    function that is local along the dims the tags shard (attention and
    the SSM scans over batch and heads): the tags must shard an output's
    dims where they shard the inputs' that feed them.  It runs as the
    one-device code does, with no DTensor op inside."""
    tensors = [x for x, _ in args if x is not None]
    if not (tensors and is_dtensor(tensors[0])) or (_ACT["dp"] is None and _ACT["tp"] is None):
        return fn(*(x for x, _ in args))
    dt = _dtensor()
    mesh = tensors[0].device_mesh
    single = not isinstance(out_tags[0], tuple)
    outs = [placements(_tag_spec(tuple(shape), tags), mesh) for tags, shape in
            zip(*(((out_tags,), (out_shape,)) if single else (out_tags, out_shape)), strict=True)]
    # a mesh dim that shards an output splits the work: the gradient of an
    # input replicated there is this rank's part of a sum
    split = {m for want in outs for m, p in enumerate(want) if p != dt.Replicate()}
    shards = []
    for x, tags in args:
        if x is not None:
            if not is_dtensor(x):
                x = dt.DTensor.from_local(x, mesh, [dt.Replicate()] * mesh.ndim,
                                          run_check=False)
            x = _redistribute(x, _tag_spec(x.shape, tags))
            grad = [dt.Partial() if p == dt.Replicate() and m in split else p
                    for m, p in enumerate(x.placements)]
            x = x.to_local(grad_placements=grad)
        shards.append(x)
    out = fn(*shards)
    got = [out] if single else list(out)
    wrapped = tuple(dt.DTensor.from_local(t, mesh, want, run_check=False)
                    for t, want in zip(got, outs, strict=True))
    return wrapped[0] if single else wrapped


def gather_weight(w, col_parallel: bool = True):
    """The reference's ZeRO-3-style use-time weight gathering: a 2-D DTensor
    weight redistributed to be sharded only on its model-parallel dim (the
    FSDP dim gathered).  The identity where no model axis is set, on a
    weight not of rank 2, where the model axis does not divide, and on a
    plain tensor.  The reference imports it in its MLP and attention layers
    but calls it nowhere; the port keeps it with no call site too."""
    if _ACT["tp"] is None or w.ndim != 2:
        return w
    tp, tps = _ACT["tp"], _ACT["tp_size"]
    if col_parallel:
        spec = (None, tp if w.shape[1] % tps == 0 else None)
    else:
        spec = (tp if w.shape[0] % tps == 0 else None, None)
    if spec == (None, None) or not is_dtensor(w):
        return w
    return _redistribute(w, spec)


COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_g", "w_r",
                "w_decay_a", "frontend_proj"}
ROW_PARALLEL = {"wo", "w_down", "w_out", "w_decay_b"}
REPLICATED = {"bq", "bk", "bv", "b_up", "b_down", "scale", "bias", "A_log",
              "dt_bias", "norm_scale", "decay_base", "bonus_u", "mu"}


def _spec(entries) -> tuple:
    """A spec as ``PartitionSpec`` keeps it: a one-name tuple becomes the
    name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def _sizes(mesh) -> dict:
    return dict(zip(axis_names(mesh), mesh_shape(mesh)))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    s = 1
    for a in axes:
        s *= _sizes(mesh)[a]
    return s


def _fit(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop axes that don't divide the corresponding dim."""
    fixed = []
    for dim, axes in zip(shape, spec):
        if axes is not None and dim % _axis_size(mesh, axes) != 0:
            axes = None
        fixed.append(axes)
    return _spec(fixed)


def _names(path) -> list:
    # a path of the port's trees is strings already (``repro_torch.tree``);
    # JAX's key objects read as the reference reads them
    return [getattr(k, "key", getattr(k, "name", str(k))) for k in path]


def param_spec(path: tuple, shape: tuple, mesh, fsdp, tp) -> tuple:
    """The spec of the parameter at ``path`` (names from the root) of
    ``shape``, on ``mesh`` with FSDP axes ``fsdp`` and TP axis ``tp``."""
    names = _names(path)
    name = names[-1]
    stacked = any(n in ("layers", "enc_layers", "cross_layers", "mamba") for n in names)
    lead = (None,) if stacked and len(shape) > 0 else ()

    def spec(*core):
        core = lead + core
        # pad/truncate to shape rank
        core = core[: len(shape)] + (None,) * (len(shape) - len(core))
        return _fit(core, shape, mesh)

    in_chan_mix = "chan" in names
    if name == "embed":
        return spec(tp, fsdp)
    if name == "lm_head":
        return spec(fsdp, tp)
    if name == "router":
        return spec(fsdp, None)
    if name in ("w_gate", "w_up", "w_down") and len(shape) - len(lead) == 3:
        # MoE expert tensors (X, E, F) / (X, F, E)
        n_exp = shape[len(lead)]
        if n_exp % _axis_size(mesh, tp) == 0:
            return spec(tp, fsdp, None)  # expert parallel
        if name == "w_down":
            return spec(None, tp, fsdp)
        return spec(None, fsdp, tp)
    if in_chan_mix and name == "w_k":
        return spec(fsdp, tp)
    if in_chan_mix and name == "w_v":
        return spec(tp, fsdp)
    if name in COL_PARALLEL or (name == "w_k" and not in_chan_mix):
        return spec(fsdp, tp)
    if name in ROW_PARALLEL:
        return spec(tp, fsdp)
    if name == "conv_w":
        return spec(None, tp)
    return spec(*([None] * (len(shape) - len(lead))))


def _data_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh)) or None


def _model_axis(mesh):
    return "model" if "model" in axis_names(mesh) else None


def make_param_shardings(params, mesh):
    """A tree of specs matching ``params`` (tensors, or anything with a
    ``shape``)."""
    fsdp, tp = _data_axes(mesh), _model_axis(mesh)
    return map_with_path(lambda path, x: param_spec(path, tuple(x.shape), mesh, fsdp, tp),
                         params)


def data_spec(mesh) -> tuple:
    dp = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    return _spec((dp if dp else None,))


def make_batch_shardings(batch_struct, mesh, shard_seq: bool = False):
    """Batch dim over the data axes; optionally the sequence dim over
    'model' (sequence parallelism for batch-1 long-context cells)."""
    dp, tp = _data_axes(mesh), _model_axis(mesh)

    def leaf(path, x):
        shape = tuple(x.shape)
        spec = [dp] + [None] * (len(shape) - 1)
        if shard_seq and len(shape) >= 2 and shape[0] == 1 and tp:
            spec[1] = tp
        # don't shard batch if it doesn't divide
        if shape[0] % _axis_size(mesh, dp) != 0:
            spec[0] = None
        return _spec(spec)

    return map_with_path(leaf, batch_struct)


def make_cache_shardings(caches, mesh, cfg=None):
    """KV caches: batch over the data axes, KV heads over 'model' when
    divisible, else the cache's sequence dim (flash-decoding-style partial
    softmax); recurrent states: heads over 'model'.  Each cache leaf has the
    stacked layer axis first."""
    dp, tp = _data_axes(mesh), _model_axis(mesh)

    def leaf(path, x):
        shape = tuple(x.shape)
        spec = [None] * len(shape)
        if len(shape) >= 2:
            spec[1] = dp if (dp and shape[1] % _axis_size(mesh, dp) == 0) else None
        if len(shape) >= 3 and tp:
            if shape[2] % _axis_size(mesh, tp) == 0:
                spec[2] = tp
            elif len(shape) >= 4 and shape[3] % _axis_size(mesh, tp) == 0:
                spec[3] = tp
        return _spec(spec)

    return map_with_path(leaf, caches)
