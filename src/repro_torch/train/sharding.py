"""Parameter and activation sharding rules (a port of
``repro.train.sharding``: DP x FSDP x TP on the production mesh).

Megatron-style tensor parallelism over the ``model`` axis (column-parallel
in-projections, row-parallel out-projections), ZeRO/FSDP-style parameter and
optimiser-state sharding over the data axes (('pod', 'data') when present).
MoE expert tensors go expert-parallel over ``model`` when the expert count
divides it, else tensor-parallel inside each expert.  An axis that does not
divide its dim is dropped (``_fit``).

The rules read only a mesh's ``axis_names`` and ``devices.shape``, as the
reference's do, so they take any object with those two attributes (a
``launch.mesh.Mesh``, a JAX mesh, a stand-in), and they give each leaf's
spec as a tuple of axis names: the reference's ``PartitionSpec``, entry for
entry (an entry ``None``, an axis name, or a tuple of two or more names).

The port runs on one card.  There every spec is a no-op, no activation
axis is set, and ``constrain`` and ``gather_weight`` return their input,
as the reference does with none set.  Applying the specs across more than
one card (DTensor placements on a ``DeviceMesh``) is not ported:
``set_activation_axes`` and ``launch.mesh.make_mesh`` refuse a mesh of more
than one device, since an activation or a weight that silently stayed
replicated across devices would be a different program.  What reads only a
mesh's axis sizes takes any mesh: these rules, and the dry run's analytic
half (``launch.dryrun``, ``launch.calibrate.analytic_bytes``), whose counted
half (``launch.calibrate.calibrated_cost``) refuses a larger mesh too.
"""
from __future__ import annotations

from repro_torch.tree import map_with_path

NOT_PORTED = ("sharding over more than one device is not ported yet: the specs applied "
              "across cards as DTensor placements come with ROADMAP queue 1 item 11 (a mesh's "
              "axis sizes are read without applying it by the dry run's analytic half: "
              "launch.dryrun's model_flops and input specs, launch.calibrate.analytic_bytes)")


def _mesh_size(mesh) -> int:
    """Devices of ``mesh``: torch's ``DeviceMesh`` (its ``.mesh`` tensor of
    ranks) or anything with a ``.devices`` array, as a JAX mesh has."""
    devices = mesh.mesh if hasattr(mesh, "mesh") else mesh.devices
    n = 1
    for d in devices.shape:
        n *= int(d)
    return n


def set_activation_axes(mesh) -> None:
    """Configure the logical activation axes for ``constrain``.  ``None`` or
    a one-device mesh sets none (``constrain`` stays the identity); a larger
    mesh raises ``NotImplementedError``."""
    if mesh is not None and _mesh_size(mesh) > 1:
        raise NotImplementedError(NOT_PORTED)


def constrain(x, tags):
    """The reference's ``with_sharding_constraint`` with logical tags ('dp',
    'tp', None) per dim.  No axis is ever set on one card, so it returns
    ``x`` itself, as the reference does with none set."""
    return x


def gather_weight(w, col_parallel: bool = True):
    """The reference's ZeRO-3-style use-time weight gathering (the weight
    constrained to its model-parallel dim only).  No model axis is ever set
    on one card, so it returns ``w`` itself, as the reference does with
    none set."""
    return w


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
    return dict(zip(mesh.axis_names, mesh.devices.shape))


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
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names) or None


def _model_axis(mesh):
    return "model" if "model" in mesh.axis_names else None


def make_param_shardings(params, mesh):
    """A tree of specs matching ``params`` (tensors, or anything with a
    ``shape``)."""
    fsdp, tp = _data_axes(mesh), _model_axis(mesh)
    return map_with_path(lambda path, x: param_spec(path, tuple(x.shape), mesh, fsdp, tp),
                         params)


def data_spec(mesh) -> tuple:
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
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
