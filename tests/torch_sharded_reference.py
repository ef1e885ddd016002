"""The reference's train step on a (2, 2) ``data`` x ``model`` mesh of four
host devices (``Auto`` axes), for ``tests/test_torch_sharded_step.py``'s
MoE archs.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        python tests/torch_sharded_reference.py IN.npz OUT.npz NAME [NAME ...]

A name is an arch, or ``<arch>:<k>`` for its step in ``k`` microbatches.
``IN.npz`` holds, for each name, the port's fp32 weights, moments (step 3)
and batch as numpy (``<name>/p<i>``, ``<name>/m<i>``, ``<name>/v<i>`` in
the leaves' order, which is JAX's; ``<name>/batch/<key>``).  Each name's
weights, moments and batch are placed by ``repro.train.sharding``'s
shardings on ``jax.make_mesh((2, 2), ("data", "model"))`` with
``set_activation_axes(mesh)`` set, so the MoE routes in ``dp_size`` = 2
groups; then, in one microbatch, ``jax.value_and_grad`` of ``loss_fn``,
and one jitted train step.  ``OUT.npz`` gets ``<name>/{loss, grad_norm,
lr, step}`` and ``<name>/{param, m, v}<i>``, and in one microbatch
``<name>/value_loss`` and ``<name>/grad<i>``.
"""
from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np


def main(in_file: str, out_file: str, names: list) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models.lm import init_params
    from repro.optim.adamw import OptConfig, OptState
    from repro.train.sharding import (
        make_batch_shardings,
        make_param_shardings,
        set_activation_axes,
    )
    from repro.train.step import loss_fn, make_train_step

    opt_kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    data = np.load(in_file)
    # Auto axes, the sharding the reference was written for: jax 0.9's
    # make_mesh defaults to Explicit ones, under which the embedding gather
    # of tokens over 'data' from a table whose columns are over 'data'
    # is refused
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    set_activation_axes(mesh)
    out = {}
    for name in names:
        arch, _, k = name.partition(":")
        microbatches = int(k or 1)
        cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype="float32")
        tree = jax.eval_shape(lambda k: init_params(cfg, k), jax.random.PRNGKey(0))
        leaves, treedef = jax.tree.flatten(tree)
        n = len(leaves)

        def tree_of(kind):
            return jax.tree.unflatten(treedef, [jnp.asarray(data[f"{name}/{kind}{i}"])
                                                for i in range(n)])

        shard = make_param_shardings(tree, mesh)
        params = jax.device_put(tree_of("p"), shard)
        opt = OptState(jnp.asarray(3, jnp.int32), jax.device_put(tree_of("m"), shard),
                       jax.device_put(tree_of("v"), shard), None)
        batch = {k[len(f"{name}/batch/"):]: jnp.asarray(data[k]) for k in data.files
                 if k.startswith(f"{name}/batch/")}
        b_shard = make_batch_shardings(
            jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batch), mesh)
        batch = jax.tree.map(jax.device_put, batch, b_shard)
        trees = []
        with mesh:
            if microbatches == 1:
                loss, grads = jax.jit(jax.value_and_grad(functools.partial(loss_fn, cfg)))(
                    params, batch)
                out[f"{name}/value_loss"] = np.asarray(loss)
                trees.append(("grad", grads))
            step = jax.jit(make_train_step(cfg, OptConfig(**opt_kw), microbatches))
            new_p, new_opt, metrics = step(params, opt, batch)
        for key in ("loss", "grad_norm", "lr"):
            out[f"{name}/{key}"] = np.asarray(metrics[key])
        out[f"{name}/step"] = np.asarray(new_opt.step)
        for kind, t in trees + [("param", new_p), ("m", new_opt.m), ("v", new_opt.v)]:
            for i, x in enumerate(jax.tree.leaves(t)):
                out[f"{name}/{kind}{i}"] = np.asarray(x, np.float32)
    np.savez(out_file, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3:])
