"""The port's copy of the GPU estimator path against ``repro.core``.

The copy must price exactly as the reference does: the H100 ranking of the
paper's 168 launches is compared bitwise, field by field, in two domains.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import machines as ref_machines
from repro.core.selector import rank_gpu_configs as ref_rank_gpu_configs
from repro.core.selector import ranking_quality as ref_ranking_quality
from repro.core.specs import lbm_d3q15 as ref_lbm_d3q15
from repro.core.specs import matmul_naive as ref_matmul_naive
from repro.core.specs import stencil_2d5pt as ref_stencil_2d5pt
from repro.core.specs import star_stencil_3d as ref_star_stencil_3d
from repro_torch.core import machines
from repro_torch.core.access import LaunchConfig
from repro_torch.core.gridwalk import block_points
from repro_torch.core.selector import (
    enumerate_gpu_configs,
    rank_gpu_configs,
    ranking_quality,
)
from repro_torch.core.specs import (
    lbm_d3q15,
    matmul_naive,
    star_stencil_3d,
    stencil_2d5pt,
    transpose_pad,
)

ROOT = Path(__file__).resolve().parents[1]
ESTIMATE_FIELDS = ("kernel", "machine", "lups", "l1_cycles_per_lup",
                   "l2_l1_load_per_lup", "l2_l1_store_per_lup",
                   "dram_load_per_lup", "dram_store_per_lup", "flops_per_lup",
                   "perf_lups", "limiter", "limiter_rates")


@functools.cache
def _port_ranking(r, domain):
    return rank_gpu_configs(star_stencil_3d(r, domain), machines.H100)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_spec_equal(mine, ref, n_accesses):
    assert (mine.name, mine.domain, mine.flops_per_point, mine.work_unit) == (
        ref.name, ref.domain, ref.flops_per_point, ref.work_unit)
    assert len(mine.accesses) == len(ref.accesses) == n_accesses
    for a, b in zip(mine.accesses, ref.accesses):
        assert (a.offsets, a.coeffs, a.dim_map, a.is_store) == (
            b.offsets, b.coeffs, b.dim_map, b.is_store)
        assert _fields(a.field) == _fields(b.field)


@pytest.mark.parametrize("r,domain,elem_bytes", [
    (1, (5, 16, 24), 4), (2, (24, 32, 64), 8), (4, (512, 512, 640), 8)])
def test_star_spec_equals_reference(r, domain, elem_bytes):
    _assert_spec_equal(star_stencil_3d(r, domain, elem_bytes),
                       ref_star_stencil_3d(r, domain, elem_bytes), 6 * r + 2)


@pytest.mark.parametrize("domain,elem_bytes", [
    ((3, 8, 16), 4), ((12, 20, 28), 8), ((256, 256, 256), 8)])
def test_lbm_spec_equals_reference(domain, elem_bytes):
    from repro.core.specs import D3Q7_OFFSETS, D3Q15_VELOCITIES

    from repro_torch.core import specs

    assert (specs.D3Q15_VELOCITIES, specs.D3Q7_OFFSETS) == (D3Q15_VELOCITIES, D3Q7_OFFSETS)
    # 15 pull loads and 15 stores, interleaved, then the 7 phase loads
    _assert_spec_equal(lbm_d3q15(domain, elem_bytes), ref_lbm_d3q15(domain, elem_bytes), 37)
    assert lbm_d3q15().domain == ref_lbm_d3q15().domain == (256, 256, 256)


@pytest.mark.parametrize("domain", [(4096, 4096), (16, 40)])
@pytest.mark.parametrize("elem_bytes", [4, 8])
def test_stencil_2d5pt_spec_equals_reference(domain, elem_bytes):
    _assert_spec_equal(stencil_2d5pt(domain, elem_bytes), ref_stencil_2d5pt(domain, elem_bytes), 6)
    assert stencil_2d5pt().domain == ref_stencil_2d5pt().domain == (4096, 4096)


def _traced_transpose_spec(monkeypatch, shape, elem_bytes):
    """The reference's transpose spec, which exists only as the GPU lowering
    of its traced Pallas kernel.  The tracer patches ``pl.load`` and
    ``pl.store``, which jax 0.9.0 no longer has: a test-only shim gives it
    something to patch (the tracer replaces both during the trace anyway)."""
    from jax.experimental import pallas

    from repro.kernels.transpose_pad.generator import traced_gpu_spec

    def load(ref, idx):
        return ref[idx]

    def store(ref, idx, val):
        ref[idx] = val

    monkeypatch.setattr(pallas, "load", load, raising=False)
    monkeypatch.setattr(pallas, "store", store, raising=False)
    try:
        return traced_gpu_spec(shape, elem_bytes)
    finally:
        traced_gpu_spec.cache_clear()  # no traced spec outlives the shim


@pytest.mark.parametrize("shape,elem_bytes", [((256, 512), 4), ((64, 96), 8)])
def test_transpose_spec_equals_traced_reference(monkeypatch, shape, elem_bytes):
    _assert_spec_equal(transpose_pad(shape, elem_bytes),
                       _traced_transpose_spec(monkeypatch, shape, elem_bytes), 2)


def test_transpose_spec_structure():
    """The structural assertions of the reference's
    ``test_gpu_lowering_transpose_dim_map``, on the port's spec."""
    spec = transpose_pad((256, 512), 4)
    assert spec.domain == (512, 256)        # out shape (N, M)
    load, store = spec.accesses
    assert not load.is_store and store.is_store
    assert load.dim_map == (1, 0)           # in[p1, p0]
    assert store.dim_map == (0, 1)
    assert (load.field.name, load.field.shape, store.field.name, store.field.shape) == (
        "x", (256, 512), "xt", (512, 256))
    assert spec.flops_per_point == 0.0


@pytest.mark.parametrize("M,K,N,elem_bytes", [
    (16384, 2048, 3072, 2), (16384, 8192, 2048, 2), (200, 96, 136, 4), (64, 48, 40, 2)])
def test_matmul_naive_spec_equals_reference(M, K, N, elem_bytes):
    _assert_spec_equal(matmul_naive(M, K, N, elem_bytes), ref_matmul_naive(M, K, N, elem_bytes), 3)
    assert matmul_naive(8, 8, 8, name="x").name == ref_matmul_naive(8, 8, 8, name="x").name


@pytest.mark.parametrize("M,K,N", [(16384, 2048, 3072), (200, 96, 136), (64, 48, 40)])
def test_matmul_naive_h100_price_at_suite_blocks_bitwise_equals_reference(M, K, N):
    """The suite's GPU price of a GEMM: every field of ``estimate_gpu`` at
    the eight ``SUITE_GPU_BLOCKS``, the granite-3-2b qkv GEMM included."""
    from repro.core.perfmodel import estimate_gpu as ref_estimate_gpu
    from repro.suite.lowering import suite_gpu_configs as ref_suite_gpu_configs

    from repro_torch.core.perfmodel import estimate_gpu
    from repro_torch.kernels.matmul.generator import suite_gpu_configs, suite_price

    ref_spec = ref_matmul_naive(M, K, N, 2)
    ranked = {rc.launch.block: rc for rc in suite_price(M, K, N, 2, machines.H100)}
    for mine_cfg, ref_cfg in zip(suite_gpu_configs(), ref_suite_gpu_configs(), strict=True):
        mine = estimate_gpu(matmul_naive(M, K, N, 2), mine_cfg, machines.H100)
        ref = ref_estimate_gpu(ref_spec, ref_cfg, ref_machines.H100)
        for name in ESTIMATE_FIELDS:
            assert getattr(mine, name) == getattr(ref, name), (ref_cfg.block, name)
        assert _fields(mine.dram_breakdown) == _fields(ref.dram_breakdown)
        assert _fields(mine.l2_breakdown) == _fields(ref.l2_breakdown)
        assert ranked[mine_cfg.block].perf == ref.perf_lups


def test_from_numpy_carries_jax_bf16_bit_exactly():
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro_torch.convert import from_numpy

    x = jax.random.normal(jax.random.PRNGKey(0), (5, 7), dtype=jnp.float32) * 1e3
    special = jnp.asarray([0.0, -0.0, jnp.inf, -jnp.inf, jnp.nan, 1e-40, 3.0e38])
    for arr in (x.astype(jnp.bfloat16), special.astype(jnp.bfloat16)):
        host = np.asarray(arr)
        assert host.dtype.name == "bfloat16"
        got = from_numpy({"w": host, "s": host[1]}, "cpu")
        assert got["w"].dtype == torch.bfloat16 and tuple(got["w"].shape) == host.shape
        bits = got["w"].view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(bits, host.view(np.uint16))
        assert got["s"].dtype == torch.bfloat16 and got["s"].shape == host[1].shape
        # and back: the same bits come out as the JAX array's values
        back = jnp.asarray(got["w"].float().numpy()).astype(jnp.bfloat16)
        np.testing.assert_array_equal(np.asarray(back).view(np.uint16), host.view(np.uint16))
    assert from_numpy(np.float32(2.5), "cpu").dtype == torch.float32


@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x7b", "rwkv6-1.6b", "zamba2-2.7b",
                                  "whisper-base", "internvl2-76b"])
def test_lm_params_from_numpy_carries_bf16_and_checks_every_block(arch):
    """``convert.lm_params_from_numpy`` carries ``repro.models.lm``'s tree
    (bf16 bit for bit, the stacked layout leaf for leaf) and raises on an
    unknown or a missing key, at the top and inside each block."""
    torch = pytest.importorskip("torch")
    import jax

    from repro.configs import get_config as jget
    from repro.models.lm import init_params
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy

    cfg = get_config(arch).reduced()
    want = jax.tree.map(np.asarray, init_params(jget(arch).reduced(), jax.random.PRNGKey(0)))
    got = lm_params_from_numpy(cfg, want, "cpu")
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    for path, w in flat_w:
        t = got
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == w.shape
        if w.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          w.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), w)
    block = "layers"
    inner = next(iter(want[block]))
    cases = [({**want, "extra": want["embed"]}, "unknown \\['extra'\\]"),
             ({k: v for k, v in want.items() if k != "lm_head"}, "missing \\['lm_head'\\]"),
             ({**want, block: {**want[block], "bogus": {}}}, "unknown \\['bogus'\\]"),
             ({**want, block: {k: v for k, v in want[block].items() if k != inner}},
              f"missing \\['{inner}'\\]"),
             ({**want, block: {**want[block], inner: {**want[block][inner], "w_x": np.zeros(1)}}},
              f"layers.{inner}: .*unknown \\['w_x'\\]")]
    for bad, match in cases:
        with pytest.raises(KeyError, match=match):
            lm_params_from_numpy(cfg, bad, "cpu")


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-1.6b", "zamba2-2.7b"])
def test_lm_caches_from_numpy_carries_the_stacked_caches(arch):
    """``convert.lm_caches_from_numpy`` carries ``repro.models.lm``'s stacked
    ``{"kv"}``, ``{"rwkv"}`` and ``{"mamba", "shared_kv"}`` trees after a
    prefill (bf16 and int32 bit for bit, the int8 cache too) and raises on
    an unknown or a missing key."""
    torch = pytest.importorskip("torch")
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models.lm import init_params
    from repro.train.step import make_prefill_step
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_caches_from_numpy

    for int8 in (False, True):
        jcfg = dataclasses.replace(jget(arch).reduced(), kv_int8=int8)
        cfg = dataclasses.replace(get_config(arch).reduced(), kv_int8=int8)
        tokens = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab, (2, 5)), jnp.int32)
        _, want, _ = make_prefill_step(jcfg, 8)(init_params(jcfg, jax.random.PRNGKey(0)), tokens)
        want = jax.tree.map(np.asarray, want)
        got = lm_caches_from_numpy(cfg, want, "cpu")
        flat_w = jax.tree.leaves(want)
        flat_g = [t for t in jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))]
        assert len(flat_g) == len(flat_w) and set(got) == set(want)
        for t, w in zip(flat_g, flat_w, strict=True):
            assert tuple(t.shape) == w.shape
            if w.dtype.name == "bfloat16":
                np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                              w.view(np.uint16))
            else:
                assert str(t.dtype).split(".")[1] == w.dtype.name
                np.testing.assert_array_equal(t.numpy(), w)
    with pytest.raises(KeyError, match="unknown \\['extra'\\]"):
        lm_caches_from_numpy(cfg, {**want, "extra": None}, "cpu")
    with pytest.raises(KeyError, match="missing"):
        lm_caches_from_numpy(cfg, {}, "cpu")


@pytest.mark.parametrize("name", ["V100", "A100", "A100_80G", "H100"])
def test_machine_parameters_equal_reference(name):
    assert _fields(getattr(machines, name)) == _fields(getattr(ref_machines, name))


@pytest.mark.parametrize("r,domain", [(2, (24, 32, 64)), (4, (64, 128, 128))])
def test_h100_ranking_bitwise_equals_reference(r, domain):
    _assert_ranking_equal(_port_ranking(r, domain),
                          ref_rank_gpu_configs(ref_star_stencil_3d(r, domain), ref_machines.H100))


def _assert_ranking_equal(mine, ref):
    assert len(mine) == len(ref) == 168
    assert mine.skipped == [] and list(ref.skipped) == []
    for m, f in zip(mine, ref):
        assert (m.launch.block, m.launch.folding) == (f.launch.block, f.launch.folding)
        assert m.perf == f.perf
        for name in ESTIMATE_FIELDS:
            assert getattr(m.estimate, name) == getattr(f.estimate, name), name
        assert _fields(m.estimate.dram_breakdown) == _fields(f.estimate.dram_breakdown)
        assert _fields(m.estimate.l2_breakdown) == _fields(f.estimate.l2_breakdown)


@pytest.mark.parametrize("domain", [(12, 20, 28), (24, 48, 64)])
def test_lbm_h100_ranking_bitwise_equals_reference(domain):
    _assert_ranking_equal(rank_gpu_configs(lbm_d3q15(domain), machines.H100),
                          ref_rank_gpu_configs(ref_lbm_d3q15(domain), ref_machines.H100))


@pytest.mark.parametrize("domain", [(64, 128), (40, 200)])
def test_jacobi_h100_ranking_bitwise_equals_reference(domain):
    _assert_ranking_equal(rank_gpu_configs(stencil_2d5pt(domain), machines.H100),
                          ref_rank_gpu_configs(ref_stencil_2d5pt(domain), ref_machines.H100))


@pytest.mark.parametrize("shape", [(256, 512), (96, 160)])
def test_transpose_h100_ranking_bitwise_equals_reference(monkeypatch, shape):
    _assert_ranking_equal(rank_gpu_configs(transpose_pad(shape), machines.H100),
                          ref_rank_gpu_configs(_traced_transpose_spec(monkeypatch, shape, 4),
                                               ref_machines.H100))


def test_ranking_breaks_ties_toward_enumeration_order():
    ranked = _port_ranking(2, (24, 32, 64))
    assert any(a.perf == b.perf for a, b in zip(ranked, ranked[1:]))
    order = {(c.block, c.folding): i for i, c in enumerate(enumerate_gpu_configs())}
    for a, b in zip(ranked, ranked[1:]):
        assert a.perf >= b.perf
        if a.perf == b.perf:
            assert order[(a.launch.block, a.launch.folding)] < order[
                (b.launch.block, b.launch.folding)]


def test_unpriceable_launch_is_skipped_with_reason():
    spec = star_stencil_3d(1, (4, 8, 8))
    bad = LaunchConfig(block=(0, 1, 1))
    ranked = rank_gpu_configs(spec, machines.H100, configs=[bad, LaunchConfig((8, 8, 1))])
    assert len(ranked) == 1 and len(ranked.skipped) == 1
    assert ranked.skipped[0].config == bad and ranked.skipped[0].reason
    with pytest.raises(ZeroDivisionError):
        rank_gpu_configs(spec, machines.H100, configs=[bad], strict=True)


def test_ranking_quality_equals_reference():
    rng = np.random.default_rng(3)
    pred, meas = rng.random(40).tolist(), rng.random(40).tolist()
    assert ranking_quality(pred, meas) == ref_ranking_quality(pred, meas)
    assert ranking_quality([1, 2, 3], [1, 2, 3]) == {"efficiency": 1.0, "spearman": 1.0}


def test_every_launch_covers_the_domain_exactly_once():
    domain = (5, 16, 24)
    for launch in enumerate_gpu_configs():
        hits = np.zeros(domain, dtype=np.int64)
        gx, gy, gz = launch.grid_for(domain)
        for bz in range(gz):
            for by in range(gy):
                for bx in range(gx):
                    pts = block_points(launch, domain, (bx, by, bz))
                    np.add.at(hits, (pts[:, 0], pts[:, 1], pts[:, 2]), 1)
        assert (hits == 1).all(), launch


@pytest.mark.parametrize("domain", [(13, 37), (40, 24)])
def test_every_launch_covers_the_2d_domain_exactly_once(domain):
    """A 2D domain reads as (1, Y, X): one block in z, and a launch with
    bz > 1 gives points only to its tz = 0 threads; every point is still
    covered exactly once (the Jacobi and transpose kernels' map)."""
    for launch in enumerate_gpu_configs():
        hits = np.zeros((1, *domain), dtype=np.int64)
        gx, gy, gz = launch.grid_for(domain)
        assert gz == 1
        for bz in range(gz):
            for by in range(gy):
                for bx in range(gx):
                    pts = block_points(launch, domain, (bx, by, bz))
                    np.add.at(hits, (pts[:, 0], pts[:, 1], pts[:, 2]), 1)
        assert (hits == 1).all(), launch


def test_port_imports_no_jax_and_nothing_of_repro():
    """Every repro_torch module and chip_smoke.py, imported in a fresh
    interpreter, load neither jax nor any module of the JAX package; their
    sources hold no such import statement either."""
    pytest.importorskip("torch")
    code = r"""
import ast, importlib, json, pkgutil, runpy, sys
from pathlib import Path
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
runpy.run_path("chip_smoke.py", run_name="chip_smoke_imported")
files = [Path("chip_smoke.py"), *Path("src/repro_torch").rglob("*.py")]
imported = set()
for f in files:
    for node in ast.walk(ast.parse(f.read_text())):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.add(node.module)
print(json.dumps({"modules": names, "loaded": sorted(sys.modules),
                  "imported": sorted(imported)}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch.kernels.stencil3d25.ops" in out["modules"]
    assert "repro_torch.kernels.lbm_d3q15.ops" in out["modules"]
    assert "repro_torch.kernels.jacobi2d.ops" in out["modules"]
    assert "repro_torch.kernels.transpose_pad.ops" in out["modules"]
    assert "repro_torch.convert" in out["modules"]
    for name in ("kernels.matmul.ops", "kernels.matmul.generator",
                 "kernels.flash_attention.ops", "kernels.flash_attention.generator",
                 "layers.attention", "layers.rope", "layers.shapes", "layers.norms",
                 "layers.mlp", "layers.moe", "layers.ssm", "models.lm", "train.sharding",
                 "train.step", "launch.serve",
                 "configs.base", "configs.granite3_2b", "serve.scheduler",
                 "serve.daemon", "serve.client", "serve.__main__"):
        assert f"repro_torch.{name}" in out["modules"]

    def foreign(name):
        return name.split(".")[0] in ("jax", "jaxlib", "repro")

    assert [m for m in out["loaded"] if foreign(m)] == []
    assert [m for m in out["imported"] if foreign(m)] == []


def test_pricing_daemon_imports_no_torch():
    """The daemon, its client and ``python -m repro_torch.serve``'s module,
    imported in a fresh interpreter, load no torch: they price and never
    touch a tensor, as the reference's daemon loads no jax.  The GEMM's
    tiles reach the suite from ``kernels.matmul.tiles``, and
    ``repro_torch.kernels`` imports torch only when a function needs it."""
    torch = pytest.importorskip("torch")
    code = r"""
import json, sys
import repro_torch.serve.daemon, repro_torch.serve.client, repro_torch.serve.__main__
import repro_torch.kernels.matmul.generator, repro_torch.layers
print(json.dumps({"torch": sorted(m for m in sys.modules if m.split(".")[0] == "torch")}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"torch": []}
    from repro_torch import kernels
    from repro_torch.kernels.matmul import kernel, tiles

    assert kernel.TILES is tiles.TILES and kernel.vector_width is tiles.vector_width
    assert [kernels.dtype_for(n) for n in (1, 2, 4, 8)] == [
        torch.int8, torch.bfloat16, torch.float32, torch.float64]
