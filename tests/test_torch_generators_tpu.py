"""The TPU side of the port's six generators against the reference's.

Each generator declares the reference's Pallas space (``tpu_candidate_specs``)
and ranks it on a ``TPUMachine`` (``tpu_rank_configs``).  The reference
traces its candidates from its Pallas builders with a tracer that patches
``pl.load`` and ``pl.store``, which jax 0.9.0 no longer has: the
``ref_tracer`` fixture gives it a test-only shim to patch (as
``tests/test_torch_frontend.py`` does) and clears every candidate cache it
fills.  Held here: the declared specs equal the traced ones at the smoke's
domains and at small and padded ones; every ranking equal bitwise, skipped
candidates and their reasons too; every config of each TPU space at the
smoke's domains taken by the port's tile choosers; and the smoke's "tpu
P1" phase at a small size on the CPU.
"""
import argparse
import dataclasses
import importlib

import pytest

torch = pytest.importorskip("torch")

from jax.experimental import pallas as pl  # noqa: E402

from repro.core import machines as ref_machines  # noqa: E402
from repro.core.engine import Explorer as RefExplorer  # noqa: E402
from repro.serve import schema as ref_schema  # noqa: E402
from repro_torch.core import machines  # noqa: E402
from repro_torch.core.engine import Explorer  # noqa: E402
from repro_torch.serve import schema  # noqa: E402

GENERATORS = ("stencil3d25", "lbm_d3q15", "jacobi2d", "transpose_pad", "matmul",
              "flash_attention")
#: what a sweep measures of itself, which two sweeps need not agree on
MEASURED = ("wall_time_s", "cache_stats", "metrics")


def _gen(name: str):
    return importlib.import_module(f"repro_torch.kernels.{name}.generator")


def _ref_gen(name: str):
    return importlib.import_module(f"repro.kernels.{name}.generator")


@pytest.fixture
def ref_tracer(monkeypatch):
    """The reference's tracer, runnable on jax 0.9.0 (a test-only shim for
    the ``pl.load`` / ``pl.store`` it patches); every candidate cache of its
    generators cleared after."""
    def load(ref, idx):
        return ref[idx]

    def store(ref, idx, val):
        ref[idx] = val

    monkeypatch.setattr(pl, "load", load, raising=False)
    monkeypatch.setattr(pl, "store", store, raising=False)
    yield
    for name in GENERATORS:
        _ref_gen(name)._candidates.cache_clear()


def _answer(obj, codec):
    """``codec.encode(obj)`` without the sweep's measurements of itself."""
    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items() if k not in MEASURED}
        if isinstance(node, list):
            return [strip(x) for x in node]
        return node
    return strip(codec.encode(obj))


# ==========================================================================
# the declared spaces against the traced ones
# ==========================================================================
DECLARED = [
    ("lbm_d3q15", ((256, 256, 256),), 8), ("lbm_d3q15", ((256, 256, 256),), 4),
    ("lbm_d3q15", ((4, 16, 8),), 4), ("lbm_d3q15", ((1, 64, 5),), 8),
    ("jacobi2d", ((4096, 4096),), 8), ("jacobi2d", ((4096, 4096),), 4),
    ("jacobi2d", ((32, 16),), 8), ("jacobi2d", ((48, 1),), 4), ("jacobi2d", ((1, 16),), 8),
    ("transpose_pad", ((8192, 8192),), 4), ("transpose_pad", ((20, 13),), 4),
    ("transpose_pad", ((7, 1000),), 8), ("transpose_pad", ((1, 1),), 2),
]


@pytest.mark.parametrize("name,shape,eb", DECLARED)
def test_declared_tpu_specs_equal_traced_reference(name, shape, eb, ref_tracer):
    gen, ref = _gen(name), _ref_gen(name)
    mine = list(gen.tpu_candidate_specs(*shape, eb))
    want = list(ref.candidate_specs(*shape, eb))
    assert [c for c, _ in mine] == [c for c, _ in want]
    assert schema.encode(mine) == ref_schema.encode(want)
    for (_, a), (_, b) in zip(mine, want):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    # memoised per shape: the same objects on a second call
    assert all(a is b for (_, a), (_, b) in zip(mine, gen.tpu_candidate_specs(*shape, eb)))
    assert len(mine) > 0


def test_declared_operand_counts_and_padding():
    """The LBM's 19 and 37 operands, Jacobi's six VPU element-ops a point
    (not the generator's 5 flops), the transpose on its padded operand."""
    from repro_torch.core.specs import stencil_2d5pt
    from repro_torch.kernels.jacobi2d.generator import tpu_candidate_specs as jac
    from repro_torch.kernels.lbm_d3q15.generator import tpu_candidate_specs as lbm
    from repro_torch.kernels.transpose_pad.generator import tpu_candidate_specs as tr

    replane, ytile = list(lbm((8, 32, 16), 8))[:2]
    assert len(replane[1].operands) == 19 and len(ytile[1].operands) == 37
    assert ytile[1].grid == (4, 8) and ytile[1].operands[-1].block_shape == (15, 1, 8, 16)
    top = dict((c.get("ty"), s) for c, s in jac((4096, 4096), 8))[2048]
    flops = stencil_2d5pt((4096, 4096), 8).flops_per_point
    assert top.vpu_elems_per_step == 50331648 == 6 * 2048 * 4096 != flops * 2048 * 4096
    assert top.grid == (2,) and [o.block_shape for o in top.operands] == [
        (2048, 4098), (2048, 4098), (2048, 4096)]
    [(cfg, spec)] = list(tr((7, 1000), 4))
    assert cfg == {"bm": 8, "bn": 8} and spec.grid == (1, 125)
    assert spec.vpu_elems_per_step == 0.0 and spec.work_per_step == 64.0


# ==========================================================================
# the rankings against the reference's, bitwise
# ==========================================================================
RANKED = [
    ("stencil3d25", (4, (512, 512, 640)), 8), ("stencil3d25", (2, (16, 64, 128)), 4),
    ("stencil3d25", (4, (512, 2048, 2048)), 8),
    ("lbm_d3q15", ((256, 256, 256),), 8), ("lbm_d3q15", ((8, 32, 16),), 4),
    ("lbm_d3q15", ((64, 1024, 1024),), 8),
    ("jacobi2d", ((4096, 4096),), 8), ("jacobi2d", ((4096, 4096),), 4),
    ("jacobi2d", ((64, 48),), 8),
    ("transpose_pad", ((8192, 8192),), 4), ("transpose_pad", ((20, 13),), 8),
    ("matmul", (512, 1024, 2048), 2), ("matmul", (256, 512, 384), 4),
    ("flash_attention", (1, 8, 2, 1024, 1024, 64, True), 2),
    ("flash_attention", (2, 4, 4, 256, 512, 32, False), 4),
]


def _ref_rank(ref, name, args, eb):
    if name == "flash_attention":
        return ref.rank_configs(*args, machine=ref_machines.TPU_V5E, elem_bytes=eb)
    return ref.rank_configs(*args, ref_machines.TPU_V5E, eb)


def _rank(gen, name, args, eb):
    if name == "flash_attention":
        return gen.tpu_rank_configs(*args, machine=machines.TPU_V5E, elem_bytes=eb)
    return gen.tpu_rank_configs(*args, machines.TPU_V5E, eb)


def _cands(gen, ref, name, args, eb):
    if name == "flash_attention":
        *head, causal = args
        return (list(gen.tpu_candidate_specs(*head, causal, eb)),
                list(ref.candidate_specs(*head, causal, eb)))
    return list(gen.tpu_candidate_specs(*args, eb)), list(ref.candidate_specs(*args, eb))


@pytest.mark.parametrize("name,args,eb", RANKED)
def test_tpu_rank_configs_equal_reference_bitwise(name, args, eb, ref_tracer):
    gen, ref = _gen(name), _ref_gen(name)
    mine, want = _rank(gen, name, args, eb), _ref_rank(ref, name, args, eb)
    assert [r.config for r in mine] == [r.config for r in want]
    for a, b in zip(mine, want):
        assert schema.encode(a.spec) == ref_schema.encode(b.spec)
        assert dataclasses.astuple(a.estimate) == dataclasses.astuple(b.estimate)
        assert schema.encode(a.estimate) == ref_schema.encode(b.estimate)
    # the candidates left out, and why: through each package's engine
    cands, ref_cands = _cands(gen, ref, name, args, eb)
    report = Explorer()._rank_pallas(cands, machines.TPU_V5E)
    ref_report = RefExplorer()._rank_pallas(ref_cands, ref_machines.TPU_V5E)
    assert _answer(report, schema) == _answer(ref_report, ref_schema)
    assert [(s.config, s.reason) for s in report.skipped] == [
        (s.config, s.reason) for s in ref_report.skipped]
    assert len(mine) + len(report.skipped) == len(cands)


def test_infeasible_stencil_candidates_skipped_with_vmem_reasons(ref_tracer):
    """The reference's engine case at (512, 2048, 2048) fp64: the ring's
    planes outgrow VMEM, and both engines say so in the same words."""
    from repro.kernels.stencil3d25.generator import candidate_specs
    from repro_torch.kernels.stencil3d25.generator import tpu_candidate_specs

    domain = (512, 2048, 2048)
    report = Explorer()._rank_pallas(list(tpu_candidate_specs(4, domain, 8)))
    ref_report = RefExplorer()._rank_pallas(list(candidate_specs(4, domain, 8)))
    skipped = [(s.config, s.reason) for s in report.skipped]
    assert skipped == [(s.config, s.reason) for s in ref_report.skipped]
    assert {"variant": "ring"} in [c for c, _ in skipped]
    assert all("VMEM" in reason for _, reason in skipped)
    assert report.entries and all(e.config not in [c for c, _ in skipped]
                                  for e in report.entries)


def test_smoke_tpu_winners_at_the_smoke_domains(ref_tracer):
    """The winners "tpu P1" runs, at the smoke's domains and dtypes."""
    import chip_smoke

    want = {("stencil", 8): {"variant": "ring"}, ("lbm", 8): {"variant": "replane"},
            ("jacobi", 8): {"variant": "ytile", "ty": 512},
            ("jacobi", 4): {"variant": "ytile", "ty": 1024},
            ("transpose", 4): {"bm": 512, "bn": 512}}
    shapes = {"stencil": ("stencil3d25", (chip_smoke.R, chip_smoke.DOMAIN)),
              "lbm": ("lbm_d3q15", (chip_smoke.LBM_DOMAIN,)),
              "jacobi": ("jacobi2d", (chip_smoke.JACOBI_DOMAIN,)),
              "transpose": ("transpose_pad", (chip_smoke.TRANSPOSE_SHAPE,))}
    assert set(chip_smoke.TPU_P1) == set(want)
    for (path, eb), cfg in want.items():
        name, args = shapes[path]
        assert _rank(_gen(name), name, args, eb)[0].config == cfg
        assert _ref_rank(_ref_gen(name), name, args, eb)[0].config == cfg


# ==========================================================================
# the port's entry points take every config of the TPU spaces
# ==========================================================================
SMOKE_SPACES = [("stencil", 8), ("stencil", 4), ("lbm", 8), ("lbm", 4), ("jacobi", 8),
                ("jacobi", 4), ("transpose", 4), ("transpose", 8)]


@pytest.mark.parametrize("path,eb", SMOKE_SPACES)
def test_tile_choosers_take_every_tpu_config_at_the_smoke_domains(path, eb):
    """Each config of the reference's TPU space at the smoke's domains is one
    the port's entry point runs: the stencil's through ``zmarch_tile`` (or
    the ranked launch), the LBM's y-tiles through ``ytile_tile`` and their
    ring stages, Jacobi's y-tiles through ``ytile_tile`` and its ring plan,
    the transpose's tiles through ``transpose_tiled``'s grid checks."""
    import chip_smoke
    from repro_torch.kernels import SMEM_PER_BLOCK
    from repro_torch.kernels.jacobi2d import kernel as JK
    from repro_torch.kernels.lbm_d3q15 import kernel as LK
    from repro_torch.kernels.stencil3d25.ops import zmarch_tile
    from repro_torch.kernels.transpose_pad import kernel as TK

    if path == "stencil":
        cfgs = list(_gen("stencil3d25").tpu_space(chip_smoke.R, chip_smoke.DOMAIN))
        for cfg in cfgs[1:]:
            ty, tx = zmarch_tile(cfg, chip_smoke.R, chip_smoke.DOMAIN, eb)
            assert ty == (cfg.get("ty") or ty) and tx >= 1
        assert cfgs[0] == {"variant": "replane"}
    elif path == "lbm":
        cfgs = list(_gen("lbm_d3q15").tpu_space(chip_smoke.LBM_DOMAIN))
        X = chip_smoke.LBM_DOMAIN[2]
        for cfg in cfgs[1:]:
            ty, tx = LK.ytile_tile(cfg["ty"], eb)
            route = LK.ytile_route(ty, tx, X + 2, eb)
            assert LK.ytile_smem_bytes(ty, tx, eb, LK.ytile_stages(ty, tx, eb, route),
                                       route) <= SMEM_PER_BLOCK
        assert cfgs[0] == {"variant": "replane"} and len(cfgs) == 6
    elif path == "jacobi":
        cfgs = list(_gen("jacobi2d").tpu_space(chip_smoke.JACOBI_DOMAIN))
        X = chip_smoke.JACOBI_DOMAIN[1]
        for cfg in cfgs[1:]:
            ty, tx = JK.ytile_tile(cfg["ty"], eb)
            sx = JK.ytile_strip(tx)
            rows, stages = JK.ytile_plan(ty, sx, eb, X + 2)
            assert JK.YTILE_MIN_STAGES <= stages <= JK.YTILE_MAX_STAGES
            assert JK.ytile_ring_bytes(rows, sx, eb, stages, X + 2) <= SMEM_PER_BLOCK
        assert cfgs[0] == {"variant": "rowstream"} and len(cfgs) == 10
    else:
        M, N = chip_smoke.TRANSPOSE_SHAPE
        cfgs = list(_gen("transpose_pad").tile_space(chip_smoke.TRANSPOSE_SHAPE))
        for cfg in cfgs:
            assert 1 <= -(-M // cfg["bm"]) <= TK._GRID_YZ_MAX
        assert len(cfgs) == 49


@pytest.mark.parametrize("path", ["stencil", "lbm", "jacobi", "transpose"])
def test_entry_points_run_every_tpu_config_on_the_cpu(path):
    """The entry points at every config of the TPU space of a small domain,
    each equal to the plain version (the CPU runs it)."""
    from repro_torch.kernels.jacobi2d.ops import jacobi_step
    from repro_torch.kernels.jacobi2d.ref import jacobi_padded_ref
    from repro_torch.kernels.jacobi2d.ref import pad_input as jacobi_pad
    from repro_torch.kernels.lbm_d3q15.ops import lbm_step
    from repro_torch.kernels.lbm_d3q15.ref import lbm_step_ref, pad_inputs
    from repro_torch.kernels.stencil3d25.ops import star_stencil
    from repro_torch.kernels.stencil3d25.ref import pad_input, star_stencil_ref, star_weights
    from repro_torch.kernels.transpose_pad.ops import transpose

    g = torch.Generator().manual_seed(0)
    if path == "stencil":
        domain = (6, 32, 40)
        src = torch.randn(domain, dtype=torch.float64, generator=g)
        w = star_weights(4, torch.float64)
        want = star_stencil_ref(pad_input(src, 4), w, 4)
        for cfg in _gen("stencil3d25").tpu_space(4, domain):
            assert torch.equal(star_stencil(src, w, r=4, config=cfg), want), cfg
    elif path == "lbm":
        domain = (4, 32, 12)
        phase = torch.sigmoid(torch.randn(domain, dtype=torch.float64, generator=g))
        pdf = torch.rand((15, *domain), dtype=torch.float64, generator=g)
        want = lbm_step_ref(*pad_inputs(pdf, phase))
        for cfg in _gen("lbm_d3q15").tpu_space(domain):
            got = lbm_step(pdf, phase, config=cfg)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), cfg
    elif path == "jacobi":
        domain = (64, 24)
        src = torch.randn(domain, dtype=torch.float32, generator=g)
        want = jacobi_padded_ref(jacobi_pad(src))
        for cfg in _gen("jacobi2d").tpu_space(domain):
            assert torch.equal(jacobi_step(src, config=cfg), want), cfg
    else:
        x = torch.randn((20, 13), dtype=torch.float32, generator=g)
        for cfg in _gen("transpose_pad").tile_space(tuple(x.shape)):
            assert torch.equal(transpose(x, cfg), x.mT.contiguous()), cfg


# ==========================================================================
# the smoke's "tpu P1" phase, small, on the CPU
# ==========================================================================
def _count(monkeypatch, kernel_module, ops_module, name, last=None):
    """Wrap ``kernel_module.name`` (and the name ``ops_module`` imported) so
    that a call on the CPU counts a launch, as the card's wrapper does, and
    fills ``last`` as the card's wrapper fills its ``LAST_*`` record."""
    plain = getattr(kernel_module, name)

    def counted(*args, **kwargs):
        out = plain(*args, **kwargs)
        kernel_module.LAUNCHES[name] += 1
        if last is not None:
            last[0].update(last[1](*args))
        return out

    monkeypatch.setattr(kernel_module, name, counted)
    if ops_module is not None and hasattr(ops_module, name):
        monkeypatch.setattr(ops_module, name, counted)


def test_smoke_tpu_phase_runs_on_the_cpu_at_reduced_size(monkeypatch, capsys):
    import chip_smoke
    from repro_torch.kernels.jacobi2d import kernel as JK
    from repro_torch.kernels.jacobi2d import ops as JO
    from repro_torch.kernels.lbm_d3q15 import kernel as LK
    from repro_torch.kernels.lbm_d3q15 import ops as LO
    from repro_torch.kernels.stencil3d25 import kernel as K
    from repro_torch.kernels.stencil3d25 import ops as KO
    from repro_torch.kernels.transpose_pad import kernel as TK
    from repro_torch.kernels.transpose_pad import ops as TO

    monkeypatch.setattr(chip_smoke, "DOMAIN", (8, 32, 64))
    monkeypatch.setattr(chip_smoke, "LBM_DOMAIN", (8, 16, 16))
    monkeypatch.setattr(chip_smoke, "JACOBI_DOMAIN", (256, 128))
    monkeypatch.setattr(chip_smoke, "TRANSPOSE_SHAPE", (256, 128))
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda torch, fn, warmup=3, reps=20: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "the CPU")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    _count(monkeypatch, K, KO, "star_pointwise")
    _count(monkeypatch, K, KO, "star_zmarch",
           (K.LAST_ZMARCH, lambda src, w, r, ty, tx: {"route": "tma", "tile": (ty, tx)}))
    _count(monkeypatch, LK, LO, "lbm_pointwise")
    _count(monkeypatch, LK, LO, "lbm_ytile")
    _count(monkeypatch, JK, JO, "jacobi_pointwise")
    _count(monkeypatch, JK, JO, "jacobi_ytile", (JK.LAST_YTILE, lambda src, ty, tx, w: dict(
        route="tma", tile=(ty, tx), strip=tx, columns=2, rows=ty, stages=4, ring_bytes=0,
        threads=64, ctas=1)))
    _count(monkeypatch, TK, TO, "transpose_pointwise")
    _count(monkeypatch, TK, TO, "transpose_tiled")
    kernels = [{"name": "star_zmarch[ring,tma]", "config": {"variant": "ring"}},
               {"name": "lbm_pointwise", "config": None}]
    records = chip_smoke.run_tpu(argparse.Namespace(seed=0), torch, torch.device("cpu"), kernels)
    out = capsys.readouterr().out.splitlines()
    # the ring and the replane step are records of the path phases; the
    # y-tiles at the domain's winners and the 256 x 128 tile are new ones
    assert kernels[0]["tpu_config"] == {"variant": "ring"} and kernels[0]["tpu_launches"] == 1
    assert kernels[1]["tpu_config"] == {"variant": "replane"} and kernels[1]["tpu_launches"] == 1
    assert [r["name"] for r in records] == ["jacobi_ytile[ty=128]", "jacobi_ytile[fp32,ty=128]",
                                            "transpose_tiled[256x128]"]
    for r in records:
        assert {"name", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "tpu_launches", "tpu_ms",
                "tpu_predicted_ms", "tpu_h100_ms"} <= set(r)
        assert r["launches"] == r["tpu_launches"] == 1 and r["max_abs_err"] == 0.0
    assert sum(line.startswith("tpu P1 ") for line in out) == 2 * len(chip_smoke.TPU_P1) + 3
    assert out[-1].startswith("tpu P1: 5 rankings and runs in ")


def test_smoke_tpu_phase_fails_on_a_refused_config(monkeypatch):
    """A TPU winner the entry point refuses fails the phase, unrescued."""
    import chip_smoke
    from repro_torch.kernels.stencil3d25 import generator

    monkeypatch.setattr(chip_smoke, "DOMAIN", (8, 32, 64))
    monkeypatch.setattr(chip_smoke, "TPU_P1", (("stencil", 8),))
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "the CPU")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    real = generator.tpu_rank_configs

    def ranked(*args):
        out = real(*args)
        out[0] = dataclasses.replace(out[0], config={"variant": "ytile_ring", "ty": 24})
        return out

    monkeypatch.setattr(generator, "tpu_rank_configs", ranked)
    with pytest.raises(ValueError, match="ty must divide Y"):
        chip_smoke.run_tpu(argparse.Namespace(seed=0), torch, torch.device("cpu"), [])
