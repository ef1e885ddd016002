"""The port's serving path: the reference's own serving checks run on
``repro_torch.models.lm`` and ``repro_torch.train.step``, and the
continuous-batching loop of ``repro_torch.launch.serve`` and
``examples/torch_serve_lm.py`` on the CPU at reduced configs.

The reference's checks (``tests/test_models_smoke.py:62-106``,
``tests/test_optimizations.py:40-53,85-93``) keep their sizes and
tolerances; their weights come from the reference's ``init_params(cfg,
PRNGKey(0))``, carried across by ``convert.lm_params_from_numpy``, and
their tokens and frontend embeddings from numpy.  The loop's logits, with
fp32 parameters over its bf16 caches, are held to a teacher-forced
``forward`` without caches over each prompt and its generated tokens, at
4 x 2^-9 of a row (L2): each of two layers reads K and V rounded to bf16.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve as launch
from repro_torch.models.lm import forward, init_caches
from repro_torch.train.step import make_decode_step, make_prefill_step

ROOT = Path(__file__).resolve().parents[1]
# the cached steps read K and V rounded to bf16 (up to 2^-9 of each value),
# the uncached forward reads them in fp32: two layers, K and V, 4 x 2^-9
TEACHER_ROW_REL = 4 * 2.0 ** -9


@functools.lru_cache(maxsize=None)
def _params(arch: str, **changes):
    """(port cfg, port params carried from the reference's PRNGKey(0) draw)."""
    import jax

    from repro.configs import get_config as jget
    from repro.models.lm import init_params

    jcfg = dataclasses.replace(jget(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    np_params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0)))
    return cfg, convert.lm_params_from_numpy(cfg, np_params, "cpu")


def _tokens(cfg, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, shape))


def _row_rel(got, want) -> float:
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_smoke(arch):
    """``tests/test_models_smoke.py::test_serve_smoke`` on the port: a
    prefill of B 2 x 16 into caches of 64 slots and two greedy decode
    steps give finite logits of the padded vocab."""
    cfg, params = _params(arch)
    B, S, cap = 2, 16, 64
    tokens = _tokens(cfg, (B, S), 1)
    frontend = (torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32))
        if cfg.frontend else None)
    prefill, decode = make_prefill_step(cfg, cap), make_decode_step(cfg)
    with torch.inference_mode():
        logits, caches, enc = prefill(params, tokens, frontend)
        assert tuple(logits.shape) == (B, cfg.padded_vocab)
        assert torch.isfinite(logits).all()
        pos0 = S + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        for i in range(2):
            lg, caches = decode(params, tok, caches,
                                torch.full((B, 1), pos0 + i, dtype=torch.int32), enc)
            assert tuple(lg.shape) == (B, cfg.padded_vocab)
            assert torch.isfinite(lg).all()
            tok = lg.argmax(-1)[:, None].to(torch.int32)


def test_decode_consistency_with_prefill():
    """``tests/test_models_smoke.py::test_decode_consistency_with_prefill``
    on the port: granite's token-by-token decode through fp32 caches equals
    the teacher-forced forward (rtol = atol = 2e-2)."""
    cfg, params = _params("granite-3-2b")
    B, S = 1, 12
    tokens = _tokens(cfg, (B, S), 5)
    full_logits, _, _ = forward(cfg, params, tokens)
    caches = init_caches(cfg, B, 32, torch.float32, device="cpu")
    steps = []
    with torch.inference_mode():
        for t in range(S):
            lg, caches, _ = forward(cfg, params, tokens[:, t:t + 1],
                                    positions=torch.tensor([[t]], dtype=torch.int32),
                                    caches=caches)
            steps.append(lg[:, 0])
    got = torch.stack(steps, dim=1)
    np.testing.assert_allclose(got.numpy(), full_logits.detach().numpy(), rtol=2e-2, atol=2e-2)


def test_int8_serving_path_end_to_end():
    """``tests/test_optimizations.py::test_int8_serving_path_end_to_end`` on
    the port: the int8 cache's prefill logits are finite and close to the
    bf16 cache's (atol 0.15, rtol 0.05), and its storage is int8."""
    cfg, params = _params("granite-3-2b", kv_int8=True)
    B, S = 2, 12
    tokens = _tokens(cfg, (B, S), 1)
    with torch.inference_mode():
        logits, caches, _ = make_prefill_step(cfg, 32)(params, tokens)
        assert torch.isfinite(logits).all()
        assert caches["kv"].k.dtype == torch.int8 and caches["kv"].quantized
        cfg16 = dataclasses.replace(cfg, kv_int8=False)
        logits16, _, _ = make_prefill_step(cfg16, 32)(params, tokens)
    np.testing.assert_allclose(logits.numpy(), logits16.numpy(), atol=0.15, rtol=0.05)


def test_ring_window_cache_bounds_long_context():
    """``tests/test_optimizations.py::test_ring_window_cache_bounds_long_context``
    on the port: SWA archs cap the cache at the window."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(), swa_window=64)
    caches = init_caches(cfg, 1, 524288, device="cpu")
    assert caches["kv"].k.shape[3] == 64  # (L, B, H, C, D) -> C == window


def _teacher_forced(cfg, params, wave, frontend):
    """Each wave's logits at the prefill's last position and at every
    decode step, from ``forward`` without caches over the prompts and the
    generated tokens."""
    fed = torch.cat([wave.prompts, wave.tokens[:, :-1].long()], dim=1)
    with torch.inference_mode():
        logits, _, _ = forward(cfg, params, fed, frontend_embeds=frontend)
    off = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    S = wave.prompts.shape[1]
    return logits[:, off + S - 1:]


@pytest.mark.parametrize("arch", ["granite-3-2b", "internvl2-76b", "whisper-base",
                                  "rwkv6-1.6b", "zamba2-2.7b"])
def test_serve_loop_answers_every_request_once(arch, capsys):
    """``launch.serve.serve`` at B 2 over 5 requests: waves [0, 1], [2, 3]
    and [4] padded to [4, 4] as the reference pads them, every request
    answered once with gen_len greedy tokens, the reference's printed
    lines, request r's prompt from the generator seeded 100 + r, and every
    step's logits (prefill and decode, positions after a vision arch's
    patches) held to the teacher-forced forward without caches."""
    cfg, params = _params(arch, param_dtype="float32")
    gen = torch.Generator().manual_seed(7)
    res = launch.serve(cfg, params, batch=2, requests=5, prompt_len=6, gen_len=4,
                       generator=gen, device="cpu", keep_logits=True)
    assert sorted(res.outputs) == [0, 1, 2, 3, 4]
    assert all(len(v) == 4 for v in res.outputs.values())
    assert [w.ids for w in res.waves] == [[0, 1], [2, 3], [4, 4]]
    assert len(res.prefill_s) == 3 and len(res.decode_s) == 3 * 3
    assert res.total_s >= sum(res.prefill_s) + sum(res.decode_s)
    out = capsys.readouterr().out.splitlines()
    assert out[:3] == ["[serve] wave of 2 done (2/5)", "[serve] wave of 2 done (4/5)",
                       "[serve] wave of 1 done (5/5)"]
    assert out[3].startswith("[serve] 5 requests, ") and out[3].endswith(" tok/s, kv_int8=False")
    assert out[4] == f"[serve] sample output req0: {res.outputs[0]}"
    frontend = None
    if cfg.frontend:
        frontend = torch.randn((2, cfg.frontend_tokens, cfg.frontend_dim),
                               generator=torch.Generator().manual_seed(7))
    for w in res.waves:
        for j, r in enumerate(w.ids):
            assert torch.equal(w.prompts[j], launch.request_prompt(cfg, r, 6))
            if j < len(set(w.ids)):  # a padding row's frontend differs from its request's
                assert w.tokens[j].tolist() == res.outputs[r]
        got = torch.stack([w.prefill_logits, *w.decode_logits], dim=1)
        want = _teacher_forced(cfg, params, w, frontend)
        assert got.shape == want.shape == (2, 4, cfg.padded_vocab)
        assert _row_rel(got, want) <= TEACHER_ROW_REL
        assert torch.equal(w.tokens, got.argmax(-1).to(torch.int32))


def test_request_prompts_follow_the_reference_seeds():
    cfg = get_config("granite-3-2b").reduced()
    for r in (0, 3):
        want = torch.randint(0, cfg.vocab, (24,), generator=torch.Generator().manual_seed(100 + r))
        assert torch.equal(launch.request_prompt(cfg, r, 24), want)
    assert not torch.equal(launch.request_prompt(cfg, 0, 24), launch.request_prompt(cfg, 1, 24))


def test_serve_main_keeps_the_reference_flags(capsys):
    """``python -m repro_torch.launch.serve``'s ``main`` on ``--device cpu``:
    the reference's flags and lines; ``--reduced`` cannot be turned off
    (``store_true`` with ``default=True``), so the reduced config is served."""
    assert launch.main(["--device", "cpu", "--requests", "3", "--batch", "2",
                        "--prompt-len", "8", "--gen-len", "3", "--kv-int8"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[serve] wave of 2 done (2/3)" and out[1] == "[serve] wave of 1 done (3/3)"
    assert out[2].startswith("[serve] 3 requests, ") and out[2].endswith("kv_int8=True")
    sample = out[3].removeprefix("[serve] sample output req0: ")
    assert len(eval(sample)) == 3
    with pytest.raises(SystemExit):
        launch.main(["--no-reduced"])


def test_serve_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--requests", "1"])
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_serve_lm
    finally:
        sys.path.remove(str(ROOT / "examples"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_serve_lm.main([])


@pytest.mark.parametrize("argv", [[], ["--kv-int8"], ["--arch", "rwkv6-1.6b"],
                                  ["--arch", "whisper-base"]])
def test_serve_example_runs_on_the_cpu(argv, capsys):
    """``examples/torch_serve_lm.py`` (default mixtral-8x7b reduced) on
    ``--device cpu``: the reference's lines, gen_len tokens a sequence."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_serve_lm
    finally:
        sys.path.remove(str(ROOT / "examples"))
    assert torch_serve_lm.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                                "--gen-len", "4", *argv]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill 2x8 in ")
    assert out[0].endswith(f"(kv_int8={'--kv-int8' in argv})")
    assert out[1].startswith("decoded 4 tokens/seq in ") and "tok/s batch throughput" in out[1]
    assert [line.split(":")[0] for line in out[2:]] == ["  seq0", "  seq1"]
    assert all(len(eval(line.split(": ")[1])) == 4 for line in out[2:])


def test_smoke_lm_phase_runs_on_the_cpu_at_reduced_configs(monkeypatch, capsys):
    """``chip_smoke.run_lm`` end to end on the CPU at every config's reduced
    size (a prompt of 64, 8 tokens generated): every check it holds on the
    card holds on the CPU too, both wrong decode steps are rejected, the MoE is
    routed alike without drops, and no port kernel is launched."""
    import argparse

    import chip_smoke
    import repro_torch.configs

    real = repro_torch.configs.get_config
    monkeypatch.setattr(repro_torch.configs, "get_config", lambda arch: real(arch).reduced())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "LM_PROMPT", 64)
    monkeypatch.setattr(chip_smoke, "LM_GEN", 8)
    chip_smoke.run_lm(argparse.Namespace(seed=0), torch, torch.device("cpu"))
    out = capsys.readouterr().out
    assert "both rejected" in out and "launched none of the port's kernels" in out
    assert [line.split(":")[0].split(" ")[2] for line in out.splitlines()
            if line.startswith("lm M3")] == ["rwkv6-1.6b", "zamba2-2.7b", "whisper-base",
                                            "mixtral-8x7b,"]
    assert "route every token as the teacher-forced forward does" in out
