"""SSM and linear-attention blocks (a port of ``repro.layers.ssm``): Mamba2
(SSD) and RWKV6 (Finch), time mix and channel mix.

Both run in their chunked parallel forms: quadratic inside a chunk, linear
across chunks through an fp32 state that a Python loop over the chunks
carries (the reference's ``lax.scan``).  A single token with a state takes
the exact recurrence.  The chunk sizes are the lowering's
(``layers.shapes``), as in the reference.

Numerics (DESIGN §7): RWKV6's per-channel data-dependent decay is
factorised inside a chunk as r~ = r·exp(lc), k~ = k·exp(-lc), with each
step's log-decay clamped to at least ``LOG_DECAY_FLOOR`` so that exp(-lc)
stays bounded in fp32 (chunk 32: exp(11.2) at most).  Mamba2's per-head
scalar decay uses the exact segment-sum mask (at most 1), its log decay
clamped at -20.  The reference's calibration hooks (``CHUNK_OVERRIDE``,
``SCAN_UNROLL``) serve its launch calibration and are not ported.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import resolve_device

from . import _draw
from .shapes import MAMBA_CHUNK, RWKV_CHUNK

LOG_DECAY_FLOOR = -0.35


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================
def mamba2_init(d_model: int, d_state: int = 64, head_dim: int = 64, expand: int = 2,
                dtype=torch.bfloat16, *, generator: torch.Generator, device="cuda") -> dict:
    """The reference's parameters: w_in, w_out and conv_w drawn in fp32 from
    ``generator`` and cast to ``dtype``; A_log 0 and dt_bias -2 in fp32; a
    unit norm scale.  On the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    normal = functools.partial(_draw.normal, generator=generator, device=device)
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    return {
        "w_in": normal((d_model, 2 * d_inner + 2 * d_state + n_heads), d_model ** -0.5, dtype),
        "w_out": normal((d_inner, d_model), d_inner ** -0.5, dtype),
        "A_log": torch.zeros((n_heads,), dtype=torch.float32, device=device),
        "dt_bias": torch.full((n_heads,), -2.0, dtype=torch.float32, device=device),
        "conv_w": normal((4, d_inner), 0.5, dtype),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=device),
    }


class Mamba2State(NamedTuple):
    ssm: torch.Tensor    # (B, H, P, N) fp32
    conv: torch.Tensor   # (B, 3, d_inner) the last 3 pre-conv inputs


def _causal_conv(x, conv_w, conv_state=None):
    """Depthwise causal convolution of width 4.  x: (B, S, D); returns
    (silu(y), the last 3 inputs)."""
    B, S, D = x.shape
    if conv_state is None:
        xp = F.pad(x, (0, 0, 3, 0))
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i: i + S] * conv_w[i] for i in range(4))
    return F.silu(y.float()).to(x.dtype), xp[:, -3:]


def _segsum_exp(log_a):
    """exp(segment sums): L[t, s] = exp(sum_{i=s+1..t} log_a_i) for s <= t,
    else 0.  log_a: (..., L)."""
    L = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=log_a.device).tril()
    return torch.where(mask, torch.exp(diff), 0.0)


def mamba2_apply(params, x, state: Mamba2State | None = None, d_state: int = 64,
                 head_dim: int = 64, chunk: int = MAMBA_CHUNK):
    """x: (B, S, E) -> (y, new_state)."""
    B, S, E = x.shape
    d_inner = params["w_out"].shape[0]
    H = d_inner // head_dim
    N = d_state

    proj = torch.einsum("bse,ef->bsf", x, params["w_in"])
    xin, z, Bc, Cc, dt_raw = torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)
    conv_state = state.conv if state is not None else None
    xc, new_conv = _causal_conv(xin, params["conv_w"], conv_state)
    xh = xc.reshape(B, S, H, head_dim)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])                   # (B, S, H)
    A = -torch.exp(params["A_log"])                                       # (H,)
    log_a = torch.clamp(dt * A, min=-20.0)                                # (B, S, H)
    Bc = Bc.float()
    Cc = Cc.float()
    xdt = xh.float() * dt[..., None]                                      # (B, S, H, P)

    if S == 1 and state is not None:
        # the exact single-step recurrence
        a = torch.exp(log_a)[:, 0]                                        # (B, H)
        s_new = state.ssm * a[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", xdt[:, 0], Bc[:, 0])
        y = torch.einsum("bhpn,bn->bhp", s_new, Cc[:, 0]).reshape(B, 1, d_inner)
        new_state = Mamba2State(s_new, new_conv)
    else:
        pad = (-S) % chunk
        if pad:
            xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
            Bc = F.pad(Bc, (0, 0, 0, pad))
            Cc = F.pad(Cc, (0, 0, 0, pad))
            log_a = F.pad(log_a, (0, 0, 0, pad))
        nch = (S + pad) // chunk
        xdt_c = xdt.reshape(B, nch, chunk, H, head_dim).permute(1, 0, 3, 2, 4)
        B_c = Bc.reshape(B, nch, chunk, N).transpose(0, 1)
        C_c = Cc.reshape(B, nch, chunk, N).transpose(0, 1)
        la_c = log_a.reshape(B, nch, chunk, H).permute(1, 0, 3, 2)         # (n, B, H, L)

        s = (state.ssm if state is not None
             else torch.zeros((B, H, head_dim, N), dtype=torch.float32, device=x.device))
        ys = []
        for c in range(nch):
            xdt_b, Bb, Cb, lab = xdt_c[c], B_c[c], C_c[c], la_c[c]
            Lmat = _segsum_exp(lab)                                       # (B, H, L, L)
            att = torch.einsum("bln,bmn->blm", Cb, Bb)[:, None] * Lmat
            y_intra = torch.einsum("bhlm,bhmp->bhlp", att, xdt_b)
            cum = torch.cumsum(lab, dim=-1)                               # (B, H, L)
            y_inter = torch.einsum("bln,bhl,bhpn->bhlp", Cb, torch.exp(cum), s)
            decay_out = torch.exp(cum[..., -1:] - cum)                    # (B, H, L)
            s = s * torch.exp(cum[..., -1])[..., None, None] + torch.einsum(
                "bhl,bhlp,bln->bhpn", decay_out, xdt_b, Bb)
            ys.append(y_intra + y_inter)
        y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, nch * chunk, H * head_dim)[:, :S]
        new_state = Mamba2State(s, new_conv)

    # the gated RMSNorm output (Mamba2 style)
    yz = y.float() * F.silu(z.float())
    var = yz.square().mean(dim=-1, keepdim=True)
    yn = yz * (var + 1e-6) ** -0.5 * params["norm_scale"].float()
    out = torch.einsum("bsf,fe->bse", yn.to(x.dtype), params["w_out"])
    return out, new_state


# ===========================================================================
# RWKV6 (Finch): linear attention with a data-dependent decay
# ===========================================================================
def rwkv6_init(d_model: int, head_dim: int = 64, lora_rank: int = 64, dtype=torch.bfloat16,
               *, generator: torch.Generator, device="cuda") -> dict:
    """The reference's parameters: the five d_model² projections and the
    decay LoRA drawn in fp32 from ``generator`` and cast to ``dtype``, the
    decay base -1.5 and the bonus in fp32, the token-shift mixes uniform in
    [0, 1).  On the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    normal = functools.partial(_draw.normal, generator=generator, device=device)
    H = d_model // head_dim
    s = d_model ** -0.5
    p = {f"w_{n}": normal((d_model, d_model), s, dtype) for n in "rkvgo"}
    p["w_decay_a"] = normal((d_model, lora_rank), s, dtype)
    p["w_decay_b"] = normal((lora_rank, d_model), lora_rank ** -0.5, dtype)
    p["decay_base"] = torch.full((d_model,), -1.5, dtype=torch.float32, device=device)
    p["bonus_u"] = normal((H, head_dim), 0.1, torch.float32)
    p["mu"] = torch.rand((5, d_model), generator=generator, device=device,
                         dtype=torch.float32).to(dtype)
    return p


class RWKV6State(NamedTuple):
    wkv: torch.Tensor     # (B, H, K, V) fp32
    prev: torch.Tensor    # (B, E) the last token's input (token shift)


def _token_shift(x, prev):
    """x shifted one token later, ``prev`` (B, E) or zeros in front."""
    B, S, E = x.shape
    pv = prev[:, None].to(x.dtype) if prev is not None else x.new_zeros((B, 1, E))
    return torch.cat([pv, x[:, :-1]], dim=1)


def rwkv6_apply(params, x, state: RWKV6State | None = None, head_dim: int = 64,
                chunk: int = RWKV_CHUNK):
    """The time-mix block.  x: (B, S, E) -> (y, new_state)."""
    B, S, E = x.shape
    H = E // head_dim
    K = V = head_dim

    x_shift = _token_shift(x, state.prev if state is not None else None)
    mu = params["mu"]
    xr, xk, xv, xg, xw = (x + mu[i] * (x_shift - x) for i in range(5))

    r = torch.einsum("bse,ef->bsf", xr, params["w_r"]).reshape(B, S, H, K)
    k = torch.einsum("bse,ef->bsf", xk, params["w_k"]).reshape(B, S, H, K)
    v = torch.einsum("bse,ef->bsf", xv, params["w_v"]).reshape(B, S, H, V)
    g = F.silu(torch.einsum("bse,ef->bsf", xg, params["w_g"]).float())
    dd = torch.einsum("bsr,re->bse", torch.tanh(
        torch.einsum("bse,er->bsr", xw, params["w_decay_a"]).float()
    ).to(x.dtype), params["w_decay_b"])
    log_w = torch.clamp(-torch.exp(params["decay_base"] + dd.float()),
                        min=LOG_DECAY_FLOOR).reshape(B, S, H, K)   # per-channel log decay
    u = params["bonus_u"]                                          # (H, K)

    rf, kf, vf = r.float(), k.float(), v.float()
    s = (state.wkv if state is not None
         else torch.zeros((B, H, K, V), dtype=torch.float32, device=x.device))

    if S == 1 and state is not None:
        # the exact recurrence: out = r . (S_prev + u k (x) v); S = w S_prev + k (x) v
        wkv = s + torch.einsum("bhk,bhv->bhkv", u[None] * kf[:, 0], vf[:, 0])
        out_t = torch.einsum("bhk,bhkv->bhv", rf[:, 0], wkv)
        s = s * torch.exp(log_w[:, 0])[..., None] + torch.einsum(
            "bhk,bhv->bhkv", kf[:, 0], vf[:, 0])
        y = out_t.reshape(B, 1, E)
    else:
        pad = (-S) % chunk
        if pad:
            rf, kf, vf, log_w = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (rf, kf, vf, log_w))
        nch = (S + pad) // chunk

        def shp(t):
            return t.reshape(B, nch, chunk, H, K).permute(1, 0, 3, 2, 4)   # (n, B, H, L, K)

        r_c, k_c, v_c, lw_c = shp(rf), shp(kf), shp(vf), shp(log_w)
        mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril(-1)
        ys = []
        for c in range(nch):
            rb, kb, vb, lwb = r_c[c], k_c[c], v_c[c], lw_c[c]             # (B, H, L, K)
            lc = torch.cumsum(lwb, dim=2)                                 # inclusive
            lc_prev = lc - lwb                                            # up to t - 1
            r_t = rb * torch.exp(lc_prev)
            k_t = kb * torch.exp(-lc)
            scores = torch.einsum("bhtk,bhsk->bhts", r_t, k_t)
            y_intra = torch.einsum("bhts,bhsv->bhtv", torch.where(mask, scores, 0.0), vb)
            y_diag = torch.einsum("bhtk,bhtv->bhtv", rb * u[None, :, None, :] * kb, vb)
            y_inter = torch.einsum("bhtk,bhkv->bhtv", r_t, s)
            a_end = torch.exp(lc[:, :, -1])                               # (B, H, K)
            k_end = kb * torch.exp(lc[:, :, -1:] - lc)                    # decay from s to L
            s = s * a_end[..., None] + torch.einsum("bhsk,bhsv->bhkv", k_end, vb)
            ys.append(y_intra + y_diag + y_inter)
        y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, nch * chunk, E)[:, :S]

    y = (y.reshape(B, -1, E) * g).to(x.dtype)
    out = torch.einsum("bse,ef->bsf", y, params["w_o"])
    return out, RWKV6State(s, x[:, -1])


def rwkv6_channel_mix_init(d_model: int, d_ff: int, dtype=torch.bfloat16, *,
                           generator: torch.Generator, device="cuda") -> dict:
    """The RWKV FFN's key, value and receptance weights (fp32 draws cast to
    ``dtype``) and its two token-shift mixes, uniform in [0, 1); on the card
    unless the caller asks for the CPU."""
    device = resolve_device(device)
    normal = functools.partial(_draw.normal, generator=generator, device=device)
    s = d_model ** -0.5
    return {
        "w_k": normal((d_model, d_ff), s, dtype),
        "w_v": normal((d_ff, d_model), d_ff ** -0.5, dtype),
        "w_r": normal((d_model, d_model), s, dtype),
        "mu": torch.rand((2, d_model), generator=generator, device=device,
                         dtype=torch.float32).to(dtype),
    }


def rwkv6_channel_mix(params, x, prev=None):
    """The RWKV FFN (squared ReLU).  Returns (y, the last token's input)."""
    x_shift = _token_shift(x, prev)
    xk = x + params["mu"][0] * (x_shift - x)
    xr = x + params["mu"][1] * (x_shift - x)
    kh = torch.einsum("bse,ef->bsf", xk, params["w_k"])
    kh = torch.square(torch.relu(kh.float())).to(x.dtype)
    val = torch.einsum("bsf,fe->bse", kh, params["w_v"])
    rg = torch.sigmoid(torch.einsum("bse,ef->bsf", xr, params["w_r"]).float())
    return (rg * val.float()).to(x.dtype), x[:, -1]
