"""Recurrent token-mixing layers: RWKV-6 (Finch) and RG-LRU (RecurrentGemma)
(counterpart of repro/models/recurrent.py).

Every projection goes through core/packed.linear_apply, so the packed GEMM
and GEMV kernels run them.  The recurrences themselves are plain PyTorch,
as the JAX package leaves them to XLA (no Pallas kernel computes them), and
keep its numerics rule for rule:

  * RWKV-6's matrix-valued state runs in the chunked linear-attention form:
    parallel within chunks of 16 (the last one zero-padded), a Python loop
    across chunks (S / 16 iterations a layer).  Decay ratios are taken in
    log space and each step's log-decay is clipped to [-20, 1.6] before the
    exp and floored at -5 after it, so exp(-cumsum) over a chunk stays in
    f32 range.  Decode is the O(1) recurrence.
  * RG-LRU's prefill is JAX's associative_scan over time, the same
    odd/even recursion (log2 S levels of whole-tensor ops, never a loop
    over time steps); decode is one step.
The states S and h are f32; the token-shift and conv states are in the
activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import packed
from repro_torch.core.encoding import Phase
from repro_torch.models.layers import norm_apply, norm_init

RWKV_CHUNK = 16
_LOG_DECAY_FLOOR = -5.0
_RGLRU_C = 8.0


def _normal(gen, shape, scale, device) -> torch.Tensor:
    return scale * torch.randn(shape, generator=gen, device=device)


# ---------------------------------------------------------------------------
# RWKV-6 time mix + channel mix


def rwkv_init(gen, cfg: ModelConfig, enc: packed.EncodingConfig, *, device) -> dict:
    """Random RWKV-6 block weights drawn from `gen` (the JAX package's
    shapes and scales; the port takes JAX's own weights through convert.py)."""
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.rwkv_head_dim
    h = d // hd
    lora = max(16, d // 32)
    kw = dict(enc=enc, dtype=cfg.activation_dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln1": norm_init(cfg, device=device),
        "ln2": norm_init(cfg, device=device),
        "mu": torch.full((5, d), 0.5, **f32),  # r, k, v, g, w token-shift mixes
        "w0": torch.zeros((d,), **f32),
        "w_lora_a": _normal(gen, (d, lora), 0.01, device),
        "w_lora_b": _normal(gen, (lora, d), 0.01, device),
        "u": _normal(gen, (h, hd), 0.1, device),  # the bonus
        "wr": packed.linear_init(gen, d, d, **kw),
        "wk": packed.linear_init(gen, d, d, **kw),
        "wv": packed.linear_init(gen, d, d, **kw),
        "wg": packed.linear_init(gen, d, d, **kw),
        "wo": packed.linear_init(gen, d, d, **kw),
        "cm_mu": torch.full((2, d), 0.5, **f32),  # channel-mix r, k
        "cm_wk": packed.linear_init(gen, d, f, **kw),
        "cm_wv": packed.linear_init(gen, f, d, **kw),
        "cm_wr": packed.linear_init(gen, d, d, **kw),
    }


def rwkv_state_init(cfg: ModelConfig, batch: int, *, device) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    dt = cfg.activation_dtype
    return {
        "S": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        "shift_tm": torch.zeros((batch, d), dtype=dt, device=device),
        "shift_cm": torch.zeros((batch, d), dtype=dt, device=device),
    }


def _token_shift(x: torch.Tensor, shift_state: torch.Tensor) -> torch.Tensor:
    """xs[t] = x[t-1]; xs[0] = shift_state."""
    return torch.cat([shift_state[:, None, :], x[:, :-1, :]], dim=1)


def _wkv_chunked(r, k, v, logw, u, state):
    """Chunked RWKV-6 core.

    r, k, v: (B, S, H, hd); logw: (B, S, H, hd) (<= 0, clamped); u: (H, hd);
    state: (B, H, hd, hd) with S[b, h, i, j] over (k-dim i, v-dim j).
    Returns (out (B, S, H, hd) f32, new_state)."""
    b, s, h, hd = r.shape
    c = min(RWKV_CHUNK, s)
    pad = (-s) % c
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw))
    nc = (s + pad) // c

    def chunks(a):  # (B, nc*c, H, hd) -> (nc, B, H, c, hd)
        return a.reshape(b, nc, c, h, hd).permute(1, 0, 3, 2, 4)

    rr, kk, vv = (chunks(a.float()) for a in (r, k, v))
    lw = chunks(logw)
    tri = torch.tril(torch.ones((c, c), dtype=torch.float32, device=r.device), diagonal=-1)
    ub = u[None, :, None, :]
    S = state.float()
    outs = []
    for i in range(nc):
        rc, kc, vc, lwc = rr[i], kk[i], vv[i], lw[i]  # (B, H, c, hd)
        lam = torch.cumsum(lwc, dim=2)            # inclusive cumulative log decay
        lam_prev = lam - lwc                      # exclusive (Λ_{t-1})
        lam_end = lam[:, :, -1:, :]               # Λ_c
        q_t = rc * torch.exp(lam_prev)            # r_t ⊙ Λ_{t-1}
        k_t = kc * torch.exp(-lam)                # k_i / Λ_i
        k_end = kc * torch.exp(lam_end - lam)     # k_i ⊙ Λ_c / Λ_i
        # Intra-chunk (strictly causal) + the diagonal bonus term.
        a = torch.einsum("bhtd,bhsd->bhts", q_t, k_t) * tri
        intra = torch.einsum("bhts,bhsv->bhtv", a, vc)
        diag = torch.einsum("bhtd,bhtd->bht", rc * ub, kc)
        intra = intra + diag[..., None] * vc
        # Inter-chunk: the carried state's contribution.
        inter = torch.einsum("bhtd,bhdv->bhtv", q_t, S)
        S = S * torch.exp(lam_end[:, :, 0, :])[..., None] + torch.einsum(
            "bhsd,bhsv->bhdv", k_end, vc)
        outs.append(intra + inter)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, nc * c, h, hd)
    return out[:, :s], S


def rwkv_apply(params: dict, x: torch.Tensor, *, cfg: ModelConfig, enc, phase: Phase,
               state: dict | None) -> tuple[torch.Tensor, dict]:
    """The RWKV-6 block: x += TM(norm1(x)); x += CM(norm2(x)).  Returns (out,
    new_state); `state` is not written.  The token-shift states track the
    normed sub-block inputs, so a decode continues a prefill exactly."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    if state is None:
        state = rwkv_state_init(cfg, b, device=x.device)

    # ---- time mix
    xn = norm_apply(params["ln1"], x, cfg)
    if phase is Phase.DECODE:
        xs = state["shift_tm"][:, None, :].to(xn.dtype).expand(xn.shape)
    else:
        xs = _token_shift(xn, state["shift_tm"].to(xn.dtype))
    xf = xn.float()
    dx = xs.float() - xf
    mu = params["mu"]
    mr, mk, mv, mg, mw = ((xf + dx * mu[i]).to(xn.dtype) for i in range(5))

    def proj(name, inp, n):
        return packed.linear_apply(params[name], inp, n=n, phase=phase, enc=enc)

    r = proj("wr", mr, d).reshape(b, s, h, hd)
    k = proj("wk", mk, d).reshape(b, s, h, hd)
    v = proj("wv", mv, d).reshape(b, s, h, hd)
    g = proj("wg", mg, d)
    # The data-dependent decay (RWKV-6's feature): w = exp(-exp(w0 + lora(mw))).
    lora = torch.tanh(mw.float() @ params["w_lora_a"]) @ params["w_lora_b"]
    log_neg = params["w0"] + lora
    logw = -torch.exp(torch.clamp(log_neg, -20.0, 1.6))
    logw = torch.clamp(logw, min=_LOG_DECAY_FLOOR).reshape(b, s, h, hd)

    if phase is Phase.DECODE:
        rf, kf, vf = (a.float()[:, 0] for a in (r, k, v))
        w1 = torch.exp(logw[:, 0])  # (B, H, hd)
        kv = torch.einsum("bhd,bhv->bhdv", kf, vf)
        out_t = torch.einsum("bhd,bhdv->bhv", rf,
                             state["S"] + params["u"][None, :, :, None] * kv)
        new_S = w1[..., None] * state["S"] + kv
        wkv = out_t[:, None]
    else:
        wkv, new_S = _wkv_chunked(r, k, v, logw, params["u"], state["S"])

    wkv = wkv.reshape(b, s, d).to(x.dtype)
    wkv = wkv * F.silu(g.float()).to(x.dtype)
    x = x + proj("wo", wkv, d)

    # ---- channel mix
    cn = norm_apply(params["ln2"], x, cfg)
    if phase is Phase.DECODE:
        cs = state["shift_cm"][:, None, :].to(cn.dtype).expand(cn.shape)
    else:
        cs = _token_shift(cn, state["shift_cm"].to(cn.dtype))
    cf = cn.float()
    dxc = cs.float() - cf
    cmu = params["cm_mu"]
    cr = (cf + dxc * cmu[0]).to(cn.dtype)
    ck = (cf + dxc * cmu[1]).to(cn.dtype)
    gate_r = torch.sigmoid(proj("cm_wr", cr, d).float())
    hidden = proj("cm_wk", ck, cfg.d_ff)
    hidden = torch.square(torch.relu(hidden.float())).to(cn.dtype)
    down = proj("cm_wv", hidden, d)
    out = x + (gate_r * down.float()).to(x.dtype)

    new_state = {
        "S": new_S,
        # Copies, so the state holds no view of the (B, S, D) activations.
        "shift_tm": xn[:, -1].to(state["shift_tm"].dtype).clone(),
        "shift_cm": cn[:, -1].to(state["shift_cm"].dtype).clone(),
    }
    return out, new_state


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)


def rglru_init(gen, cfg: ModelConfig, enc: packed.EncodingConfig, *, device) -> dict:
    d = cfg.d_model
    rw = cfg.rnn_width or d
    kw = dict(enc=enc, dtype=cfg.activation_dtype, device=device)
    lam = torch.linspace(0.9, 0.999, rw, dtype=torch.float32, device=device)
    return {
        "w_in": packed.linear_init(gen, d, rw, **kw),
        "w_gate_branch": packed.linear_init(gen, d, rw, **kw),
        "conv_w": _normal(gen, (cfg.conv_width, rw), 0.1, device),
        "conv_b": torch.zeros((rw,), dtype=torch.float32, device=device),
        "w_a": packed.linear_init(gen, rw, rw, **kw),
        "w_x": packed.linear_init(gen, rw, rw, **kw),
        "lam": torch.log(torch.expm1(lam ** -0.5)),  # softplus^-1 proxy
        "w_out": packed.linear_init(gen, rw, d, **kw),
    }


def rglru_state_init(cfg: ModelConfig, batch: int, *, device) -> dict:
    rw = cfg.rnn_width or cfg.d_model
    return {
        "h": torch.zeros((batch, rw), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, rw), dtype=cfg.activation_dtype,
                            device=device),
    }


def _causal_conv1d(x, w, b, conv_state):
    """Depthwise causal conv.  x (B, S, C); w (W, C); state (B, W-1, C).
    Returns (out in x's dtype, new_state: the last W-1 inputs)."""
    width = w.shape[0]
    xx = torch.cat([conv_state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = xx[:, 0:s].float() * w[0]
    for i in range(1, width):
        out = out + xx[:, i:i + s].float() * w[i]
    out = out + b
    new_state = xx[:, -(width - 1):] if width > 1 else conv_state
    return out.to(x.dtype), new_state


def _combine(c1, c2):
    """The linear recurrence's monoid: (a1, b1) then (a2, b2)."""
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along axis 1: even[0], odd[0], even[1], ... (len(even) - len(odd) in {0, 1})."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1], *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of (a, b) pairs under _combine along axis 1, by
    jax.lax.associative_scan's recursion: combine adjacent pairs, scan the
    half-length sequence, fill the even positions from it, interleave.
    log2 S levels of whole-tensor ops."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_apply(params: dict, x: torch.Tensor, *, cfg: ModelConfig, enc, phase: Phase,
                state: dict | None) -> tuple[torch.Tensor, dict]:
    """The Griffin recurrent block: gate branch ⊙ (conv -> RG-LRU) -> out
    projection.  Returns (out, new_state); `state` is not written."""
    b, s, d = x.shape
    rw = cfg.rnn_width or d
    if state is None:
        state = rglru_state_init(cfg, b, device=x.device)

    def proj(name, inp, n):
        return packed.linear_apply(params[name], inp, n=n, phase=phase, enc=enc)

    gate = F.gelu(proj("w_gate_branch", x, rw).float(), approximate="tanh")
    xi = proj("w_in", x, rw)
    xi, conv_state = _causal_conv1d(xi, params["conv_w"], params["conv_b"], state["conv"])
    ra = torch.sigmoid(proj("w_a", xi, rw).float())
    ri = torch.sigmoid(proj("w_x", xi, rw).float())
    softplus = torch.logaddexp(params["lam"], torch.zeros_like(params["lam"]))  # jax.nn.softplus
    log_a = -_RGLRU_C * softplus * ra  # (B, S, rw), <= 0
    a = torch.exp(log_a)
    gated_x = ri * xi.float()
    bt = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gated_x

    if phase is Phase.DECODE:
        new_h = a[:, 0] * state["h"] + bt[:, 0]
        y = new_h[:, None, :]
    else:
        a_cum, b_cum = associative_scan(a, bt)
        y = b_cum + a_cum * state["h"][:, None, :]
        new_h = y[:, -1, :].clone()

    y = (y * gate).to(x.dtype)
    return proj("w_out", y, d), {"h": new_h, "conv": conv_state.clone()}
