"""Recurrent sequence-mixing blocks: xLSTM (mLSTM + sLSTM) and RG-LRU
(Griffin) — port of ``repro.models.recurrent``.

mLSTM runs the stabilized *chunkwise-parallel* form (a loop over chunks,
dense intra-chunk math) for prefill and a single-step state update for
decode.  sLSTM is sequential (recurrent weights): a loop over time.
RG-LRU's linear recurrence runs as a log-depth associative scan over the
sequence (the reference's ``associative_scan``).

Every decode path carries an explicit state dict, so a decode step is
O(1) in the context length.

With ``rules`` each mixer's recurrence runs on each rank's own rows with
whole weights (``sharding.local.batch_local_call``), and its output
projection under DTensor dispatch after the reference's constraint.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.modules import (_normal, dense_apply, dense_init,
                                        dense_specs)
from repro_torch.sharding import local as SL

F32 = torch.float32


def _log_sigmoid(x):
    """log sigmoid(x) as the reference writes it: -softplus(-x)."""
    return -F.softplus(-x)


# =====================================================================
# mLSTM
# =====================================================================

def mlstm_init(key, cfg, dtype):
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    inner = h * hd
    return {
        "wq": dense_init(key, d, inner, dtype),
        "wk": dense_init(key, d, inner, dtype),
        "wv": dense_init(key, d, inner, dtype),
        "wif": dense_init(key, d, 2 * h, dtype, bias=True),    # i~, f~ gates
        "wo_gate": dense_init(key, d, inner, dtype),           # output gate
        "wo": dense_init(key, inner, d, dtype,
                         scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def mlstm_specs(cfg):
    return {
        "wq": dense_specs("embed", "qkv"),
        "wk": dense_specs("embed", "qkv"),
        "wv": dense_specs("embed", "qkv"),
        "wif": dense_specs("embed", None, bias=True),
        "wo_gate": dense_specs("embed", "qkv"),
        "wo": dense_specs("qkv", "embed"),
    }


def mlstm_state_init(cfg, batch: int, dtype=F32, *, device=None):
    h, hd = cfg.n_heads, cfg.head_dim
    return {
        "C": torch.zeros((batch, h, hd, hd), dtype=dtype, device=device),
        "n": torch.zeros((batch, h, hd), dtype=dtype, device=device),
        "m": torch.full((batch, h), -1e30, dtype=dtype, device=device),
    }


def mlstm_state_specs():
    return {"C": ("batch", "heads", None, None),
            "n": ("batch", "heads", None),
            "m": ("batch", "heads")}


def _mixer(core, p, x, state, rules, out: str, constrain=None):
    """``core(p, x, state) -> (y, new_state)`` then the output projection
    ``p[out]``; with ``rules`` the core runs on each rank's rows and ``y``
    is constrained to ``constrain`` first."""
    if not SL.on_mesh(x, rules, "a recurrent mixer"):
        y, new_state = core(p, x, state)
    else:
        y, new_state = SL.batch_local_call(
            core, rules, x, {k: v for k, v in p.items() if k != out},
            state)
        if constrain is not None:
            y = rules.constrain(y, constrain)
    return dense_apply(p[out], y), new_state


def _mlstm_gates(p, x, h):
    """Returns (logi, logf) each (B, S, H) in f32."""
    g = dense_apply(p["wif"], x).float()
    logi, fraw = torch.split(g, h, dim=-1)
    return logi, _log_sigmoid(fraw)


def mlstm_apply(p, x, cfg, *, state=None, chunk: int = 256, rules=None):
    """x: (B, S, D).  Returns (y, new_state).

    S == 1 with state  -> decode step.
    S > 1              -> chunkwise-parallel scan (state optional, default 0).
    """
    return _mixer(lambda p_, x_, st: _mlstm_core(p_, x_, cfg, st, chunk),
                  p, x, state, rules, "wo", ("batch", None, "qkv"))


def _mlstm_core(p, x, cfg, state, chunk: int):
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    q = dense_apply(p["wq"], x).reshape(b, s, h, hd)
    k = dense_apply(p["wk"], x).reshape(b, s, h, hd)
    v = dense_apply(p["wv"], x).reshape(b, s, h, hd)
    logi, logf = _mlstm_gates(p, x, h)

    if state is None:
        state = mlstm_state_init(cfg, b, device=x.device)

    if s == 1:
        y, new_state = _mlstm_step(
            q[:, 0], k[:, 0] * scale, v[:, 0],
            logi[:, 0], logf[:, 0], state)
        y = y[:, None]
    else:
        y, new_state = _mlstm_chunked(
            q, k * scale, v, logi, logf, state, chunk=min(chunk, s))

    o_gate = torch.sigmoid(dense_apply(p["wo_gate"], x).float())
    y = (y.reshape(b, s, h * hd).float() * o_gate).to(x.dtype)
    return y, new_state


def _mlstm_step(q, k, v, logi, logf, state):
    """Single-token update.  q,k,v: (B,H,hd); gates: (B,H)."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(logf + m, logi)
    a = torch.exp(logf + m - m_new)            # decay of old state
    bq = torch.exp(logi - m_new)               # injection weight
    C_new = a[..., None, None] * C + bq[..., None, None] * (
        k[..., :, None] * v[..., None, :])     # (B,H,hd_k,hd_v)
    n_new = a[..., None] * n + bq[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", C_new, q.float())
    den = torch.abs(torch.einsum("bhk,bhk->bh", n_new, q.float()))
    den = torch.maximum(den, torch.exp(-m_new))
    y = num / den[..., None]
    return y, {"C": C_new, "n": n_new, "m": m_new}


def _mlstm_chunked(q, k, v, logi, logf, state, *, chunk: int):
    """Chunkwise-parallel stabilized mLSTM.

    q,k,v: (B,S,H,hd); logi/logf: (B,S,H).  state: dict(C,n,m).
    """
    b, s, h, hd = q.shape
    if s % chunk:
        pad = chunk - s % chunk
        zf = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        q, k, v = zf(q), zf(k), zf(v)
        # padded steps: f=1 (logf=0) keeps state, i -> -inf drops input
        logi = F.pad(logi, (0, 0, 0, pad))
        logf = F.pad(logf, (0, 0, 0, pad))
        logi[:, s:] = -1e30
    sp = q.shape[1]
    nc = sp // chunk
    rs = lambda t: t.reshape((b, nc, chunk) + tuple(t.shape[2:]))
    qc, kc, vc = rs(q), rs(k), rs(v)                # (B, nc, L, H, hd)
    lic = rs(logi).transpose(2, 3)                  # (B, nc, H, L)
    lfc = rs(logf).transpose(2, 3)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))

    C, n, m = state["C"], state["n"], state["m"]     # Ĉ, n̂ (stab), m
    ys = []
    for c in range(nc):
        # (B,L,H,hd) -> (B,H,L,hd)
        qi = qc[:, c].transpose(1, 2).float()
        ki = kc[:, c].transpose(1, 2).float()
        vi = vc[:, c].transpose(1, 2).float()
        li, lf = lic[:, c], lfc[:, c]
        Fc = torch.cumsum(lf, dim=-1)                          # (B,H,L) inclusive
        Ftot = Fc[..., -1:]                                    # (B,H,1)
        # per-position stabilizer: m_i = max(m_prev + F_i, max_{j<=i}(li_j - F_j) + F_i)
        g = li - Fc
        gmax = torch.cummax(g, dim=-1).values
        m_i = torch.maximum(m[..., None], gmax) + Fc           # (B,H,L)
        m_i = torch.clamp(m_i, min=-1e30)
        # inter contribution: exp(m_prev + F_i - m_i) * (Ĉ_prev^T q_i)
        w_inter = torch.exp(m[..., None] + Fc - m_i)          # (B,H,L)
        inter_num = torch.einsum("bhkv,bhlk->bhlv", C, qi)     # (B,H,L,hd)
        inter_den = torch.einsum("bhk,bhlk->bhl", n, qi)
        # intra: D_ij = exp(li_j + F_i - F_j - m_i) for j<=i
        logD = li[..., None, :] + Fc[..., :, None] - Fc[..., None, :] \
            - m_i[..., :, None]                                # (B,H,L_i,L_j)
        D = torch.where(tri, torch.exp(logD), 0.0)
        sc = torch.einsum("bhik,bhjk->bhij", qi, ki) * D       # (B,H,L,L)
        intra_num = torch.einsum("bhij,bhjv->bhiv", sc, vi)
        intra_den = sc.sum(dim=-1)
        num = intra_num + w_inter[..., None] * inter_num
        den = torch.abs(intra_den + w_inter * inter_den)
        den = torch.maximum(den, torch.exp(-m_i))
        ys.append((num / den[..., None]).transpose(1, 2))     # (B,L,H,hd)
        # state update to end of chunk
        gk = li + Ftot - Fc                                    # weight for k_j v_j
        m_chunk = torch.amax(gk, dim=-1)                       # (B,H)
        m_new = torch.maximum(m + Ftot[..., 0], m_chunk)
        wC = torch.exp(gk - m_new[..., None])                  # (B,H,L)
        decay = torch.exp(m + Ftot[..., 0] - m_new)
        C = decay[..., None, None] * C + \
            torch.einsum("bhl,bhlk,bhlv->bhkv", wC, ki, vi)
        n = decay[..., None] * n + torch.einsum("bhl,bhlk->bhk", wC, ki)
        m = m_new
    y = torch.stack(ys, dim=1).reshape(b, sp, h, hd)[:, :s]
    return y, {"C": C, "n": n, "m": m}


# =====================================================================
# sLSTM
# =====================================================================

def slstm_init(key, cfg, dtype):
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    inner = h * hd
    return {
        # input projections for z,i,f,o (fused)
        "wx": dense_init(key, d, 4 * inner, dtype, bias=True),
        # recurrent (block-diagonal per head): (H, hd, 4*hd)
        "r": _normal(key, (h, hd, 4 * hd), dtype),
        "wo": dense_init(key, inner, d, dtype,
                         scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def slstm_specs(cfg):
    return {"wx": dense_specs("embed", None, bias=True),
            "r": ("heads", None, None),
            "wo": dense_specs(None, "embed")}


def slstm_state_init(cfg, batch: int, dtype=F32, *, device=None):
    h, hd = cfg.n_heads, cfg.head_dim
    z = lambda: torch.zeros((batch, h, hd), dtype=dtype, device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, h, hd), -1e30, dtype=dtype,
                            device=device)}


def slstm_state_specs():
    t = ("batch", "heads", None)
    return {"c": t, "n": t, "h": t, "m": t}


def slstm_apply(p, x, cfg, *, state=None, rules=None):
    """x: (B,S,D) -> (y, new_state).  Sequential loop over time."""
    return _mixer(lambda p_, x_, st: _slstm_core(p_, x_, cfg, st),
                  p, x, state, rules, "wo")


def _slstm_core(p, x, cfg, state):
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    if state is None:
        state = slstm_state_init(cfg, b, device=x.device)
    wx = dense_apply(p["wx"], x).float().reshape(b, s, 4, h, hd)
    r = p["r"].float()
    c, n, hprev, m = state["c"], state["n"], state["h"], state["m"]
    ys = []
    for t in range(s):
        # (B,H,4,hd), indexed as the reference's step indexes it: xt[:, g]
        # takes the H axis, so its gates broadcast against rec[:, :, g]
        # only where H == 4 (every xLSTM config has 4 heads)
        xt = wx[:, t].transpose(1, 2)
        # recurrent contribution: (B,H,hd) @ (H,hd,4hd) -> (B,H,4,hd)
        rec = torch.einsum("bhk,hkf->bhf", hprev, r).reshape(b, h, 4, hd)
        z = torch.tanh(xt[:, 0] + rec[:, :, 0])
        ii = xt[:, 1] + rec[:, :, 1]
        logf = _log_sigmoid(xt[:, 2] + rec[:, :, 2])
        o = torch.sigmoid(xt[:, 3] + rec[:, :, 3])
        m_new = torch.maximum(logf + m, ii)
        a = torch.exp(logf + m - m_new)
        bq = torch.exp(ii - m_new)
        c = a * c + bq * z
        n = a * n + bq
        hprev = o * c / torch.clamp(n, min=1.0)
        m = m_new
        ys.append(hprev)
    y = torch.stack(ys, dim=1).reshape(b, s, h * hd).to(x.dtype)
    return y, {"c": c, "n": n, "h": hprev, "m": m}


# =====================================================================
# RG-LRU (Griffin / recurrentgemma recurrent block)
# =====================================================================

def rglru_init(key, cfg, dtype):
    d = cfg.d_model
    rdim = cfg.rglru_dim or d
    p = {
        "w_in": dense_init(key, d, rdim, dtype),       # recurrence branch
        "w_gate_in": dense_init(key, d, rdim, dtype),  # gelu gate branch
        "conv_w": _normal(key, (4, rdim), dtype),      # temporal conv width 4
        "conv_b": torch.zeros((rdim,), dtype=dtype, device=key.device),
        "w_rg": dense_init(key, rdim, rdim, dtype),    # recurrence gate r
        "w_ig": dense_init(key, rdim, rdim, dtype),    # input gate i
    }
    # Λ init so that a = sigmoid(Λ)^c in [0.9, 0.999]
    u = torch.empty((rdim,), dtype=F32, device=key.device).uniform_(
        0.9, 0.999, generator=key)
    p["lam"] = torch.log((u ** (1.0 / 8.0)) / (1 - u ** (1.0 / 8.0)))
    p["w_out"] = dense_init(key, rdim, d, dtype,
                            scale=0.02 / math.sqrt(2 * cfg.n_layers))
    return p


def rglru_specs(cfg):
    return {
        "w_in": dense_specs("embed", "d_ff"),
        "w_gate_in": dense_specs("embed", "d_ff"),
        "conv_w": (None, "d_ff"),
        "conv_b": ("d_ff",),
        # (R, R) gate maps: row-parallel (one dim on 'model')
        "w_rg": dense_specs("d_ff", None),
        "w_ig": dense_specs("d_ff", None),
        "lam": ("d_ff",),
        "w_out": dense_specs("d_ff", "embed"),
    }


def rglru_state_init(cfg, batch: int, dtype=F32, *, device=None):
    rdim = cfg.rglru_dim or cfg.d_model
    return {"h": torch.zeros((batch, rdim), dtype=dtype, device=device),
            "conv": torch.zeros((batch, 3, rdim), dtype=dtype,
                                device=device)}


def rglru_state_specs():
    return {"h": ("batch", "d_ff"), "conv": ("batch", None, "d_ff")}


_RG_C = 8.0


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t with h_{-1} = 0 along dim 1, as a log-depth
    inclusive scan of the pairs (a, b) under (a_l, b_l) . (a_r, b_r) =
    (a_l a_r, a_r b_l + b_r)."""
    s, step = a.shape[1], 1
    while step < s:
        # out of place: autograd keeps each level's (a, b) for the backward
        b = torch.cat([b[:, :step],
                       torch.addcmul(b[:, step:], a[:, step:], b[:, :-step])],
                      dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    return b


def rglru_apply(p, x, cfg, *, state=None, rules=None):
    """Griffin recurrent block. x: (B,S,D) -> (y, new_state)."""
    return _mixer(lambda p_, x_, st: _rglru_core(p_, x_, cfg, st),
                  p, x, state, rules, "w_out", ("batch", None, "d_ff"))


def _rglru_core(p, x, cfg, state):
    b, s, d = x.shape
    if state is None:
        state = rglru_state_init(cfg, b, device=x.device)
    u = dense_apply(p["w_in"], x)                        # (B,S,R)
    gate = F.gelu(dense_apply(p["w_gate_in"], x).float(), approximate="tanh")

    # temporal conv width 4 (causal), carrying last-3 inputs as decode state
    hist = state["conv"].to(u.dtype)                     # (B,3,R)
    uc = torch.cat([hist, u], dim=1)                     # (B,S+3,R)
    w = p["conv_w"].float()
    conv = sum(uc[:, i:i + s].float() * w[i] for i in range(4))
    conv = conv + p["conv_b"].float()                    # (B,S,R)
    new_conv = uc[:, -3:].float()

    r = torch.sigmoid(dense_apply(p["w_rg"], conv.to(u.dtype)).float())
    i = torch.sigmoid(dense_apply(p["w_ig"], conv.to(u.dtype)).float())
    log_a = -_RG_C * r * F.softplus(-p["lam"].float())  # log sigmoid(Λ)^(c·r)
    a = torch.exp(log_a)                                 # (B,S,R)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * conv)

    if s == 1:
        hcur = a[:, 0] * state["h"] + gated[:, 0]
        hs = hcur[:, None]
        new_h = hcur
    else:
        # h_0 folded into b_1
        bb = gated.clone()
        bb[:, 0] += a[:, 0] * state["h"]
        hs = linear_scan(a, bb)
        new_h = hs[:, -1]

    y = (hs * gate).to(x.dtype)                          # (B,S,R)
    return y, {"h": new_h, "conv": new_conv}
