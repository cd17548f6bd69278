"""Mamba selective-SSM block (Gu & Dao 2023), used by the Jamba hybrid — the
port of ``repro.models.mamba``.

Block: in_proj -> (x, z); causal depthwise conv (width cfg.ssm_conv) + SiLU;
data-dependent (dt, B, C); selective scan
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t,   y_t = C_t . h_t + D * x_t
then y * SiLU(z) -> out_proj.  Decode state is (B, d_inner, d_state) + a
(conv-1)-token conv buffer: O(1) in sequence length.  The scan is a Python
loop over time; a sequence of more than ``TIME_CHUNK`` steps (and a
multiple of it) runs in chunks, each rematerialized in the backward where
autograd records, as the reference's chunked ``lax.scan`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.model_api import ArchConfig, ParamDefs


def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def dt_rank(cfg: ArchConfig) -> int:
    return max(cfg.d_model // 16, 8)


def param_defs(cfg: ArchConfig, lead: tuple[int, ...]) -> ParamDefs:
    """Mamba params with arbitrary leading stack dims (e.g. (periods, 7))."""
    d, di, ds, dr, ck = cfg.d_model, d_inner(cfg), cfg.d_state, dt_rank(cfg), cfg.ssm_conv
    n = (None,) * len(lead)
    return {
        "in_proj": (lead + (d, 2 * di), (*n, "fsdp", "tp")),
        "conv_w": (lead + (ck, di), (*n, None, "tp")),
        "conv_b": (lead + (di,), (*n, "tp")),
        "x_proj": (lead + (di, dr + 2 * ds), (*n, "tp", None)),
        "dt_w": (lead + (dr, di), (*n, None, "tp")),
        "dt_bias": (lead + (di,), (*n, "tp")),
        "a_log": (lead + (di, ds), (*n, "tp", None)),
        "d_skip": (lead + (di,), (*n, "tp")),
        "out_proj": (lead + (di, d), (*n, "tp", "fsdp")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 buf: torch.Tensor | None):
    """Depthwise causal conv over time.  x: (B, T, di), w: (K, di).

    buf: (B, K-1, di) trailing context (decode) or None (zero pad).
    Returns (y, new_buf)."""
    k = w.shape[0]
    if buf is None:
        buf = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xx = torch.cat([buf.to(x.dtype), x], dim=1)  # (B, T+K-1, di)
    y = sum(xx[:, i: i + x.shape[1], :] * w[i].to(x.dtype)[None, None, :] for i in range(k))
    y = y + b.to(x.dtype)
    return y, xx[:, -(k - 1):, :]


TIME_CHUNK = 64  # remat granularity of the selective scan (the reference's)


def _ssm_steps(x_act, dt, bmat, cmat, a, h):
    ys = []
    for i in range(x_act.shape[1]):
        x_t, dt_t, b_t, c_t = x_act[:, i], dt[:, i], bmat[:, i], cmat[:, i]
        da = torch.exp(dt_t[..., None] * a[None])  # (B,di,ds)
        h = da * h + (dt_t * x_t)[..., None] * b_t[:, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, c_t))
    return torch.stack(ys, dim=1), h


def _ssm_scan(x_act, dt, bmat, cmat, a, h0):
    """Selective scan.  x_act/dt: (B,T,di); bmat/cmat: (B,T,ds); a: (di,ds);
    h0: (B,di,ds).  Returns y (B,T,di) f32, h_T."""
    t = x_act.shape[1]
    if t <= TIME_CHUNK or t % TIME_CHUNK != 0:
        return _ssm_steps(x_act, dt, bmat, cmat, a, h0)
    h, ys = h0, []
    for c in range(0, t, TIME_CHUNK):
        part = slice(c, c + TIME_CHUNK)
        y, h = L.checkpointed(_ssm_steps, x_act[:, part], dt[:, part], bmat[:, part],
                              cmat[:, part], a, h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba_forward(cfg: ArchConfig, x: torch.Tensor, p: dict,
                  state: tuple[torch.Tensor, torch.Tensor] | None = None):
    """x: (B, T, d); p: one sublayer's params; state: (h, conv_buf) for
    decode.  Returns (out (B,T,d), (h_T, conv_buf_T))."""
    b = x.shape[0]
    di, ds, dr = d_inner(cfg), cfg.d_state, dt_rank(cfg)
    xz = x @ p["in_proj"].to(x.dtype)
    x_in, z = torch.split(xz, di, dim=-1)
    h0 = state[0] if state is not None else torch.zeros((b, di, ds), dtype=torch.float32,
                                                        device=x.device)
    buf = state[1] if state is not None else None
    x_conv, new_buf = _causal_conv(x_in, p["conv_w"], p["conv_b"], buf)
    x_act = F.silu(x_conv)
    proj = x_act @ p["x_proj"].to(x.dtype)
    dt_low, bmat, cmat = torch.split(proj, [dr, ds, ds], dim=-1)
    dt = F.softplus((dt_low @ p["dt_w"].to(x.dtype)).float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    y, h_t = _ssm_scan(x_act.float(), dt, bmat.float(), cmat.float(), a, h0)
    y = y + p["d_skip"].float() * x_act.float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"].to(x.dtype), (h_t, new_buf)


def state_shapes(cfg: ArchConfig, batch: int, lead: tuple[int, ...] = ()):
    """Shapes and dtypes of the decode state: (h, conv_buf)."""
    di, ds, ck = d_inner(cfg), cfg.d_state, cfg.ssm_conv
    return ((lead + (batch, di, ds), torch.float32),
            (lead + (batch, ck - 1, di), cfg.activation_dtype()))


def state_specs(lead_n: int):
    n = (None,) * lead_n
    return ((*n, "dp", "tp", None), (*n, "dp", None, "tp"))
