"""Mamba-2 SSD mixer (``repro/models/ssm.py``): prefill through the SSD
chunked-scan kernel, decode as a one-step state update in plain torch.

Projections are separate (z / x / BC / dt), as in the reference. A
layer's decode cache is ``{"conv_x", "conv_bc"}``, the last ``d_conv - 1``
inputs of the two depthwise causal convolutions in the compute dtype,
and ``"ssm"``, the (B, H, P, N) state in fp32.

Prefill calls ``ssd`` (the kernel's wrapper ``ssd_scan`` plus the D
term) where the reference calls ``ssd_chunked`` and adds D, at
``chunk = min(cfg.ssm.chunk, S)``, for y and the final state. Decode
updates the cache in place (the reference returns a new one): a cache
is made by ``prefill`` and handed to exactly one decode loop
(``serving.engine.PrefillFuture``). The casts follow the reference's per
mode: prefill rounds the conv biases to the compute dtype, and its y
stays fp32 from the D term through the out projection; decode adds the
conv biases in fp32 and rounds y to the compute dtype before the gated
norm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.models.layers import (Params, apply_dense, cast,
                                       compute_dtype, rmsnorm)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim


def init_mamba(init, cfg: ModelConfig) -> Params:
    """The reference's shapes and init: N(0, 0.02) projections, N(0, 0.1)
    conv weights, zero conv biases and dt bias, A_log = log(linspace(1,
    16, H)), D and the norm scale 1."""
    s, d = cfg.ssm, cfg.d_model
    d_in, n_heads = _dims(cfg)
    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads)).to(init.device)
    return {
        "z_proj": init.normal(d, d_in),
        "x_proj": init.normal(d, d_in),
        "bc_proj": init.normal(d, 2 * s.d_state),
        "dt_proj": init.normal(d, n_heads),
        "conv_x_w": init.normal(s.d_conv, d_in, scale=0.1),
        "conv_x_b": init.const(0.0, d_in),
        "conv_bc_w": init.normal(s.d_conv, 2 * s.d_state, scale=0.1),
        "conv_bc_b": init.const(0.0, 2 * s.d_state),
        "A_log": a_log,
        "D": init.const(1.0, n_heads),
        "dt_bias": init.const(0.0, n_heads),
        "norm": init.const(1.0, d_in),
        "out_proj": init.normal(d_in, d),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=None,
                     device="cpu"):
    """Zeros decode cache of one Mamba layer."""
    s = cfg.ssm
    d_in, n_heads = _dims(cfg)
    dtype = dtype or compute_dtype(cfg)
    return {
        "conv_x": torch.zeros(batch, s.d_conv - 1, d_in, dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros(batch, s.d_conv - 1, 2 * s.d_state,
                               dtype=dtype, device=device),
        "ssm": torch.zeros(batch, n_heads, s.head_dim, s.d_state,
                           dtype=torch.float32, device=device),
    }


def _causal_conv(u, w, bias):
    """u: (b, s, ch); w: (k, ch) depthwise causal conv, summed in fp32 and
    returned in u's dtype."""
    k, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(k):
        out = out + pad[:, i:i + s].float() * w[i].float()
    return (out + bias.float()).to(u.dtype)


def _tail(u, k: int):
    """The last ``k`` steps of u (b, s, ch); a prompt shorter than the
    conv window is preceded by zeros, as the window starts."""
    s = u.shape[1]
    return u[:, -k:] if s >= k else F.pad(u, (0, 0, k - s, 0))


def _conv_step(window, w, bias):
    """One decode step of the causal conv over ``window`` (b, k, ch), in
    fp32 with the fp32 bias, silu, in the window's dtype."""
    y = torch.einsum("bkc,kc->bc", window.float(), w.float()) + bias
    return F.silu(y).to(window.dtype)


def apply_mamba(p: Params, xin, *, cfg: ModelConfig, mode: str, cache=None):
    """xin: (B, S, d) (S = 1 for decode). Returns (y, new_cache): the
    cache is None in "train", new in "prefill", ``cache`` updated in place
    in "decode"."""
    s_cfg = cfg.ssm
    d_in, n_heads = _dims(cfg)
    b, s, _ = xin.shape
    N, P = s_cfg.d_state, s_cfg.head_dim

    z = apply_dense({"w": p["z_proj"]}, xin, cfg)
    xc = apply_dense({"w": p["x_proj"]}, xin, cfg)
    bc = apply_dense({"w": p["bc_proj"]}, xin, cfg)
    dt_raw = apply_dense({"w": p["dt_proj"]}, xin, cfg)
    a = -torch.exp(p["A_log"])                                  # (h,)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])              # (b,s,h)

    if mode in ("train", "prefill"):
        xcv = F.silu(_causal_conv(xc, cast(p["conv_x_w"], cfg),
                                  cast(p["conv_x_b"], cfg)))
        bcv = F.silu(_causal_conv(bc, cast(p["conv_bc_w"], cfg),
                                  cast(p["conv_bc_b"], cfg)))
        x = xcv.reshape(b, s, n_heads, P)
        y, state = ssd(x, dt, a, bcv[..., :N].contiguous(),
                       bcv[..., N:].contiguous(), p["D"],
                       chunk=min(s_cfg.chunk, s), return_state=True)
        new_cache = None
        if mode == "prefill":
            k = s_cfg.d_conv - 1
            new_cache = {"conv_x": _tail(xc, k), "conv_bc": _tail(bc, k),
                         "ssm": state}
    else:  # decode
        win_x = torch.cat([cache["conv_x"], xc], dim=1)         # (b, k, d_in)
        win_bc = torch.cat([cache["conv_bc"], bc], dim=1)
        xcv = _conv_step(win_x, cast(p["conv_x_w"], cfg), p["conv_x_b"])
        bcv = _conv_step(win_bc, cast(p["conv_bc_w"], cfg), p["conv_bc_b"])
        x = xcv.reshape(b, n_heads, P).float()
        bm, cm = bcv[..., :N].float(), bcv[..., N:].float()
        dt1 = dt[:, 0]                                          # (b,h)
        h_new = cache["ssm"]                                    # (b,h,p,n) f32
        h_new.mul_(torch.exp(dt1 * a)[..., None, None]).add_(
            torch.einsum("bh,bn,bhp->bhpn", dt1, bm, x))
        y = torch.einsum("bn,bhpn->bhp", cm, h_new)
        y = (y + p["D"][:, None] * x)[:, None].to(xin.dtype)
        cache["conv_x"].copy_(win_x[:, 1:])
        cache["conv_bc"].copy_(win_bc[:, 1:])
        new_cache = cache

    y = y.reshape(b, s, d_in)
    y = rmsnorm(y, p["norm"]) * F.silu(z)
    out = y @ cast(p["out_proj"], cfg).to(y.dtype)
    return out.to(xin.dtype), new_cache
