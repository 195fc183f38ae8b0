"""Mixture-of-Experts FFN with capacity-based token-choice routing
(``repro/models/moe.py``).

Each batch row is a dispatch group. Within a group every expert takes up
to ``capacity`` of the tokens routed to it, earliest first; a token
routed past an expert's capacity loses that expert's contribution. The
discrete parts follow the reference exactly: softmax router, top-k and
renormalisation; the earliest-token dispatch (``top_k`` over the
priority ``t - position``, a slot valid iff its priority is > 0), so a
right-padded prompt's pad tokens come last and never take a real token's
slot; the combine's slot = the token's rank among the expert's earlier
tokens, dropped past the capacity and clipped for the gather.

Every expert FFN goes through the grouped-matmul kernel's wrapper
``gmm`` (``kernels/moe_gmm``): three launches per layer for SwiGLU
(``expert_mlp``, the reference's kernel branch), two for ungated MLPs,
at any ``b * cap`` (the reference's ``(b * cap) % 8 == 0`` gate is the
TPU's tiling). The dispatched tokens are gathered straight into the
kernel's (E, b * cap, d) layout, and the combine reads the outputs back
from it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm.ops import expert_mlp, gmm
from repro_torch.models.layers import Params, _act, apply_dense


def init_moe(init, cfg: ModelConfig) -> Params:
    """Router, stacked expert weights and shared experts with the
    reference's shapes: router (d, E), up/gate (E, d, f), down (E, f, d),
    ``sh_*`` (d, f * n_shared) / (f * n_shared, d)."""
    e, d = cfg.moe, cfg.d_model
    gated = cfg.ffn_act in ("swiglu", "geglu")
    p = {"router": init.normal(d, e.n_experts),
         "up": init.normal(e.n_experts, d, e.d_expert),
         "down": init.normal(e.n_experts, e.d_expert, d)}
    if gated:
        p["gate"] = init.normal(e.n_experts, d, e.d_expert)
    if e.n_shared:
        d_sh = e.d_expert * e.n_shared
        p["sh_up"] = init.normal(d, d_sh)
        p["sh_down"] = init.normal(d_sh, d)
        if gated:
            p["sh_gate"] = init.normal(d, d_sh)
    return p


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    e = cfg.moe
    c = int(tokens_per_group * e.top_k * e.capacity_factor / e.n_experts)
    return max(1, min(c, tokens_per_group))


def router(p: Params, x, cfg: ModelConfig):
    """The router for x (B, T, d): probs (B, T, E), the fp32 softmax of the
    router logits, and the top-k choices (B, T, k): weights w
    (renormalised to sum 1) and experts e_idx."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, e_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, w / w.sum(-1, keepdim=True).clamp_min(1e-9), e_idx


def dispatch(probs, e_idx, cfg: ModelConfig) -> dict:
    """The dispatch plan for the choices e_idx (B, T, k):
      cap, each expert's capacity per group; aux, the Switch load-balance
      loss; top_i (B, E, cap), the tokens each expert takes, earliest
      first, and slot_valid (B, E, cap), which of those slots hold a
      routed token; keep (B, T, k), whether a choice fits its expert's
      capacity, and slot (B, T, k), its slot there (clipped to cap - 1
      when it does not)."""
    e = cfg.moe
    t = e_idx.shape[1]
    cap = capacity(cfg, t)
    assign = F.one_hot(e_idx, e.n_experts).float()              # (b,t,k,E)
    tok_mask = assign.sum(2)                                    # (b,t,E) 0/1
    aux = e.n_experts * (tok_mask.mean(1) * probs.mean(1)).sum(-1).mean()
    prio = tok_mask * (t - torch.arange(t, dtype=torch.float32,
                                        device=e_idx.device))[None, :, None]
    top_p, top_i = torch.topk(prio.transpose(1, 2), cap, dim=-1)
    pos_all = (tok_mask.cumsum(1) - tok_mask).long()            # exclusive
    pos_tk = torch.gather(pos_all, 2, e_idx)                    # (b,t,k)
    return {"cap": cap, "aux": aux, "top_i": top_i, "slot_valid": top_p > 0,
            "keep": pos_tk < cap, "slot": pos_tk.clamp_max(cap - 1)}


def apply_moe(p: Params, x, *, cfg: ModelConfig):
    """x: (B, T, d) — B is the dispatch group dim. Returns (y, aux_loss)."""
    e = cfg.moe
    b, t, d = x.shape
    probs, w, e_idx = router(p, x, cfg)
    r = dispatch(probs, e_idx, cfg)
    cap, n_e = r["cap"], e.n_experts
    gated = "gate" in p

    # dispatch, gathered as (E, b, cap) rows: the kernel's (E, C, d) layout
    rows = r["top_i"] + (torch.arange(b, device=x.device) * t)[:, None, None]
    xe = x.reshape(b * t, d)[rows.transpose(0, 1).reshape(-1)]
    xe = xe * r["slot_valid"].transpose(0, 1).reshape(-1, 1).to(x.dtype)
    xe = xe.reshape(n_e, b * cap, d)

    if gated and cfg.ffn_act == "swiglu":
        ye = expert_mlp(xe, p["gate"], p["up"], p["down"])
    else:
        up = gmm(xe, p["up"])
        h = _act(cfg.ffn_act, gmm(xe, p["gate"])) * up if gated \
            else _act(cfg.ffn_act, up)
        ye = gmm(h, p["down"])

    # combine: token (bi, ti)'s k-th choice reads slot `slot` of its expert
    flat = (e_idx * (b * cap) + r["slot"]
            + (torch.arange(b, device=x.device) * cap)[:, None, None])
    y_tok = ye.reshape(n_e * b * cap, d)[flat.reshape(-1)].reshape(
        b, t, e.top_k, d)
    wk = (w * r["keep"]).to(x.dtype)
    y = (wk.float()[..., None] * y_tok.float()).sum(2).to(x.dtype)

    if "sh_up" in p:                                            # shared
        su = apply_dense({"w": p["sh_up"]}, x, cfg)
        sh = (_act(cfg.ffn_act, apply_dense({"w": p["sh_gate"]}, x, cfg)) * su
              if gated else _act(cfg.ffn_act, su))
        y = y + apply_dense({"w": p["sh_down"]}, sh, cfg)
    return y, r["aux"]
