"""LLM cascade (paper §3 Strategy 3): the tier-by-tier executor.

Port of ``repro/core/cascade.py``'s live-tier path: ``tier_step``
(invoke + score + accept on one chunk) and ``execute_cascade`` (query
tier j with every still-pending query, accept the reliable answers,
re-batch the rest to tier j+1), with every tier and scorer call chunked
to ``batch_size``. Entry routing, retry and circuit breakers are later
slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.cascade_compact.ops import compact as compact_op

_NP_FLOAT = {torch.float16: np.float16, torch.float32: np.float32,
             torch.float64: np.float64}


@dataclasses.dataclass
class CascadeTier:
    """One cascade stage: ``invoke(queries) -> (answers (b,), costs (b,))``
    — one call per batch chunk, so a backend that produces an answer and
    its cost together is never double-charged."""

    name: str
    invoke: Callable


def _accept_threshold(dtype, threshold: float):
    """Smallest ``dtype`` value t' with ``(x >= t') == (float64(x) >=
    threshold)`` for every finite x of ``dtype``: round the threshold
    *up* to the next representable value whenever casting rounded it
    down, so a native-dtype accept on device matches the host float64
    rule bit for bit."""
    t = np.asarray(threshold, dtype)
    if float(t) < float(threshold):
        t = np.nextafter(t, np.asarray(np.inf, dtype))
    return t


def tier_step(tier: CascadeTier, chunk, j: int, *, scorer: Callable,
              threshold: float | None, last: bool,
              device_masks: list | None = None):
    """One compaction step on ONE chunk: invoke tier j, score, accept.

    Returns ``(answers (b,), costs (b,) float64, scores (b,) float64,
    accept (b,) bool)``; scores are NaN where the scorer was not
    consulted (the last tier accepts everything unscored).

    ``device_masks`` (optional list): when the scorer returns a float
    ``torch.Tensor``, the accept mask is computed on the tensor's device
    with the threshold rounded by ``_accept_threshold`` and appended to
    the list, so ``execute_cascade(compact="device")`` compacts with it
    without a host-to-device copy of the mask.
    """
    a, c = tier.invoke(chunk)
    a = np.asarray(a)
    c = np.asarray(c, np.float64)
    if last:
        return (a, c, np.full(len(chunk), np.nan),
                np.ones(len(chunk), bool))
    raw = scorer(chunk, a, j)
    accept = None
    if torch.is_tensor(raw):
        if device_masks is not None and raw.dtype in _NP_FLOAT:
            t = _accept_threshold(_NP_FLOAT[raw.dtype], threshold)
            mask = raw >= torch.tensor(t.item(), dtype=raw.dtype,
                                       device=raw.device)
            device_masks.append(mask)
            accept = mask.cpu().numpy()
        s = raw.detach().cpu().double().numpy()
    else:
        s = np.asarray(raw, np.float64)
    if accept is None:
        accept = s >= threshold
    return a, c, s, accept


#: pending-set compaction modes: "host" is numpy boolean indexing;
#: "device" keeps the pending indices (and numeric queries) as tensors on
#: the pipeline's device and compacts them with the compaction kernel
COMPACT_MODES = ("host", "device")


def execute_cascade(tiers: Sequence[CascadeTier], thresholds: Sequence[float],
                    scorer: Callable, queries, *, batch_size: int = 256,
                    compact: str = "host", device="cuda") -> dict:
    """Tier-by-tier compaction over ``queries`` (n, ...).

    scorer(queries_chunk, answers_chunk, tier_pos) -> scores in [0,1].
    ``device`` is where ``compact="device"`` keeps the pending set (it is
    not read for ``"host"``). Both modes give identical outputs.

    Returns dict(answers, cost, stopped_at (cascade position, -1 =
    unanswered), scores (accept-time score, NaN where not scored),
    tier_counts (pending per tier), accepted_counts).
    """
    if compact not in COMPACT_MODES:
        raise ValueError(f"unknown compact mode {compact!r}; expected "
                         f"one of {COMPACT_MODES}")
    queries = np.asarray(queries)
    n = queries.shape[0]
    m = len(tiers)
    if len(thresholds) != m - 1:
        raise ValueError(f"need {m - 1} thresholds for {m} tiers, "
                         f"got {len(thresholds)}")
    answers = np.empty(n, dtype=object)
    cost = np.zeros(n, np.float64)
    stopped_at = np.full(n, -1, np.int32)
    scores = np.full(n, np.nan)
    pending = np.arange(n)
    on_device = compact == "device"
    pending_dev = dev_queries = None
    if on_device:
        dev = resolve_device(device)
        pending_dev = torch.arange(n, dtype=torch.int32, device=dev)
        if queries.dtype != object:
            dev_queries = torch.from_numpy(
                np.ascontiguousarray(queries)).to(dev)
    tier_counts: list[int] = []
    accepted_counts: list[int] = []
    for j, tier in enumerate(tiers):
        tier_counts.append(len(pending))
        last = j == m - 1
        if len(pending) == 0:
            accepted_counts.append(0)
            continue
        qs = (dev_queries.index_select(0, pending_dev).cpu().numpy()
              if dev_queries is not None else queries[pending])
        ans_chunks, cost_chunks, score_chunks, accept_chunks = [], [], [], []
        dev_masks: list = []
        for i in range(0, len(pending), batch_size):
            a, c, s, acc = tier_step(
                tier, qs[i:i + batch_size], j, scorer=scorer,
                threshold=None if last else thresholds[j], last=last,
                device_masks=dev_masks if on_device else None)
            ans_chunks.append(a)
            cost_chunks.append(c)
            score_chunks.append(s)
            accept_chunks.append(acc)
        ans = np.concatenate(ans_chunks)
        cost[pending] += np.concatenate(cost_chunks)
        accept = np.concatenate(accept_chunks)
        done = pending[accept]
        scores[done] = np.concatenate(score_chunks)[accept]
        if ans.dtype == object or ans.ndim != 1:
            for i_local, i_global in zip(np.flatnonzero(accept), done):
                answers[i_global] = ans[i_local]
        else:
            answers[done] = ans[accept]
        stopped_at[done] = j
        accepted_counts.append(int(accept.sum()))
        if on_device:
            if dev_masks and len(dev_masks) == len(accept_chunks):
                # every chunk's accept mask was made on device
                keep = torch.logical_not(torch.cat(dev_masks))
            else:
                keep = torch.from_numpy(~accept).to(pending_dev.device)
            padded, cnt = compact_op(pending_dev, keep)
            pending_dev = padded[:int(cnt)]   # cnt sync sizes the slice
            # host mirror for the numpy cost/answer scatters above
            pending = pending_dev.cpu().numpy()
        else:
            pending = pending[~accept]
    try:                                     # densify when answers are scalar
        dense = np.array(answers.tolist())
        answers_arr = dense if dense.ndim == 1 else answers
    except ValueError:                       # heterogeneous answer objects
        answers_arr = answers
    return {
        "answers": answers_arr,
        "cost": cost,
        "stopped_at": stopped_at,
        "scores": scores,
        "tier_counts": tier_counts,
        "accepted_counts": accepted_counts,
    }
