#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

  [device]   the card's name, and its name and power limit as
             ``nvidia-smi`` reports them;
  [build]    every CUDA kernel built from the sources (one nvcc each, in
             parallel), with ptxas's registers, spills and shared bytes
             per kernel instance (a spill in the gmm kernels fails);
  [grad]     each float kernel wrapper refuses a CUDA input that requires
             grad under grad mode (no kernel has a backward yet) and runs
             under ``torch.no_grad()``;
  [flash]    the flash-attention kernel against its plain PyTorch version
             at the encoder serve path's shapes, on a sweep (ragged S,
             head dims, masks, GQA, bf16) and at Gemma-3-1B's prefill
             shapes (hd 256, 4 query heads on 1 KV head, causal, window 0
             and 512, fp32 and bf16), with CUDA-event times beside the
             plain version and ``scaled_dot_product_attention`` (a
             yardstick the port never calls);
  [compact]  the compaction kernel against its plain version, bit for
             bit, over sizes and keep densities, timed beside ``idx[keep]``;
  [serve]    512 seeded ``headlines`` requests (25% repeats) served twice
             through ``assemble_pipeline(device="cuda", compact="device")``
             with three encoder tiers and the scorer from seeded weights;
             both kernels must have launched, the second pass must be all
             cache hits, the first must match the same weights on the CPU;
             then a cascade of the two cheaper tiers keeps the priciest
             marketplace tier as its savings baseline;
  [decode]   the decode-attention kernel against its plain version at
             Gemma's decode shapes (B 1/8/64, cache 16..4096, ragged
             lengths) and on a GQA sweep, timed beside SDPA;
  [generate] Gemma-3-1B at full width (26 layers, vocab 262 144) from
             seeded weights: (a) fp32 greedy generation on the card equals
             the same weights on the CPU, (b) bf16 times per prefill and
             per decoded token, and bf16 logits teacher-forced against
             fp32, (c) a two-tier cascade (an encoder tier, then a Gemma
             generation tier from an ``EnginePool``) serving 256 requests
             twice, through both attention kernels, which are then held
             against their plain versions at the shapes the tier gave
             them (its prefill buckets, its cache lengths);
  [gmm]      the grouped expert matmul against its plain version over a
             sweep (fp32 and bf16, every kernel instance, ragged C / K /
             F, C from 1 to 320, a base pointer off 16 bytes) and at
             Granite-MoE's prefill and decode shapes, timed back to back
             and in device time (inputs cycled past L2) beside the plain
             version and ``torch.bmm``, with the instance each shape took;
             the two swapped instances forced and timed at C 8;
  [ssd]      the SSD chunked scan against its plain version, y and final
             state (fp32 and bf16, S a multiple of the chunk and ragged,
             chunks that fit shared memory in one pass and longer ones,
             up to 1000, in sub-tiles), and at Mamba2-1.3B's shapes and a
             Jamba-shaped prefill (chunk 256), timed beside the plain
             version; both paths forced and timed where both fit;
  [generate-moe], [generate-ssm]
             Granite-3.0-1B-A400M and Mamba2-1.3B at full width and depth
             from seeded weights, as [generate] (a) and (b) run Gemma: fp32
             greedy tokens on the card against the CPU (8 x 13 and 1 x 300
             prompts; a row may differ only on a CPU near-tie, a top-2
             logit margin or, for the MoE, a router top-k gap), bf16 times
             and launches of the timed run (every MoE layer's 3 gmm per
             forward, every Mamba layer's ssd per prefill), bf16 logits
             teacher-forced against fp32 (the MoE with the fp32 expert
             choices pinned), a drift held to the reference arithmetic's
             own: the plain path on the CPU, same weights and tokens;
  [serve-moe-ssm]
             a cascade of an encoder tier, a Mamba2 generation tier and a
             Granite-MoE generation tier serving 256 requests twice,
             through all five kernels;
  [kernels]  one line over the five kernels, then the kernels' JSON
             record and the result line.

It exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
N_REQUESTS = 512
REPEAT_FRAC = 0.25
TIERS = ("GPT-J", "ChatGPT", "GPT-4")
THRESHOLDS = (0.5, 0.5)
FLOAT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# bf16 outputs are also held to BF16_REL x max|plain|: kernel and plain
# version both accumulate in fp32 and round once, and one bf16 ulp of an
# output is at most 2^-7 of the largest output, so this allows one
# rounding flip and no more
BF16_REL = 1e-2
FRAGILE = 1e-4           # score-to-threshold gap / top-2 logit margin
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside
# the tensor cores, dense bf16 tensor-core FLOP/s (the bound of bf16 work)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
PEAK_FLOP_S = {"float32": FP32_FLOP_S, "bfloat16": BF16_FLOP_S}
# Gemma-3-1B generation ([generate])
GEN_NEW = 16                 # tokens generated per prompt in (a) and (b)
GEN_FRAGILE = 1e-3           # CPU top-2 margin under which a row may flip
# largest |bf16 - fp32| logit, teacher-forced: bf16 rounds every product
# and residual add to 8 bits, ~2% relative drift over 26 layers, ~0.06
# on the largest of the logits (spread ~0.7); the reasoning is in PERF.md
BF16_LOGIT_TOL = 0.2
N_GEN_REQUESTS = 256
GEN_SERVE_NEW = 4            # tokens a serve's generation tier decodes
GEN_TIMING_REPS = 3          # timed generates per batch in (b), + 1 warm-up
# grouped matmul and SSD scan ([gmm], [ssd]): outputs are sums of up to
# 1024 products of order-1 inputs, so an absolute bound does not scale;
# fp32 is held to FP32_REL x max|plain| (two fp32 summation orders differ
# by ~sqrt(K) 2^-24 ~ 2e-6 of the largest output at K = 1024), bf16 to
# BF16_REL x max|plain| (both sides round an fp32 sum once)
FP32_REL = 1e-5
# MoE and SSM generation ([generate-moe], [generate-ssm])
# a CPU router top-k gap (probability of the k-th minus the (k+1)-th
# expert) under which card and CPU may choose different experts: fp32 on
# the two differs by ~1e-8 in a router probability after 24 layers
ROUTER_FRAGILE = 1e-6
# largest |bf16 - fp32| logit, teacher-forced (the MoE with the fp32
# expert choices pinned), on the card, at most REF_DRIFT_RATIO x the same
# drift of the plain path on the CPU, from the same weights and tokens:
# tests/test_torch_generation.py holds that path's bf16 to the JAX
# package's, so its drift is the reference's own. The card sums in other
# orders, a second draw of the same rounding noise; the largest of ~10^7
# logit differences varies between such draws by well under 1.5x
REF_DRIFT_RATIO = 1.5


def _time_ms(fn, reps: int = 20, rounds: int = 7) -> float:
    """Median over ``rounds`` of CUDA-event time per call of ``reps``
    back-to-back calls, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _device_ms(fns, reps: int = 20, rounds: int = 7) -> float:
    """Median over ``rounds`` of CUDA-event time per call of ``reps``
    calls captured once in a CUDA graph and replayed: the device's time,
    without the host's enqueue. ``fns`` is one callable or a list that the
    captured calls cycle through (say, one per copy of the weights, so
    that they come from HBM and not from L2). Kernel counters are
    restored: no main path runs here."""
    import torch
    fns = fns if isinstance(fns, list) else [fns]
    counters = {k: c.launches for k, c in _counters().items()}
    for f in fns[:3]:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    for k, c in _counters().items():
        c.launches = counters[k]
    return statistics.median(times)


def _agree(out, ref, what: str) -> float:
    """Max abs error of a kernel's output against its plain version on
    the same inputs; raises past the output type's tolerance."""
    import torch
    torch.cuda.synchronize()
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    tol = FLOAT_TOL["float32"]
    if out.dtype == torch.bfloat16:
        tol = min(FLOAT_TOL["bfloat16"], BF16_REL * ref.abs().max().item())
    if not err <= tol:
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"max abs err {err:.3e} > {tol:.3e}")
    return err


def _agree_rel(out, ref, what: str) -> float:
    """Max abs error of a kernel's output against its plain version,
    raising past FP32_REL (fp32) or BF16_REL (bf16) x max|plain|."""
    import torch
    torch.cuda.synchronize()
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    rel = BF16_REL if out.dtype == torch.bfloat16 else FP32_REL
    tol = rel * ref.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"max abs err {err:.3e} > {tol:.3e}")
    return err


def _bound(nbytes, flops, dtype_name):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    HBM's rate and the operations over the peak rate for the type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _tol_text() -> str:
    return (f"fp32 <= {FLOAT_TOL['float32']}, bf16 <= min("
            f"{FLOAT_TOL['bfloat16']}, {BF16_REL} x max|plain|)")


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] torch: {name}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return name, smi


def _ptxas(log: str) -> list[tuple[str, int, int, int, int]]:
    """(kernel, registers, spill stores, spill loads, static shared bytes)
    of every entry function in an ``nvcc -Xptxas=-v`` log, names
    demangled with ``cu++filt`` where the toolkit has it."""
    import re
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = tuple(int(v) for v in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
        elif "Used" in line and "registers" in line and name:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((name, regs, *spills, int(smem.group(1)) if smem
                         else 0))
            name, spills = None, (0, 0)
    from repro_torch.kernels._build import _nvcc
    filt = Path(_nvcc()).parent / "cu++filt"
    if rows and filt.exists():
        names = subprocess.run(
            [str(filt)], input="\n".join(r[0] for r in rows),
            capture_output=True, text=True, timeout=60,
            check=True).stdout.splitlines()
        rows = [(n.replace("<unnamed>::", ""), *r[1:])
                for n, r in zip(names, rows)]
    return rows


def phase_build():
    """Build every kernel; print ptxas's registers, spills and static
    shared bytes per kernel instance (and the gmm instances' dynamic
    shared bytes). A spill in the gmm kernels fails the phase."""
    import ctypes
    from torch.utils.cpp_extension import is_ninja_available
    from repro_torch.kernels._build import BUILD_LOGS, build_all
    from repro_torch.kernels.moe_gmm.ops import INSTANCES
    t = time.perf_counter()
    libs = build_all()
    took = time.perf_counter() - t
    print(f"[build] {len(libs)} kernel libraries in {took:.1f}s "
          f"(nvcc, one process per source; ninja "
          f"{'present' if is_ninja_available() else 'absent'}): "
          f"{sorted(libs)}")
    for family, log in sorted(BUILD_LOGS.items()):
        for name, regs, st, ld, smem in _ptxas(log):
            print(f"  ptxas {family}: {name}: {regs} registers, spill "
                  f"stores {st} B / loads {ld} B, {smem} B static shared")
            if family == "moe_gmm" and (st or ld):
                raise AssertionError(f"moe_gmm instance {name} spills")
    smem = ctypes.CDLL(str(libs["moe_gmm"])).repro_moe_gmm_smem
    print("  moe_gmm dynamic shared bytes: " + ", ".join(
        f"{n} {smem(i)}" for i, n in enumerate(INSTANCES)))


def phase_grad():
    """Each float kernel wrapper refuses, on the card, an input that
    requires grad while grad mode is on (its kernel has no backward yet,
    so its output would carry no gradient), and runs under no_grad."""
    import torch
    from repro_torch.kernels.decode_attention.ops import gqa_decode
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.moe_gmm.ops import gmm
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    r = lambda *shape: torch.randn(*shape, generator=gen,  # noqa: E731
                                   device="cuda").requires_grad_()
    q, k, v = r(2, 16, 4, 64), r(2, 16, 2, 64), r(2, 16, 2, 64)
    calls = {
        "mha": lambda: mha(q, k, v),
        "gqa_decode": lambda: gqa_decode(r(2, 1, 4, 64), k, v, 9),
        "gmm": lambda: gmm(r(4, 8, 64), r(4, 64, 32)),
        "ssd_scan": lambda: ssd_scan(
            r(1, 16, 2, 64), torch.rand(1, 16, 2, device="cuda")
            .requires_grad_(), -torch.ones(2, device="cuda"), r(1, 16, 32),
            r(1, 16, 32), chunk=8)}
    counters = {n: c.launches for n, c in _counters().items()}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as err:
            if "has no backward" not in str(err):
                raise
        else:
            raise AssertionError(f"{name} ran on inputs that require grad")
        with torch.no_grad():
            out = call()
        if out.grad_fn is not None or not torch.isfinite(out).all():
            raise AssertionError(f"{name} under no_grad: grad_fn "
                                 f"{out.grad_fn}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
    for n, c in _counters().items():
        c.launches = counters[n]
    print(f"[grad] {', '.join(calls)}: each refuses a CUDA input that "
          f"requires grad under grad mode and runs under torch.no_grad()")


def _qkv(b, s, h, kvh, hd, dtype, gen):
    import torch
    mk = lambda heads: torch.randn(b, s, heads, hd, generator=gen,  # noqa: E731
                                   device="cuda").to(dtype)
    return mk(h), mk(kvh), mk(kvh)


def phase_flash():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import mha, mha_reference
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    n_checks = 0

    def check(b, s, h, kvh, hd, dtype, causal, window):
        nonlocal worst, n_checks
        q, k, v = _qkv(b, s, h, kvh, hd, dtype, gen)
        err = _agree(mha(q, k, v, causal=causal, window=window),
                     mha_reference(q, k, v, causal=causal, window=window),
                     f"flash_attention at B={b} S={s} H={h} KVH={kvh} "
                     f"hd={hd} {dtype} causal={causal} window={window}")
        if dtype == torch.float32:
            worst = max(worst, err)
        n_checks += 1
        return err, (q, k, v)

    # the serve path: every tier's (H, hd) and the scorer's, at S = 64
    # (tier queries, scorer embeddings) and S = 66 (scorer pairs)
    timed = []
    for s in (64, 66):
        for h, hd in ((2, 16), (2, 24), (3, 32), (4, 32), (5, 32)):
            err, (q, k, v) = check(256, s, h, h, hd, torch.float32, False, 0)
            if (s, h) in ((64, 2), (64, 5), (66, 4)) and hd != 24:
                timed.append(((256, s, h, hd), err, q, k, v))
    # the sweep: ragged S, head dims, masks, GQA, bf16
    masks = ((False, 0), (True, 0), (True, 32), (False, 32))
    for i, s in enumerate((1, 7, 128, 200, 512)):
        for j, hd in enumerate((24, 64, 128)):
            causal, window = masks[(i + j) % len(masks)]
            h, kvh = (8, 2) if (i + j) % 2 else (4, 4)
            check(2, s, h, kvh, hd, torch.float32, causal, window)
    check(2, 200, 8, 2, 64, torch.bfloat16, True, 32)
    check(4, 66, 4, 4, 32, torch.bfloat16, False, 0)
    # Gemma-3-1B prefill: 4 query heads on 1 KV head of 256, causal,
    # window 0 (global layers) and 512 (local), S = 600 past the window
    gemma = []
    for b in (1, 8):
        for s in (13, 64, 600):
            for window in (0, 512):
                for dtype in (torch.float32, torch.bfloat16):
                    _, qkv = check(b, s, 4, 1, 256, dtype, True, window)
                    if dtype == torch.bfloat16 and (b, s) in ((8, 64),
                                                              (1, 600)):
                        gemma.append(((b, s, window), qkv))
    print(f"[flash] {n_checks} shapes agree with the plain version "
          f"(fp32 max abs err {worst:.3e}; {_tol_text()})")

    rows = []
    for (b, s, h, hd), err, q, k, v in timed:
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = _time_ms(lambda: mha(q, k, v, causal=False))
        plain = _time_ms(lambda: mha_reference(q, k, v, causal=False))
        lib = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        nbytes = 4 * b * s * h * hd * 4
        flops = 4 * b * h * s * s * hd
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
        row = {"shape": f"B={b} S={s} H={h} hd={hd}", "max_abs_err": err,
               "ms": ms, "plain_ms": plain, "library_ms": lib,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        rows.append(row)
        print(f"  flash {row['shape']} fp32: kernel {ms:.4f} ms | plain "
              f"{plain:.4f} ms | sdpa {lib:.4f} ms | bound {row['bound_ms']:.4f}"
              f" ms ({row['bound_by']})")
    # the record's time: the scorer's shape (most of the path's launches)
    main = next(r for r in rows if r["shape"] == "B=256 S=66 H=4 hd=32")
    gemma_rows = [_flash_gemma_row(b, s, window, *qkv)
                  for (b, s, window), qkv in gemma]
    return {**main, "sweep_fp32_max_abs_err": worst, "gemma": gemma_rows}


def _causal_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal, optionally windowed mask keeps."""
    return sum(min(i + 1, window) if window else i + 1 for i in range(s))


def _flash_gemma_row(b, s, window, q, k, v):
    """Check flash at a Gemma prefill shape (bf16) against the plain
    version, then time it beside the plain version and SDPA on the same
    inputs. Restores the launch counter: none of this is a main path."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import mha, mha_reference
    h, hd = q.shape[2], q.shape[3]
    before = mha.launches
    err = _agree(mha(q, k, v, causal=True, window=window),
                 mha_reference(q, k, v, causal=True, window=window),
                 f"flash_attention at B={b} S={s} H={h} KVH={k.shape[2]} "
                 f"hd={hd} {q.dtype} causal window={window}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pos = torch.arange(s, device="cuda")
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    ms = _time_ms(lambda: mha(q, k, v, causal=True, window=window))
    mha.launches = before
    plain = _time_ms(lambda: mha_reference(q, k, v, causal=True,
                                           window=window))
    lib = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * k.shape[2] * hd)
    flops = 4 * b * h * _causal_pairs(s, window) * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / BF16_FLOP_S * 1e3
    row = {"shape": f"B={b} S={s} H={h} KVH={k.shape[2]} hd={hd} causal "
                    f"window={window} bf16",
           "max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": lib,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"  flash {row['shape']}: max abs err {err:.2e} | kernel {ms:.4f} "
          f"ms | plain {plain:.4f} ms | sdpa {lib:.4f} ms | bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def phase_compact():
    import torch
    from repro_torch.kernels.cascade_compact.ops import (compact,
                                                         compact_reference)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    n_checks = 0
    worst = 0
    for n in (1, 31, 32, 33, 255, 256, 257, 4096, 100_000):
        for density in (0.0, 0.01, 0.5, 1.0):
            idx = (torch.randperm(n, generator=gen, device="cuda") * 3).int()
            keep = torch.rand(n, generator=gen, device="cuda") < density
            out, cnt = compact(idx, keep, fill=-1)
            ref, rcnt = compact_reference(idx, keep, fill=-1)
            torch.cuda.synchronize()
            worst = max(worst, (out.long() - ref.long()).abs().max().item())
            if int(cnt) != int(rcnt) or not torch.equal(out, ref):
                raise AssertionError(f"cascade_compact differs from its plain "
                                     f"version at n={n} density={density}")
            n_checks += 1
    print(f"[compact] {n_checks} (n, density) cases bit-exact against the "
          f"plain version")
    n = N_REQUESTS                  # first-tier misses of a served batch
    idx = torch.randperm(n, generator=gen, device="cuda").int()
    keep = torch.rand(n, generator=gen, device="cuda") < 0.5
    ms = _time_ms(lambda: compact(idx, keep))
    plain = _time_ms(lambda: compact_reference(idx, keep))
    lib = _time_ms(lambda: idx[keep])
    bound = (n * 4 + n * 1 + n * 4 + 4) / HBM_BYTES_S * 1e3
    print(f"  compact n={n} density 0.5: kernel {ms:.4f} ms | plain "
          f"{plain:.4f} ms | idx[keep] {lib:.4f} ms | bound {bound:.6f} ms "
          f"(bytes)")
    return {"max_abs_err": float(worst), "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bound, "bound_by": "bytes"}


def _requests(n: int = N_REQUESTS, seed: int = SEED + 7):
    """``n`` seeded ``headlines`` queries, ``REPEAT_FRAC`` of them repeats."""
    import numpy as np
    from repro_torch.data import synthetic
    n_base = round(n * (1 - REPEAT_FRAC))
    base = synthetic.sample("headlines", n_base, seed=seed).tokens
    rng = np.random.default_rng(seed)
    rep = base[rng.choice(n_base, n - n_base)]
    toks = np.concatenate([base, rep])
    return toks[rng.permutation(n)]


def _fragile_rows(apis, sp, tokens):
    """Rows where float noise may flip a decision: any tier's top-2 logit
    margin, or any scored tier's score-to-threshold gap, under FRAGILE."""
    import numpy as np
    from repro_torch.core import scorer as SC
    from repro_torch.models.classifier import classifier_logits
    fragile = np.zeros(len(tokens), bool)
    for j, api in enumerate(apis):
        top2 = classifier_logits(api.params, tokens, api.cfg).topk(2).values
        fragile |= (top2[:, 0] - top2[:, 1]).numpy() < FRAGILE
        if j < len(THRESHOLDS):
            s = SC.score(sp, tokens, api.answer(tokens))
            fragile |= np.abs(s.astype(np.float64) - THRESHOLDS[j]) < FRAGILE
    return fragile


def phase_serve():
    import numpy as np
    import torch
    from repro_torch.core import neural_market as NM
    from repro_torch.core import scorer as SC
    from repro_torch.core.prompt import PromptSpec
    from repro_torch.data import synthetic
    from repro_torch.models.classifier import init_classifier
    from repro_torch.serving.builder import (FULL_PROMPT_TOKENS,
                                             assemble_pipeline)

    apis = NM.init_marketplace("headlines", tiers=NM.tier_subset(TIERS),
                               seed=SEED, device="cpu")
    sp = init_classifier(SC.SCORER_CFG, 1, seed=SEED + 100, device="cpu")
    prompts = [PromptSpec((0, 1, 2), 110, 140), PromptSpec((0, 1), 110, 140),
               None]
    tokens = _requests()
    # set-up: one serve through a throwaway pipeline pays the card's
    # first-use costs (context, cuBLAS handles, allocator) outside the
    # timed passes
    t = time.perf_counter()
    assemble_pipeline(apis, sp, THRESHOLDS, prompts, device="cuda",
                      compact="device").serve(tokens)
    torch.cuda.synchronize()
    print(f"[serve] set-up serve (first use of the card): "
          f"{time.perf_counter() - t:.3f}s wall")
    pipe = assemble_pipeline(apis, sp, THRESHOLDS, prompts, device="cuda",
                             compact="device")
    passes, launches = _serve_twice(pipe, tokens, "[serve]")
    print(f"  launches over both passes: {launches} (the encoders decode "
          f"nothing)")
    if min(launches["flash_attention"], launches["cascade_compact"]) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    first, second = passes[0][0], passes[1][0]
    if second.cache_hit_rate != 1.0 or any(second.tier_counts):
        raise AssertionError(f"second pass: hit rate "
                             f"{second.cache_hit_rate}, tier traffic "
                             f"{second.tier_counts}")
    if first.tier_counts[1] >= first.tier_counts[0]:
        raise AssertionError(f"no compaction between tiers: "
                             f"{first.tier_counts}")

    cpu = assemble_pipeline(apis, sp, THRESHOLDS, prompts, device="cpu",
                            compact="device").serve(tokens)
    fragile = _fragile_rows(apis, sp, tokens)
    agree = ((first.stopped_at == cpu.stopped_at)
             & (first.answers == cpu.answers))
    differ = ~agree
    n_diff = int(differ.sum())
    if (differ & ~fragile).any():
        raise AssertionError(f"{int((differ & ~fragile).sum())} rows differ "
                             f"from the CPU serve away from any threshold or "
                             f"logit tie")
    if n_diff > 0.01 * len(tokens):
        raise AssertionError(f"{n_diff} rows differ from the CPU serve "
                             f"(> 1% of {len(tokens)})")
    if not np.array_equal(first.cost[agree], cpu.cost[agree]):
        raise AssertionError("cost differs from the CPU serve on agreeing rows")
    gaps = [abs(a - b) for a, b in zip(first.tier_counts, cpu.tier_counts)]
    if max(gaps) > n_diff:
        raise AssertionError(f"tier counts {first.tier_counts} vs CPU "
                             f"{cpu.tier_counts} beyond the {n_diff} "
                             f"differing rows")
    print(f"  vs CPU serve of the same weights: {n_diff} of {len(tokens)} rows "
          f"differ ({int(fragile.sum())} fragile rows within {FRAGILE} of a "
          f"threshold or logit tie); cost identical on agreeing rows")

    # a cascade that drops the marketplace's priciest tier keeps it as the
    # savings baseline (build_pipeline's rule: the argmax over the whole
    # marketplace of the offline mean cost, each tier with its own prompt)
    part = assemble_pipeline(apis, sp, THRESHOLDS[:1], prompts,
                             cascade=[0, 1], device="cuda", compact="device")
    res = part.serve(tokens)
    n_q = (tokens != synthetic.PAD).sum(-1)
    top = max(range(len(apis)), key=lambda i: float(apis[i].price.query_cost(
        64 + (prompts[i].n_tokens if prompts[i] else FULL_PROMPT_TOKENS), 1)))
    want = float(np.asarray(apis[top].price.query_cost(
        n_q + FULL_PROMPT_TOKENS, np.ones_like(n_q))).sum())
    if not (top == 2 and part.baseline_price == apis[top].price
            and res.baseline_cost == want and len(res.tier_counts) == 2):
        raise AssertionError(f"cascade [0, 1]: baseline {res.baseline_cost} "
                             f"vs the marketplace's priciest tier's {want}")
    print(f"  cascade [GPT-J, ChatGPT] of the 3-tier marketplace: savings "
          f"baseline {apis[top].name}, ${res.baseline_cost:.6f} (by hand "
          f"${want:.6f}), {100 * res.savings_frac:.1f}% saved")
    return launches


def phase_decode():
    """The decode kernel against its plain version at Gemma's decode
    shapes and on a GQA sweep. Returns the max fp32 error."""
    import torch
    from repro_torch.kernels.decode_attention.ops import (decode_reference,
                                                          gqa_decode)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = 0.0
    n_checks = 0

    def check(b, s, h, kvh, hd, length, dtype):
        nonlocal worst, n_checks
        mk = lambda *shape: torch.randn(*shape, generator=gen,  # noqa: E731
                                        device="cuda").to(dtype)
        q, k, v = mk(b, 1, h, hd), mk(b, s, kvh, hd), mk(b, s, kvh, hd)
        err = _agree(gqa_decode(q, k, v, length),
                     decode_reference(q, k, v, length),
                     f"decode_attention at B={b} S={s} H={h} KVH={kvh} "
                     f"hd={hd} length={length} {dtype}")
        if dtype == torch.float32:
            worst = max(worst, err)
        n_checks += 1

    for dtype in (torch.float32, torch.bfloat16):
        # Gemma-3-1B: 4 query heads on 1 KV head of 256
        for b in (1, 8, 64):
            for s in (16, 512, 1024, 4096):
                for length in (1, s // 2 + 3, s):
                    check(b, s, 4, 1, 256, length, dtype)
        # GQA sweep at hd 64 and 128, ragged S, G = 1, 2, 3, 4, 12
        for b, s, h, kvh, hd in ((2, 1000, 8, 2, 64), (3, 77, 12, 4, 128),
                                 (2, 300, 4, 4, 64), (1, 129, 6, 2, 128),
                                 (4, 333, 48, 4, 128), (2, 4100, 32, 8, 128)):
            for length in (1, s // 2 + 3, s):
                check(b, s, h, kvh, hd, length, dtype)
    print(f"[decode] {n_checks} shapes agree with the plain version (fp32 max "
          f"abs err {worst:.3e}; {_tol_text()})")
    for b, s, length in ((8, 32, 20), (64, 32, 20), (8, 1024, 608),
                         (8, 512, 512)):
        _decode_row(b, s, (length,))
    return worst


def _decode_row(b, s, lengths, dtype_name="bfloat16"):
    """Check the decode kernel at a Gemma shape and each of ``lengths``
    against the plain version, then time it at the middle length beside
    the plain version and SDPA (one-token query, ``enable_gqa``) on the
    same inputs. Restores the launch counter: none of this is a main
    path."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (decode_reference,
                                                          gqa_decode)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype_name]
    gen = torch.Generator(device="cuda").manual_seed(SEED + b + s)
    mk = lambda *shape: torch.randn(*shape, generator=gen,  # noqa: E731
                                    device="cuda").to(dtype)
    h, kvh, hd = 4, 1, 256
    q, k, v = mk(b, 1, h, hd), mk(b, s, kvh, hd), mk(b, s, kvh, hd)
    before = gqa_decode.launches
    err = max(_agree(gqa_decode(q, k, v, n), decode_reference(q, k, v, n),
                     f"decode_attention at B={b} S={s} H={h} KVH={kvh} "
                     f"hd={hd} length={n} {dtype_name}") for n in lengths)
    length = lengths[len(lengths) // 2]
    ms = _time_ms(lambda: gqa_decode(q, k, v, length))
    gqa_decode.launches = before
    plain = _time_ms(lambda: decode_reference(q, k, v, length))
    qt = q.transpose(1, 2)
    kt, vt = k[:, :length].transpose(1, 2), v[:, :length].transpose(1, 2)
    lib = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          enable_gqa=True))
    esize = q.element_size()
    nbytes = esize * (2 * b * h * hd + 2 * b * length * kvh * hd)
    flops = 4 * b * h * length * hd
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[dtype_name] * 1e3
    row = {"shape": f"B={b} S={s} length={length} H={h} KVH={kvh} hd={hd} "
                    f"{dtype_name}",
           "max_abs_err": err,
           "checked_lengths": list(lengths), "ms": ms, "plain_ms": plain, "library_ms": lib,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"  decode {row['shape']}: max abs err {err:.2e} over lengths "
          f"{list(lengths)} | kernel {ms:.4f} ms | plain {plain:.4f} ms | "
          f"sdpa {lib:.4f} ms | bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']})")
    return row


def _greedy_trace(params, cfg, prompts, n_new, s_pad=None):
    """Greedy tokens (B, n_new) and each row's smallest top-2 logit margin
    over its steps, from a prefill + decode chain with no batch bucket;
    the prompt is right-padded with token 0 to ``s_pad`` (the engine's
    prompt bucket) and read at its true last position, as the engine
    does."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    s = prompts.shape[1]
    s_pad = s_pad or s
    toks = np.zeros((len(prompts), s_pad), prompts.dtype)
    toks[:, :s] = prompts
    logits, cache = T.prefill(params, {"tokens": toks}, cfg,
                              max_len=s_pad + n_new, last_index=s - 1)
    toks, margins = [], []
    for i in range(n_new):
        top2 = logits[:, -1].topk(2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        toks.append(nxt)
        if i < n_new - 1:
            logits, cache = T.decode_step(params, cache, nxt, s + i, cfg)
    return (torch.cat(toks, 1).cpu().numpy(),
            torch.stack(margins, 1).amin(1).cpu().numpy())


def _forced_logits(params, cfg, prompts, forced):
    """fp32 logits (B, n, V) of every step when ``forced`` (B, n) tokens
    are fed back in place of the model's own choices."""
    import torch
    from repro_torch.models import transformer as T
    s, n = prompts.shape[1], forced.shape[1]
    logits, cache = T.prefill(params, {"tokens": prompts}, cfg,
                              max_len=s + n)
    out = [logits[:, -1]]
    for i in range(n - 1):
        logits, cache = T.decode_step(params, cache, forced[:, i:i + 1],
                                      s + i, cfg)
        out.append(logits[:, -1])
    return torch.stack(out, 1)


def _gen_times(eng, prompts, reps: int = GEN_TIMING_REPS):
    """Median ms of one prefill (``prefill_async`` to the card's end) and
    per decoded token (``decode_from``, which returns host tokens)."""
    import torch
    eng.generate(prompts, GEN_NEW)                     # warm-up
    pre, dec = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fut = eng.prefill_async(prompts, GEN_NEW)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.decode_from(fut)
        t2 = time.perf_counter()
        pre.append((t1 - t) * 1e3)
        dec.append((t2 - t1) * 1e3 / (GEN_NEW - 1))
    return statistics.median(pre), statistics.median(dec)


def _init_model(cfg, tag):
    """Seeded fp32 masters on the CPU for ``cfg`` at full width and depth,
    their copy on the card and its ``cfg.dtype`` cast. Returns (cfg32,
    master, p32, p16)."""
    import dataclasses
    import torch
    from repro_torch.convert import params_to
    from repro_torch.models import transformer as T
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t = time.perf_counter()
    master = T.init_params(cfg32, seed=SEED, device="cpu")
    n_params = sum(x.numel() for x in _tensors(master))
    p32 = params_to(master, "cuda")
    p16 = T.cast_params(p32, cfg)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"vocab {cfg.vocab}, {n_params / 1e9:.3f} B params from seed "
          f"{SEED} ({time.perf_counter() - t:.1f}s to draw and copy)")
    return cfg32, master, p32, p16


def _fp32_vs_cpu(eng32, master, cfg32, prompts, max_excused=1):
    """(a): fp32 greedy generation on the card equals the same weights on
    the CPU, except rows the CPU run marks fragile: a top-2 logit margin
    under GEN_FRAGILE or, in MoE layers, a router top-k gap under
    ROUTER_FRAGILE on a real token (``_route_recorder``). The CPU chain
    takes the exact prompt, so the card's bucketing (right padding) is
    held to it, except where an attention + MoE layer's capacity follows
    the padded length: there the CPU prompt is padded as the engine's."""
    import numpy as np
    from repro_torch.serving.engine import bucket_size
    has_moe = any(sp.ffn == "moe" for sp in cfg32.layers)
    pad_ref = any(sp.ffn == "moe" and sp.mixer.startswith("attn")
                  for sp in cfg32.layers)
    n_rows = n_fragile = 0
    excused = []
    for name, pr in prompts.items():
        t = time.perf_counter()
        card = eng32.generate(pr, GEN_NEW)
        s = pr.shape[1]
        s_b = bucket_size(s, eng32.seq_floor)
        s_eng = s_b if eng32._seq_paddable(s_b) else s
        s_pad = s_eng if pad_ref else s
        with _route_recorder() as rec:
            ref, margin = _greedy_trace(master, cfg32, pr, GEN_NEW, s_pad)
        gap = _router_gaps(rec.calls, s, len(pr), cfg32)
        differ = (card != ref).any(1)
        fragile = (margin < GEN_FRAGILE) | (gap < ROUTER_FRAGILE)
        if (differ & ~fragile).any():
            raise AssertionError(
                f"fp32 generation on the card differs from the CPU on "
                f"{int((differ & ~fragile).sum())} rows of {name} with every "
                f"CPU top-2 margin >= {GEN_FRAGILE} and router gap >= "
                f"{ROUTER_FRAGILE}")
        excused += [f"{name}[{i}] (margin {margin[i]:.1e}, router gap "
                    f"{gap[i]:.1e})" for i in np.flatnonzero(differ)]
        n_rows += len(pr)
        n_fragile += int(fragile.sum())
        routing = (f"; smallest router top-k gap {gap.min():.2e}"
                   if has_moe else "")
        print(f"  (a) fp32 {name} (card prompt padded to {s_eng}, CPU to "
              f"{s_pad}): "
              f"{int((~differ).sum())}/{len(pr)} rows identical to the CPU "
              f"over {GEN_NEW} tokens; smallest CPU top-2 margin "
              f"{margin.min():.2e}{routing} ({time.perf_counter() - t:.1f}s "
              f"with the CPU reference)")
    print(f"  (a) rows that differ on a near-tie: {excused or 'none'} "
          f"({n_fragile} fragile rows of {n_rows})")
    if len(excused) > max_excused:
        raise AssertionError(f"{len(excused)} of {n_rows} rows differ from "
                             f"the CPU (near-ties allow {max_excused})")


class _route_recorder:
    """Context: records (probs, e_idx) of every MoE router call
    (``models.moe.router``); ``pin`` replays a recorded run's expert
    choices, in call order, with this run's own probabilities as weights
    (renormalised), and counts the tokens whose own choice differed."""

    def __init__(self, pin=None):
        self.calls, self.pin, self.flipped, self.tokens = [], pin, 0, 0

    def __enter__(self):
        from repro_torch.models import moe as M
        self._orig = orig = M.router

        def router(p, x, cfg):
            probs, w, e_idx = orig(p, x, cfg)
            if self.pin is not None:
                forced = self.pin[len(self.calls)][1].to(e_idx.device)
                own = e_idx.sort(-1).values
                self.flipped += int((own != forced.sort(-1).values)
                                    .any(-1).sum())
                self.tokens += own.shape[0] * own.shape[1]
                e_idx = forced
                w = probs.gather(-1, e_idx)
                w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
            self.calls.append((probs, e_idx))
            return probs, w, e_idx

        M.router = router
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as M
        M.router = self._orig


def _router_gaps(calls, s, b, cfg):
    """Per row, the smallest gap between the k-th and (k+1)-th router
    probability over the real tokens (the first ``s`` of a prefill call,
    every decode token) of every recorded router call; inf without MoE."""
    import numpy as np
    import torch
    gap = np.full(b, np.inf)
    for probs, _ in calls:
        k = cfg.moe.top_k
        top = torch.topk(probs[:b, :s].float(), k + 1, dim=-1).values
        g = (top[..., k - 1] - top[..., k]).amin(1).cpu().numpy()
        gap = np.minimum(gap, g)
    return gap


def _pinned_logits(p32, p16, cfg32, cfg, prompts, forced):
    """fp32 and bf16 logits teacher-forced on ``forced``, the bf16 run
    taking the fp32 run's expert choices; and the bf16 run's recorder."""
    with _route_recorder() as rec32:
        l32 = _forced_logits(p32, cfg32, prompts, forced)
    with _route_recorder(pin=rec32.calls) as rec:
        l16 = _forced_logits(p16, cfg, prompts, forced)
    return l32, l16, rec


def _bf16_checks(eng16, p16, p32, cfg, cfg32, prompts, timed, tol=None,
                 master=None):
    """(b): ms per prefill and per decoded token of the bf16 engine at
    each batch of ``timed``, with every kernel counter zeroed before and
    read after (the main path's launches); then bf16 logits,
    teacher-forced on the bf16 engine's own tokens, against fp32 within
    ``tol`` or, given the fp32 ``master`` weights on the CPU, within
    REF_DRIFT_RATIO x the same drift of the plain path there (the
    reference's arithmetic) on the same tokens. In MoE layers the bf16
    run takes the fp32 run's expert choices (``_route_recorder(pin=...)``):
    a near-tie that bf16 rounding flips swaps whole experts, which no
    rounding bound covers; the flipped choices are counted. Returns
    (times, launches)."""
    import torch
    from repro_torch.models import transformer as T
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    times = {}
    for b, pr in timed.items():
        times[b] = _gen_times(eng16, pr)
        print(f"  (b) bf16 B={b} prompt {pr.shape[1]}, {GEN_NEW} new: "
              f"{times[b][0]:.2f} ms per prefill, {times[b][1]:.2f} ms per "
              f"decoded token")
    launches = {k: c.launches for k, c in counters.items()}
    print(f"  (b) launches over the timed generation: {launches}")
    has_moe = any(sp.ffn == "moe" for sp in cfg.layers)
    m16 = None if master is None else T.cast_params(master, cfg)
    worst, over = 0.0, []
    for name, pr in prompts.items():
        out16 = eng16.generate(pr, GEN_NEW)
        forced = torch.from_numpy(out16).to("cuda")
        l32, l16, rec = _pinned_logits(p32, p16, cfg32, cfg, pr, forced)
        diff = (l16 - l32).abs().max().item()
        agree = (l16.argmax(-1) == l32.argmax(-1)).float().mean().item()
        own = (l16.argmax(-1).cpu().numpy() == out16).mean()
        worst = max(worst, diff)
        pinned = (f"; the fp32 expert choices pinned, bf16's own differed "
                  f"on {rec.flipped} of {rec.tokens} token-layers"
                  if has_moe else "")
        print(f"  (b) bf16 {name} teacher-forced through fp32: max |logit "
              f"diff| {diff:.4f} (logit std {l32.std().item():.3f}); argmax "
              f"agrees with fp32 on {agree:.3f} of steps, with the bf16 "
              f"engine's own tokens on {own:.3f}{pinned}")
        if m16 is not None:
            t = time.perf_counter()
            c32, c16, _ = _pinned_logits(master, m16, cfg32, cfg, pr,
                                         forced.cpu())
            ref = (c16 - c32).abs().max().item()
            bound = REF_DRIFT_RATIO * ref
            print(f"  (b) bf16 {name}, the plain path on the CPU (the "
                  f"reference's arithmetic), same tokens: max |logit diff| "
                  f"{ref:.4f}; card / CPU drift {diff / ref:.3f} (bound "
                  f"{REF_DRIFT_RATIO}); card vs CPU: bf16 "
                  f"{(l16.cpu() - c16).abs().max().item():.4f}, fp32 "
                  f"{(l32.cpu() - c32).abs().max().item():.2e} "
                  f"({time.perf_counter() - t:.1f}s on the CPU)")
            if not diff <= bound:
                over.append(f"{name}: {diff:.4f} > {REF_DRIFT_RATIO} x "
                            f"{ref:.4f}")
            del c16, c32
        del l16, l32
    if over:
        raise AssertionError(f"bf16 logits drift from fp32 on the card more "
                             f"than the reference's arithmetic: {over}")
    if tol is not None and not worst <= tol:
        raise AssertionError(f"bf16 logits differ from fp32 by {worst:.4f} > "
                             f"{tol}")
    return times, launches


def _counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels.cascade_compact.ops import compact
    from repro_torch.kernels.decode_attention.ops import gqa_decode
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.moe_gmm.ops import gmm
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    return {"flash_attention": mha, "cascade_compact": compact,
            "decode_attention": gqa_decode, "moe_gmm": gmm,
            "ssd_scan": ssd_scan}


def phase_generate():
    """Gemma-3-1B at full width on the card: (a) fp32 greedy tokens equal
    the CPU's, (b) bf16 times and bf16-vs-fp32 logits, (c) a two-tier
    cascade with a generation tier, served twice. Returns the launch
    counts of (c) and the kernels' times at its shapes."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.cost import TABLE1
    from repro_torch.data import synthetic
    from repro_torch.serving.engine import (EnginePool, GenerationEngine,
                                            bucket_size, generation_tier)

    cfg = ARCHS["gemma3-1b"]                         # bf16, the config's own
    cfg32, master, p32, p16 = _init_model(cfg, "generate")
    rng = np.random.default_rng(SEED + 13)
    prompts = {"8x13": rng.integers(1, cfg.vocab, (8, 13)).astype(np.int32),
               "1x600": rng.integers(1, cfg.vocab, (1, 600)).astype(np.int32)}

    # (a) fp32 on the card == fp32 on the CPU, up to near-tie rows
    _fp32_vs_cpu(GenerationEngine(cfg32, p32, device="cuda"), master, cfg32,
                 prompts)
    del master

    # (b) bf16: times, and logits teacher-forced against fp32
    eng16 = GenerationEngine(cfg, p16, device="cuda")
    timed = {8: prompts["8x13"],
             64: rng.integers(1, cfg.vocab, (64, 13)).astype(np.int32)}
    _bf16_checks(eng16, p16, p32, cfg, cfg32, prompts, timed, BF16_LOGIT_TOL)
    del p32
    torch.cuda.empty_cache()

    # (c) serve: an encoder tier, then a Gemma generation tier
    n_classes = synthetic.N_CLASSES["headlines"]
    pool = EnginePool(max_new_tokens=GEN_SERVE_NEW)
    top_price = TABLE1["GPT-4"]
    gen = generation_tier(cfg.name, pool.get(cfg, p16, device="cuda"),
                          top_price,
                          decode_answer=lambda g: g[:, 0] % n_classes,
                          n_new=GEN_SERVE_NEW)
    pipe = _cascade_pipeline([(gen, top_price)])
    tokens = _requests(N_GEN_REQUESTS, SEED + 17)
    passes, launches = _serve_twice(pipe, tokens, "[generate] (c)")
    first, second = passes[0][0], passes[1][0]
    n_gen = first.tier_counts[1]
    chunks = [min(pipe.batch_size, n_gen - i)
              for i in range(0, n_gen, pipe.batch_size)]
    s_q = tokens.shape[1]
    buckets = {(bucket_size(c, 8), bucket_size(s_q, 16),
                bucket_size(bucket_size(s_q, 16) + GEN_SERVE_NEW, 16))
               for c in chunks}
    stats = pool.compile_stats
    print(f"  (c) launches over both passes: {launches}; generation tier "
          f"served {n_gen} rows in buckets {sorted(buckets)}; pool "
          f"{stats}")
    if min(launches[k] for k in ("flash_attention", "decode_attention")) <= 0:
        raise AssertionError(f"an attention kernel never launched: "
                             f"{launches}")
    if n_gen == 0 or stats["prefill_compiles"] > len(buckets):
        raise AssertionError(f"generation tier: {n_gen} rows, "
                             f"{stats['prefill_compiles']} buckets > "
                             f"{len(buckets)}")
    if second.cache_hit_rate != 1.0 or any(second.tier_counts):
        raise AssertionError(f"second pass: hit rate "
                             f"{second.cache_hit_rate}, tier traffic "
                             f"{second.tier_counts}")
    if not (first.answers[first.stopped_at == 1] < n_classes).all():
        raise AssertionError("generation tier answered outside its classes")

    # the kernels checked and timed at every shape the Gemma tier gave
    # them: each bucket's prefill (causal; local and global layers) and
    # its decode steps, on the full cache of max_len slots and the ring
    # of min(window, max_len), at lengths min(pos + 1, slots)
    positions = range(s_q, s_q + GEN_SERVE_NEW - 1)
    gen_rng = torch.Generator(device="cuda").manual_seed(SEED + 19)
    decode_rows, flash_rows = [], []
    for b_b, s_b, max_len in sorted(buckets, reverse=True):
        for slots in sorted({max_len, min(cfg.window, max_len)}):
            lengths = tuple(sorted({min(p + 1, slots) for p in positions}))
            decode_rows.append(_decode_row(b_b, slots, lengths))
        q, k, v = (torch.randn(b_b, s_b, heads, cfg.head_dim,
                               generator=gen_rng, device="cuda").bfloat16()
                   for heads in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
        flash_rows += [_flash_gemma_row(b_b, s_b, window, q, k, v)
                       for window in (cfg.window, 0)]
    return launches, decode_rows, flash_rows


def _cascade_pipeline(gens):
    """The generation serve's pipeline: the GPT-J encoder tier (prompt
    adapted) from seeded weights, then the generation tiers ``gens``
    [(Tier, ApiCost)], each scored against a 0.5 threshold by the seeded
    scorer, behind the completion cache, with on-device compaction."""
    import functools
    from repro_torch.core import neural_market as NM
    from repro_torch.core import scorer as SC
    from repro_torch.core.approx import CompletionCache, embed_queries
    from repro_torch.core.prompt import PromptSpec
    from repro_torch.data import synthetic
    from repro_torch.models.classifier import init_classifier
    from repro_torch.serving.builder import FULL_PROMPT_TOKENS
    from repro_torch.serving.pipeline import ServingPipeline, TierSpec
    api = NM.init_marketplace("headlines", tiers=NM.tier_subset(["GPT-J"]),
                              seed=SEED, device="cuda")[0]
    sp = init_classifier(SC.SCORER_CFG, 1, seed=SEED + 100, device="cuda")
    tiers = [TierSpec(api.name, api.answer, api.price,
                      prompt=PromptSpec((0, 1, 2), 110, 140))]
    tiers += [TierSpec(g.name, g.answer, price, n_out=GEN_SERVE_NEW)
              for g, price in gens]
    return ServingPipeline(
        tiers=tiers, thresholds=(0.5,) * len(gens),
        scorer=lambda toks, ans: SC.score(sp, toks, ans),
        cache=CompletionCache(capacity=1024, threshold=0.995),
        embed=functools.partial(embed_queries, sp, cfg=SC.SCORER_CFG),
        full_prompt_tokens=FULL_PROMPT_TOKENS, pad_token=synthetic.PAD,
        baseline_price=gens[-1][1], compact="device", device="cuda")


def _serve_twice(pipe, tokens, label):
    """Serve ``tokens`` twice with every kernel counter zeroed before and
    read after (the main path's launches). Returns ([(result, wall s)],
    launches by kernel)."""
    import torch
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    passes = []
    for _ in range(2):
        t = time.perf_counter()
        res = pipe.serve(tokens)
        torch.cuda.synchronize()
        passes.append((res, time.perf_counter() - t))
    launches = {k: c.launches for k, c in counters.items()}
    for i, (res, wall) in enumerate(passes):
        print(f"{label} pass {i + 1} ({wall:.3f}s wall): {res.summary()}")
    return passes, launches


# -- kernel 4: the grouped expert matmul -----------------------------------

# Granite-3.0-1B-A400M's expert shapes: E 32, d 1024, d_expert 512; C =
# b x cap: prefill of 16-token buckets (cap 5) at B = 8 and 64, decode
# (cap 1) at B = 8 and 64, and the MoE/SSM serve's prefill bucket of 64
# rows of 64 tokens (cap 20); "gate/up" (K 1024, F 512) and "down" (512,
# 1024)
GMM_TIMED = [(f"{kind} {phase} B={b}", c, k, f)
             for phase, b, c in (("decode", 8, 8), ("decode", 64, 64),
                                 ("prefill", 8, 40), ("prefill", 64, 320),
                                 ("serve prefill S=64", 64, 1280))
             for kind, k, f in (("gate/up", 1024, 512), ("down", 512, 1024))]
# the masked scalar-load instance at a prefill-sized shape (K, F no
# multiple of 8)
GMM_TIMED_UNALIGNED = [("unaligned K 1020 F 516", 40, 1020, 516)]
# the two swapped-operand instances that can run a decode group of C 8,
# timed against each other at Granite's C 8 shapes
GMM_SWAPPED = ("bf16_tc_swap_c8", "bf16_tc_swap_c16")
# the sweep: every instance (C <= 8 and <= 16 swapped, 64 x 128 and
# 128 x 128 tiles, masked scalar loads), ragged C / K / F, C 1 to 320
GMM_SWEEP = ((32, 1, 1024, 512), (32, 8, 1024, 512), (32, 8, 512, 1024),
             (32, 13, 1024, 512), (32, 16, 512, 1024), (32, 40, 1024, 512),
             (32, 64, 512, 1024), (32, 127, 1024, 512), (32, 128, 512, 1024),
             (32, 320, 1024, 512), (3, 77, 33, 130), (2, 33, 100, 65),
             (5, 200, 72, 40), (1, 7, 5, 3), (4, 5, 24, 1000),
             (2, 300, 1000, 24))
# copies of a timed row's inputs that the timed calls cycle through, more
# bytes than the 50 MB L2 holds, so that each call reads them from HBM as
# the model's layers do
COLD_BYTES = 100e6


def phase_gmm():
    """The grouped matmul against its plain version on a sweep (fp32 and
    bf16, every kernel instance, ragged C / K / F, a base pointer off 16
    bytes), then at Granite's own shapes and one unaligned shape, timed
    beside the plain version and ``torch.bmm``."""
    import torch
    from repro_torch.kernels.moe_gmm.ops import INSTANCES, gmm, gmm_reference
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    worst, n_checks, taken = 0.0, 0, {}
    before = gmm.launches
    for dtype in (torch.float32, torch.bfloat16):
        for (e, c, k, f), offset in [(shape, 0) for shape in GMM_SWEEP] + [
                ((32, 40, 1024, 512), 1), ((32, 8, 1024, 512), 1)]:
            # offset 1: x starts one element past an aligned address
            buf = torch.randn(e * c * k + offset, generator=gen,
                              device="cuda").to(dtype)
            x = buf[offset:].view(e, c, k)
            w = torch.randn(e, k, f, generator=gen, device="cuda").to(dtype)
            what = (f"moe_gmm at E={e} C={c} K={k} F={f} {dtype}"
                    f"{' x off 16 B' if offset else ''}")
            err = _agree_rel(gmm(x, w), gmm_reference(x, w), what)
            taken.setdefault(gmm.last_instance, []).append(
                f"{c}x{k}x{f}{'+1' if offset else ''}")
            if dtype == torch.float32:
                worst = max(worst, err)
            n_checks += 1
    gmm.launches = before
    print(f"[gmm] {n_checks} shapes agree with the plain version (fp32 max "
          f"abs err {worst:.3e}; fp32 <= {FP32_REL} x max|plain|, bf16 <= "
          f"{BF16_REL} x max|plain|)")
    for name in INSTANCES:
        print(f"  instance {name}: {taken.get(name, [])}")
    if set(taken) != set(INSTANCES):
        raise AssertionError(f"the sweep missed instances "
                             f"{set(INSTANCES) - set(taken)}")
    rows = gmm_timed_rows(GMM_TIMED + GMM_TIMED_UNALIGNED)
    swapped = [_gmm_instance_times(label, 32, c, k, f)
               for label, c, k, f in GMM_TIMED if c <= 8]
    return {**rows[0], "sweep_fp32_max_abs_err": worst,
            "sweep_instances": {n: len(v) for n, v in taken.items()},
            "granite": rows, "swapped_at_c8": swapped}


def gmm_timed_rows(shapes=GMM_TIMED):
    """``_gmm_row`` at each (label, C, K, F) of ``shapes``, E 32. It calls
    ``gmm`` and ``gmm_reference`` alone, so it times any version of the
    package that is first on ``sys.path``: run it on a ``git archive`` of
    an earlier commit and on the tree, in turns, in one call, to compare
    the two by the same method."""
    return [_gmm_row(label, 32, c, k, f) for label, c, k, f in shapes]


def _gmm_inputs(e, c, k, f):
    """Copies of bf16 (x, w) at one shape, w scaled as Granite's weights,
    enough that cycling through them reads more than L2 holds."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + c + k)
    nbytes = 2 * (e * c * k + e * k * f + e * c * f)
    return [(torch.randn(e, c, k, generator=gen, device="cuda").bfloat16(),
             (0.02 * torch.randn(e, k, f, generator=gen, device="cuda"))
             .bfloat16())
            for _ in range(max(1, math.ceil(COLD_BYTES / nbytes)))], nbytes


def _gmm_row(label, e, c, k, f):
    """Check the grouped matmul at one of Granite's shapes (bf16), then
    time it beside the plain version and ``torch.bmm`` on the same inputs,
    two ways: ``ms`` as every kernel's (back-to-back calls on one warm set
    of inputs, the host's enqueue included), and ``device_ms`` (a CUDA
    graph of calls cycling through copies that overflow L2, as the model's
    layers read their weights). Restores the launch counter: none of this
    is a main path."""
    import torch
    from repro_torch.kernels.moe_gmm.ops import gmm, gmm_reference
    copies, nbytes = _gmm_inputs(e, c, k, f)
    x, w = copies[0]
    before = gmm.launches
    err = _agree_rel(gmm(x, w), gmm_reference(x, w),
                     f"moe_gmm at Granite's {label}")
    # an earlier version of the wrapper may not report its instance
    instance = getattr(gmm, "last_instance", None)
    ms = _time_ms(lambda: gmm(x, w))
    dev = _device_ms([lambda x=x, w=w: gmm(x, w) for x, w in copies])
    gmm.launches = before
    plain = _time_ms(lambda: gmm_reference(x, w))
    plain_dev = _device_ms([lambda x=x, w=w: gmm_reference(x, w)
                            for x, w in copies])
    lib = _time_ms(lambda: torch.bmm(x, w))
    lib_dev = _device_ms([lambda x=x, w=w: torch.bmm(x, w)
                          for x, w in copies])
    bound, by = _bound(nbytes, 2 * e * c * k * f, "bfloat16")
    row = {"shape": f"{label}: E={e} C={c} K={k} F={f} bf16",
           "instance": instance, "max_abs_err": err, "ms": ms,
           "plain_ms": plain, "library_ms": lib, "device_ms": dev,
           "plain_device_ms": plain_dev, "library_device_ms": lib_dev,
           "bound_ms": bound, "bound_by": by}
    print(f"  gmm {row['shape']} [{instance}]: max abs err {err:.2e} | "
          f"back-to-back: kernel {ms:.4f} ms, plain {plain:.4f} ms, bmm "
          f"{lib:.4f} ms (kernel / bmm {ms / lib:.2f}, faster than plain "
          f"{'yes' if ms < plain else 'NO'}) | device, L2 cold: kernel "
          f"{dev:.4f} ms, plain {plain_dev:.4f} ms, bmm {lib_dev:.4f} ms "
          f"(kernel / bmm {dev / lib_dev:.2f}) | bound {bound:.4f} ms ({by})")
    return row


def _gmm_instance_times(label, e, c, k, f):
    """Each of GMM_SWAPPED forced at one decode shape: checked against the
    plain version, timed both ways as in ``_gmm_row``."""
    from repro_torch.kernels.moe_gmm.ops import gmm, gmm_reference
    copies, _ = _gmm_inputs(e, c, k, f)
    x, w = copies[0]
    before, times = gmm.launches, {}
    for name in GMM_SWAPPED:
        _agree_rel(gmm(x, w, instance=name), gmm_reference(x, w),
                   f"moe_gmm instance {name} at Granite's {label}")
        times[name] = {
            "ms": _time_ms(lambda: gmm(x, w, instance=name)),
            "device_ms": _device_ms([
                lambda x=x, w=w: gmm(x, w, instance=name)
                for x, w in copies])}
    gmm.launches = before
    print(f"  gmm {label} C={c} K={k} F={f}, each swapped instance forced: "
          + " | ".join(f"{n} {t['ms']:.4f} ms back-to-back, "
                       f"{t['device_ms']:.4f} ms device"
                       for n, t in times.items()))
    return {"shape": f"{label}: E={e} C={c} K={k} F={f} bf16", **times}


# -- kernel 5: the SSD chunked scan ----------------------------------------

def _ssd_inputs(b, s, h, p, n, dtype, gen):
    """x, B, C ~ N(0, 1) in ``dtype``; dt = softplus(N(0, 1)) and a =
    -exp(0.3 N(0, 1)) in fp32 (tests/test_kernels.py's draws)."""
    import torch
    import torch.nn.functional as F
    mk = lambda *shape: torch.randn(*shape, generator=gen,  # noqa: E731
                                    device="cuda")
    return (mk(b, s, h, p).to(dtype), F.softplus(mk(b, s, h)),
            -torch.exp(0.3 * mk(h)), mk(b, s, n).to(dtype),
            mk(b, s, n).to(dtype))


# (B, S, H, P, N, chunk) of the sweep: S a multiple of the chunk and
# ragged; chunks that fit shared memory whole (single pass) and longer
# ones (sub-tiled: 256 as in SSMCfg's default and Jamba, at S = 300 and
# 600, in either type, and 1000), and chunks on either side of a sub-tile
# (64 rows in fp32, 128 in bf16: 65, 129)
SSD_SWEEP = ((1, 64, 2, 32, 16, 32), (2, 256, 4, 64, 32, 64),
             (2, 77, 3, 32, 16, 32), (8, 13, 64, 64, 128, 13),
             (1, 300, 64, 64, 128, 128), (2, 256, 8, 64, 128, 128),
             (3, 1, 4, 64, 128, 128), (2, 200, 4, 64, 128, 65),
             (2, 200, 4, 64, 128, 129), (1, 300, 64, 64, 128, 256),
             (1, 600, 64, 64, 128, 256), (1, 1000, 8, 64, 128, 1000))
# (B, S, chunk, type) at Mamba2-1.3B's H, P, N where both paths can run,
# each forced and timed: the chunk of a sub-tile in either type, and
# Mamba2's chunk in fp32 (the card's fp32 generation runs it)
SSD_BOTH_PATHS = ((1, 300, 128, "bfloat16"), (1, 300, 64, "float32"),
                  (1, 300, 128, "float32"))


def phase_ssd():
    """The SSD scan against its plain version, y and final state, on a
    sweep (fp32 and bf16; S a multiple of the chunk and ragged; both
    kernel paths, chunk 256 at S = 300 and 600) and at Mamba2-1.3B's and
    a Jamba-shaped prefill, timed."""
    import torch
    from repro_torch.kernels.ssd_scan.ops import (PATHS, ssd_reference,
                                                  ssd_scan)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    worst, n_checks, taken = 0.0, 0, {}
    before = ssd_scan.launches
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, p, n, chunk in SSD_SWEEP:
            args = _ssd_inputs(b, s, h, p, n, dtype, gen)
            what = f"ssd_scan at B={b} S={s} H={h} P={p} N={n} chunk={chunk}"
            y, state = ssd_scan(*args, chunk=chunk, return_state=True)
            taken.setdefault((str(dtype)[6:], ssd_scan.last_path),
                             set()).add(min(chunk, s))
            ry, rstate = ssd_reference(*args, chunk=min(chunk, s))
            err = _agree_rel(y, ry, f"{what} {dtype}, y")
            # the state is fp32 on both sides, whatever the input type
            _agree_rel(state, rstate, f"{what} {dtype}, final state")
            if dtype == torch.float32:
                worst = max(worst, err)
            n_checks += 1
            del args, y, state, ry, rstate
    ssd_scan.launches = before
    by_path = " ".join(f"{t}/{p} {sorted(c)}" for (t, p), c in taken.items())
    print(f"[ssd] {n_checks} shapes agree with the plain version, y and "
          f"final state (fp32 max abs err {worst:.3e}; fp32 <= {FP32_REL} x "
          f"max|plain|, bf16 y <= {BF16_REL} x max|plain|); chunks by type "
          f"and path: {by_path}")
    if {p for _, p in taken} != set(PATHS) or len(taken) != 2 * len(PATHS):
        raise AssertionError(f"a kernel path never ran: {set(taken)}")
    rows = [_ssd_row(b, s) for b, s in ((8, 13), (64, 13), (1, 300),
                                        (64, 64))]
    jamba = _ssd_row(1, 300, h=128, chunk=256, tag="Jamba-shaped ")
    both = [_ssd_path_times(*shape) for shape in SSD_BOTH_PATHS]
    return {**rows[0], "sweep_fp32_max_abs_err": worst, "library_ms": None,
            "mamba2": rows, "jamba": jamba, "both_paths": both}


def _ssd_path_times(b, s, chunk, dtype_name, h=64, p=64, n=128):
    """Each path forced at one chunk that both can run: checked against
    the plain version (y and state), timed as in ``_ssd_row``."""
    import torch
    from repro_torch.kernels.ssd_scan.ops import (PATHS, ssd_reference,
                                                  ssd_scan)
    gen = torch.Generator(device="cuda").manual_seed(SEED + b + s)
    args = _ssd_inputs(b, s, h, p, n, getattr(torch, dtype_name), gen)
    ry, rstate = ssd_reference(*args, chunk=chunk)
    before, times = ssd_scan.launches, {}
    for path in PATHS:
        what = f"ssd_scan path {path} at B={b} S={s} chunk={chunk}"
        y, state = ssd_scan(*args, chunk=chunk, return_state=True, path=path)
        _agree_rel(y, ry, f"{what} {dtype_name}, y")
        _agree_rel(state, rstate, f"{what} {dtype_name}, final state")
        times[path] = _time_ms(lambda: ssd_scan(
            *args, chunk=chunk, return_state=True, path=path))
    ssd_scan.launches = before
    shape = f"B={b} S={s} H={h} P={p} N={n} chunk={chunk} {dtype_name}"
    print(f"  ssd {shape}, each path forced: " + " | ".join(
        f"{k} {v:.4f} ms" for k, v in times.items()))
    return {"shape": shape, **{f"{k}_ms": v for k, v in times.items()}}


def _ssd_row(b, s, h=64, p=64, n=128, chunk=128, tag=""):
    """Check the SSD scan at Mamba2-1.3B's shape for a (B, S) prefill
    (bf16, dt fp32), or another model's with ``h`` / ``chunk``, and time
    it beside the plain version. No single PyTorch call computes this
    function, so there is no library time. Restores the launch counter:
    none of this is a main path."""
    import torch
    from repro_torch.kernels.ssd_scan.ops import ssd_reference, ssd_scan
    gen = torch.Generator(device="cuda").manual_seed(SEED + b + s)
    args = _ssd_inputs(b, s, h, p, n, torch.bfloat16, gen)
    q = min(chunk, s)
    before = ssd_scan.launches
    y, state = ssd_scan(*args, chunk=q, return_state=True)
    path = ssd_scan.last_path
    ry, rstate = ssd_reference(*args, chunk=q)
    err = _agree_rel(y, ry, f"ssd_scan at {tag}B={b} S={s} H={h}")
    _agree_rel(state, rstate, f"ssd_scan at {tag}B={b} S={s} H={h}, state")
    ms = _time_ms(lambda: ssd_scan(*args, chunk=q, return_state=True))
    ssd_scan.launches = before
    plain = _time_ms(lambda: ssd_reference(*args, chunk=q))
    nbytes = (2 * 2 * b * s * h * p + 4 * b * s * h + 4 * h
              + 2 * 2 * b * s * n + 4 * b * h * p * n)
    flops = 0
    for t0 in range(0, s, q):             # per chunk of L true rows
        ell = min(q, s - t0)
        pairs = ell * (ell + 1) // 2
        flops += b * (pairs * 2 * n                      # C.B, per batch row
                      + h * (pairs * 2 * p               # M (x dt)
                             + 2 * ell * 2 * p * n))     # C.state, state upd
    bound, by = _bound(nbytes, flops, "bfloat16")
    row = {"shape": f"{tag}B={b} S={s} H={h} P={p} N={n} chunk={q} bf16",
           "path": path, "max_abs_err": err, "ms": ms, "plain_ms": plain,
           "library_ms": None, "bound_ms": bound, "bound_by": by}
    print(f"  ssd {row['shape']} [{path}]: max abs err {err:.2e} | kernel "
          f"{ms:.4f} ms | plain {plain:.4f} ms | no library call | bound "
          f"{bound:.5f} ms ({by})")
    return row


# -- the MoE and SSM generation tiers --------------------------------------

def phase_generate_family(name, tag):
    """One model at full width and depth from seeded weights, as
    [generate] (a) and (b) run Gemma: fp32 greedy tokens on the card
    against the CPU for 8 x 13 and 1 x 300-token prompts (16 new), bf16
    times per prefill and per decoded token at B = 8 and 64 with the
    launches of that timed run, bf16 logits teacher-forced against fp32
    within REF_DRIFT_RATIO x the drift of the same weights and tokens on
    the CPU's plain path. Returns (bf16 params, times, launches)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.serving.engine import GenerationEngine
    cfg = ARCHS[name]
    cfg32, master, p32, p16 = _init_model(cfg, tag)
    rng = np.random.default_rng(SEED + 23)
    prompts = {"8x13": rng.integers(1, cfg.vocab, (8, 13)).astype(np.int32),
               "1x300": rng.integers(1, cfg.vocab, (1, 300)).astype(np.int32)}
    _fp32_vs_cpu(GenerationEngine(cfg32, p32, device="cuda"), master, cfg32,
                 prompts, max_excused=2)
    eng16 = GenerationEngine(cfg, p16, device="cuda")
    timed = {8: prompts["8x13"],
             64: rng.integers(1, cfg.vocab, (64, 13)).astype(np.int32)}
    times, launches = _bf16_checks(eng16, p16, p32, cfg, cfg32, prompts,
                                   timed, master=master)
    del master
    # every generate of the timed run: one prefill and GEN_NEW - 1 decode
    # steps; SwiGLU MoE layers launch 3 gmm per forward, Mamba layers one
    # ssd per prefill (decode is a one-step update)
    n_generates = len(timed) * (GEN_TIMING_REPS + 1)
    n_moe = sum(sp.ffn == "moe" for sp in cfg.layers)
    n_mamba = sum(sp.mixer == "mamba" for sp in cfg.layers)
    expect = {"moe_gmm": n_generates * 3 * n_moe * GEN_NEW,
              "ssd_scan": n_generates * n_mamba}
    print(f"  (b) expected from the layer pattern: {expect}")
    for kernel, n in expect.items():
        if launches[kernel] != n:
            raise AssertionError(f"{kernel}: {launches[kernel]} launches on "
                                 f"the timed generation, expected {n}")
    if not any(launches[k] for k in expect):
        raise AssertionError(f"no MoE or SSM kernel launched: {launches}")
    del p32, eng16
    torch.cuda.empty_cache()
    return p16, times, launches


def phase_serve_moe_ssm(p_ssm, p_moe):
    """A cascade of the GPT-J encoder tier, a Mamba2-1.3B generation tier
    and a Granite-MoE generation tier (bf16, first generated token mod the
    classes, 4 new tokens), serving 256 requests twice. Returns the
    launches of the five kernels over the two passes."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.cost import TABLE1
    from repro_torch.data import synthetic
    from repro_torch.serving.engine import EnginePool, generation_tier
    n_classes = synthetic.N_CLASSES["headlines"]
    pool = EnginePool(max_new_tokens=GEN_SERVE_NEW)
    gens = []
    for name, params, price in (("mamba2-1.3b", p_ssm, "ChatGPT"),
                                ("granite-moe-1b-a400m", p_moe, "GPT-4")):
        eng = pool.get(ARCHS[name], params, device="cuda")
        gens.append((generation_tier(
            name, eng, TABLE1[price],
            decode_answer=lambda g: g[:, 0] % n_classes,
            n_new=GEN_SERVE_NEW), TABLE1[price]))
    pipe = _cascade_pipeline(gens)
    passes, launches = _serve_twice(pipe, _requests(N_GEN_REQUESTS,
                                                    SEED + 29),
                                    "[serve-moe-ssm]")
    first, second = passes[0][0], passes[1][0]
    print(f"  launches over both passes: {launches}; pool "
          f"{pool.compile_stats}")
    if min(first.tier_counts) <= 0 or min(launches.values()) <= 0:
        raise AssertionError(f"a tier saw no traffic or a kernel never "
                             f"launched: tiers {first.tier_counts}, "
                             f"launches {launches}")
    if second.cache_hit_rate != 1.0 or any(second.tier_counts):
        raise AssertionError(f"second pass: hit rate "
                             f"{second.cache_hit_rate}, tier traffic "
                             f"{second.tier_counts}")
    if not (first.answers[first.stopped_at >= 1] < n_classes).all():
        raise AssertionError("a generation tier answered outside its classes")
    return launches


def _tensors(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package at {src / 'repro_torch'}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    t0 = time.perf_counter()
    kind, smi = phase_device()
    phase_build()
    phase_grad()
    flash = phase_flash()
    comp = phase_compact()
    serve_launches = phase_serve()
    decode_err = phase_decode()
    gen_launches, decode_rows, flash_gen_rows = phase_generate()
    flash["gemma"] += flash_gen_rows
    gmm_rec = phase_gmm()
    ssd_rec = phase_ssd()
    p_moe, moe_times, moe_launches = phase_generate_family(
        "granite-moe-1b-a400m", "generate-moe")
    p_ssm, ssm_times, ssm_launches = phase_generate_family(
        "mamba2-1.3b", "generate-ssm")
    mix_launches = phase_serve_moe_ssm(p_ssm, p_moe)
    paths = {"serve": serve_launches, "generate": gen_launches,
             "generate-moe": moe_launches, "generate-ssm": ssm_launches,
             "serve-moe-ssm": mix_launches}

    def record(name, source, replaces, fields):
        by_path = {k: v.get(name, 0) for k, v in paths.items()}
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/{source}",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, **fields}

    records = [
        record("flash_attention", "flash_attention/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:69", flash),
        record("cascade_compact", "cascade_compact/cascade_compact.cu",
               "src/repro/kernels/cascade_compact/kernel.py:56", comp),
        record("decode_attention", "decode_attention/decode_attention.cu",
               "src/repro/kernels/decode_attention/kernel.py:58",
               {**decode_rows[0],
                "max_abs_err": max(r["max_abs_err"] for r in decode_rows),
                "sweep_fp32_max_abs_err": decode_err,
                "gemma_tier": decode_rows}),
        record("moe_gmm", "moe_gmm/moe_gmm.cu",
               "src/repro/kernels/moe_gmm/kernel.py:37", gmm_rec),
        record("ssd_scan", "ssd_scan/ssd_scan.cu",
               "src/repro/kernels/ssd_scan/kernel.py:66", ssd_rec),
    ]
    for r in records:
        if not (math.isfinite(r["ms"]) and r["launches"] > 0):
            raise AssertionError(f"bad record {r}")
    print(f"[generate-moe/ssm] bf16 ms per prefill / per decoded token: "
          f"granite {moe_times}, mamba2 {ssm_times}")
    print("[kernels] " + ", ".join(
        f"{r['name']}: {r['launches']} launches "
        f"({', '.join(f'{k} {v}' for k, v in r['launches_by_path'].items())})"
        f", matched its plain version" for r in records)
        + f" ({time.perf_counter() - t0:.1f}s total)")
    print(f"[device] {smi}")     # again, beside the numbers above it
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
