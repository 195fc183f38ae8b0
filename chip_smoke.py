#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

  [device]   the card's name, and its name and power limit as
             ``nvidia-smi`` reports them;
  [build]    every CUDA kernel built from the sources (one nvcc each, in
             parallel), with ptxas's register and spill report;
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
  [kernels]  one line over the three kernels, then the kernels' JSON
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
    return name


def phase_build():
    from torch.utils.cpp_extension import is_ninja_available
    from repro_torch.kernels._build import BUILD_LOGS, build_all
    t = time.perf_counter()
    libs = build_all()
    took = time.perf_counter() - t
    print(f"[build] {len(libs)} kernel libraries in {took:.1f}s "
          f"(nvcc, one process per source; ninja "
          f"{'present' if is_ninja_available() else 'absent'}): "
          f"{sorted(libs)}")
    for name, log in sorted(BUILD_LOGS.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


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
    from repro_torch.kernels.cascade_compact.ops import compact
    from repro_torch.kernels.decode_attention.ops import gqa_decode
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.models.classifier import init_classifier
    from repro_torch.serving.builder import assemble_pipeline

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
    mha.launches = gqa_decode.launches = compact.launches = 0
    passes = []
    for _ in range(2):
        t = time.perf_counter()
        res = pipe.serve(tokens)
        torch.cuda.synchronize()
        passes.append((res, time.perf_counter() - t))
    launches = {"flash_attention": mha.launches,
                "cascade_compact": compact.launches,
                "decode_attention": gqa_decode.launches}
    for i, (res, wall) in enumerate(passes):
        print(f"[serve] pass {i + 1} ({wall:.3f}s wall): {res.summary()}")
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


def _greedy_trace(params, cfg, prompts, n_new):
    """Greedy tokens (B, n_new) and each row's smallest top-2 logit margin
    over its steps, from an unbucketed prefill + decode chain."""
    import torch
    from repro_torch.models import transformer as T
    s = prompts.shape[1]
    logits, cache = T.prefill(params, {"tokens": prompts}, cfg,
                              max_len=s + n_new)
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


def _gen_times(eng, prompts, reps: int = 3):
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


def phase_generate():
    """Gemma-3-1B at full width on the card: (a) fp32 greedy tokens equal
    the CPU's, (b) bf16 times and bf16-vs-fp32 logits, (c) a two-tier
    cascade with a generation tier, served twice. Returns the launch
    counts of (c) and the kernels' times at its shapes."""
    import dataclasses
    import functools
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.convert import params_to
    from repro_torch.core import neural_market as NM
    from repro_torch.core import scorer as SC
    from repro_torch.core.approx import CompletionCache, embed_queries
    from repro_torch.core.cost import TABLE1
    from repro_torch.core.prompt import PromptSpec
    from repro_torch.data import synthetic
    from repro_torch.kernels.cascade_compact.ops import compact
    from repro_torch.kernels.decode_attention.ops import gqa_decode
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.models import transformer as T
    from repro_torch.models.classifier import init_classifier
    from repro_torch.serving.builder import FULL_PROMPT_TOKENS
    from repro_torch.serving.engine import (EnginePool, GenerationEngine,
                                            bucket_size, generation_tier)
    from repro_torch.serving.pipeline import ServingPipeline, TierSpec

    cfg = ARCHS["gemma3-1b"]                         # bf16, the config's own
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t = time.perf_counter()
    master = T.init_params(cfg32, seed=SEED, device="cpu")
    n_params = sum(x.numel() for x in _tensors(master))
    p32 = params_to(master, "cuda")
    p16 = T.cast_params(p32, cfg)
    torch.cuda.synchronize()
    print(f"[generate] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"vocab {cfg.vocab}, {n_params / 1e9:.3f} B params from seed "
          f"{SEED} ({time.perf_counter() - t:.1f}s to draw and copy)")
    rng = np.random.default_rng(SEED + 13)
    prompts = {"8x13": rng.integers(1, cfg.vocab, (8, 13)).astype(np.int32),
               "1x600": rng.integers(1, cfg.vocab, (1, 600)).astype(np.int32)}

    # (a) fp32 on the card == fp32 on the CPU, up to near-tie rows
    eng32 = GenerationEngine(cfg32, p32, device="cuda")
    n_rows = n_fragile = 0
    excused = []
    for name, pr in prompts.items():
        t = time.perf_counter()
        card = eng32.generate(pr, GEN_NEW)
        ref, margin = _greedy_trace(master, cfg32, pr, GEN_NEW)
        differ = (card != ref).any(1)
        fragile = margin < GEN_FRAGILE
        if (differ & ~fragile).any():
            raise AssertionError(
                f"fp32 generation on the card differs from the CPU on "
                f"{int((differ & ~fragile).sum())} rows of {name} with every "
                f"CPU top-2 margin >= {GEN_FRAGILE}")
        excused += [f"{name}[{i}]" for i in np.flatnonzero(differ)]
        n_rows += len(pr)
        n_fragile += int(fragile.sum())
        print(f"  (a) fp32 {name}: {int((~differ).sum())}/{len(pr)} rows "
              f"identical to the CPU over {GEN_NEW} tokens; smallest CPU "
              f"top-2 margin {margin.min():.2e} "
              f"({time.perf_counter() - t:.1f}s with the CPU reference)")
    print(f"  (a) rows that differ on a CPU margin < {GEN_FRAGILE}: "
          f"{excused or 'none'} ({n_fragile} fragile rows of {n_rows})")
    if len(excused) > 1:
        raise AssertionError(f"{len(excused)} of {n_rows} rows differ from "
                             f"the CPU (near-ties allow 1)")
    del master

    # (b) bf16: times, and logits teacher-forced against fp32
    eng16 = GenerationEngine(cfg, p16, device="cuda")
    timed = {8: prompts["8x13"],
             64: rng.integers(1, cfg.vocab, (64, 13)).astype(np.int32)}
    for b, pr in timed.items():
        pre_ms, tok_ms = _gen_times(eng16, pr)
        print(f"  (b) bf16 B={b} prompt 13, {GEN_NEW} new: {pre_ms:.2f} ms "
              f"per prefill, {tok_ms:.2f} ms per decoded token")
    worst = 0.0
    for name, pr in prompts.items():
        out16 = eng16.generate(pr, GEN_NEW)
        forced = torch.from_numpy(out16).to("cuda")
        l16 = _forced_logits(p16, cfg, pr, forced)
        l32 = _forced_logits(p32, cfg32, pr, forced)
        diff = (l16 - l32).abs().max().item()
        agree = (l16.argmax(-1) == l32.argmax(-1)).float().mean().item()
        own = (l16.argmax(-1).cpu().numpy() == out16).mean()
        worst = max(worst, diff)
        print(f"  (b) bf16 {name} teacher-forced through fp32: max |logit "
              f"diff| {diff:.4f} (logit std {l32.std().item():.3f}); argmax "
              f"agrees with fp32 on {agree:.3f} of steps, with the bf16 "
              f"engine's own tokens on {own:.3f}")
        del l16, l32
    if not worst <= BF16_LOGIT_TOL:
        raise AssertionError(f"bf16 logits differ from fp32 by {worst:.4f} > "
                             f"{BF16_LOGIT_TOL}")
    del eng32, p32
    torch.cuda.empty_cache()

    # (c) serve: an encoder tier, then a Gemma generation tier
    n_classes = synthetic.N_CLASSES["headlines"]
    api = NM.init_marketplace("headlines", tiers=NM.tier_subset(["GPT-J"]),
                              seed=SEED, device="cuda")[0]
    sp = init_classifier(SC.SCORER_CFG, 1, seed=SEED + 100, device="cuda")
    pool = EnginePool(max_new_tokens=GEN_SERVE_NEW)
    top_price = TABLE1["GPT-4"]
    gen = generation_tier(cfg.name, pool.get(cfg, p16, device="cuda"),
                          top_price,
                          decode_answer=lambda g: g[:, 0] % n_classes,
                          n_new=GEN_SERVE_NEW)
    pipe = ServingPipeline(
        tiers=[TierSpec(api.name, api.answer, api.price,
                        prompt=PromptSpec((0, 1, 2), 110, 140)),
               TierSpec(gen.name, gen.answer, top_price, n_out=GEN_SERVE_NEW)],
        thresholds=(0.5,), scorer=lambda toks, ans: SC.score(sp, toks, ans),
        cache=CompletionCache(capacity=1024, threshold=0.995),
        embed=functools.partial(embed_queries, sp, cfg=SC.SCORER_CFG),
        full_prompt_tokens=FULL_PROMPT_TOKENS, pad_token=synthetic.PAD,
        baseline_price=top_price, compact="device", device="cuda")
    tokens = _requests(N_GEN_REQUESTS, SEED + 17)
    mha.launches = gqa_decode.launches = compact.launches = 0
    passes = []
    for _ in range(2):
        t = time.perf_counter()
        res = pipe.serve(tokens)
        torch.cuda.synchronize()
        passes.append((res, time.perf_counter() - t))
    launches = {"flash_attention": mha.launches,
                "decode_attention": gqa_decode.launches,
                "cascade_compact": compact.launches}
    for i, (res, wall) in enumerate(passes):
        print(f"[generate] (c) pass {i + 1} ({wall:.3f}s wall): "
              f"{res.summary()}")
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

    t0 = time.perf_counter()
    kind = phase_device()
    phase_build()
    flash = phase_flash()
    comp = phase_compact()
    serve_launches = phase_serve()
    decode_err = phase_decode()
    gen_launches, decode_rows, flash_gen_rows = phase_generate()
    flash["gemma"] += flash_gen_rows
    records = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:69",
         "launches": (serve_launches["flash_attention"]
                      + gen_launches["flash_attention"]),
         "launches_by_path": {"serve": serve_launches["flash_attention"],
                              "generate": gen_launches["flash_attention"]},
         **flash},
        {"name": "cascade_compact", "route": "cuda",
         "source": "src/repro_torch/kernels/cascade_compact/cascade_compact.cu",
         "replaces": "src/repro/kernels/cascade_compact/kernel.py:56",
         "launches": (serve_launches["cascade_compact"]
                      + gen_launches["cascade_compact"]),
         "launches_by_path": {"serve": serve_launches["cascade_compact"],
                              "generate": gen_launches["cascade_compact"]},
         **comp},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/decode_attention/"
                   "decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:58",
         "launches": (serve_launches["decode_attention"]
                      + gen_launches["decode_attention"]),
         "launches_by_path": {"serve": serve_launches["decode_attention"],
                              "generate": gen_launches["decode_attention"]},
         **decode_rows[0],
         "max_abs_err": max(r["max_abs_err"] for r in decode_rows),
         "sweep_fp32_max_abs_err": decode_err, "gemma_tier": decode_rows},
    ]
    for r in records:
        if not (math.isfinite(r["ms"]) and r["launches"] > 0):
            raise AssertionError(f"bad record {r}")
    print("[kernels] " + ", ".join(
        f"{r['name']}: {r['launches']} launches "
        f"({', '.join(f'{k} {v}' for k, v in r['launches_by_path'].items())})"
        f", matched its plain version" for r in records)
        + f" ({time.perf_counter() - t0:.1f}s total)")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
