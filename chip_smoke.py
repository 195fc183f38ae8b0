#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

  1. device: the card's name, and its name and power limit as
     ``nvidia-smi`` reports them;
  2. build every CUDA kernel from the sources, then hold the
     flash-attention kernel against its plain PyTorch version at the
     serve path's shapes and on a sweep (ragged S, head dims, masks, GQA,
     bf16), with CUDA-event times beside the plain version and
     ``scaled_dot_product_attention`` (a yardstick the port never calls);
  3. hold the compaction kernel against its plain version, bit for bit,
     over sizes and keep densities, timed beside ``idx[keep]``;
  4. serve 512 seeded ``headlines`` requests (25% repeats) twice through
     ``assemble_pipeline(device="cuda", compact="device")`` with three
     tiers and the scorer from seeded weights; both kernels must have
     launched, the second pass must be all cache hits, and the first
     pass must match the same weights served on the CPU;
  5. one JSON line per the kernels' record, then the result line.

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
FRAGILE = 1e-4           # score-to-threshold gap / top-2 logit margin
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside
# the tensor cores (both kernels do fp32 or integer work on CUDA cores)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12


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


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[1 device] torch: {name}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return name


def phase_build():
    from torch.utils.cpp_extension import is_ninja_available
    from repro_torch.kernels._build import BUILD_LOGS, build_all
    t = time.perf_counter()
    libs = build_all()
    took = time.perf_counter() - t
    print(f"[2 build] {len(libs)} kernel libraries in {took:.1f}s "
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
        out = mha(q, k, v, causal=causal, window=window)
        ref = mha_reference(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = FLOAT_TOL[str(dtype).split(".")[-1]]
        if not err <= tol:
            raise AssertionError(
                f"flash_attention disagrees with its plain version at B={b} "
                f"S={s} H={h} KVH={kvh} hd={hd} {dtype} causal={causal} "
                f"window={window}: max abs err {err:.3e} > {tol}")
        if dtype == torch.float32:
            worst = max(worst, err)
        n_checks += 1
        return q, k, v

    # the serve path: every tier's (H, hd) and the scorer's, at S = 64
    # (tier queries, scorer embeddings) and S = 66 (scorer pairs)
    timed = []
    for s in (64, 66):
        for h, hd in ((2, 16), (2, 24), (3, 32), (4, 32), (5, 32)):
            q, k, v = check(256, s, h, h, hd, torch.float32, False, 0)
            if (s, h) in ((64, 2), (64, 5), (66, 4)) and hd != 24:
                timed.append(((256, s, h, hd), q, k, v))
    # the sweep: ragged S, head dims, masks, GQA, bf16
    masks = ((False, 0), (True, 0), (True, 32), (False, 32))
    for i, s in enumerate((1, 7, 128, 200, 512)):
        for j, hd in enumerate((24, 64, 128)):
            causal, window = masks[(i + j) % len(masks)]
            h, kvh = (8, 2) if (i + j) % 2 else (4, 4)
            check(2, s, h, kvh, hd, torch.float32, causal, window)
    check(2, 200, 8, 2, 64, torch.bfloat16, True, 32)
    check(4, 66, 4, 4, 32, torch.bfloat16, False, 0)
    print(f"[2 flash] {n_checks} shapes agree with the plain version "
          f"(fp32 max abs err {worst:.3e} <= {FLOAT_TOL['float32']}, "
          f"bf16 <= {FLOAT_TOL['bfloat16']})")

    rows = []
    for (b, s, h, hd), q, k, v in timed:
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = _time_ms(lambda: mha(q, k, v, causal=False))
        plain = _time_ms(lambda: mha_reference(q, k, v, causal=False))
        lib = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        nbytes = 4 * b * s * h * hd * 4
        flops = 4 * b * h * s * s * hd
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
        row = {"shape": f"B={b} S={s} H={h} hd={hd}", "ms": ms,
               "plain_ms": plain, "library_ms": lib,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        rows.append(row)
        print(f"  flash {row['shape']} fp32: kernel {ms:.4f} ms | plain "
              f"{plain:.4f} ms | sdpa {lib:.4f} ms | bound {row['bound_ms']:.4f}"
              f" ms ({row['bound_by']})")
    # the record's time: the scorer's shape (most of the path's launches)
    main = next(r for r in rows if r["shape"] == "B=256 S=66 H=4 hd=32")
    return {"max_abs_err": worst, **{k: main[k] for k in
            ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}


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
    print(f"[3 compact] {n_checks} (n, density) cases bit-exact against the "
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


def _requests():
    import numpy as np
    from repro_torch.data import synthetic
    n_base = round(N_REQUESTS * (1 - REPEAT_FRAC))
    base = synthetic.sample("headlines", n_base, seed=SEED + 7).tokens
    rng = np.random.default_rng(SEED + 7)
    rep = base[rng.choice(n_base, N_REQUESTS - n_base)]
    toks = np.concatenate([base, rep])
    return toks[rng.permutation(N_REQUESTS)]


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
    print(f"[4 serve] set-up serve (first use of the card): "
          f"{time.perf_counter() - t:.3f}s wall")
    pipe = assemble_pipeline(apis, sp, THRESHOLDS, prompts, device="cuda",
                             compact="device")
    mha.launches = 0
    compact.launches = 0
    passes = []
    for _ in range(2):
        t = time.perf_counter()
        res = pipe.serve(tokens)
        torch.cuda.synchronize()
        passes.append((res, time.perf_counter() - t))
    launches = {"flash_attention": mha.launches,
                "cascade_compact": compact.launches}
    for i, (res, wall) in enumerate(passes):
        print(f"[4 serve] pass {i + 1} ({wall:.3f}s wall): {res.summary()}")
    print(f"  launches over both passes: {launches}")
    if min(launches.values()) <= 0:
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
    launches = phase_serve()
    records = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:69",
         "launches": launches["flash_attention"], **flash},
        {"name": "cascade_compact", "route": "cuda",
         "source": "src/repro_torch/kernels/cascade_compact/cascade_compact.cu",
         "replaces": "src/repro/kernels/cascade_compact/kernel.py:56",
         "launches": launches["cascade_compact"], **comp},
    ]
    for r in records:
        if not (math.isfinite(r["ms"]) and r["launches"] > 0):
            raise AssertionError(f"bad record {r}")
    print(f"[5 kernels] " + ", ".join(
        f"{r['name']}: {r['launches']} launches, matched its plain version"
        for r in records) + f" ({time.perf_counter() - t0:.1f}s total)")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
