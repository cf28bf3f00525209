#!/usr/bin/env python3
"""End-to-end smoke run of paddle_tpu_torch (the PyTorch / CUDA port) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the serving path from paddle_tpu_torch/csrc
   with nvcc for sm_90a, all sources at once;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, then time kernel, plain version and
   the PyTorch library call that computes the same function: each one's
   calls captured in a CUDA graph (no host launch cost in the time) over
   rotating input sets larger than the 50 MB L2, replayed in turns
   between CUDA events;
4. serve: ContinuousBatchingEngine on CUDAPlace(0) at the Transformer LM's
   full width (vocab 32000, d_model 512, d_inner 2048, 8 heads, 6 layers),
   16 slots, max_len 256, random weights from the startup program's seed,
   48 requests with prompts of 8-96 tokens and 32 new tokens each. Launch
   counts are zeroed just before and read just after: every kernel of the
   path must have run (decode attention: 6 launches, one per layer, each
   tick);
5. reference check on a small input: the same engine at a small width on
   the card and on the CPU (where the plain versions run) from the same
   weights in float32 must generate identical tokens;
6. where a tick's time goes: torch.profiler over steady-state ticks of
   the phase-4 engine — wall and device-busy time per tick, the device's
   idle share, the top device kernels, and host time per op type (each
   op lowering wrapped in a record_function named by its op type, for
   this phase only). Diagnostics; it changes no result above.

Float32 matrix products run without TF32 here
(torch.backends.cuda.matmul.allow_tf32 = False, and cudnn's too), so
float32 comparisons are full float32.

The line before last is one JSON object with each kernel's launches on the
serving run, error against its plain version (`max_abs_err` at the serving
shape with float32 q; decode attention adds `max_abs_err_bf16_q`, the same
shape with the serving path's bfloat16 q) and times; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside this file, it exits non-zero and prints no result.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

SEED = 1234

# serving configuration: the engine's default model, 16 slots of 256
SERVE = dict(n_slots=16, vocab=32000, max_len=256, d_model=512, d_inner=2048,
             num_heads=8, num_layers=6)
N_REQUESTS, PROMPT_LO, PROMPT_HI, MAX_NEW = 48, 8, 96, 32

# published H100 rates by part (NVIDIA data sheets): memory bytes/s and
# float32 (non-tensor-core) flop/s
_RATES = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12),
          "SXM": (3.35e12, 67e12)}

_KERNEL_META = {
    "decode_attention": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/fusion/decode_attention.py:60",
    },
}


def log(*a):
    print(*a, flush=True)


def card_rates(name):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, _RATES[key]
    return "SXM", _RATES["SXM"]


def time_in_turns(fns, sets, reps=100, rounds=3):
    """Median device ms per call of each fn. Each fn's `reps` calls,
    cycling through `sets`, are captured once in a CUDA graph, so host
    launch cost is out of the measurement; the graphs then replay in turns
    (a b c, c b a, a b c) between CUDA events."""
    import torch
    graphs = {}
    for name, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):           # warm-up before capture
            for s in sets:
                fn(s)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(reps):
                fn(sets[i % len(sets)])
        graphs[name] = g
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns)
    for rnd in range(rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[name].replay()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return {n: sorted(v)[len(v) // 2] for n, v in times.items()}


def check_decode_attention(ptt, name, rates):
    """Phase 3 for the decode-attention kernel. Returns its JSON fields
    (all but launches)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.fusion.decode_attention import (
        decode_attention_cuda, decode_attention_plain)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def make(r, nh, t, dh, q_dtype):
        q = torch.randn(r, nh, dh, device=dev, generator=gen).to(q_dtype)
        k = torch.randn(r, nh, t, dh, device=dev, generator=gen)
        v = torch.randn(r, nh, t, dh, device=dev, generator=gen)
        # per-row masks ending at different positions, shared by every
        # head (stride 0), as the tick's [S,1,1,1,T] bias reaches the op
        ends = torch.randint(1, t + 1, (r, 1), device=dev, generator=gen)
        keep = torch.arange(t, device=dev)[None] < ends
        mask = torch.where(keep, 0.0, -1e9).to(torch.float32)
        return q, k, v, mask[:, None, :].expand(r, nh, t)

    # correctness: the serving shape in both q types, plus odd shapes
    # (heads not a power of two, dh not a multiple of 32, T beyond 48 KB
    # of scores)
    r, nh, t, dh = SERVE["n_slots"], SERVE["num_heads"], SERVE["max_len"], \
        SERVE["d_model"] // SERVE["num_heads"]
    cases = [(r, nh, t, dh, torch.bfloat16), (r, nh, t, dh, torch.float32),
             (3, 6, 40, 48, torch.bfloat16), (2, 2, 16384, 64, torch.float32),
             (4, 4, 1000, 256, torch.float32)]
    tol = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-2, 1e-2)}
    errs = {}
    for (cr, cnh, ct, cdh, dt) in cases:
        q, k, v, bias = make(cr, cnh, ct, cdh, dt)
        scale = cdh ** -0.5
        out = decode_attention_cuda(q, k, v, bias, scale)
        ref = decode_attention_plain(q, k, v, bias, scale)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        atol, rtol = tol[dt]
        ok = bool((diff <= atol + rtol * ref.float().abs()).all())
        err = float(diff.max())
        log(f"  decode_attention R={cr} nh={cnh} T={ct} dh={cdh} "
            f"q={str(dt)[6:]}: max_abs_err={err:.3e} "
            f"(tolerance atol {atol} + rtol {rtol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode_attention disagrees with its plain "
                                 f"version at R={cr} nh={cnh} T={ct} dh={cdh} "
                                 f"q={dt}: max abs err {err}")
        errs[(cr, cnh, ct, cdh, dt)] = err

    # timing at the serving path's shape and types (bf16 q, f32 caches),
    # rotating input sets whose K/V exceed the L2 three times over
    kv_bytes = 2 * r * nh * t * dh * 4
    n_sets = max(4, math.ceil(3 * 50e6 / kv_bytes))
    sets = []
    for _ in range(n_sets):
        q, k, v, bias = make(r, nh, t, dh, torch.bfloat16)
        sets.append({"q": q, "k": k, "v": v, "bias": bias,
                     # SDPA takes one dtype: q in float32, computed once
                     "q4": q.float()[:, :, None, :],
                     "mask4": bias[:, :, None, :]})
    scale = dh ** -0.5
    times = time_in_turns({
        "kernel": lambda s: decode_attention_cuda(s["q"], s["k"], s["v"],
                                                  s["bias"], scale),
        "plain": lambda s: decode_attention_plain(s["q"], s["k"], s["v"],
                                                  s["bias"], scale),
        "library": lambda s: F.scaled_dot_product_attention(
            s["q4"], s["k"], s["v"], attn_mask=s["mask4"], scale=scale),
    }, sets)
    # least time: each input read once (q, K, V, the [R,T] mask the
    # heads share), the output written once; flops 4 per cache element
    # (q.k and p.v) + ~5 per score (scale, bias, max, exp, sum)
    nbytes = (r * nh * dh * 2 + kv_bytes + r * t * 4 + r * nh * dh * 2)
    flops = 4 * r * nh * t * dh + 5 * r * nh * t
    mem_rate, f32_rate = rates
    bound_ms = max(nbytes / mem_rate, flops / f32_rate) * 1e3
    bound_by = "bytes" if nbytes / mem_rate >= flops / f32_rate else \
        "operations"
    log(f"  decode_attention timing R={r} nh={nh} T={t} dh={dh} q=bf16, "
        f"{n_sets} input sets of {kv_bytes / 1e6:.1f} MB K/V: kernel "
        f"{times['kernel'] * 1e3:.2f} us, plain {times['plain'] * 1e3:.2f} "
        f"us, SDPA {times['library'] * 1e3:.2f} us, bound "
        f"{bound_ms * 1e3:.2f} us ({bound_by}: {nbytes / 1e6:.2f} MB at "
        f"{mem_rate / 1e12:.2f} TB/s)")
    # the error at the serving shape with float32 q shows the kernel's own
    # arithmetic; with bfloat16 q both outputs round to bfloat16, which
    # hides it, so that one is reported beside it under its own key
    return {"max_abs_err": errs[cases[1]],
            "max_abs_err_bf16_q": errs[cases[0]], "ms": times["kernel"],
            "plain_ms": times["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": times["library"]}


def serve(ptt, kernels):
    """Phase 4: the main path at full width. Returns (launch counts,
    engine)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    eng = ptt.ContinuousBatchingEngine(place=ptt.CUDAPlace(0), **SERVE)
    torch.cuda.synchronize()
    log(f"  engine built and initialized in {time.perf_counter() - t0:.2f} s"
        f" (KV caches {eng.stats()['kv_cache_bytes'] / 1e6:.1f} MB)")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, SERVE["vocab"],
                           rng.randint(PROMPT_LO, PROMPT_HI + 1)).tolist()
               for _ in range(N_REQUESTS)]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, MAX_NEW) for p in prompts]
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    assert len(done) == N_REQUESTS and all(r.done for r in reqs), \
        "not every request completed"
    for r in reqs:
        assert len(r.tokens) == MAX_NEW, (r.rid, len(r.tokens))
        assert all(0 <= tok < SERVE["vocab"] for tok in r.tokens), r.rid
    # percentiles: the highest with at least ten samples beyond it
    ticks = np.asarray(eng.tick_seconds) * 1e3
    ttft = np.asarray([r.first_token_pc - r.submitted_pc for r in reqs])
    prompt_tokens = sum(len(p) for p in prompts)
    log(f"  served {N_REQUESTS} requests, {N_REQUESTS} completed, 0 failed "
        f"({prompt_tokens} prompt + {eng.tokens_out} generated tokens) in "
        f"{eng.n_ticks} ticks, {wall:.3f} s: "
        f"{eng.tokens_out / wall:.1f} generated tokens/s, "
        f"{(prompt_tokens + eng.tokens_out) / wall:.1f} tokens/s all")
    log(f"  tick (the gap between a slot's tokens): median "
        f"{np.median(ticks):.3f} ms, p95 {np.percentile(ticks, 95):.3f} ms "
        f"({len(ticks)} ticks); time to first token (all requests queued "
        f"at once): median {np.median(ttft):.3f} s, p75 "
        f"{np.percentile(ttft, 75):.3f} s ({len(ttft)} requests); "
        f"occupancy {eng.occupancy():.3f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
    log(f"  launches on the serving run: {launches}")
    expect = eng.n_ticks * SERVE["num_layers"]
    assert launches["decode_attention"] == expect, (
        f"decode_attention launched {launches['decode_attention']} times in "
        f"{eng.n_ticks} ticks; the path must launch it {expect} times")
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was never launched on the main path"
    return launches, eng


def reference_check(ptt):
    """Phase 5: small width, float32, card vs CPU from the same weights:
    identical tokens."""
    from paddle_tpu_torch.framework.executor import as_numpy
    small = dict(n_slots=4, vocab=97, max_len=32, d_model=64, d_inner=128,
                 num_heads=4, num_layers=2)
    prev = ptt.flags.get_flag("use_bf16_matmul")
    ptt.flags.set_flag("use_bf16_matmul", False)
    try:
        gpu = ptt.ContinuousBatchingEngine(place=ptt.CUDAPlace(0),
                                           scope=ptt.Scope(), **small)
        params = {p.name: as_numpy(gpu.scope.get(p.name))
                  for p in gpu._program.all_parameters()}
        cpu = ptt.ContinuousBatchingEngine(
            place=ptt.CPUPlace(),
            scope=ptt.load_numpy_params(params, ptt.Scope(), ptt.CPUPlace()),
            **small)
        prompts = [[(7 * i + j) % small["vocab"] for j in range(n)]
                   for i, n in enumerate((3, 9, 1, 14, 6, 11))]
        g = [gpu.submit(p, 8) for p in prompts]
        c = [cpu.submit(p, 8) for p in prompts]
        gpu.run_until_idle()
        cpu.run_until_idle()
    finally:
        ptt.flags.set_flag("use_bf16_matmul", prev)
    gt, ct = [r.tokens for r in g], [r.tokens for r in c]
    assert gt == ct, f"card tokens {gt} != CPU tokens {ct}"
    log(f"  small engine, float32: card and CPU generate identical tokens "
        f"({len(prompts)} requests, {gpu.n_ticks} ticks)")


def _profile(eng, n, annotate):
    """torch.profiler over `n` engine ticks; with `annotate`, each op
    lowering runs inside a record_function named by its op type."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch.framework import lowering

    run_op = lowering.run_op

    def named_run_op(op, env, ctx):
        with record_function(op.type):
            run_op(op, env, ctx)

    if annotate:
        lowering.run_op = named_run_op
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        lowering.run_op = run_op
    return wall, prof.key_averages()


def profile_ticks(eng, warm=8, n=32):
    """Phase 6: torch.profiler over steady-state ticks of the serving
    engine (16 fresh requests keep every slot busy throughout): the same
    number of ticks without the profiler (wall only), one profile as it
    runs (wall, device busy and the idle share of that window, top
    kernels), one with the op
    lowerings annotated (host time per op type; the annotations add host
    cost, so read those as shares)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    rng = np.random.RandomState(SEED + 1)
    for _ in range(SERVE["n_slots"]):
        eng.submit(rng.randint(0, SERVE["vocab"], 64).tolist(), 64)
    for _ in range(warm):
        eng.step()

    def dev_self(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) or 0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    log(f"  {n} steady-state ticks, no profiler: wall "
        f"{(time.perf_counter() - t0) / n * 1e3:.3f} ms/tick")
    wall, events = _profile(eng, n, annotate=False)
    kernels_ = [e for e in events if e.device_type == DeviceType.CUDA
                and dev_self(e) > 0]
    busy_us = sum(dev_self(e) for e in kernels_)
    log(f"  {n} ticks under the profiler: wall {wall / n * 1e3:.3f} "
        f"ms/tick")
    if busy_us <= 0:
        log("  the profiler saw no device time: device busy share not "
            "measured")
    else:
        log(f"  device busy {busy_us / n / 1e3:.3f} ms/tick "
            f"({len(kernels_)} distinct kernels), idle share of the "
            f"profiled window {1 - busy_us / 1e6 / wall:.3f}")
    for e in sorted(kernels_, key=dev_self, reverse=True)[:8]:
        log(f"    device {dev_self(e) / n:8.1f} us/tick {e.count / n:6.1f}"
            f" calls/tick  {e.key[:80]}")
    wall, events = _profile(eng, n, annotate=True)
    op_types = {op.type for op in eng._step._plan.ops}
    host = [e for e in events
            if e.key in op_types and e.device_type == DeviceType.CPU]
    total = sum(e.cpu_time_total for e in host)
    log(f"  host time in op lowerings, annotated run (wall "
        f"{wall / n * 1e3:.3f} ms/tick):")
    for e in sorted(host, key=lambda e: e.cpu_time_total, reverse=True):
        log(f"    host {e.cpu_time_total / n:8.1f} us/tick "
            f"{e.cpu_time_total / max(total, 1e-9):6.1%} "
            f"{e.count / n:5.1f} calls/tick  op {e.key}")
    eng.run_until_idle()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 1: card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    part, rates = card_rates(name)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {name} "
        f"(rates of the H100 {part} part: {rates[0] / 1e12:.2f} TB/s, "
        f"{rates[1] / 1e12:.0f} TFLOP/s float32)")

    log("phase 2: build kernels")
    t0 = time.perf_counter()
    took = kernels.build()
    log(f"  built {sorted(took)} in {time.perf_counter() - t0:.2f} s "
        f"(per source: {took})")
    for kname, text in kernels.BUILD_LOGS.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill", text)]
        log(f"  [{kname}] {len(regs)} instantiations, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes "
            f"{max(spills, default=0)}")

    log("phase 3: kernels against their plain versions")
    results = {"decode_attention": check_decode_attention(ptt, name, rates)}

    log("phase 4: serve the Transformer LM at full width")
    launches, eng = serve(ptt, kernels)

    log("phase 5: reference check on a small input")
    reference_check(ptt)

    log("phase 6: where a serving tick's time goes")
    profile_ticks(eng)

    line = {"kernels": [dict(name=k, **_KERNEL_META[k],
                             launches=launches[k], **results[k])
                        for k in results]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
