#!/usr/bin/env python3
"""Where a step of the LSTM kernel (K5, csrc/recurrent.cu lstm_seq_kernel)
and of the GRU kernel (K6, gru_seq_kernel) goes on an NVIDIA GPU.

    python3 probe_recurrent.py [lstm|gru] [name=path/to/recurrent.cu ...]

from the repository root, on a machine with one card and nvcc (both
kernels unless one is named). It builds paddle_tpu_torch/csrc/recurrent.cu
as it is and variants of it, each with one part of every step of one
kernel removed by a text edit of the source (the FMAs of the recurrent
product, the staging of h (and r h), each grid barrier, the stores of hs,
cs and the stash), and times each at its path's shape — the stacked
LSTM's (B 64, T 100, H 512) for K5, the NMT encoder's (B 32, T 64, H 512)
for K6, float32, with the stash — the way chip_smoke.py phase 3 does
(CUDA-graph replay), three rounds in turns. The variants compute wrong
results: they only split the step's time. Each further name=path argument
adds another build of the source, which must agree with the plain version
(1e-4) and is timed beside the others, to compare two designs in one run.
Prints the card's name and power limit first, then one line a build and
kernel: its times in microseconds (per call and per step).
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "paddle_tpu_torch", "csrc", "recurrent.cu")
# kernel -> its path's (B, T, H)
SHAPES = {"lstm": (64, 100, 512), "gru": (32, 64, 512)}

# kernel -> variant name -> [(text in the source, its replacement)]
VARIANTS = {
    "lstm": {
        "no_fma": [("          if (ks * KL + kq < kn) {",
                    "          if (false) {")],
        "no_stage": [("        if (q < nj) {\n          float* sl = ring",
                      "        if (false) {\n          float* sl = ring")],
        "no_barrier": [("    grid_sync(arrived, target);\n  }\n}\n\n"
                        "// --- K6", "  }\n}\n\n// --- K6")],
        "no_stores": [("        st_e(hs + so, hn);\n        st_e(cs + so, cn);\n"
                       "        if (stash != nullptr) {",
                       "        if (false) {")],
    },
    "gru": {
        "no_fma": [("    if (ks * 4 < kn) {", "    if (false) {")],
        "no_stage": [("    if (q < nj) {\n      float* piece = ring",
                      "    if (false) {\n      float* piece = ring")],
        "no_barrier_a": [("    grid_sync(arrived, target);   // r h of every "
                          "unit is out\n", "")],
        "no_barrier_b": [("    grid_sync(arrived, target);   // the new h of "
                          "every unit is out\n", "")],
        "no_stores": [("        if (stash != nullptr) st_e(stash + xo, g);\n",
                       ""),
                      ("        st_e(hs + ((size_t)b * T + t) * H + j, hn);\n"
                       "        if (stash != nullptr) st_e(stash + xo, cgate);\n",
                       "")],
    },
}
for _v in VARIANTS.values():
    _v["no_fma_no_stage"] = _v["no_fma"] + _v["no_stage"]


def _inputs(torch, kind, dev, gen):
    b, t, h = SHAPES[kind]
    g = 4 if kind == "lstm" else 3
    return [dict(x=torch.randn(b, t, g * h, device=dev, generator=gen) * .5,
                 w=torch.randn(h, g * h, device=dev, generator=gen) * h ** -.5,
                 h0=torch.randn(b, h, device=dev, generator=gen) * .1,
                 c0=torch.randn(b, h, device=dev, generator=gen) * .1,
                 sl=torch.randint(16, t + 1, (b,), device=dev, generator=gen))
            for _ in range(2)]


def main():
    import torch
    if not torch.cuda.is_available():
        print("probe_recurrent: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.fusion import recurrent as rec

    args = sys.argv[1:]
    kinds = [a for a in args if a in SHAPES] or list(SHAPES)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_dir = os.path.join(kernels.build_dir(), "probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(SOURCE) as f:
        text = f.read()
    sources = {"as_is": SOURCE}
    builds = {kind: ["as_is"] for kind in kinds}   # kernel -> builds to time
    for kind in kinds:
        for name, edits in VARIANTS[kind].items():
            src = text
            for old, new in edits:
                if src.count(old) != 1:
                    raise SystemExit(f"probe_recurrent: {kind} variant "
                                     f"{name} no longer matches {SOURCE}")
                src = src.replace(old, new)
            label = f"{kind}_{name}"
            sources[label] = os.path.join(out_dir, f"{label}.cu")
            builds[kind].append(label)
            with open(sources[label], "w") as f:
                f.write(src)
    checked = {"as_is"}
    for arg in args:
        if arg in SHAPES:
            continue
        name, path = arg.split("=", 1)
        sources[name] = os.path.abspath(path)
        checked.add(name)
        for kind in kinds:
            builds[kind].append(name)

    procs = {}
    for name, path in sources.items():
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels._NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"probe_recurrent: {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(lib)
        libs[name].ptt_cuda_error_string.argtypes = [ctypes.c_int]
        libs[name].ptt_cuda_error_string.restype = ctypes.c_char_p

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)

    def runner(kind, name):
        def fn(s):
            kernels._LIBS["recurrent"] = libs[name]
            if kind == "lstm":
                return rec.lstm_seq_cuda(s["x"], s["h0"], s["c0"], s["w"],
                                         s["sl"], False, True)
            return rec.gru_seq_cuda(s["x"], s["h0"], s["w"], s["sl"], False,
                                    True)
        return fn

    for kind in kinds:
        sets = _inputs(torch, kind, dev, gen)
        s0 = sets[0]
        if kind == "lstm":
            ref = rec.lstm_seq_plain(s0["x"], s0["h0"], s0["c0"], s0["w"],
                                     s0["sl"], False, True)
        else:
            ref = rec.gru_seq_plain(s0["x"], s0["h0"], s0["w"], s0["sl"],
                                    False, True)
        for name in sorted(checked):
            out = runner(kind, name)(s0)
            err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
            print(f"{kind} {name}: max_abs_err {err:.3e} against the plain "
                  f"version", flush=True)
            if not err <= 1e-4:
                raise SystemExit(f"probe_recurrent: {kind} {name} disagrees")
        names = builds[kind]
        times = {name: [] for name in names}
        for rnd in range(3):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                times[name].append(chip_smoke.time_in_turns(
                    {name: runner(kind, name)}, sets, reps=10)[name] * 1e3)
        steps = SHAPES[kind][1]
        for name, v in times.items():
            med = sorted(v)[1]
            print(f"{kind} {name}: {med:.1f} us a call, {med / steps:.2f} us "
                  f"a step (rounds: {', '.join(f'{x:.1f}' for x in v)})",
                  flush=True)
    kernels._LIBS.pop("recurrent", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
