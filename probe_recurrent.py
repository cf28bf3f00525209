#!/usr/bin/env python3
"""Where a step of the LSTM kernel (K5, csrc/recurrent.cu lstm_seq_kernel)
goes on an NVIDIA GPU.

    python3 probe_recurrent.py [name=path/to/recurrent.cu ...]

from the repository root, on a machine with one card and nvcc. It builds
paddle_tpu_torch/csrc/recurrent.cu as it is and variants of it, each with
one part of every step removed by a text edit of the source (the FMAs of
the recurrent product, the staging of h, the grid barrier, the stores of
hs, cs and the stash), and times each at the stacked LSTM's shape (B 64,
T 100, H 512, float32, with the stash) the way chip_smoke.py phase 3
does (CUDA-graph replay), three rounds in turns. The variants compute
wrong results: they only split the step's time. Each further name=path
argument adds another build of the source, which must agree with the plain
version (1e-4) and is timed beside the others, to compare two designs in
one run. Prints the card's name and power limit first, then one line a
build: its times in microseconds (per call and per step).
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "paddle_tpu_torch", "csrc", "recurrent.cu")
B, T, H = 64, 100, 512

# name -> [(text in the source, its replacement)]
VARIANTS = {
    "no_fma": [("          if (ks * KL + kq < kn) {",
                "          if (false) {")],
    "no_stage": [("        if (q < nj) {\n          float* sl = ring",
                  "        if (false) {\n          float* sl = ring")],
    "no_barrier": [("    grid_sync(arrived, target);\n  }\n}\n\n// --- K6",
                    "  }\n}\n\n// --- K6")],
    "no_stores": [("        hs[so] = hn;\n        cs[so] = cn;\n"
                   "        if (stash != nullptr) {",
                   "        if (false) {")],
}
VARIANTS["no_fma_no_stage"] = VARIANTS["no_fma"] + VARIANTS["no_stage"]


def main():
    import torch
    if not torch.cuda.is_available():
        print("probe_recurrent: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.fusion import recurrent as rec

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_dir = os.path.join(kernels.build_dir(), "probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(SOURCE) as f:
        text = f.read()
    sources = {"as_is": SOURCE}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"probe_recurrent: variant {name} no longer "
                                 f"matches {SOURCE}")
            src = src.replace(old, new)
        sources[name] = os.path.join(out_dir, f"{name}.cu")
        with open(sources[name], "w") as f:
            f.write(src)
    checked = {"as_is"}
    for arg in sys.argv[1:]:
        name, path = arg.split("=", 1)
        sources[name] = os.path.abspath(path)
        checked.add(name)

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
    sets = [dict(x=torch.randn(B, T, 4 * H, device=dev, generator=gen) * .5,
                 w=torch.randn(H, 4 * H, device=dev, generator=gen) * H ** -.5,
                 h0=torch.randn(B, H, device=dev, generator=gen) * .1,
                 c0=torch.randn(B, H, device=dev, generator=gen) * .1,
                 sl=torch.randint(16, T + 1, (B,), device=dev, generator=gen))
            for _ in range(2)]

    def runner(name):
        def fn(s):
            kernels._LIBS["recurrent"] = libs[name]
            return rec.lstm_seq_cuda(s["x"], s["h0"], s["c0"], s["w"],
                                     s["sl"], False, True)
        return fn

    s0 = sets[0]
    ref = rec.lstm_seq_plain(s0["x"], s0["h0"], s0["c0"], s0["w"], s0["sl"],
                             False, True)
    for name in sorted(checked):
        out = runner(name)(s0)
        err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        print(f"{name}: max_abs_err {err:.3e} against the plain version",
              flush=True)
        if not err <= 1e-4:
            raise SystemExit(f"probe_recurrent: {name} disagrees")
    times = {name: [] for name in libs}
    for rnd in range(3):
        for name in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
            times[name].append(chip_smoke.time_in_turns(
                {name: runner(name)}, sets, reps=10)[name] * 1e3)
    for name, v in times.items():
        med = sorted(v)[1]
        print(f"{name}: {med:.1f} us a call, {med / T:.2f} us a step "
              f"(rounds: {', '.join(f'{x:.1f}' for x in v)})", flush=True)
    kernels._LIBS.pop("recurrent", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
