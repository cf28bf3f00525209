"""Analytic cost models: per-op flops and bytes, the roofline, the memory
walk by category, wire bytes and the joined prediction.

≙ paddle_tpu/framework/costs.py, line for line over the Program IR but for
three things:

- the hardware constants are the H100's (below), each with its source; the
  JAX package's are the TPU v5e's. A caller (a test) that sets the module's
  constants to the JAX package's values gets the JAX package's numbers
  back, since every function reads the constants when it runs;
- bytes are priced by each var's own dtype: the port keeps int64 and
  float64 (ROADMAP.md §3), where the JAX package with x64 off narrows
  them to 32-bit;
- the three parsers of XLA's HLO text (`hlo_shape_bytes`,
  `collective_census`, `hlo_liveness_temp_bytes`) are the JAX package's
  pure text functions; the port compiles no HLO, so its own census of a
  step is `measured_collective_census`, read from torch.profiler's c10d
  collective and point-to-point events (NCCL on the cards, gloo on the
  CPU) into the same {kind: [(bytes, label)]} form.

Accounting disciplines (as in the JAX package):

- per-op (flops, bytes) from declared var shapes, -1 batch dims resolved
  to `nominal_batch`; roofline combine max(flops/peak, bytes/bw) at the
  card's constants;
- per-device interconnect bytes per collective from its output bytes,
  ring-algorithm costs;
- peak live bytes from variable lifetimes (first writer .. last reader).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..core.dtypes import convert_dtype
from ..core.enforce import enforce

# ---------------------------------------------------------------------------
# hardware constants: one NVIDIA H100 SXM (80 GB HBM3). The roofline, the
# planner's recompute and transfer prices, MFU and the feasibility budget
# all read these, so one number means one thing everywhere. A relative
# model: it ranks programs and plans; it is not a wall-clock forecast.
# ---------------------------------------------------------------------------

#: dense bfloat16 tensor-core peak (NVIDIA H100 SXM data sheet; PERF.md's
#: bound column uses it)
H100_PEAK_FLOPS = 989e12
#: HBM3 bandwidth (the same data sheet; PERF.md's bound column)
H100_HBM_BPS = 3.35e12
#: device memory of one card (80 GB, as `nvidia-smi` reports the H100 80GB
#: HBM3 this port is measured on)
H100_HBM_BYTES = 80 * (1 << 30)
#: NVLink 4 bandwidth one direction, per device (900 GB/s both ways, the
#: data sheet): what the ring models' per-device bytes divide through
H100_NVLINK_BPS = 450e9
#: host <-> device PCIe rate measured on the card for the large buffers its
#: readers move (the offloaded optimizer state, the stash-to-host
#: candidate): chip_smoke.py phase 45's offload copies, 0.4136 GB one copy
#: each way on a CUDA side stream between a pinned slab and the card,
#: h2d 42.12 GB/s (d2h 44.29) on an NVIDIA H100 80GB HBM3 at 700.00 W
#: (PERF.md). The slower direction prices a round trip.
H100_PCIE_BPS = 42.12e9
#: host time of one eager op lowering, the least an op costs the port's
#: step whatever its roofline: chip_smoke.py phase 39's LM generation
#: step, 141 lowerings in 18.2-23.3 ms, so at least 129 us each, on an
#: NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md, PR 16). The memory
#: planner prices recompute with it (`op_step_cost`); the roofline does
#: not read it. 0 gives the JAX package's compiled-step prices.
H100_HOST_OP_S = 129e-6

# dtype byte widths for parsing XLA shape strings — the ONE copy shared by
# the probes (probe_caps) and the comm-structure tests. Covers every XLA
# scalar type that can appear in a typed shape (ADVICE r5 #4); an
# unrecognized typed-shape token RAISES instead of silently counting 0
# bytes (which would let byte-balance assertions pass/fail misleadingly
# if dtypes drift).
HLO_ITEM_BYTES = {"pred": 1,
                  "s2": 1, "u2": 1, "s4": 1, "u4": 1,     # sub-byte types
                  "s8": 1, "u8": 1, "s16": 2, "u16": 2,   # pack >= 1 byte
                  "s32": 4, "u32": 4, "s64": 8, "u64": 8,
                  "f8e4m3": 1, "f8e4m3fn": 1, "f8e4m3b11fnuz": 1,
                  "f8e4m3fnuz": 1, "f8e5m2": 1, "f8e5m2fnuz": 1,
                  "f8e3m4": 1, "f8e8m0fnu": 1,
                  "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
                  "c64": 8, "c128": 16}

# typed-shape tokens that are legitimately byte-free
_HLO_ZERO_BYTE_TYPES = frozenset({"token", "opaque"})


def hlo_shape_bytes(sh: str) -> int:
    """Total bytes of every typed array in one HLO shape string (tuple
    shapes sum their elements). Raises on a typed-shape token whose
    element type is not in HLO_ITEM_BYTES."""
    total = 0
    matched_any = False
    for m in re.finditer(r"([a-zA-Z][a-zA-Z0-9]*)\[([0-9,]*)\]", sh):
        matched_any = True
        dtype = m.group(1)
        if dtype in _HLO_ZERO_BYTE_TYPES:
            continue
        if dtype not in HLO_ITEM_BYTES:
            raise ValueError(
                f"hlo_shape_bytes: unrecognized element type {dtype!r} in "
                f"shape string {sh!r}; add it to HLO_ITEM_BYTES")
        n = 1
        for d in m.group(2).split(","):
            if d:
                n *= int(d)
        total += n * HLO_ITEM_BYTES[dtype]
    if not matched_any and "[" in sh:
        raise ValueError(
            f"hlo_shape_bytes: no typed shape recognized in {sh!r} "
            f"(dynamic dims or unexpected syntax?)")
    return total


def collective_census(hlo: str) -> Dict[str, list]:
    """{kind: [(output_bytes, line)]} for every collective instruction in a
    compiled (per-device) HLO module. Async pairs are counted once, at the
    -start; tuple-shaped outputs (all-to-all emits one operand per peer,
    with /*index=N*/ comments past 5 elements) sum their elements."""
    out: Dict[str, list] = {}
    for line in hlo.splitlines():
        # tuple shapes may nest one paren level INSIDE the tuple: TPU
        # layouts print as {1,0:T(8,128)} — [^()] alone would stop there
        # and silently drop the instruction from the census
        m = re.match(
            r"\s*(?:ROOT )?%?[\w.\-]+ = "
            r"(\((?:[^()]|\([^()]*\))*\)|\S+)\s+"
            r"(all-reduce|reduce-scatter|all-gather|collective-permute|"
            r"all-to-all)(-start|-done)?\(", line)
        if not m:
            continue
        if m.group(3) == "-done":
            continue
        kind = m.group(2)
        out.setdefault(kind, []).append((hlo_shape_bytes(m.group(1)), line))
    return out


# Per-device bytes each collective puts on the interconnect, as a function
# of its (per-device) OUTPUT bytes — the standard
# ring-algorithm accounting, shared by the comm-structure tests and the
# benchmark's grad_bytes_on_wire field so both quote the same model:
#   all-reduce out=n:        ring RS+AG, sends 2n(N-1)/N
#   reduce-scatter out=c:    input N*c, sends c(N-1)
#   all-gather out=n:        contributes n/N, sends n(N-1)/N
#   all-to-all out total=t:  keeps its own chunk, sends t(N-1)/N
#   collective-permute out=n: sends n
def collective_wire_bytes(kind: str, out_bytes: int, n_devices: int) -> float:
    n = n_devices
    return {
        "all-reduce": 2.0 * out_bytes * (n - 1) / n,
        "reduce-scatter": float(out_bytes) * (n - 1),
        "all-gather": float(out_bytes) * (n - 1) / n,
        "all-to-all": float(out_bytes) * (n - 1) / n,
        "collective-permute": float(out_bytes),
    }[kind]


def reshard_wire_bytes(nbytes: int, old_factors, new_factors) -> float:
    """Per-device interconnect bytes of the CANONICAL mesh-resize
    redistribution of one array (parallel/reshard.py emits the matching
    schedule; elastic restore is its checkpoint-mediated form):

    - a dim whose new shard factor is a multiple of its current one
      refines by dynamic-slice — 0 wire;
    - every remaining incompatible dim all-gathers over its old group
      (ring accounting, `collective_wire_bytes`), output priced at the
      CURRENT factors of the other dims (refinement first — the
      memory-efficient ordering), then slices to the new factor.

    Closed-form twin of reshard.schedule_steps: the step-priced schedule
    and this prediction must agree exactly (pinned by test)."""
    cur = list(old_factors)
    new = list(new_factors)
    if len(cur) != len(new):
        raise ValueError(f"reshard_wire_bytes: factor ranks differ "
                         f"({len(cur)} vs {len(new)})")
    for d in range(len(cur)):
        if new[d] % max(cur[d], 1) == 0:
            cur[d] = new[d]
    total = 0.0
    for d in range(len(cur)):
        if cur[d] == new[d]:
            continue
        others = 1
        for d2 in range(len(cur)):
            if d2 != d:
                others *= cur[d2]
        out = nbytes // others
        total += collective_wire_bytes("all-gather", out, cur[d])
        cur[d] = new[d]
    return total


_HLO_COMP_HEAD = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\([^)]*\)\s*->.*\{\s*$")
_HLO_INSTR = re.compile(
    r"^\s*(ROOT\s+)?%?([\w.\-]+)\s+=\s+"
    r"(\((?:[^()]|\([^()]*\))*\)|\S+)\s+"
    r"([\w\-]+)\(")


def _parse_hlo_computations(hlo: str) -> Dict[str, list]:
    """{computation name: [(is_root, value name, shape str, opcode,
    referenced names)]} for every computation in an HLO text dump. The
    ENTRY computation is additionally indexed under \"ENTRY\"."""
    comps: Dict[str, list] = {}
    cur: Optional[list] = None
    for line in hlo.splitlines():
        if cur is None:
            m = _HLO_COMP_HEAD.match(line.strip())
            if m:
                cur = comps[m.group(1)] = []
                if line.lstrip().startswith("ENTRY"):
                    comps["ENTRY"] = cur
            continue
        if line.strip() == "}":
            cur = None
            continue
        m = _HLO_INSTR.match(line)
        if not m:
            continue
        # strip metadata={...} before collecting %refs: op_name strings
        # can quote anything
        body = line.split("metadata=", 1)[0]
        refs = re.findall(r"%([\w.\-]+)", body)
        cur.append((bool(m.group(1)), m.group(2), m.group(3),
                    m.group(4), refs[1:]))  # refs[0] is the def itself
    return comps


def hlo_liveness_temp_bytes(hlo: str) -> int:
    """Peak live TEMP bytes of a compiled HLO module from a liveness walk
    over its (scheduled) instruction sequences — the DOCUMENTED fallback
    for backends whose `CompiledMemoryStats.temp_size_in_bytes` reads 0
    (this container's jaxlib-0.4.x CPU backend reports it only for some
    programs). A value is live from its defining instruction to its last
    textual use; called computations (fusion/while/reduce `to_apply`,
    `body`, `condition`...) contribute their own peak while the calling
    instruction is live. Parameters are argument buffers (counted in
    `argument_size_in_bytes`) and roots are the caller's (or, for ENTRY,
    the output) buffer, so both are excluded. An ESTIMATE: real buffer
    assignment aliases compatible buffers, so this bounds the measured
    temp from above — it exists so the measured census never silently
    reads a 0 the backend merely declined to report, and the ledger's
    accounting identity only charges measured bytes that EXCEED the
    prediction (observability/ledger.py check_memory_identity)."""
    comps = _parse_hlo_computations(hlo)
    entry = comps.get("ENTRY")
    if not entry:
        return 0
    memo: Dict[int, int] = {}

    def comp_peak(instrs, is_entry, chain):
        key = id(instrs)
        if not is_entry and key in memo:
            return memo[key]
        if key in chain:
            return 0   # recursive call graph: bound the walk
        n = len(instrs)
        defs: Dict[str, int] = {}
        sizes: Dict[str, int] = {}
        called_at: Dict[int, int] = {}
        for i, (is_root, name, shape, opcode, refs) in enumerate(instrs):
            if opcode == "parameter" or is_root:
                continue
            defs[name] = i
            try:
                sizes[name] = hlo_shape_bytes(shape)
            except ValueError:
                sizes[name] = 0
        last_use = dict(defs)
        for i, (_, _, _, _, refs) in enumerate(instrs):
            for r in refs:
                if r in defs:
                    last_use[r] = max(last_use[r], i)
                elif r in comps:
                    called_at[i] = called_at.get(i, 0) + comp_peak(
                        comps[r], False, chain + (key,))
        alloc: Dict[int, int] = {}
        free: Dict[int, int] = {}
        for name, d in defs.items():
            alloc[d] = alloc.get(d, 0) + sizes[name]
            free[last_use[name] + 1] = (free.get(last_use[name] + 1, 0)
                                        + sizes[name])
        peak = live = 0
        for t in range(n):
            live += alloc.get(t, 0) - free.get(t, 0)
            peak = max(peak, live + called_at.get(t, 0))
        if not is_entry:
            memo[key] = peak
        return peak

    return comp_peak(entry, True, ())


def census_wire_bytes(census: Dict[str, list], n_devices: int,
                      min_bytes: int = 0) -> float:
    """Total per-device interconnect bytes for one step, from a
    collective_census; instructions with output below `min_bytes` can be
    excluded (scalar loss/metric reductions)."""
    total = 0.0
    for kind, items in census.items():
        for b, _ in items:
            if b >= min_bytes:
                total += collective_wire_bytes(kind, b, n_devices)
    return total


# the port's measured census: torch.profiler's events of the collectives
# and point-to-point transfers a step ran, in collective_census's form.
# Every torch.distributed call records its dispatcher op ("c10d::allreduce_",
# "c10d::_allgather_base_", "c10d::send", ...: what the program asked for,
# the same on every backend), then the backend records its own, possibly on
# a worker thread: an event per call ("gloo:all_reduce", "nccl:all_reduce",
# with the tensor's shape and element type), and on NCCL a
# "record_param_comms" event whose metadata (where the profiler keeps it)
# names the collective, its element count and type. A coalesced group of
# sends, as `batch_isend_irecv` issues on the cards, has neither: the
# port's `collective.batch_p2p` runs it inside a range named
# P2P_SEND_RANGE + the sends' bytes. The kind comes from the dispatcher op
# (gloo runs a reduce-scatter as an all-reduce); the bytes from its output
# tensor, or, where it takes a tensor list, from the enclosing send range
# or the next backend record of that op, in start order.
P2P_SEND_RANGE = "ptpu_p2p/send_bytes="
_C10D_KINDS = {"allreduce_": ("all-reduce", "all_reduce"),
               "_allgather_base_": ("all-gather", "all_gather"),
               "allgather_": ("all-gather", "all_gather"),
               "allgather_into_tensor_coalesced_": ("all-gather",
                                                    "all_gather"),
               "_reduce_scatter_base_": ("reduce-scatter",
                                         "reduce_scatter"),
               "reduce_scatter_": ("reduce-scatter", "reduce_scatter"),
               "reduce_scatter_tensor_coalesced_": ("reduce-scatter",
                                                    "reduce_scatter"),
               "alltoall_base_": ("all-to-all", "all_to_all"),
               "alltoall_": ("all-to-all", "all_to_all"),
               "send": ("collective-permute", "send")}
# profiler element-type names -> bytes (the event dtypes' spelling, and
# record_param_comms' metadata spelling)
_PROFILER_ITEM_BYTES = {"float": 4, "double": 8, "c10::BFloat16": 2,
                        "c10::Half": 2, "long int": 8, "int": 4,
                        "short int": 2, "signed char": 1,
                        "unsigned char": 1, "bool": 1,
                        "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1,
                        "Float": 4, "Double": 8, "BFloat16": 2, "Half": 2,
                        "Long": 8, "Int": 4, "Short": 2, "Char": 1,
                        "Byte": 1, "Bool": 1}


def _event_bytes(shape, dtype) -> int:
    if dtype not in _PROFILER_ITEM_BYTES:
        raise ValueError(
            f"measured_collective_census: unrecognized element type "
            f"{dtype!r}; add it to _PROFILER_ITEM_BYTES")
    n = _PROFILER_ITEM_BYTES[dtype]
    for d in shape:
        n *= int(d)
    return n


def _param_comms(e):
    """(collective name, element count, element type) of a
    record_param_comms event, or None."""
    meta = e.extra_meta() if hasattr(e, "extra_meta") else {}
    name = meta.get("Collective name")
    if not name or "In msg nelems" not in meta or "dtype" not in meta:
        return None
    return name, int(meta["In msg nelems"]), meta["dtype"]


def measured_collective_census(prof) -> Dict[str, list]:
    """{kind: [(output_bytes, label)]} of every collective and
    point-to-point send one rank ran inside a `torch.profiler.profile`
    window opened with `record_shapes=True` (`prof`: the profile, or the
    list of its kineto events). The port's counterpart of
    `collective_census` over compiled HLO: `census_wire_bytes` applies to
    it unchanged. A send counts as one `collective-permute` of its bytes
    (a receive is the same transfer at its peer and is not counted);
    broadcasts and barriers are not gradient traffic and are skipped. A
    collective whose size no event gives raises ValueError."""
    events = prof
    if hasattr(prof, "profiler"):
        events = prof.profiler.kineto_results.events()
    out: Dict[str, list] = {}
    pending: Dict[str, list] = {}      # backend op -> [(kind, label)]
    send_bytes: List[int] = []         # from the enclosing send ranges
    for e in sorted(events, key=lambda e: e.start_ns()):
        name = e.name()
        if name.startswith(P2P_SEND_RANGE):
            send_bytes += [int(b) for b in
                           name[len(P2P_SEND_RANGE):].split(",") if b]
            continue
        if name.startswith("c10d::"):
            hit = _C10D_KINDS.get(name[len("c10d::"):])
            if hit is None:
                continue
            kind, op = hit
            shapes, dtypes = e.shapes(), e.dtypes()
            if shapes and dtypes and dtypes[0] in _PROFILER_ITEM_BYTES:
                # the dispatcher op's first argument is the output tensor
                out.setdefault(kind, []).append(
                    (_event_bytes(shapes[0], dtypes[0]), name))
            elif op == "send" and send_bytes:
                out.setdefault(kind, []).append((send_bytes.pop(0), name))
            else:
                pending.setdefault(op, []).append((kind, name))
            continue
        if name == "record_param_comms":
            pc = _param_comms(e)
            if pc is None or not pending.get(pc[0]):
                continue
            kind, label = pending[pc[0]].pop(0)
            out.setdefault(kind, []).append(
                (_event_bytes((pc[1],), pc[2]), label))
            continue
        backend, _, op = name.partition(":")
        if backend not in ("gloo", "nccl") or not pending.get(op):
            continue
        shapes, dtypes = e.shapes(), e.dtypes()
        if not shapes or not dtypes or not dtypes[0]:
            continue
        kind, label = pending[op].pop(0)
        out.setdefault(kind, []).append(
            (_event_bytes(shapes[0], dtypes[0]), label))
    left = [label for v in pending.values() for _, label in v]
    if left:
        raise ValueError(
            f"measured_collective_census: no event gave the size of "
            f"{len(left)} collective call(s) ({sorted(set(left))}); was "
            f"the profile recorded with record_shapes=True?")
    return out


# ---------------------------------------------------------------------------
# analytic per-op cost model (costs are RELATIVE: batch dims unknown until
# feed time use `nominal_batch`)
# ---------------------------------------------------------------------------

# ops that are pure markers / bookkeeping: zero device cost
_ZERO_COST_OPS = frozenset({"pp_send", "pp_recv", "feed", "fetch"})

# per-output-element flop weights for transcendental-ish elementwise ops
_ELEMENTWISE_FLOPS = {"softmax": 5.0, "exp": 4.0, "log": 4.0, "tanh": 6.0,
                      "sigmoid": 5.0, "relu": 1.0, "sqrt": 4.0, "pow": 4.0,
                      "elementwise_pow": 4.0, "gelu": 8.0,
                      "layer_norm": 8.0, "batch_norm": 6.0,
                      "softmax_with_cross_entropy": 8.0,
                      "cross_entropy": 4.0, "dropout": 2.0}


def _var_numel(block, name, nominal_batch):
    try:
        v = block.var(name)
    except Exception:
        return 0
    shape = getattr(v, "shape", None) or ()
    n = 1
    for d in shape:
        n *= (nominal_batch if d == -1 else int(d))
    return n


def _var_shape(block, name, nominal_batch):
    try:
        v = block.var(name)
    except Exception:
        return None
    shape = getattr(v, "shape", None)
    if shape is None:
        return None
    return [nominal_batch if d == -1 else int(d) for d in shape]


def op_cost_flops_bytes(op, block, nominal_batch: int = 8) -> Tuple[float,
                                                                    float]:
    """(flops, bytes) estimate for one program op, from declared var shapes
    (-1 batch dims resolved to `nominal_batch` — the model only needs to be
    RELATIVELY right to balance contiguous stages)."""
    if op.type in _ZERO_COST_OPS:
        return 0.0, 0.0
    in_n = sum(_var_numel(block, n, nominal_batch)
               for n in op.input_names())
    out_n = sum(_var_numel(block, n, nominal_batch)
                for n in op.output_names())
    bytes_ = 4.0 * (in_n + out_n)
    t = op.type
    if t in ("mul", "matmul"):
        xs = _var_shape(block, op.inputs["X"][0], nominal_batch)
        k = 1.0
        if xs:
            k = float(xs[-2] if op.attrs.get("transpose_X") and len(xs) >= 2
                      else xs[-1])
        return 2.0 * out_n * k, bytes_
    if t in ("conv2d", "conv3d", "conv2d_transpose", "conv3d_transpose",
             "depthwise_conv2d"):
        # filter is [num_filters, cin/groups, k...] in both layouts, so
        # per-output-element work = 2 * numel(filter) / num_filters
        fn = _var_numel(block, op.inputs["Filter"][0], nominal_batch)
        fs = _var_shape(block, op.inputs["Filter"][0], nominal_batch)
        nf = float(fs[0]) if fs else 1.0
        return 2.0 * out_n * (fn / max(nf, 1.0)), bytes_
    if t in ("dynamic_lstm", "fused_lstm", "dynamic_gru", "fused_gru"):
        wn = sum(_var_numel(block, n, nominal_batch)
                 for slot in ("Weight", "WeightX", "WeightH")
                 for n in op.inputs.get(slot, []))
        return 2.0 * max(out_n, in_n) * max(wn, 1) ** 0.5, bytes_
    if t == "lookup_table":
        return float(out_n), bytes_
    return _ELEMENTWISE_FLOPS.get(t, 1.0) * out_n, bytes_


def op_time_cost(flops: float, bytes_: float) -> float:
    """Roofline combine of one op's (flops, bytes): seconds at the card's
    peaks — whichever engine bounds it."""
    return max(flops / H100_PEAK_FLOPS, bytes_ / H100_HBM_BPS)


def op_step_cost(flops: float, bytes_: float) -> float:
    """Seconds one op adds to the port's eager step: its roofline time,
    and never less than the host's lowering of it (`H100_HOST_OP_S`), so
    a recomputed op is priced at what re-running it costs here."""
    return max(op_time_cost(flops, bytes_), H100_HOST_OP_S)


def program_flops_bytes(program, nominal_batch: int = 8) -> Dict:
    """Whole-program (block 0) analytic flops/bytes + roofline seconds —
    the per-op model summed, with the per-op roofline combine (so
    compute-bound and memory-bound ops each contribute their binding
    engine's time, the same combine the pipeline partitioner balances)."""
    block = program.global_block()
    flops = bytes_ = secs = 0.0
    for op in block.ops:
        f, b = op_cost_flops_bytes(op, block, nominal_batch)
        flops += f
        bytes_ += b
        secs += op_time_cost(f, b)
    return {"flops": flops, "bytes": bytes_,
            "roofline_s": secs, "n_ops": len(block.ops),
            "nominal_batch": nominal_batch}


def roofline_fields(step_s: float, flops: float, bytes_acc: float) -> Dict:
    """The shared attribution fields; None where the cost model gave 0."""
    out = {
        "step_ms": round(step_s * 1e3, 2),
        "bytes_GB": round(bytes_acc / 1e9, 2) if bytes_acc else None,
        "flops_G": round(flops / 1e9, 1) if flops else None,
        "intensity_flops_per_byte":
            round(flops / bytes_acc, 1) if flops and bytes_acc else None,
        "ideal_mxu_ms":
            round(flops / H100_PEAK_FLOPS * 1e3, 3) if flops else None,
        "ideal_hbm_ms":
            round(bytes_acc / H100_HBM_BPS * 1e3, 3) if bytes_acc else None,
        "mfu": round(mfu(flops, step_s), 4) if flops else None,
    }
    return out


def mfu(flops: float, step_s: float,
        peak_flops: Optional[float] = None) -> float:
    """Model-flops utilization: predicted step flops over measured step
    time, as a fraction of the hardware peak — the `ptpu_mfu` gauge and
    the benchmark row column (ROADMAP items 1 and 3(d) share this
    sensor)."""
    if not flops or step_s <= 0:
        return 0.0
    return flops / step_s / (peak_flops or H100_PEAK_FLOPS)


def state_category(v, name: str) -> str:
    """The ONE state-category classifier — the predicted walk
    (memory_categories) and the measured census
    (observability.memory.state_census) both call it, so the ledger's
    exact per-category checks can never fail from classifier drift.
    `v` may be None (an undeclared scope var): other_state."""
    if v is not None and (getattr(v, "dp_replica_state", False)
                          or name.startswith("dp_comm_err")):
        return "ef_residual"
    if v is not None and (getattr(v, "is_optimizer_state", False)
                          or getattr(v, "accumulator_of", None)):
        return "optimizer_state"
    if name.startswith("draft_") and (
            name.endswith("@qparam") or name.endswith("@qscale")
            or (v is not None and getattr(v, "trainable", False))):
        # speculative-decoding draft-model weights (serving/speculative.py
        # copies target weights under the reserved `draft_` prefix): their
        # own census category, so the target-weight claims (params /
        # params_quantized) stay unchanged when a draft rides along. The
        # prefix check precedes the suffix check — a quantized draft
        # weight `draft_*@qparam` is params_draft, not params_quantized
        return "params_draft"
    if name.endswith("@qparam") or name.endswith("@qscale"):
        # quantize_params_pass payload/scale pairs: classified by NAME
        # suffix (the pass's census contract) because Program.clone() only
        # preserves whitelisted extra var attrs
        return "params_quantized"
    if v is not None and getattr(v, "trainable", False):
        return "params"
    return "other_state"


def _tp_local(shape, v, tp: int) -> list:
    """A var's per-device shape under the tp rewrite (framework/
    sharding.py's rule): its `tp_spec` dims split over tp."""
    if tp > 1 and getattr(v, "tp_spec", None):
        from .sharding import tp_local_shape
        return list(tp_local_shape(shape, v.tp_spec, tp))
    return list(shape)


# per-device byte prediction for one persistable var, from its declared
# shape + the rewrite markers that decide its placement (the static twin
# of ParallelExecutor._state_sharding)
def _state_per_device_bytes(v, dp: int, tp: int,
                            nominal_batch: int) -> int:
    shape = _tp_local([nominal_batch if d == -1 else int(d)
                       for d in (v.shape or ())], v, tp)
    # the var's own dtype: the port keeps 64-bit state, as the measured
    # census counts it
    n = convert_dtype(v.dtype).itemsize
    for d in shape:
        n *= d
    if dp > 1 and (getattr(v, "dp_shard_update", False)
                   or getattr(v, "dp_replica_state", False)):
        n //= dp
    return n


def memory_categories(program, *, dp: int = 1, tp: int = 0,
                      nominal_batch: int = 8) -> Dict:
    """Predicted PER-DEVICE memory by category for one (rewritten)
    program — the prediction side of the memory ledger's accounting
    identity (observability/ledger.py check_memory_identity):

      params           trainable persistable state (replicated; tp-local
                       when the tp pass marked a `tp_spec`)
      params_quantized block-scaled weight payload+scale pairs left by
                       quantize_params_pass (`@qparam`/`@qscale` suffix)
      params_draft     speculative-decoding draft-model weights (the
                       reserved `draft_` name prefix minted by
                       serving/speculative.py; quantized draft payloads
                       `draft_*@qparam` land here, not params_quantized)
      optimizer_state  accumulators (`is_optimizer_state`/`accumulator_of`);
                       dim 0 / dp when `dp_shard_update` (ZeRO-1)
      ef_residual      per-replica error-feedback state
                       (`dp_replica_state`, declared [dp, n] over dp)
      other_state      remaining persistables (counters, caches)
      feeds            declared data vars: batch-led ([-1, ...]) rows
                       split over dp, fixed-shape aux feeds replicated —
                       the manual-mode placement rule. Undeclared sidecar
                       feeds (`@SEQLEN`) cannot be predicted statically;
                       they surface in the ledger's named residual bucket
      seed             the step's uint32 RNG seed (4 bytes)
      transient_peak   static peak-live estimate at the per-device batch
                       (analysis.peak_live_bytes at nominal_batch // dp)

    Placement rules mirror ParallelExecutor._state_sharding exactly; the
    SPMD Reduce heuristic (un-marked accumulator sharding) is NOT
    modeled — predict for the manual/explicit modes or dp=1."""
    cats = {"params": 0, "params_quantized": 0, "params_draft": 0,
            "optimizer_state": 0, "ef_residual": 0, "other_state": 0,
            "feeds": 0, "seed": 4}
    if tp <= 1 and getattr(program, "_tp_applied", False):
        tp = int(getattr(program, "_tp_size", 0) or 0)
    seen = set()
    for b in program.blocks:
        for name, v in b.vars.items():
            if name in seen:
                continue
            seen.add(name)
            if v.persistable:
                nb = _state_per_device_bytes(v, dp, tp, nominal_batch)
                cats[state_category(v, name)] += nb
            elif getattr(v, "is_data", False):
                shape = list(v.shape or ())
                # the var's own dtype, as the measured side
                # (memory.device_memory_census) counts what is resident
                nb = convert_dtype(v.dtype).itemsize
                for d in shape:
                    nb *= (nominal_batch if d == -1 else int(d))
                if shape and shape[0] == -1 and dp > 1:
                    nb //= dp
                cats["feeds"] += nb
    local_batch = max(1, nominal_batch // max(dp, 1))
    from .analysis import peak_live_bytes
    cats["transient_peak"] = int(peak_live_bytes(
        program, nominal_batch=local_batch)["peak_transient_bytes"])
    # the QUANTIZED gradient pipeline's working set is internal to the
    # dp_grad_comm lowering (quantize -> all_to_all -> f32 dequant-sum
    # -> quantized all_gather, parallel/collective.py) and invisible to
    # the program-level lifetime walk; the f32 dequant buffer dominates
    # at ~= the flat gradient bytes. Named separately so the ledger
    # artifact shows what was added and why.
    comm_ws = 0
    for b in program.blocks:
        for op in b.ops:
            if op.type != "dp_grad_comm" or not op.attrs.get("quant"):
                continue
            for name in op.input_names():
                v = None
                for b2 in program.blocks:
                    if b2.has_var(name):
                        v = b2.var(name)
                        break
                if v is None or v.shape is None:
                    continue
                nb = 4
                for d in v.shape:
                    nb *= (local_batch if d == -1 else int(d))
                comm_ws += nb
    cats["dp_comm_working_set"] = comm_ws
    cats["transient_peak"] += comm_ws
    # the PIPELINE region's executed working set is schedule state the
    # lifetime walk cannot see either (peak_live_bytes explicitly defers
    # it to the pipeline stash census): the activation + gradient stash
    # buffers at their census depths (one boundary buffer per in-flight
    # microbatch), and the per-stage gradient accumulator plus its
    # update copy (the scan carry's new-value buffer co-resides with
    # the old one while the backward adds into it).
    pp_ws = 0
    if getattr(program, "_pp_applied", False):
        region = next((op for op in program.global_block().ops
                       if op.type == "pp_pipeline_region"), None)
        if region is not None:
            from ..parallel.pipeline import (pp_boundary_wire_bytes,
                                             schedule_census)
            m = int(region.attrs["num_microbatches"])
            k = int(region.attrs["num_stages"])
            sched = schedule_census(region.attrs["schedule"], m, k)
            mb_rows = max(1, nominal_batch // max(1, dp * m))
            wire = pp_boundary_wire_bytes(program, mb_rows)
            boundary = (int(wire["buffer_numel"]) * 4) if wire else 0
            grad_bytes = 0
            for b in program.blocks:
                for v in b.vars.values():
                    if not (getattr(v, "trainable", False)
                            and v.persistable):
                        continue
                    shape = _tp_local(list(v.shape or ()), v, tp)
                    nb = 4
                    for d in shape:
                        nb *= d
                    grad_bytes += nb
            pp_ws = (boundary * (int(sched["act_stash_depth"])
                                 + int(sched["grad_stash_depth"]))
                     + 2 * grad_bytes)
    cats["pp_working_set"] = pp_ws
    cats["transient_peak"] += pp_ws
    cats["dp"] = dp
    cats["tp"] = tp
    cats["nominal_batch"] = nominal_batch
    return cats


# ---------------------------------------------------------------------------
# predict(): one call joining every analytic model for a (possibly
# rewrite-passed) program — the ledger's prediction side and the planner's
# objective function
# ---------------------------------------------------------------------------


def speculative_expectation(gamma: int, acceptance,
                            draft_cost_ratio: Optional[float] = None,
                            draft_layers: Optional[int] = None,
                            num_layers: Optional[int] = None,
                            draft_bits: int = 32,
                            verify_widening: float = 0.05) -> Dict:
    """Analytic expectation for speculative decoding (the `speculative`
    section of `predict`): expected committed tokens per round under
    per-token acceptance rate α is the truncated geometric sum
    (1-α^(γ+1))/(1-α) — every round commits at least one token (the
    target's own output) and at most γ+1 (full acceptance + bonus).

    `acceptance` is a probability OR a zero-arg callable returning one —
    the hook that feeds a MEASURED rate (e.g. a serving engine's
    `spec.acceptance_rate`) into the model, TVM-style like
    auto_parallel.plan's measure_fn. Costs are in PLAIN-TICK units: the
    draft tick ratio defaults to (draft_layers/num_layers)·(bits/32) —
    the memory-bound weight-read scaling of serving/speculative.py's
    truncated, quantized draft — and the verify forward pays a widening
    term per extra query position (the γ+1-wide window reads the same
    weights/KV once; only activation compute widens)."""
    from ..core.enforce import InvalidArgumentError, enforce
    a = float(acceptance() if callable(acceptance) else acceptance)
    enforce(0.0 <= a <= 1.0,
            f"acceptance must be a probability, got {a}",
            exc=InvalidArgumentError)
    g = int(gamma)
    enforce(g >= 1, "gamma must be >= 1", exc=InvalidArgumentError)
    expected = (g + 1.0 if a >= 1.0
                else (1.0 - a ** (g + 1)) / (1.0 - a))
    if draft_cost_ratio is None:
        lr = (float(draft_layers) / float(num_layers)
              if draft_layers and num_layers else 1.0)
        draft_cost_ratio = lr * (float(draft_bits) / 32.0)
    draft_cost = (g + 1) * float(draft_cost_ratio)
    verify_cost = 1.0 + float(verify_widening) * g
    round_cost = draft_cost + verify_cost
    return {
        "gamma": g,
        "acceptance": a,
        "expected_tokens_per_round": expected,
        # one target forward (the verify) per round: the amortization
        # headline tools/bench_spec.py measures
        "tokens_per_target_forward": expected,
        "draft_ticks_per_round": g + 1,
        "draft_cost_ratio": float(draft_cost_ratio),
        "draft_cost_ticks": draft_cost,
        "verify_widening": float(verify_widening),
        "verify_cost_ticks": verify_cost,
        "round_cost_ticks": round_cost,
        "speedup_vs_plain_decode": expected / round_cost,
    }


def predict(program, strategy=None, *, dp: int = 1, tp: int = 0,
            nominal_batch: int = 8,
            speculative: Optional[Dict] = None) -> Dict:
    """Joined analytic cost prediction for one program.

    `program` should be the program the executor will actually run — for
    the manual modes that is the REWRITTEN program
    (`ParallelExecutor._prepare_program(prog, scope)`), whose markers
    (`_dp_comm_applied`, `_pp_applied`, `_tp_applied`) select which wire
    models apply. `strategy` (a BuildStrategy) is only consulted for
    documentation fields; every byte/bubble number comes from the program
    itself so prediction and execution cannot drift.

    Returns a CostReport dict with sections:
      compute:   program_flops_bytes (flop/byte roofline)
      dp_comm:   grad_comm.analytic_wire_bytes (explicit pipeline) or
                 spmd_allreduce_wire_bytes (SPMD), when dp > 1
      tp_comm:   sharding.tp_analytic_wire_bytes, when the tp pass ran
      pipeline:  schedule_census bubble/stash model +
                 pp_boundary_wire_bytes, when the pp pass ran
      memory:    analysis.peak_live_bytes
      speculative: speculative_expectation(**speculative), when the
                 caller describes a speculative-decoding deployment
                 ({"gamma":, "acceptance":, ...} — acceptance may be a
                 callable reading a measured rate)
    Sections that don't apply are None — a ledger row records that the
    model was consulted and judged inapplicable, not silently skipped.
    """
    from . import analysis as _analysis
    from . import sharding as _sharding
    from ..parallel import grad_comm as _gc

    report: Dict = {
        "nominal_batch": nominal_batch,
        "dp": dp,
        "compute": program_flops_bytes(program, nominal_batch),
        "dp_comm": None,
        "tp_comm": None,
        "pipeline": None,
        "offload": None,
        "speculative": (speculative_expectation(**speculative)
                        if speculative else None),
        "memory": {
            **_analysis.peak_live_bytes(program,
                                        nominal_batch=nominal_batch),
            # the MEASURED counterpart's attribution target: per-device
            # state/feed/transient bytes by category
            # (ledger.check_memory_identity reconciles a
            # device_memory_census against exactly these buckets)
            "per_device": memory_categories(program, dp=dp, tp=tp,
                                            nominal_batch=nominal_batch),
        },
    }
    if getattr(program, "_memory_plan_applied", False):
        # the static memory plan's decision record rides the prediction:
        # the ledger's conservative transient estimate stays UNPLANNED
        # (so a planned cell's measured reduction surfaces in the NAMED
        # unrealized:transient_peak bucket, never the residual), and this
        # section says what the plan predicted it bought and how
        plan = dict(getattr(program, "_memory_plan_report", {}) or {})
        report["memory"]["plan"] = {
            "predicted_peak_before": plan.get("predicted_peak_before"),
            "predicted_peak_after": plan.get("predicted_peak_after"),
            "predicted_reduction_bytes":
                plan.get("predicted_reduction_bytes"),
            "n_slots": plan.get("n_slots"),
            "shared_vars": plan.get("shared_vars"),
            "remat": plan.get("remat"),
            "pp_stages": plan.get("pp_stages"),
            "schedule": plan.get("schedule"),
        }
        if strategy is not None and getattr(strategy, "memory_plan", False):
            # PLAN-AWARE memory pricing (the auto-parallel planner's
            # view): the ledger's conservative estimates above stay
            # UNPLANNED on purpose — a planned cell's measured reduction
            # must keep landing in the NAMED unrealized:transient_peak
            # bucket, so the identity checks never change — and the
            # planned expectation rides in NEW keys instead. The plan's
            # peak_before/after ratio is scale-invariant, so it applies
            # to the per-device transient (priced at the local batch)
            # as well as the whole-program peak; the dp-comm/pipeline
            # working sets are schedule state the plan cannot touch.
            before = float(plan.get("predicted_peak_before") or 0)
            after = float(plan.get("predicted_peak_after") or 0)
            if before > 0:
                frac = min(max(after / before, 0.0), 1.0)
                per_dev = report["memory"]["per_device"]
                fixed_ws = (per_dev.get("dp_comm_working_set", 0)
                            + per_dev.get("pp_working_set", 0))
                base = max(0, per_dev["transient_peak"] - fixed_ws)
                per_dev["transient_peak_planned"] = int(base * frac
                                                        + fixed_ws)
                mem = report["memory"]
                mem["planned_peak_total_bytes"] = int(
                    mem["persistent_bytes"] + mem["feed_bytes"]
                    + mem["peak_transient_bytes"] * frac)
    if dp > 1:
        spmd_model = _gc.spmd_allreduce_wire_bytes
        if _enum_name(getattr(strategy, "reduce_strategy", None)) \
                == "Reduce":
            # the ZeRO-1 SPMD mode costs MORE wire than plain allreduce
            # (grad allreduce + sharded-update param all-gather); an
            # allreduce-priced Reduce point would win planner comparisons
            # unfairly
            spmd_model = _gc.spmd_zero1_wire_bytes
        report["dp_comm"] = (_gc.analytic_wire_bytes(program, dp)
                             or spmd_model(program, dp))
        report["dp_comm"]["explicit"] = bool(
            getattr(program, "_dp_comm_applied", False))
    if getattr(program, "_tp_applied", False):
        tpn = tp or int(getattr(program, "_tp_size", 0) or 0)
        if tpn > 1:
            report["tp_comm"] = _sharding.tp_analytic_wire_bytes(
                program, tpn, nominal_batch=nominal_batch)
    if getattr(program, "_pp_applied", False):
        from ..parallel.pipeline import (pp_boundary_wire_bytes,
                                         schedule_census)
        region = next((op for op in program.global_block().ops
                       if op.type == "pp_pipeline_region"), None)
        if region is not None:
            m = int(region.attrs["num_microbatches"])
            k = int(region.attrs["num_stages"])
            sched = schedule_census(region.attrs["schedule"], m, k)
            mb_rows = max(1, nominal_batch // max(1, dp * m))
            wire = pp_boundary_wire_bytes(program, mb_rows)
            report["pipeline"] = {**sched,
                                  "boundary": wire,
                                  "microbatch_rows": mb_rows,
                                  "grad_psum_wire_bytes":
                                      _pp_grad_psum_bytes(program, k)}
    if strategy is not None and getattr(strategy, "offload_optimizer_state",
                                        False):
        # host-offload pricing (framework/offload.py): the optimizer
        # state's per-step PCIe round-trip (restore h2d before the step,
        # spill d2h after) against the step's compute window. HBM keeps
        # only ~one in-flight transfer bucket resident; the rest moves
        # to the host tier. `hides` is the planner's verdict — when the
        # round-trip exceeds the per-device compute window the residual
        # is CHARGED to predicted_step_seconds, so an offload point that
        # cannot overlap loses the search instead of lying about it.
        per_dev = report["memory"]["per_device"]
        opt_bytes = int(per_dev.get("optimizer_state", 0))
        bucket = int(getattr(strategy, "comm_bucket_bytes", 0) or 0)
        resident = min(opt_bytes, bucket) if bucket else opt_bytes
        pcie_s = 2.0 * opt_bytes / H100_PCIE_BPS
        window = report["compute"]["roofline_s"] / max(dp, 1)
        report["offload"] = {
            "optimizer_state_bytes": opt_bytes,
            "resident_bytes": resident,
            "hbm_freed_bytes": max(0, opt_bytes - resident),
            "pcie_bps": H100_PCIE_BPS,
            "pcie_roundtrip_s": pcie_s,
            "overlap_window_s": window,
            "residual_s": max(0.0, pcie_s - window),
            "hides": pcie_s <= window,
        }
    if strategy is not None:
        report["strategy"] = {
            "reduce_strategy": str(getattr(strategy, "reduce_strategy", "")),
            "quant_comm": getattr(strategy, "quant_comm", ""),
            "pipeline_stages": getattr(strategy, "pipeline_stages", 0),
            "num_microbatches": getattr(strategy, "num_microbatches", 0),
            "pipeline_schedule": getattr(strategy, "pipeline_schedule", ""),
        }
    return report


def _enum_name(v):
    """An enum member's name (the JAX package's strategy enums, or any
    object carrying the same names), else the value itself."""
    return getattr(v, "name", v)


def _pp_grad_psum_bytes(program, k: int) -> int:
    """Per-device wire bytes of the pipeline region's ONE gradient psum
    over the pp axis (run_pp_region: grads accumulate per stage, one
    psum over pp replicates them for the optimizer) — an all-reduce of
    every trainable gradient, ring 2n(K-1)/K. Grads live at tp-LOCAL
    shapes when the tp pass rewrote the program."""
    tp = int(getattr(program, "_tp_size", 0) or 0) \
        if getattr(program, "_tp_applied", False) else 0
    total = 0.0
    for b in program.blocks:
        for v in b.vars.values():
            if not (getattr(v, "trainable", False) and v.persistable):
                continue
            shape = list(v.shape or ())
            shape = _tp_local(shape, v, tp)
            n = 4
            for d in shape:
                n *= d
            total += 2.0 * n * (k - 1) / k
    return int(total)


def predicted_wire_bytes(report: Dict) -> float:
    """Predicted per-device wire bytes per step on the ONCE-PER-STEP
    collectives (dp gradient pipeline + tp collectives) — the number the
    ledger reconciles EXACTLY with the collective census. The pipeline's
    boundary collective-permutes are deliberately excluded: they execute
    2(M+K-1) times inside the tick scan but appear once in the static
    census, so they are reconciled structurally instead
    (ledger.check_pp_boundary: instruction count == 2, per-instruction
    bytes == the predicted cut buffer)."""
    total = 0.0
    if report.get("dp_comm"):
        total += report["dp_comm"].get("wire_bytes", 0)
    if report.get("tp_comm"):
        total += report["tp_comm"].get("tp_wire_bytes", 0)
    pipe = report.get("pipeline")
    if pipe:
        total += pipe.get("grad_psum_wire_bytes", 0)
    return total


# ---------------------------------------------------------------------------
# planner-facing scalarization: one CostReport -> predicted seconds/bytes.
# The auto-parallel planner (framework/auto_parallel.py) minimizes
# predicted_step_seconds subject to predicted_device_bytes <= HBM; both
# read ONLY the report, so prediction and search can never disagree on
# what a strategy costs.
# ---------------------------------------------------------------------------


def predicted_device_bytes(report: Dict, planned: bool = True) -> int:
    """Predicted per-device footprint of one step from a predict()
    report: the per-device state/feed/seed categories plus the transient
    peak — the memory-PLANNED transient (`transient_peak_planned`,
    priced by predict() when the strategy set memory_plan) when present
    and `planned` is True, the unplanned estimate otherwise."""
    per_dev = report["memory"]["per_device"]
    total = sum(int(per_dev.get(c, 0))
                for c in ("params", "optimizer_state", "ef_residual",
                          "other_state", "feeds", "seed"))
    transient = per_dev["transient_peak"]
    if planned and "transient_peak_planned" in per_dev:
        transient = per_dev["transient_peak_planned"]
    off = report.get("offload")
    if off:
        # host-offloaded optimizer state: only the resident transfer
        # window stays on device — the capacity lever the offload knob
        # buys (the freed bytes are priced, not assumed: the same
        # report's residual_s charges any unhidden round-trip time)
        total -= int(off.get("hbm_freed_bytes", 0))
    return int(max(0, total) + transient)


def predicted_step_seconds(report: Dict, *, mesh_axes: Optional[Dict] = None,
                           strategy=None,
                           ici_bps: Optional[float] = None,
                           hbm_bps: Optional[float] = None,
                           coll_launch_s: float = 2e-6) -> Dict:
    """Scalarize one predict() report into predicted step seconds on the
    card's constants (`ici_bps` defaults to H100_NVLINK_BPS, `hbm_bps` to
    H100_HBM_BPS) — the auto-parallel planner's objective. A RELATIVE
    model (like the pipeline partitioner's balance signal): it only has
    to rank strategies, not to forecast wall-clock on any particular
    host. Terms:

      compute_s   roofline seconds of the whole program divided over
                  dp*tp*K (dp splits the batch, tp the sharded matmuls,
                  pipeline stages run concurrently)
      bubble_s    the schedule's fill/drain overhead on that compute:
                  compute * ((M+K-1)/M - 1), the executed-table bubble
      dp_comm_s / tp_comm_s / pp_comm_s
                  per-device wire bytes / ici_bps (ring models; the pp
                  term adds the boundary permutes — 2 per tick — and the
                  pp-axis gradient psum)
      quant_s     the quantized pipeline's quantize -> f32 dequant-sum
                  -> requantize working-set passes (~3x the flat f32
                  gradient bytes at HBM speed) — what makes int8 wire a
                  LOSS for models whose gradients are small enough that
                  the saved wire never amortizes it (the measured r08
                  CPU-mesh attribution, priced instead of ignored)
      launch_s    per-collective launch overhead x the plan's launch
                  count — what makes comm_bucket_bytes a searched knob
                  (fewer, larger transfers) instead of a free one
      offload_s   the unhidden residual of the offloaded optimizer
                  state's PCIe round-trip (report `offload` section)
                  after overlapping this point's per-device compute —
                  zero when the transfer hides entirely
    """
    ici_bps = ici_bps or H100_NVLINK_BPS
    hbm_bps = hbm_bps or H100_HBM_BPS
    axes = dict(mesh_axes or {})
    dp = int(axes.get("dp", report.get("dp", 1)) or 1)
    # credit the tp split ONLY when the tp rewrite actually ran (the
    # report carries a tp_comm section): a tp mesh axis over a program
    # without executable sharding runs REPLICATED — charging tp-divided
    # compute for it would make wasted devices look free
    tp = int(axes.get("tp", 1) or 1) if report.get("tp_comm") else 1
    pipe = report.get("pipeline")
    k = int(pipe["num_stages"]) if pipe else 1
    compute = report["compute"]["roofline_s"] / max(dp * tp * max(k, 1), 1)
    bubble = 0.0
    if pipe:
        m = int(pipe["num_microbatches"])
        bubble = compute * ((m + k - 1) / m - 1.0)
    dp_comm_s = tp_comm_s = pp_comm_s = quant_s = 0.0
    launches = 0
    dpc = report.get("dp_comm")
    if dpc:
        dp_comm_s = dpc.get("wire_bytes", 0) / ici_bps
        launches += int(dpc.get("n_transfers", 0))
        if (strategy is not None and getattr(strategy, "quant_comm", "")
                and dpc.get("explicit")):
            quant_s = 3.0 * dpc.get("grad_f32_bytes", 0) / hbm_bps
    tpc = report.get("tp_comm")
    if tpc:
        tp_comm_s = tpc.get("tp_wire_bytes", 0) / ici_bps
        launches += int(sum((tpc.get("tp_op_counts") or {}).values()))
    if pipe:
        pp_comm_s = pipe.get("grad_psum_wire_bytes", 0) / ici_bps
        boundary = pipe.get("boundary") or {}
        pp_comm_s += boundary.get("pp_boundary_bytes", 0) / ici_bps
        launches += 2 * int(boundary.get("ticks_per_step", 0)) + 1
    launch_s = coll_launch_s * launches
    offload_s = 0.0
    off = report.get("offload")
    if off:
        # the optimizer-state PCIe round-trip overlaps THIS mesh point's
        # per-device compute; only the unhidden residual is charged
        # (recomputed against this point's compute so the term and the
        # search window can never disagree)
        offload_s = max(0.0, off.get("pcie_roundtrip_s", 0.0) - compute)
    total = (compute + bubble + dp_comm_s + tp_comm_s + pp_comm_s
             + quant_s + launch_s + offload_s)
    return {"compute_s": compute, "bubble_s": bubble,
            "dp_comm_s": dp_comm_s, "tp_comm_s": tp_comm_s,
            "pp_comm_s": pp_comm_s, "quant_s": quant_s,
            "launch_s": launch_s, "n_collective_launches": launches,
            "offload_s": offload_s,
            "total_s": total}


# ---------------------------------------------------------------------------
# compile-free strategy feasibility: the SAME gates the executor/pass
# stack raises at run time, surfaced statically with NAMED reasons — the
# auto-parallel planner's pruning predicate and the lint_program
# --strategy surface.
# ---------------------------------------------------------------------------


class Feasibility:
    """Result of strategy_is_feasible: `ok`, the named `reasons`
    ([{code, message}]) when not, and — for a feasible deep check — the
    `program` AS THE EXECUTOR WOULD RUN IT (tp/dp-comm/pipeline/
    memory-plan rewrites applied), ready for costs.predict."""

    def __init__(self, ok: bool, reasons, program=None):
        self.ok = bool(ok)
        self.reasons = list(reasons)
        self.program = program

    def reason_codes(self):
        return sorted({r["code"] for r in self.reasons})

    def __repr__(self):
        return (f"Feasibility(ok={self.ok}, "
                f"reasons={self.reason_codes()})")

    def __bool__(self):
        return self.ok


def _reason(code: str, message: str) -> Dict:
    return {"code": code, "message": message}


# ≙ parallel/mesh.py's axis names, parallel/pipeline.py's schedules and
# parallel/grad_comm.py's op sets (kept here so the cost model does not
# import the parallel package)
DATA_AXIS, MODEL_AXIS, PIPELINE_AXIS = "dp", "tp", "pp"
PIPELINE_SCHEDULES = ("gpipe", "1f1b")
_BATCH_GLOBAL_OPS = frozenset({"batch_norm"})
_MEAN_LOSS_OPS = frozenset({"mean", "reduce_mean"})


def strategy_is_feasible(program, strategy, *, mesh_axes: Dict,
                         nominal_batch: int = 8,
                         deep: bool = True) -> Feasibility:
    """Would `(strategy, mesh_axes)` execute this program? The checks are
    the executor/pass gates themselves, run statically (nothing runs)
    and mapped to NAMED rejection codes — a config this function accepts
    cannot be rejected by ParallelExecutor at run time, and one it
    rejects names the same condition the run-time enforce would raise:

      quant-invalid          quant_comm outside {'', 'int8', 'bf16'}
      gradient-scale-unsupported  CoeffNumDevice (executor __init__)
      mesh-mismatch          pipeline_stages vs pp axis size, explicit
                             comm without a dp axis, schedule unknown
      batch-indivisible      batch % dp (explicit comm) or % (dp*M)
                             (pipeline) != 0 (_pad_for_dp)
      batch-norm             whole-batch statistics ops under a manual
                             mode (grad_comm/pipeline _BATCH_GLOBAL_OPS)
      non-mean-loss          manual modes need a MEAN-reduced loss
      sp-manual-conflict     enable_sequence_parallel + manual mode
      non-tp-sharded-param   parameter sharded over a live non-tp axis
                             (_gate_manual_mode)
      multi-region           pipeline needs exactly one vjp_region
      pp-too-few-ops         fewer forward ops than stages
      tp-unannotated         manual tp>1 on a program with no sharding
                             annotations
      tp-indivisible         an annotated dim does not divide by tp
      tp-spec-conflict       sharding propagation conflict diagnostics
      narrow-cut             pipeline_partition_pass boundary validation
                             (wide cut / persistable / non-float / sink)
      tp-gate / dp-gate / pp-gate / memory-plan-gate
                             any remaining pass enforce, verbatim

    With `deep=True` (default) the surviving config is pushed through
    the ACTUAL rewrite passes in executor order (tp -> dp-comm ->
    pipeline -> memory plan) so pass-internal gates — narrow-cut
    validity above all — run for real, and the rewritten program rides
    back on the result for costs.predict. `deep=False` stops after the
    cheap structural checks (the planner's first pruning sweep)."""
    from ..core.enforce import EnforceError
    from . import sharding as _sharding
    from .analysis import ProgramAnalysisError

    axes = dict(mesh_axes or {})
    dp = int(axes.get(DATA_AXIS, 1) or 1)
    pp = int(axes.get(PIPELINE_AXIS, 1) or 1)
    tp = int(axes.get(MODEL_AXIS, 1) or 1)
    reasons = []

    quant = getattr(strategy, "quant_comm", "") or ""
    if quant not in ("", "int8", "bf16"):
        reasons.append(_reason(
            "quant-invalid",
            f"BuildStrategy.quant_comm must be '', 'int8' or 'bf16', "
            f"got {quant!r}"))
        quant = ""
    if _enum_name(getattr(strategy, "gradient_scale_strategy", None)) \
            == "CoeffNumDevice":
        reasons.append(_reason(
            "gradient-scale-unsupported",
            "GradientScaleStrategy.CoeffNumDevice is not implemented "
            "(the SPMD global-batch mean already scales the loss)"))

    stages = int(getattr(strategy, "pipeline_stages", 0) or 0)
    m = int(getattr(strategy, "num_microbatches", 1) or 1)
    schedule = getattr(strategy, "pipeline_schedule", "1f1b")
    explicit = (_enum_name(getattr(strategy, "reduce_strategy", None))
                == "ReduceScatter") or bool(quant)
    manual = explicit or stages >= 2

    if stages >= 2 and pp != stages:
        reasons.append(_reason(
            "mesh-mismatch",
            f"pipeline_stages={stages} needs a pp mesh axis of exactly "
            f"that size; mesh axes are {axes}"))
    if stages < 2 and pp > 1:
        reasons.append(_reason(
            "mesh-mismatch",
            f"mesh carries a pp axis of size {pp} but the strategy asks "
            f"for no pipeline (pipeline_stages={stages})"))
    if stages >= 2 and schedule not in PIPELINE_SCHEDULES:
        reasons.append(_reason(
            "mesh-mismatch",
            f"pipeline_schedule must be one of {PIPELINE_SCHEDULES}, "
            f"got {schedule!r}"))
    if explicit and DATA_AXIS not in axes:
        reasons.append(_reason(
            "mesh-mismatch",
            f"the explicit gradient pipeline (ReduceScatter/quant_comm) "
            f"needs a {DATA_AXIS!r} axis in the mesh, got {axes}"))

    if explicit and nominal_batch % max(dp, 1) != 0:
        reasons.append(_reason(
            "batch-indivisible",
            f"batch {nominal_batch} is not divisible by dp={dp}: the "
            f"explicit gradient pipeline derives the global-mean "
            f"gradient from EQUAL per-shard batches"))
    if stages >= 2 and nominal_batch % max(dp * m, 1) != 0:
        reasons.append(_reason(
            "batch-indivisible",
            f"batch {nominal_batch} is not divisible by dp * "
            f"num_microbatches = {dp} * {m}: the pipeline schedule "
            f"derives the global-mean loss from EQUAL microbatches"))

    if manual and getattr(strategy, "enable_sequence_parallel", False):
        reasons.append(_reason(
            "sp-manual-conflict",
            "sequence-parallel feed splitting cannot compose with the "
            "manual execution modes (whole per-shard sequences)"))

    block0 = program.global_block()
    if manual:
        bad = sorted({op.type for op in block0.ops
                      if op.type in _BATCH_GLOBAL_OPS})
        if bad:
            reasons.append(_reason(
                "batch-norm",
                f"ops {bad} fold statistics over the WHOLE batch and "
                f"would silently compute per-shard statistics under a "
                f"manual mode"))
        live = {a for a, s in axes.items() if int(s or 1) > 1}
        for b in program.blocks:
            for v in b.vars.values():
                spec = getattr(v, "sharding_spec", None)
                if not v.persistable or spec is None:
                    continue
                names = set()
                for s in spec:
                    if isinstance(s, (tuple, list)):
                        names.update(s)
                    elif s is not None:
                        names.add(s)
                non_tp = sorted((names & live) - {MODEL_AXIS})
                if non_tp:
                    reasons.append(_reason(
                        "non-tp-sharded-param",
                        f"parameter {v.name!r} is sharded over mesh "
                        f"axes {non_tp}; only the tp axis has a manual-"
                        f"mode rewrite pass"))

    regions = [op for op in block0.ops if op.type == "vjp_region"]
    if manual:
        for rop in regions:
            loss_name = rop.attrs["loss"]
            producer = next(
                (o for o in reversed(block0.ops)
                 if loss_name in o.output_names()
                 and o.type != "vjp_region"), None)
            if producer is None or producer.type not in _MEAN_LOSS_OPS:
                reasons.append(_reason(
                    "non-mean-loss",
                    f"loss {loss_name!r} is produced by "
                    f"{producer.type if producer else '<nothing>'}; the "
                    f"manual modes require a MEAN-reduced loss "
                    f"(layers.mean / reduce_mean)"))
    if stages >= 2:
        if len(regions) != 1:
            reasons.append(_reason(
                "multi-region",
                f"pipeline partitioning supports exactly one backward "
                f"region (vjp_region), found {len(regions)}"))
        elif len(list(regions[0].attrs["fwd_ops"])) < stages:
            reasons.append(_reason(
                "pp-too-few-ops",
                f"cannot cut {len(list(regions[0].attrs['fwd_ops']))} "
                f"forward ops into {stages} non-empty stages"))

    if tp > 1 and manual:
        if not _sharding.has_tp_annotations(program):
            reasons.append(_reason(
                "tp-unannotated",
                f"mesh carries a tp axis of size {tp} but the program "
                f"has no tp sharding annotations "
                f"(ParamAttr(sharding_spec=...) / annotate_tp)"))
        else:
            res = _sharding.propagate_sharding(program, tp_size=tp)
            for d in res.diagnostics:
                if d.severity != "error":
                    continue
                code = ("tp-indivisible"
                        if d.code == "shard-divisibility"
                        else "tp-spec-conflict")
                reasons.append(_reason(code, f"{d.loc}: {d.message}"))

    if reasons:
        return Feasibility(False, reasons)
    if not deep:
        return Feasibility(True, [])

    # -- deep check: the actual rewrite passes, executor order ------------
    from ..parallel import grad_comm as _gc
    from ..parallel import pipeline as _pipeline
    from .passes import get_pass

    rewritten = program
    try:
        if (tp > 1 and manual
                and _sharding.has_tp_annotations(rewritten)
                and not getattr(rewritten, "_tp_applied", False)):
            rewritten = get_pass("tp_shard_pass", tp=tp)(rewritten)
    except (EnforceError, ProgramAnalysisError) as e:
        return Feasibility(False, [_reason("tp-gate", str(e))])
    cfg = _gc.explicit_comm_config(strategy)
    if cfg is not None and not getattr(rewritten, "_dp_comm_applied",
                                       False):
        try:
            rewritten = _gc.comm_optimize_pass(rewritten, dp, cfg)
        except (EnforceError, ProgramAnalysisError) as e:
            return Feasibility(False, [_reason("dp-gate", str(e))])
    pcfg = _pipeline.pipeline_config(strategy)
    if pcfg is not None and not getattr(rewritten, "_pp_applied", False):
        try:
            rewritten = get_pass(
                "pipeline_partition_pass",
                num_stages=pcfg["stages"],
                num_microbatches=pcfg["microbatches"],
                schedule=pcfg["schedule"],
                nominal_batch=nominal_batch,
                dp_axis="dp" if "dp" in axes else "",
                reduce_dp=("dp" in axes
                           and not getattr(rewritten, "_dp_comm_applied",
                                           False)),
            )(rewritten)
        except (EnforceError, ProgramAnalysisError) as e:
            msg = str(e)
            code = ("narrow-cut"
                    if ("narrow activation cut" in msg
                        or "carries no activation" in msg
                        or "may cross a stage cut" in msg
                        or "cannot cross a pipeline cut" in msg
                        or "cannot be pruned" in msg)
                    else "pp-too-few-ops" if "cannot cut" in msg
                    else "pp-gate")
            return Feasibility(False, [_reason(code, msg)])
    if getattr(strategy, "memory_plan", False) \
            and not getattr(rewritten, "_memory_plan_applied", False):
        from . import memory_plan as _memory_plan  # noqa: F401 (registers)
        try:
            budget = float(getattr(strategy, "memory_plan_time_budget_s",
                                   0.0) or 0.0)
            rewritten = get_pass(
                "memory_plan_pass",
                nominal_batch=nominal_batch,
                time_budget_s=(budget or None),
                time_budget_frac=float(getattr(strategy,
                                               "memory_plan_time_frac",
                                               0.02)),
                remat_prevent_cse=bool(getattr(strategy,
                                               "memory_plan_prevent_cse",
                                               False)),
            )(rewritten)
        except (EnforceError, ProgramAnalysisError) as e:
            return Feasibility(False, [_reason("memory-plan-gate",
                                               str(e))])
    return Feasibility(True, [], rewritten)
