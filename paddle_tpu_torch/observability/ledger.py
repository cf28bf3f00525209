"""≙ paddle_tpu/observability/ledger.py, line for line: predicted against
measured, per run. The measured memory census it reconciles is the
port's (observability/memory.py: the caching allocator's figures on a
card); the collective census `set_census` takes is the measured one
(`costs.measured_collective_census`, NCCL's calls in torch.profiler).

Cost ledger: predicted-vs-measured reconciliation in one artifact.

Every evidence round so far published its analytic-vs-census comparison
through a bespoke script (bench_dp wire bytes, probe_bubble slot fits,
bench_tp ring sums). The ledger is the common form: one row per
(model, strategy) run joining

  predicted:  a `framework.costs.predict()` CostReport
  measured:   the HLO collective census (exact), span aggregates from the
              tracer (timing), and any run-reported numbers (losses,
              step_ms)
  checks:     named predicted-vs-measured comparisons, each with the
              tolerance it was held to and whether it passed.

`write()` emits the BENCH_OBS artifact; `check_*` helpers implement the
two standing reconciliation disciplines — EXACT byte balance for
collectives (r08/r11) and banded agreement for bubbles (r09).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..core.enforce import InvalidArgumentError, enforce
from ..framework.costs import census_wire_bytes, predicted_wire_bytes


class LedgerRow:
    """One run's predicted-vs-measured record."""

    def __init__(self, name: str, config: Optional[Dict] = None):
        self.name = name
        self.config = dict(config or {})
        self.predicted: Optional[Dict] = None
        self.measured: Dict = {}
        self.checks: List[Dict] = []

    # -- inputs -----------------------------------------------------------
    def set_prediction(self, report: Dict):
        """Attach a framework.costs.predict() CostReport."""
        self.predicted = report
        return self

    def set_census(self, census: Dict, n_devices: int,
                   min_bytes: int = 8):
        """Attach an HLO collective census (framework.costs
        .collective_census output); stores per-kind counts/bytes and the
        ring-model wire total. `min_bytes` excludes scalar loss/metric
        reductions, matching the r08 test discipline."""
        step_census = {k: v for k, v in census.items()
                       if k != "collective-permute"}
        self.measured["census"] = {
            "collectives": {k: len(v) for k, v in census.items()},
            "bytes_by_kind": {k: sum(b for b, _ in v)
                              for k, v in census.items()},
            # once-per-step collectives only: pipeline boundary permutes
            # run per TICK inside the scan (see check_pp_boundary)
            "wire_bytes": int(census_wire_bytes(step_census, n_devices,
                                                min_bytes=min_bytes)),
            "permute_bytes": [b for b, _ in
                              census.get("collective-permute", [])],
            "n_devices": n_devices,
            "min_bytes": min_bytes,
        }
        return self

    def set_spans(self, aggregate: Dict):
        """Attach a tracing.aggregate() table (per-name timing rows)."""
        self.measured["spans"] = {
            k: {f: round(v, 4) if isinstance(v, float) else v
                for f, v in row.items()}
            for k, row in aggregate.items()}
        return self

    def set_measured(self, **fields):
        self.measured.update(fields)
        return self

    def set_memory_census(self, census: Dict):
        """Attach a measured memory census
        (observability.memory.device_memory_census output — per-device
        state categories from the actual arrays, feed bytes, and the XLA
        executable's argument/output/temp/alias figures)."""
        self.measured["memory"] = census
        return self

    # -- reconciliation ---------------------------------------------------
    def _check(self, what, predicted, measured, tolerance, ok):
        rec = {"what": what, "predicted": predicted, "measured": measured,
               "tolerance": tolerance, "ok": bool(ok)}
        self.checks.append(rec)
        return rec

    def check_wire_bytes_exact(self) -> Dict:
        """Predicted per-device wire bytes must equal the census ring
        total EXACTLY — the r08/r11 byte-balance discipline. Requires
        set_prediction and set_census first."""
        enforce(self.predicted is not None and "census" in self.measured,
                f"ledger row {self.name!r}: need both a prediction and a "
                f"census before check_wire_bytes_exact",
                exc=InvalidArgumentError)
        pred = int(predicted_wire_bytes(self.predicted))
        meas = int(self.measured["census"]["wire_bytes"])
        return self._check("wire_bytes", pred, meas, "exact", pred == meas)

    def check_pp_boundary(self) -> Dict:
        """Structural reconciliation of the pipeline boundary transfers
        (the r09 discipline): the compiled step must carry EXACTLY 2
        collective-permutes (one act shift + one grad shift), each moving
        the predicted cut buffer's bytes. Their per-step total is
        per-tick x ticks, which the static census cannot count — hence
        structural, not summed."""
        enforce(self.predicted is not None
                and self.predicted.get("pipeline") is not None
                and "census" in self.measured,
                f"ledger row {self.name!r}: need a pipeline prediction "
                f"and a census before check_pp_boundary",
                exc=InvalidArgumentError)
        boundary = self.predicted["pipeline"]["boundary"]
        pred_bytes = int(boundary["buffer_numel"]) * 4
        meas = sorted(self.measured["census"]["permute_bytes"])
        ok = meas == [pred_bytes, pred_bytes]
        return self._check("pp_boundary_permutes",
                           [pred_bytes, pred_bytes], meas,
                           "exactly 2, exact bytes", ok)

    def check_bubble_fraction(self, measured_fraction: float,
                              band: float = 0.02) -> Dict:
        """Predicted schedule-table bubble fraction vs a measured one,
        within `band` (the r09 2% wall-clock band)."""
        enforce(self.predicted is not None
                and self.predicted.get("pipeline") is not None,
                f"ledger row {self.name!r}: prediction has no pipeline "
                f"section", exc=InvalidArgumentError)
        pred = self.predicted["pipeline"]["bubble_fraction"]
        ok = abs(pred - measured_fraction) <= band
        return self._check("bubble_fraction", pred, measured_fraction,
                           f"abs<={band}", ok)

    #: categories whose per-device bytes are EXACTLY predictable from
    #: declared shapes + placement markers (costs.memory_categories) —
    #: any drift is a placement/accounting bug, not noise
    MEMORY_EXACT_CATEGORIES = ("params", "params_quantized",
                               "params_draft", "optimizer_state",
                               "ef_residual", "other_state", "feeds")

    def check_memory_identity(self, residual_frac: float = 0.10) -> Dict:
        """The r17 memory accounting identity: every MEASURED per-device
        byte of the step's footprint is attributed to a predicted
        category or lands in an explicitly NAMED residual bucket, and
        the named residual stays bounded. Three disciplines in one
        check set (requires set_prediction — with the memory.per_device
        section — and set_memory_census first):

        1. `memory_<cat>` per category in MEMORY_EXACT_CATEGORIES:
           measured == predicted EXACTLY (declared shapes + placement
           markers fully determine these; `unrealized:<cat>` /
           `unattributed:<cat>` buckets name any drift).
        2. `memory_args_balance`: the category walk must re-derive the
           XLA executable's own argument figure —
           state_total + feeds + seed == argument_bytes within 64 bytes
           (scalar-seed/alignment slack). Catches a category the walk
           missed entirely.
        3. `memory_residual_bound`: unattributed measured bytes (the
           sum of every `unattributed:<cat>` bucket, dominated by
           measured temp exceeding the static transient estimate)
           <= residual_frac of the measured peak footprint.

        The identity itself — sum(attributed) + sum(unattributed) ==
        measured total — holds by construction and is recorded in the
        check's `buckets` field for the artifact."""
        enforce(self.predicted is not None
                and isinstance(self.predicted.get("memory"), dict)
                and "per_device" in self.predicted["memory"]
                and "memory" in self.measured,
                f"ledger row {self.name!r}: need a prediction carrying "
                f"memory.per_device (costs.predict) AND a memory census "
                f"(set_memory_census) before check_memory_identity",
                exc=InvalidArgumentError)
        pred = self.predicted["memory"]["per_device"]
        mem = self.measured["memory"]
        mcats = mem["state"]["categories"]
        measured = {
            "params": mcats["params"],
            "params_quantized": mcats["params_quantized"],
            "params_draft": mcats["params_draft"],
            "optimizer_state": mcats["optimizer_state"],
            "ef_residual": mcats["ef_residual"],
            # kv_cache is the census's refinement of other_state (slot
            # caches are plain persistables to the static walk, which
            # prices them under other_state) — attribute them together
            # so a serving census with kv_names set reconciles instead
            # of pushing every KV byte into unattributed
            "other_state": mcats["other_state"] + mcats["kv_cache"],
            "feeds": mem["feeds"]["per_device_bytes"],
            "seed": mem["seed_bytes"],
            "transient_peak": mem["xla"]["temp_bytes"],
        }
        predicted = {c: float(pred.get(c, 0)) for c in measured}
        attributed, buckets = {}, {}
        for c, mv in measured.items():
            pv = predicted[c]
            attributed[c] = min(mv, pv)
            if mv > pv + 0.5:
                buckets[f"unattributed:{c}"] = mv - pv
            elif pv > mv + 0.5:
                buckets[f"unrealized:{c}"] = pv - mv
        for c in self.MEMORY_EXACT_CATEGORIES:
            self._check(f"memory_{c}", predicted[c], measured[c],
                        "exact", abs(predicted[c] - measured[c]) < 0.5)
        args_lhs = (mcats["state_total"]
                    + mem["feeds"]["per_device_bytes"]
                    + mem["seed_bytes"])
        args_rhs = mem["xla"]["argument_bytes"]
        self._check("memory_args_balance", round(args_lhs), args_rhs,
                    "abs<=64", abs(args_lhs - args_rhs) <= 64)
        unattributed = sum(v for k, v in buckets.items()
                           if k.startswith("unattributed:"))
        peak = float(mem["peak_bytes"])
        rec = self._check(
            "memory_residual_bound", round(residual_frac * peak),
            round(unattributed), f"unattributed<={residual_frac}*peak",
            unattributed <= residual_frac * peak)
        rec["buckets"] = {k: round(v) for k, v in buckets.items()}
        rec["attributed_total"] = round(sum(attributed.values()))
        rec["measured_total"] = round(sum(measured.values()))
        rec["peak_bytes"] = round(peak)
        # the identity proper: attribution is a partition of measured
        assert abs((sum(attributed.values()) + unattributed)
                   - sum(measured.values())) < 1.0
        return rec

    def check_plan_reduction(self, unplanned, *, min_reduction: float = 0.0,
                             time_band: float = 0.02) -> Dict:
        """Reconcile a memory-PLANNED cell against its unplanned twin
        (the r18 acceptance shape — bench_mem --plan): `unplanned` is the
        twin's row-shaped dict {"memory": census, "step_ms": float}.

        1. `plan_state_feeds_invariant`: the plan may only move TRANSIENT
           bytes — state/feed/seed categories must match the unplanned
           census exactly (a plan that changed resident state re-placed
           something it had no business touching).
        2. `plan_reduction_named`: the measured peak reduction must be
           fully explained by the transient/temp category — the named
           side of the r17 identity — not by drift in the residual
           (|Δpeak − Δtemp| bounded by the output-alias slack).
        3. `plan_step_time_band`: planned step time within `time_band`
           of unplanned.
        4. `plan_reduction_floor`: peak reduction >= `min_reduction`
           (fraction; 0 records the measured value without gating).
        """
        enforce("memory" in self.measured
                and isinstance(unplanned, dict)
                and "memory" in unplanned,
                f"ledger row {self.name!r}: need a memory census on both "
                f"the planned row and the unplanned twin",
                exc=InvalidArgumentError)
        mem_p, mem_u = self.measured["memory"], unplanned["memory"]
        sp = dict(mem_p["state"]["categories"],
                  feeds=mem_p["feeds"]["per_device_bytes"])
        su = dict(mem_u["state"]["categories"],
                  feeds=mem_u["feeds"]["per_device_bytes"])
        cats = ("params", "params_quantized", "params_draft",
                "optimizer_state", "ef_residual", "kv_cache",
                "other_state", "feeds")
        same_state = all(abs(sp[c] - su[c]) < 0.5 for c in cats)
        # record every compared category so a failing artifact row shows
        # WHICH one the plan perturbed
        self._check("plan_state_feeds_invariant",
                    {c: round(su[c]) for c in cats},
                    {c: round(sp[c]) for c in cats},
                    "exact", same_state)
        d_peak = float(mem_u["peak_bytes"]) - float(mem_p["peak_bytes"])
        d_temp = float(mem_u["xla"]["temp_bytes"]) \
            - float(mem_p["xla"]["temp_bytes"])
        slack = 64 + abs(
            (mem_u["xla"]["output_bytes"] - mem_u["xla"]["alias_bytes"])
            - (mem_p["xla"]["output_bytes"] - mem_p["xla"]["alias_bytes"]))
        self._check("plan_reduction_named", round(d_temp), round(d_peak),
                    "Δpeak == Δtemp (named transient category)",
                    abs(d_peak - d_temp) <= slack)
        t_p = self.measured.get("step_ms")
        t_u = unplanned.get("step_ms")
        if t_p is not None and t_u is not None and t_u > 0:
            # one-sided: the plan must not SLOW the step past the band;
            # a faster planned step is a win, never a violation
            rel = t_p / t_u - 1.0
            self._check("plan_step_time_band", f"<= +{time_band:.0%}",
                        round(rel, 4), f"rel<={time_band}",
                        rel <= time_band)
        frac = d_peak / max(float(mem_u["peak_bytes"]), 1.0)
        rec = self._check("plan_reduction_floor", min_reduction,
                          round(frac, 4), f">={min_reduction}",
                          frac >= min_reduction)
        rec["planned_peak_bytes"] = round(float(mem_p["peak_bytes"]))
        rec["unplanned_peak_bytes"] = round(float(mem_u["peak_bytes"]))
        rec["reduction_bytes"] = round(d_peak)
        return rec

    def check(self, what: str, predicted, measured, rel: float) -> Dict:
        """Generic relative-tolerance comparison."""
        denom = max(abs(measured), 1e-12)
        ok = abs(predicted - measured) / denom <= rel
        return self._check(what, predicted, measured, f"rel<={rel}", ok)

    @property
    def ok(self) -> bool:
        return all(c["ok"] for c in self.checks)

    def to_dict(self) -> Dict:
        return {"name": self.name, "config": self.config,
                "predicted": self.predicted, "measured": self.measured,
                "checks": self.checks, "ok": self.ok}


class CostLedger:
    """A run's collection of rows + one artifact writer."""

    def __init__(self, run: str, meta: Optional[Dict] = None):
        self.run = run
        self.meta = dict(meta or {})
        self.rows: List[LedgerRow] = []

    def row(self, name: str, **config) -> LedgerRow:
        r = LedgerRow(name, config)
        self.rows.append(r)
        return r

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.rows)

    def to_dict(self) -> Dict:
        return {"run": self.run, "meta": self.meta, "ok": self.ok,
                "rows": [r.to_dict() for r in self.rows]}

    def write(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, default=_json_default)
            f.write("\n")
        return path


def _json_default(o):
    try:
        import numpy as np
        if isinstance(o, np.generic):
            return o.item()
    except ImportError:
        pass
    return str(o)
