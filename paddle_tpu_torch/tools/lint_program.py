"""Static program linter CLI over framework/analysis.py.

≙ tools/lint_program.py, with the same flags, JSON rows and exit
contract. Builds any model from paddle_tpu_torch/models (training nets
AND the serving engine's programs, at the JAX tool's sizes), optionally
applies the parallelism rewrite passes (--tp / --dp / --pipeline_stages),
runs the full static analyzer (structural + parallel + dataflow
verification AND whole-program shape/dtype inference), prints a
diagnostics table with block/op#/op.type provenance, and reports the
static peak-live-bytes estimate from variable lifetimes. Only the
quantized decode tick runs a program (its startup, so the quantize pass
has weights): on `--place`, the card by default.

    python -m paddle_tpu_torch.tools.lint_program --model mnist
    python -m paddle_tpu_torch.tools.lint_program --model transformer_lm \
        --pipeline_stages 2 --num_microbatches 4
    python -m paddle_tpu_torch.tools.lint_program --all --json
    python -m paddle_tpu_torch.tools.lint_program --all --dp 2 --json \
        --allow_gate_rejects --place cpu

--json emits ONE machine-readable document on stdout (a list of per-model
objects: model, config, ops, diagnostics [{code, severity, loc, message}],
inference/memory summaries, gate_rejected) and nothing else, for a CI gate
to consume instead of scraping the table.

Exit status:
  0  every analyzed program is clean (warnings allowed); models whose
     requested config was rejected by a pass gate count as SKIPPED only
     under --allow_gate_rejects
  1  at least one error-severity diagnostic
  2  a pass gate rejected the requested config (tp/dp/pipeline enforce)
     and --allow_gate_rejects was not given — the config does not apply
     to that model, which is itself a lint finding for a hand-picked run
     but expected noise for a sweep
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import add_place_arg, resolve_place

# builders returning None build an INFERENCE program (no loss to minimize)
# into the default main program — the serving path (engine decode tick,
# prefill/generate) rides these.
def _builders(place=None):
    """The JAX tool's 23 builders at its sizes; `place` is where the
    quantized decode tick runs its startup program (default: the
    card)."""
    from paddle_tpu_torch import layers, models

    def mt():
        from paddle_tpu_torch.models import machine_translation as m
        src = layers.data("src", shape=[8], dtype="int64")
        src_lens = layers.data("src_lens", shape=[], dtype="int64")
        tgt_in = layers.data("tgt_in", shape=[8], dtype="int64")
        tgt_out = layers.data("tgt_out", shape=[8], dtype="int64")
        tgt_mask = layers.data("tgt_mask", shape=[8], dtype="float32")
        return m.train_net(src, src_lens, tgt_in, tgt_out, tgt_mask,
                           dict_size=1000, embed_dim=64, hidden_dim=64)[0]

    def decode_tick():
        # the continuous-batching engine's compiled step
        # (serving_engine.py builds exactly this shape)
        models.transformer.transformer_lm_decode_tick(
            n_slots=4, vocab=1000, max_len=32, d_model=64, d_inner=128,
            num_heads=4, num_layers=2)
        return None

    def paged_decode_tick():
        # the paged engine's compiled step (serving/kv_pager.py builds
        # exactly this shape: block-table gather + paged_cache_write)
        models.transformer.transformer_lm_paged_decode_tick(
            n_slots=4, n_blocks=17, block_size=8, blocks_per_req=4,
            vocab=1000, d_model=64, d_inner=128, num_heads=4,
            num_layers=2)
        return None

    def quant_decode_tick():
        # the weight-only quantized engine's compiled step: the decode
        # tick rewritten in place by quantize_params_pass (startup runs
        # first so the pass has real weight arrays to quantize)
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.framework.passes import get_pass
        models.transformer.transformer_lm_decode_tick(
            n_slots=4, vocab=1000, max_len=32, d_model=64, d_inner=128,
            num_heads=4, num_layers=2)
        pt.Executor(place).run(pt.default_startup_program())
        get_pass("quantize_params_pass", bits=8)(
            pt.default_main_program(), pt.global_scope())
        return None

    def draft_tick():
        # the speculative draft model's compiled tick
        # (serving/speculative.py builds exactly this shape: the
        # target's architecture at half depth, weights under the
        # reserved draft_ prefix, logp emitted for rejection sampling)
        models.transformer.transformer_lm_decode_tick(
            n_slots=4, vocab=1000, max_len=32, d_model=64, d_inner=128,
            num_heads=4, num_layers=1, cache_prefix="lintdr",
            param_prefix="draft_", emit_logp=True)
        return None

    def spec_verify_tick():
        # the speculative verify forward: γ+1 window positions scored
        # through ONE target forward against the slot caches
        models.transformer.transformer_lm_spec_verify_tick(
            n_slots=4, gamma=4, vocab=1000, max_len=32, d_model=64,
            d_inner=128, num_heads=4, num_layers=2)
        return None

    def paged_spec_verify_tick():
        # ... and its paged twin: the same window scored through the
        # block-table gather + paged_cache_write path
        models.transformer.transformer_lm_paged_spec_verify_tick(
            n_slots=4, gamma=4, n_blocks=17, block_size=8,
            blocks_per_req=4, vocab=1000, d_model=64, d_inner=128,
            num_heads=4, num_layers=2)
        return None

    def prefill():
        # the teacher-forced prefill + greedy/beam generation program the
        # engine's prompt phase shares weights with
        models.transformer.transformer_lm_generate(
            vocab=1000, max_gen=8, d_model=64, d_inner=128, num_heads=4,
            num_layers=2, beam_size=4)
        return None

    return {
        "mnist": lambda: models.mnist.mlp()[0],
        "mnist_conv": lambda: models.mnist.conv_net()[0],
        "resnet": lambda: models.resnet.resnet_imagenet(depth=50)[0],
        "resnet_cifar10": lambda: models.resnet.resnet_cifar10(depth=20)[0],
        "vgg": lambda: models.vgg.vgg16_cifar()[0],
        "alexnet": lambda: models.alexnet.alexnet_imagenet()[0],
        "googlenet": lambda: models.googlenet.googlenet_imagenet()[0],
        "se_resnext": lambda: models.se_resnext.se_resnext_imagenet(
            depth=50)[0],
        "deepfm": lambda: models.deepfm.deepfm()[0],
        "ssd": lambda: models.ssd.ssd_detector()[0],
        "ocr_crnn": lambda: models.ocr_crnn.crnn_ctc()[0],
        "stacked_lstm": lambda: models.stacked_lstm.stacked_lstm_net(
            dict_dim=10000, emb_dim=128, hid_dim=128)[0],
        "lstm_lm": lambda: models.stacked_lstm.lstm_language_model(
            vocab_size=10000, emb_dim=64, hid_dim=64)[0],
        "transformer_lm": lambda: models.transformer.transformer_lm(
            vocab=1000, max_len=32, d_model=64, d_inner=128, num_heads=4,
            num_layers=2)[0],
        "transformer_lm_tp": _tp_transformer,
        "transformer_lm_decode_tick": decode_tick,
        "transformer_lm_quant_decode_tick": quant_decode_tick,
        "transformer_lm_paged_decode_tick": paged_decode_tick,
        "transformer_lm_draft_tick": draft_tick,
        "transformer_lm_spec_verify_tick": spec_verify_tick,
        "transformer_lm_paged_spec_verify_tick": paged_spec_verify_tick,
        "transformer_lm_prefill": prefill,
        "machine_translation": mt,
    }


def _tp_transformer():
    """tp-annotated transformer_lm: Megatron column/row/vocab shardings
    applied by parallel.auto_shard.annotate_tp; lint with --tp 2 to also
    run the tp_shard_pass rewrite and lint the spliced program."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.parallel import annotate_tp
    loss, _ = models.transformer.transformer_lm(
        vocab=1000, max_len=32, d_model=64, d_inner=128, num_heads=4,
        num_layers=2, mean_loss=True)
    annotate_tp()
    return loss


def _human(n):
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024.0


def _config_desc(args):
    cfg = {}
    if args.tp >= 2:
        cfg["tp"] = args.tp
    if args.dp >= 2:
        cfg["dp"] = args.dp
    if args.pipeline_stages >= 2:
        cfg["pipeline_stages"] = args.pipeline_stages
        cfg["num_microbatches"] = args.num_microbatches
    if args.memory_plan:
        cfg["memory_plan"] = True
    if getattr(args, "offload", False):
        cfg["offload"] = True
    if args.strategy:
        cfg["strategy"] = args.strategy
    return cfg


_STRATEGY_KEYS = ("dp", "pp", "tp", "microbatches", "schedule", "reduce",
                  "quant", "bucket_bytes", "memory_plan", "offload")


def _parse_strategy(text):
    """--strategy JSON -> a StrategyPoint (auto_parallel's point type).
    Unknown keys raise with the accepted key list."""
    from paddle_tpu_torch.framework.auto_parallel import StrategyPoint
    cfg = json.loads(text)
    bad = sorted(set(cfg) - set(_STRATEGY_KEYS))
    if bad:
        raise SystemExit(
            f"--strategy: unknown key(s) {bad}; accepted keys are "
            f"{list(_STRATEGY_KEYS)}")
    return StrategyPoint(**cfg)


def _apply_strategy(prog, point, args):
    """--strategy: the SAME compile-free feasibility check the
    auto-parallel planner prunes with (costs.strategy_is_feasible) over
    a user-supplied joint config — named rejection reasons statically
    instead of executor enforce raises at run time. Returns
    (program-as-the-executor-would-run-it, feasibility dict,
    gate_reason)."""
    from paddle_tpu_torch.framework import costs as _costs
    feas = _costs.strategy_is_feasible(
        prog, point.to_build_strategy(), mesh_axes=point.mesh_axes(),
        nominal_batch=args.batch_size)
    record = {"point": point.describe(), "ok": feas.ok,
              "reasons": feas.reasons}
    if not feas.ok:
        gate = "; ".join(f"[{r['code']}] {r['message']}"
                         for r in feas.reasons)
        return prog, record, f"strategy infeasible: {gate}"
    return feas.program, record, None


def _apply_config(prog, name, args):
    """tp -> dp -> pipeline, the ParallelExecutor._prepare_program order.
    Returns (program, gate_reason): gate_reason is the enforce text when a
    pass rejected the config (a lint FINDING for a hand-picked run,
    expected noise for a sweep — see the exit-code contract)."""
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.framework import analysis
    from paddle_tpu_torch.framework import sharding as _sharding
    from paddle_tpu_torch.framework.passes import get_pass

    if args.tp >= 2:
        if not _sharding.has_tp_annotations(prog):
            return prog, (f"--tp {args.tp}: model has no tp sharding "
                          f"annotations (only tp-annotated builders, e.g. "
                          f"transformer_lm_tp, take the tp config)")
        try:
            prog = get_pass("tp_shard_pass", tp=args.tp)(prog)
        except (EnforceError, analysis.ProgramAnalysisError) as e:
            return prog, f"tp_shard_pass: {e}"
    if args.dp >= 2:
        from paddle_tpu_torch.parallel.grad_comm import comm_optimize_pass
        cfg = {"shard_update": True, "quant": "", "block": 512,
               "error_feedback": False,
               "bucket_bytes": args.comm_bucket_bytes}
        try:
            prog = comm_optimize_pass(prog, args.dp, cfg)
        except EnforceError as e:
            return prog, f"comm_optimize_pass: {e}"
    if args.pipeline_stages >= 2:
        try:
            prog = get_pass(
                "pipeline_partition_pass",
                num_stages=args.pipeline_stages,
                num_microbatches=args.num_microbatches,
                dp_axis="dp" if args.dp >= 2 else "",
                reduce_dp=False)(prog)
        except EnforceError as e:
            return prog, f"pipeline_partition_pass: {e}"
    if args.memory_plan:
        # the import registers the pass
        from paddle_tpu_torch.framework import memory_plan  # noqa: F401
        try:
            # a generous budget so lint always analyzes a NON-trivial
            # plan: the budget gates candidates only under the
            # mandated-recompute mode, but keeping it wide here means a
            # future mode flip still lints the fullest plan the search
            # can choose
            prog = get_pass("memory_plan_pass",
                            nominal_batch=args.batch_size,
                            time_budget_s=1.0)(prog)
        except (EnforceError, analysis.ProgramAnalysisError) as e:
            return prog, f"memory_plan_pass: {e}"
    return prog, None


def _restore_diagnostics(prog, args):
    """--restore_dir: statically check that an elastic snapshot restores
    onto THIS program/config (parallel/elastic.py; the recovery drill's
    lint half). Emitted as error-severity diagnostics:

      restore-uncommitted     no committed snapshot / integrity failure
      restore-digest-mismatch a file's content digest disagrees with the
                              COMMIT record (silent corruption)
      restore-missing-var     program declares state the snapshot lacks
      restore-shape-mismatch  saved shape != declared shape
      restore-dp-indivisible  a ZeRO-1-sharded var cannot split over --dp
      restore-ef-unmappable   error-feedback state cannot re-map N→M

    verify_program over the (rewritten) program runs as part of the
    normal lint — a clean report therefore means "the restored program's
    sharded-state placement passes verify_program AND the snapshot's
    contents fit it"."""
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.framework.analysis import Diagnostic
    from paddle_tpu_torch.io import _is_persistable, _select_vars
    from paddle_tpu_torch.parallel import elastic
    from paddle_tpu_torch.sharded_checkpoint import ShardedCheckpoint

    diags = []
    try:
        snap = elastic._resolve_snapshot_dir(args.restore_dir)
        elastic.validate_snapshot(snap)
    except elastic.SnapshotDigestError as e:
        return [Diagnostic("restore-digest-mismatch", args.restore_dir,
                           str(e))]
    except EnforceError as e:
        return [Diagnostic("restore-uncommitted", args.restore_dir,
                           str(e))]
    meta = elastic.read_meta(snap)
    ckpt = ShardedCheckpoint(snap)
    saved = ckpt.vars
    dp = args.dp if args.dp >= 2 else int(meta.get("world", {})
                                          .get("dp", 1))
    new_ef = elastic._ef_layout(prog)
    old_ef = meta.get("ef_layout")
    ef_vars = {t["var"] for t in (new_ef or {}).get("transfers", ())}
    if new_ef is not None:
        if old_ef is None:
            diags.append(Diagnostic(
                "restore-ef-unmappable", snap,
                "program carries error-feedback state but the snapshot "
                "recorded no ef_layout"))
        else:
            old_grads = {g for t in old_ef["transfers"]
                         for g in t["grads"]}
            lost = sorted({g for t in new_ef["transfers"]
                           for g in t["grads"]} - old_grads)
            if lost:
                diags.append(Diagnostic(
                    "restore-ef-unmappable", snap,
                    f"no saved residuals for gradient(s) {lost[:4]}"))
    for v in _select_vars(prog, _is_persistable):
        if v.name in ef_vars or getattr(v, "dp_replica_state", False):
            continue  # re-mapped from ef_layout, not restored by name
        entry = saved.get(v.name)
        if entry is None:
            diags.append(Diagnostic(
                "restore-missing-var", snap,
                f"program declares persistable {v.name!r} but the "
                f"snapshot lacks it"))
            continue
        decl = list(v.shape or ())
        if decl and -1 not in decl and list(entry["shape"]) != decl:
            diags.append(Diagnostic(
                "restore-shape-mismatch", snap,
                f"{v.name!r}: saved {entry['shape']} vs declared {decl}"))
            continue
        if getattr(v, "dp_shard_update", False) and dp >= 2:
            if not entry["shape"] or entry["shape"][0] % dp != 0:
                diags.append(Diagnostic(
                    "restore-dp-indivisible", snap,
                    f"ZeRO-1-sharded {v.name!r} dim0 "
                    f"{entry['shape'] and entry['shape'][0]} does not "
                    f"split over dp={dp}"))
    return diags


def _offload_diagnostics(prog, loss, args):
    """--offload: statically check the host-tier transfer schedules
    (framework/offload.py) of the program being linted.

    Train-step programs (loss is not None): walk the block for
    optimizer-state reads/writes and verify the ZeRO-offload round-trip
    (restore at step entry, spill after last access) never reads a var
    before its h2d arrives — `offload-use-before-arrival` BY NAME when
    it would.

    Serving tick programs (loss is None): build the two-tier prefetch
    schedule for a window of suspended requests through the SHIPPED
    policy helper (`offload.prefetch_issue_tick` — shared code with
    PagedKVEngine, not a copy) and run the same checker, so a policy
    edit that issues prefetches after their read fails lint before it
    ships."""
    from paddle_tpu_torch.framework import offload as _offload
    if loss is not None:
        events = _offload.optimizer_roundtrip_events(prog)
        kind = "optimizer_roundtrip"
    else:
        distance = 2
        reads = {f"resume_t{t}": t for t in range(distance, distance + 4)}
        events = _offload.kv_prefetch_events(reads, distance)
        kind = "kv_prefetch"
    diags = _offload.check_schedule(events)
    return ({"schedule": kind, "events": len(events),
             "violations": len(diags)}, diags)


def _serving_diagnostics(prog, loss, args):
    """--serving: the serving-tier ownership verifier.

    Three static surfaces, all named-diagnostic:

    1. cache-write aliasing over the program being linted
       (dataflow.cache_write_aliasing): `serving-cache-write-alias` /
       `serving-cache-stale-read` against the executor's donated-state
       contract (builders pass out=pool, so Cache IS Out).
    2. the two-tier prefetch schedule re-checked under speculative
       rollback windows (offload.check_schedule rollback_windows): the
       shipped policy re-issues prefetches AFTER a rollback, so a window
       at the issue tick is clean — a policy edit that lets a transfer
       straddle a rollback is `offload-stale-after-rollback` by name.
    3. the pager-protocol model check (framework/ownership.py): a
       depth-bounded exhaustive exploration of alloc/share/release,
       radix register/evict, CoW fork, speculative rollback and
       spill/reload interleavings over a small pool, verifying every
       lifetime invariant after every transition; any violation joins
       the diagnostics by its ownership code.
    """
    from paddle_tpu_torch.framework import offload as _offload
    from paddle_tpu_torch.framework import ownership as _ownership
    from paddle_tpu_torch.framework.analysis import Diagnostic
    from paddle_tpu_torch.framework.dataflow import cache_write_aliasing

    diags = list(cache_write_aliasing(prog))

    distance = 2
    reads = {f"resume_t{t}": t for t in range(distance, distance + 4)}
    events = _offload.kv_prefetch_events(reads, distance)
    # the shipped contract: any rollback precedes (or lands on) the
    # re-issued prefetch, so windows at the issue tick must be clean
    windows = {ev.var: [ev.issue_tick] for ev in events}
    diags += _offload.check_schedule(events, rollback_windows=windows)

    checker = _ownership.ModelChecker()
    res = checker.run()
    for v in res.violations:
        diags.append(Diagnostic(v["code"], f"model-check:{v['op']}",
                                v["message"]))
    return ({"model_check": {"states_explored": res.states_explored,
                             "transitions": res.transitions,
                             "depth": res.depth,
                             "violations": len(res.violations)},
             "schedule_events": len(events),
             "violations": len(diags)}, diags)


def lint_one(name, build, args):
    """Returns the per-model report dict (the --json row)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.framework import analysis
    from paddle_tpu_torch.framework import sharding as _sharding

    pt.reset_default_programs()
    pt.reset_global_scope()
    t0 = time.time()
    with unique_name.guard():
        loss = build()
        if loss is not None:
            if args.optimizer == "sgd":
                pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
            else:
                pt.optimizer.MomentumOptimizer(
                    0.1, momentum=0.9).minimize(loss)
    prog = pt.default_main_program()
    report = {"model": name, "config": _config_desc(args),
              "gate_rejected": None, "errors": 0, "warnings": 0,
              "diagnostics": []}

    strat_cfg = None
    if args.strategy:
        point = _parse_strategy(args.strategy)
        if loss is None and (point.dp > 1 or point.pp > 1 or point.tp > 1
                             or point.explicit or point.memory_plan):
            report["gate_rejected"] = (
                "inference/serving programs lint in the plain config "
                "only (no backward region to rewrite)")
        else:
            prog, strat_cfg, gate = _apply_strategy(prog, point, args)
            report["strategy_feasible"] = strat_cfg
            report["gate_rejected"] = gate
    elif loss is None and (args.tp >= 2 or args.dp >= 2
                           or args.pipeline_stages >= 2):
        report["gate_rejected"] = (
            "inference/serving programs lint in the plain config only "
            "(no backward region to rewrite)")
    else:
        prog, gate = _apply_config(prog, name, args)
        report["gate_rejected"] = gate
    if report["gate_rejected"]:
        return report
    build_s = time.time() - t0

    t1 = time.time()
    res = analysis.infer_program(prog)
    diags = analysis.verify_program(prog) + res.diagnostics
    if args.restore_dir:
        diags += _restore_diagnostics(prog, args)
    shard_res = None
    if args.tp >= 2 or _sharding.has_tp_annotations(prog):
        shard_res = _sharding.propagate_sharding(
            prog, tp_size=args.tp if args.tp >= 2 else None)
        diags += shard_res.diagnostics
    offload_check = None
    if getattr(args, "offload", False):
        offload_check, offload_diags = _offload_diagnostics(prog, loss,
                                                            args)
        diags += offload_diags
    serving_check = None
    if getattr(args, "serving", False):
        serving_check, serving_diags = _serving_diagnostics(prog, loss,
                                                            args)
        diags += serving_diags
    mem = analysis.peak_live_bytes(prog, nominal_batch=args.batch_size)
    plan = None
    if args.memory_plan and getattr(prog, "_memory_plan_applied", False):
        from paddle_tpu_torch.framework.memory_plan import plan_report
        plan = plan_report(prog)
    analyze_s = time.time() - t1

    n_ops = sum(len(b.ops) for b in prog.blocks)
    errors = [d for d in diags if d.severity == "error"]
    warnings = [d for d in diags if d.severity == "warning"]
    report.update({
        "ops": n_ops, "blocks": len(prog.blocks),
        "build_s": round(build_s, 2), "analyze_s": round(analyze_s, 2),
        "inferred": res.n_inferred, "skipped": res.n_skipped,
        "errors": len(errors), "warnings": len(warnings),
        "diagnostics": [{"code": d.code, "severity": d.severity,
                         "loc": d.loc, "message": d.message}
                        for d in errors + warnings],
        "memory": {k: v for k, v in mem.items() if k != "peak_at"},
        "peak_at": mem["peak_at"],
    })
    if plan is not None:
        def _remat_summary(rm):
            return {k: rm.get(k) for k in
                    ("chosen", "segments", "policy", "stash_freed_bytes")}
        # multi-loss programs carry one decision PER region
        # (plan_report: remat=None, remat_regions=[...])
        rms = ([plan["remat"]] if plan.get("remat")
               else plan.get("remat_regions") or [])
        report["memory_plan"] = {
            "predicted_peak_before": plan["predicted_peak_before"],
            "predicted_peak_after": plan["predicted_peak_after"],
            "n_slots": plan["n_slots"],
            "shared_vars": plan["shared_vars"],
            "remat": _remat_summary(rms[0]) if len(rms) == 1 else None,
            "remat_regions": ([_remat_summary(r) for r in rms]
                              if len(rms) > 1 else None),
            "pp_stages": plan.get("pp_stages"),
        }
    if offload_check is not None:
        report["offload"] = offload_check
    if serving_check is not None:
        report["serving"] = serving_check

    if args.json:
        return report

    print(f"\n== {name} ==")
    print(f"  ops={n_ops} blocks={len(prog.blocks)} "
          f"build={build_s:.2f}s analyze={analyze_s:.2f}s")
    if strat_cfg is not None:
        print(f"  strategy: {strat_cfg['point']} FEASIBLE "
              f"(linting the program as the executor would run it)")
    print(f"  inference: {res.n_inferred}/{res.n_ops} ops inferred, "
          f"{res.n_skipped} skipped (waived/unknown inputs)")
    if shard_res is not None:
        sharded = shard_res.sharded_vars()
        n_seed = len(shard_res.seeded)
        n_coll = len(shard_res.actions)
        print(f"  sharding: {n_seed} annotated var(s) propagated to "
              f"{len(sharded)} sharded var(s), {n_coll} op(s) need tp "
              f"collectives")
        rows = []
        for vn in sorted(sharded):
            spec = sharded[vn]
            v = next((b.var(vn) for b in prog.blocks if b.has_var(vn)),
                     None)
            shape = tuple(v.shape) if v is not None and v.shape else None
            local = (_sharding.tp_local_shape(shape, spec, args.tp)
                     if shape and args.tp >= 2 else None)
            rows.append((vn, "[" + ",".join(s or "-" for s in spec) + "]",
                         str(shape), str(local) if local else "-"))
        if rows:
            w0 = max(len(r[0]) for r in rows)
            w1 = max(len(r[1]) for r in rows)
            w2 = max(len(r[2]) for r in rows)
            print(f"    {'VAR':<{w0}}  {'SPEC':<{w1}}  "
                  f"{'DECLARED':<{w2}}  TP-LOCAL")
            for vn, spec, shape, local in rows[:args.max_shard_rows]:
                print(f"    {vn:<{w0}}  {spec:<{w1}}  {shape:<{w2}}  "
                      f"{local}")
            if len(rows) > args.max_shard_rows:
                print(f"    ... {len(rows) - args.max_shard_rows} more")
    if plan is not None:
        rms = ([plan["remat"]] if plan.get("remat")
               else plan.get("remat_regions") or [])
        remat_txt = ", ".join(
            (f"{rm.get('chosen', '-')}"
             + (f" ({rm['segments']} segments, "
                f"policy={rm.get('policy') or 'full'})"
                if rm.get("chosen") == "remat" else ""))
            for rm in rms) or "-"
        print(f"  memory plan (batch={args.batch_size}): predicted peak "
              f"{_human(plan['predicted_peak_before'])} -> "
              f"{_human(plan['predicted_peak_after'])}, "
              f"{plan['n_slots']} shared slot(s) over "
              f"{plan['shared_vars']} var(s), remat={remat_txt}")
        for row in plan["slots"][:args.max_shard_rows]:
            print(f"    slot {row['slot']}: {row['reuses']} reuse(s) of "
                  f"{_human(row['bytes'])}  <- {row['vars']}")
        if len(plan["slots"]) > args.max_shard_rows:
            print(f"    ... {len(plan['slots']) - args.max_shard_rows} "
                  f"more slot(s)")
    sub = mem.get("sub_block_peaks") or {}
    sub_txt = (f" (+{len(sub)} sub-block(s), "
               f"{_human(sum(sub.values()))} at their binders)"
               if sub else "")
    print(f"  memory (batch={args.batch_size}, whole-program lifetimes): "
          f"params+state {_human(mem['persistent_bytes'])}, "
          f"feeds {_human(mem['feed_bytes'])}, "
          f"peak transient {_human(mem['peak_transient_bytes'])} "
          f"at {mem['peak_at']}{sub_txt}")
    if serving_check is not None:
        mc = serving_check["model_check"]
        print(f"  serving verifier: model check explored "
              f"{mc['states_explored']} states / {mc['transitions']} "
              f"transitions at depth {mc['depth']}, "
              f"{mc['violations']} violation(s); "
              f"{serving_check['schedule_events']} schedule event(s) "
              f"rollback-checked")
    if not diags:
        print("  diagnostics: clean")
    else:
        print(f"  diagnostics: {len(errors)} error(s), "
              f"{len(warnings)} warning(s)")
        rows = [(d.severity.upper(), d.code, d.loc, d.message)
                for d in errors + warnings]
        w0 = max(len(r[0]) for r in rows)
        w1 = max(len(r[1]) for r in rows)
        w2 = max(len(r[2]) for r in rows)
        for sev, code, loc, msg in rows[:args.max_diags]:
            print(f"    {sev:<{w0}}  {code:<{w1}}  {loc:<{w2}}  {msg}")
        if len(rows) > args.max_diags:
            print(f"    ... {len(rows) - args.max_diags} more")
    return report


def main(argv=None):
    p = argparse.ArgumentParser(
        description="static analyzer CLI (shape/dtype inference + "
                    "structural/parallel/dataflow verification + memory "
                    "estimate)")
    p.add_argument("--model", choices=sorted(_builders()), default="mnist")
    p.add_argument("--all", action="store_true",
                   help="lint every model builder")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON list of per-model reports on "
                        "stdout and nothing else")
    p.add_argument("--allow_gate_rejects", action="store_true",
                   help="a pass gate rejecting the requested config "
                        "counts as a skip (exit 0), not exit 2 — for "
                        "sweeps over builders x configs")
    p.add_argument("--batch_size", type=int, default=8,
                   help="stand-in for the symbolic batch dim in the "
                        "memory estimate")
    p.add_argument("--optimizer", choices=("sgd", "momentum"),
                   default="sgd")
    p.add_argument("--pipeline_stages", type=int, default=0,
                   help="apply pipeline_partition_pass and lint the "
                        "partitioned program")
    p.add_argument("--num_microbatches", type=int, default=4)
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel degree: apply the explicit "
                        "reduce-scatter gradient pipeline "
                        "(grad_comm.comm_optimize_pass) and lint the "
                        "rewritten program")
    p.add_argument("--comm_bucket_bytes", type=int, default=1 << 20)
    p.add_argument("--memory_plan", action="store_true",
                   help="apply the static memory planner "
                        "(framework/memory_plan.py memory_plan_pass) "
                        "after the parallelism rewrites and lint the "
                        "PLANNED program: prints the buffer-slot table "
                        "and the predicted peak before/after; any "
                        "error-severity diagnostic the plan introduces "
                        "(the buffer-reuse detectors) exits 1")
    p.add_argument("--offload", action="store_true",
                   help="check the host-tier transfer schedules "
                        "(framework/offload.py): the ZeRO-offload "
                        "optimizer round-trip for train-step programs, "
                        "the two-tier KV prefetch policy for serving "
                        "ticks — a transfer arriving after its first "
                        "read is the error-severity "
                        "offload-use-before-arrival diagnostic")
    p.add_argument("--serving", action="store_true",
                   help="serving-tier ownership verifier: cache-write "
                        "aliasing over the linted program "
                        "(serving-cache-write-alias / "
                        "serving-cache-stale-read), the prefetch "
                        "schedule under speculative rollback windows "
                        "(offload-stale-after-rollback), and the "
                        "exhaustive small-scope model check of the "
                        "pager protocol (framework/ownership.py) — the "
                        "state count lands in the --json report, any "
                        "violation exits 1 under its ownership code")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel degree: apply tp_shard_pass to a "
                        "tp-annotated program (e.g. --model "
                        "transformer_lm_tp) and lint the spliced program; "
                        "the propagated sharding-spec table prints per "
                        "sharded var")
    p.add_argument("--strategy", default="",
                   help="JSON joint-strategy config, e.g. "
                        "'{\"dp\": 2, \"pp\": 2, \"microbatches\": 4, "
                        "\"reduce\": \"reduce_scatter\"}' (keys: dp, pp, "
                        "tp, microbatches, schedule, reduce, quant, "
                        "bucket_bytes, memory_plan): run the SAME "
                        "compile-free feasibility check the auto-parallel "
                        "planner prunes with (costs.strategy_is_feasible) "
                        "and lint the rewritten program when feasible; an "
                        "infeasible config reports its NAMED rejection "
                        "reasons and exits 2 (the gate-reject contract). "
                        "Mutually exclusive with --dp/--tp/"
                        "--pipeline_stages/--memory_plan")
    p.add_argument("--restore_dir", default="",
                   help="elastic snapshot dir (or root of snapshot-* "
                        "dirs, parallel/elastic.py): statically verify "
                        "the snapshot restores onto this model/config — "
                        "commit integrity, every declared persistable "
                        "present at its declared shape, ZeRO-1 dim0 "
                        "divisibility at --dp, error-feedback "
                        "re-mappability")
    p.add_argument("--max_shard_rows", type=int, default=24)
    p.add_argument("--max_diags", type=int, default=40)
    add_place_arg(p)
    args = p.parse_args(argv)
    if args.strategy and (args.dp >= 2 or args.tp >= 2
                          or args.pipeline_stages >= 2
                          or args.memory_plan):
        p.error("--strategy carries the whole joint config; do not "
                "combine it with --dp/--tp/--pipeline_stages/"
                "--memory_plan")

    builders = _builders(resolve_place(args.place))
    names = sorted(builders) if args.all else [args.model]
    reports = [lint_one(name, builders[name], args) for name in names]
    n_errors = sum(r["errors"] for r in reports)
    gates = [r for r in reports if r["gate_rejected"]]
    if args.json:
        print(json.dumps(reports, indent=1))
    else:
        for r in gates:
            print(f"\n== {r['model']} ==\n  GATE REJECTED  "
                  f"{r['gate_rejected']}")
        print(f"\nlint: {len(names)} program(s), {n_errors} error(s), "
              f"{len(gates)} gate-rejected")
    if n_errors:
        return 1
    if gates and not args.allow_gate_rejects:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
