"""CLI driver for the scenario layer.

Port of ``repro.sph.__main__``:

    python -m repro_torch.sph list [--names]
    python -m repro_torch.sph run <case> [--nsteps N] [--observe-every K]
                                   [--ds DS | --n N_TARGET]
                                   [--backend reference|xla|kernel]
                                   [--records fp32|fp16|bf16]
                                   [--guard] [--guard-block B]
                                   [--inject nan|teleport|cap|window|dt]
                                   [--set field=value ...] [--device DEV]
    python -m repro_torch.sph sweep <case> [...] [--device DEV]
    python -m repro_torch.sph serve [case] [...] [--device DEV]
    python -m repro_torch.sph request [case] [...]

``run``, ``sweep`` and ``serve`` run on CUDA unless ``--device`` names
another (``cpu`` runs the kernels' plain versions); they raise when
CUDA is asked for and missing. ``--backend pallas`` is taken as
``kernel``, the port's name for the JAX package's ``"pallas"`` backend.
The JAX package's ``lint`` subcommand (its trace-hygiene linter over
JAX code) has no counterpart here.

``run`` builds the registered case, advances it under the production
persistent pipeline with observables, prints the observable
table, the final diagnostics, measured steps/sec, and the case's
analytic validation metrics where it defines them (e.g. the
Taylor–Green KE decay rate). ``--json`` prints the same document
(schema ``"repro.sph.run/1"``, the same keys) as the JAX package.

``--guard`` runs under the self-healing health guard (core/recovery.py):
in-scan divergence detection, checkpoint rollback, dt backoff, capacity
regrow, precision degrade. ``--inject`` arms one of the named faults
(and implies ``--guard``) — the CI smoke uses this to prove every case
recovers unattended. A guarded run that exhausts its policy exits 1
with the structured divergence report.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import logging
import signal
import sys

import numpy as np
import torch

from repro_torch.core import cases as cases_lib
from repro_torch.core import recovery, solver
from repro_torch.core.api import Simulation
from repro_torch.core.precision import PrecisionPolicy

#: ``--backend`` values; the JAX package's "pallas" is the port's "kernel".
BACKEND_CHOICES = ["reference", "xla", "kernel", "pallas"]


def _case_overrides(args) -> dict:
    over: dict = {}
    if args.ds is not None:
        over["ds"] = args.ds
    elif args.n is not None:
        over["ds"] = cases_lib.resolve_ds(args.case, args.n)
    if args.backend is not None:
        over["backend"] = "kernel" if args.backend == "pallas" else args.backend
    if args.records is not None:
        over["policy"] = PrecisionPolicy(records=args.records)
    for item in args.set or []:
        key, _, val = item.partition("=")
        if not val:
            raise SystemExit(f"--set wants field=value, got {item!r}")
        try:
            over[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            over[key] = val
    return over


def cmd_list(args) -> int:
    if args.names:
        print("\n".join(cases_lib.case_names()))
        return 0
    print(f"{'case':14s} {'boundary':58s} validation")
    for name in cases_lib.case_names():
        cls = cases_lib.CASES[name]
        print(f"{name:14s} {getattr(cls, 'boundary', '-'):58s} "
              f"{getattr(cls, 'validation', '-')}")
    return 0


def cmd_run(args) -> int:
    sim = Simulation.from_case(args.case, device=args.device,
                               **_case_overrides(args))
    case, cfg = sim.case, sim.cfg
    nsteps = args.nsteps or getattr(case, "default_nsteps", 400)
    every = args.observe_every or max(1, nsteps // 20)

    guard = args.guard or args.inject is not None
    policy = None
    if guard:
        logging.basicConfig(level=logging.WARNING)
        policy = recovery.GuardPolicy(
            block=args.guard_block or recovery.GuardPolicy.block
        )
        if args.inject is not None:
            sim.cfg = cfg = recovery.apply_named_fault(
                cfg, args.inject, nsteps, sim.n_particles
            )
    as_json = getattr(args, "json", False)
    # machine-readable mode: exactly one JSON document on stdout (schema
    # "repro.sph.run/1", documented in the README) — everything the
    # human table prints, plus the guard report, as data
    doc = {
        "schema": "repro.sph.run/1",
        "case": args.case,
        "n": sim.n_particles,
        "ds": float(case.ds),
        "dt": float(cfg.dt),
        "backend": cfg.resolved_backend,
        "records": cfg.policy.records,
        "nsteps": int(nsteps),
        "observe_every": int(every),
        "guard": guard,
        "inject": args.inject,
    }
    if not as_json:
        print(f"# {args.case}: N={sim.n_particles} ds={case.ds:.4g} "
              f"dt={cfg.dt:.3e} backend={cfg.resolved_backend} "
              f"records={cfg.policy.records} nsteps={nsteps} "
              f"observe_every={every}"
              + (f" guard=on inject={args.inject or '-'}" if guard else ""))

    try:
        if args.time:
            res, sps = sim.run_timed(nsteps, observe_every=every,
                                     guard=policy)
        else:
            res, sps = sim.run(nsteps, observe_every=every,
                               guard=policy), None
    except recovery.SimulationDiverged as e:
        if as_json:
            doc.update(status="diverged", exit=1, diverged={
                "step": int(e.step), "checks": list(e.checks),
                "word": int(e.word),
                "stats": {k: float(v) for k, v in (e.stats or {}).items()},
                "events": [ev.to_json() for ev in e.events],
            })
            print(json.dumps(doc))
            return 1
        print(f"# DIVERGED at step {e.step}: checks={e.checks} "
              f"stats={e.stats}", file=sys.stderr)
        for ev in e.events:
            print(f"#   tried {ev.action} at step {ev.step}: {ev.detail}",
                  file=sys.stderr)
        return 1

    obs = res.observables
    t, ekin, vmax, rho_err = (c.cpu().numpy() for c in obs)
    stats = res.stats
    bad = (
        np.isnan(ekin).any() or np.isnan(vmax).any()
        or not np.isfinite(ekin[-1])
    )
    overflow = bool(stats.overflow)
    metrics = (case.validate(t, ekin)
               if hasattr(case, "validate") and not bad else {})

    if as_json:
        doc.update(
            status=("nonfinite" if bad
                    else "overflow" if overflow else "ok"),
            exit=1 if (bad or overflow) else 0,
            observables={"t": t.tolist(), "ekin": ekin.tolist(),
                         "vmax": vmax.tolist(),
                         "rho_err": rho_err.tolist()},
            stats={"steps": int(stats.steps),
                   "rebuilds": int(stats.rebuilds),
                   "overflow": overflow},
            steps_per_sec=sps,
            validation={k: float(v) for k, v in metrics.items()},
        )
        if res.report is not None:
            doc["guard_report"] = res.report.to_json()
        print(json.dumps(doc))
        return doc["exit"]

    print(f"{'t':>10s} {'ekin':>12s} {'vmax':>10s} {'rho_err':>10s}")
    for row in zip(t, ekin, vmax, rho_err):
        print(f"{row[0]:10.4f} {row[1]:12.6e} {row[2]:10.4f} {row[3]:10.4f}")

    print(f"# steps={int(stats.steps)} rebuilds={int(stats.rebuilds)} "
          f"overflow={bool(stats.overflow)}"
          + (f" steps/sec={sps:.1f}" if sps is not None else ""))
    if res.report is not None and res.report.recovered:
        rep = res.report
        print(f"# guard recovered: retries={rep.retries} "
              f"dt_halvings={rep.dt_halvings} regrows={rep.regrows} "
              f"records_degraded={rep.records_degraded} "
              f"final dt={rep.cfg.dt:.3e}")
        if rep.dropped_obs_rows:
            # rollbacks discard rows from undone trajectory segments —
            # say so instead of printing a silently thinned table
            print(f"# {rep.dropped_obs_rows} observable row(s) dropped "
                  "by rollback (sampled on undone trajectory segments)")
        for ev in rep.events:
            print(f"#   step {ev.step}: {ev.checks} -> {ev.action} "
                  f"({ev.detail})")
    if bad:
        print("# FAILED: non-finite observables", file=sys.stderr)
        return 1
    if overflow:
        # dropped neighbor pairs = silently wrong physics — fail loudly
        print("# FAILED: neighbor/cell-capacity overflow (raise "
              "max_neighbors / capacity for this resolution)",
              file=sys.stderr)
        return 1

    for k, v in metrics.items():
        print(f"# {k} = {v:.4g}")
    if hasattr(case, "front_position"):
        print(f"# surge front x = {case.front_position(cfg, res.state):.4f} "
              f"(tank width {case.width})")
    return 0


def cmd_sweep(args) -> int:
    from repro_torch.core import ensemble

    logging.basicConfig(level=logging.WARNING)
    over = _case_overrides(args)
    base_case = cases_lib.build_case(args.case, **{
        k: v for k, v in over.items()
        if k in {f.name for f in dataclasses.fields(cases_lib.CASES[args.case])}
    })
    cfg0, state0 = base_case.build(device=solver.resolve_device(args.device))
    for k, v in over.items():
        if k in {f.name for f in dataclasses.fields(type(cfg0))}:
            cfg0 = dataclasses.replace(cfg0, **{k: v})
    nsteps = args.nsteps or getattr(base_case, "default_nsteps", 400)
    policy = recovery.GuardPolicy(
        block=args.block or recovery.GuardPolicy.block
    )

    # config variants: each --vary value is its own shape bucket
    variants = [("", cfg0)]
    if args.vary:
        field, _, vals = args.vary.partition("=")
        if not vals:
            raise SystemExit(f"--vary wants FIELD=V1,V2,..., got {args.vary!r}")
        variants = []
        for raw in vals.split(","):
            val = ast.literal_eval(raw)
            variants.append(
                (f"[{field}={raw}]", dataclasses.replace(cfg0, **{field: val}))
            )

    # members: per-variant batch of velocity-perturbed copies of the
    # case state (member 0 of each variant is the unperturbed reference)
    fault = None
    if args.inject is not None:
        fault = recovery.apply_named_fault(
            cfg0, args.inject, nsteps, int(state0.xn.shape[0])
        ).fault
    requests = []
    fluid = ~state0.fixed.cpu().numpy()
    for tag, vcfg in variants:
        for i in range(args.batch):
            st = state0
            if i > 0 and args.perturb > 0.0:
                rng = np.random.default_rng(args.seed + i)
                v = st.fluid.v.cpu().numpy().copy()
                v[fluid] += args.perturb * rng.standard_normal(
                    v[fluid].shape
                ).astype(v.dtype)
                st = st._replace(fluid=st.fluid._replace(
                    v=torch.as_tensor(v, device=state0.xn.device)))
            requests.append(ensemble.SweepRequest(
                name=f"{args.case}{tag}#{i}", cfg=vcfg, state=st,
                fault=fault if len(requests) == args.inject_member else None,
            ))

    total = len(requests)
    print(f"# sweep {args.case}: members={total} batch={args.batch} "
          f"variants={len(variants)} N={int(state0.xn.shape[0])} "
          f"nsteps={nsteps} block={policy.block}"
          + (f" inject={args.inject} on member {args.inject_member}"
             if fault else "")
          + (f" checkpoint={args.checkpoint}" if args.checkpoint else "")
          + (" resume" if args.resume else ""))

    res = ensemble.run_sweep(
        requests, nsteps, policy,
        checkpoint_dir=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        keep=args.keep, resume=args.resume,
    )

    print(f"{'member':28s} {'status':12s} {'steps':>7s} {'retries':>7s} "
          f"{'dt_scale':>9s} {'events'}")
    for name, m in zip(res.names, res.members):
        evs = ", ".join(ev.action for ev in m.events) or "-"
        if m.solo_report is not None and m.solo_report.events:
            evs += " | solo: " + ", ".join(
                ev.action for ev in m.solo_report.events)
        print(f"{name:28s} {m.status:12s} {m.steps:7d} {m.retries:7d} "
              f"{m.dt_scale:9.4g} {evs}")
        if m.error is not None:
            print(f"#   quarantined: {m.error}")
    for j, rep in enumerate(res.reports):
        extra = ""
        if rep.resumed_from is not None:
            extra += f" resumed_from_block={rep.resumed_from}"
        if rep.dead_process_detected:
            extra += " dead_predecessor_process=yes"
        if rep.straggler_flagged:
            extra += " straggler=FLAGGED"
        print(f"# bucket {j}: blocks={rep.blocks} "
              f"slow_blocks={rep.slow_blocks}{extra}")
    counts = res.counts()
    print("# sweep summary: " + " ".join(
        f"{k}={v}" for k, v in counts.items()))
    nonfinite = any(
        not bool(torch.isfinite(st.fluid.v).all())
        for st, m in zip(res.states, res.members)
        if m.status != "quarantined"
    )
    if nonfinite:
        print("# FAILED: non-finite final state on a non-quarantined "
              "member", file=sys.stderr)
        return 1
    return 0


def cmd_serve(args) -> int:
    logging.basicConfig(level=logging.INFO)
    policy = recovery.GuardPolicy(
        block=args.block or recovery.GuardPolicy.block, snapshot_every=1)
    if args.single_process:
        from repro_torch.sph.serve import SimServer

        srv = SimServer(
            host=args.host, port=args.port, slots=args.slots,
            queue=args.queue, policy=policy,
            checkpoint_dir=args.checkpoint, device=args.device,
        )
        mode = "single-process"
    else:
        from repro_torch.sph.supervisor import FrontendServer

        srv = FrontendServer(
            host=args.host, port=args.port, slots=args.slots,
            queue=args.queue, policy=policy,
            checkpoint_dir=args.checkpoint,
            max_restarts=args.max_restarts,
            hang_timeout_s=args.hang_timeout,
            save_every=args.save_every,
            drain_timeout_s=args.drain_timeout,
            chaos=args.chaos, device=args.device,
        )
        mode = "multi-process"
    # SIGTERM/SIGINT -> graceful drain: stop admitting, checkpoint
    # in-flight lanes, answer RETRY_AFTER, exit 0
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: srv.request_drain())
    if args.case:
        srv.prewarm(args.case, n=args.n, ds=args.ds)
    print(f"# serving on {srv.host}:{srv.port} slots={srv.slots} "
          f"queue={srv.queue_cap} block={policy.block} mode={mode}"
          + (f" checkpoint={srv.ckdir}" if srv.ckdir else "")
          + (f" chaos={args.chaos}" if args.chaos else "")
          + (f" predecessor={srv.predecessor}" if srv.predecessor else ""),
          flush=True)
    srv.serve_forever()
    print("# drained cleanly", flush=True)
    return 0


def cmd_request(args) -> int:
    from repro_torch.sph import client

    req: dict = {"case": args.case, "observe": args.observe}
    if args.resume_token:
        req = {"resume_token": args.resume_token}
    if args.nsteps is not None:
        req["nsteps"] = args.nsteps
    if args.n is not None:
        req["n"] = args.n
    if args.ds is not None:
        req["ds"] = args.ds
    if args.deadline_s is not None:
        req["deadline_s"] = args.deadline_s
    if args.inject is not None:
        req["inject"] = {"kind": args.inject}
    logging.basicConfig(level=logging.WARNING)
    if args.retry > 0:
        frames, term = client.run_request_resilient(
            args.host, args.port, req, timeout=args.timeout,
            retries=args.retry)
    else:
        frames, term = client.run_request(
            args.host, args.port, req, timeout=args.timeout)
    for f in frames:
        print(json.dumps(f))
    if term is None:
        print("# connection closed without a terminal reply",
              file=sys.stderr)
        return 1
    return 0 if term.get("type") in ("done", "stats") else 1


DEVICE_HELP = ("torch device (default: cuda; raises without it); "
               "'cpu' runs the kernels' plain versions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sph")
    sub = ap.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("list", help="list registered cases")
    lp.add_argument("--names", action="store_true",
                    help="bare case names only (for scripting)")
    lp.set_defaults(fn=cmd_list)

    rp = sub.add_parser("run", help="run a registered case")
    rp.add_argument("case", choices=cases_lib.case_names())
    rp.add_argument("--nsteps", type=int, default=None)
    rp.add_argument("--observe-every", type=int, default=None)
    rp.add_argument("--ds", type=float, default=None)
    rp.add_argument("--n", type=int, default=None,
                    help="target fluid particle count (sets ds)")
    rp.add_argument("--backend", default=None,
                    choices=BACKEND_CHOICES)
    rp.add_argument("--records", default=None,
                    choices=["fp32", "fp16", "bf16"])
    rp.add_argument("--time", action="store_true",
                    help="run twice and report steps/sec (warm-up excluded)")
    rp.add_argument("--guard", action="store_true",
                    help="run under the self-healing health guard")
    rp.add_argument("--guard-block", type=int, default=None,
                    help="steps per guarded block (default: policy's 32)")
    rp.add_argument("--inject", default=None,
                    choices=["nan", "teleport", "cap", "window", "dt"],
                    help="arm a named fault (implies --guard)")
    rp.add_argument("--set", action="append", metavar="FIELD=VALUE",
                    help="override any case dataclass field")
    rp.add_argument("--json", action="store_true",
                    help="machine-readable output: one JSON document "
                    "(schema repro.sph.run/1) instead of the table")
    rp.add_argument("--device", default=None, help=DEVICE_HELP)
    rp.set_defaults(fn=cmd_run)

    sp = sub.add_parser(
        "sweep",
        help="run a batched fault-isolated ensemble sweep of a case",
    )
    sp.add_argument("case", choices=cases_lib.case_names())
    sp.add_argument("--batch", type=int, default=4,
                    help="members per config variant (default 4)")
    sp.add_argument("--nsteps", type=int, default=None)
    sp.add_argument("--perturb", type=float, default=0.01,
                    help="stddev of the per-member fluid velocity "
                    "perturbation (member 0 stays unperturbed)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--vary", default=None, metavar="FIELD=V1,V2,...",
                    help="sweep an SPHConfig field; each value is its "
                    "own shape bucket of --batch members")
    sp.add_argument("--block", type=int, default=None,
                    help="ensemble block length (= rebuild cadence; "
                    "default: policy's 32)")
    sp.add_argument("--ds", type=float, default=None)
    sp.add_argument("--n", type=int, default=None,
                    help="target fluid particle count (sets ds)")
    sp.add_argument("--backend", default=None,
                    choices=BACKEND_CHOICES)
    sp.add_argument("--records", default=None,
                    choices=["fp32", "fp16", "bf16"])
    sp.add_argument("--inject", default=None,
                    choices=["nan", "teleport"],
                    help="arm a deterministic fault on ONE member "
                    "(--inject-member); the lane-masked recovery must "
                    "leave the rest of the batch bit-identical")
    sp.add_argument("--inject-member", type=int, default=0,
                    help="flat member index the fault arms (default 0)")
    sp.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="durable sweep state under DIR (per-bucket "
                    "CheckpointManager subdirs + sweep.json manifest)")
    sp.add_argument("--checkpoint-every", type=int, default=1,
                    help="blocks between checkpoints (default 1)")
    sp.add_argument("--keep", type=int, default=3,
                    help="checkpoint steps to retain; 0 keeps all")
    sp.add_argument("--resume", action="store_true",
                    help="resume an interrupted sweep from the latest "
                    "valid checkpoint (bit-identical continuation)")
    sp.add_argument("--set", action="append", metavar="FIELD=VALUE",
                    help="override any case dataclass field")
    sp.add_argument("--device", default=None, help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_sweep)

    vp = sub.add_parser(
        "serve",
        help="online simulation service: live-batch lane admission "
        "over a socket",
    )
    vp.add_argument("case", nargs="?", default=None,
                    choices=cases_lib.case_names(),
                    help="optional case to prewarm (build + run "
                    "one block before the first request)")
    vp.add_argument("--host", default="127.0.0.1")
    vp.add_argument("--port", type=int, default=7853,
                    help="listen port; 0 picks a free one (default 7853)")
    vp.add_argument("--slots", type=int, default=8,
                    help="lanes per shape bucket (default 8)")
    vp.add_argument("--queue", type=int, default=32,
                    help="admission queue bound; a full queue answers "
                    "REJECTED busy (default 32)")
    vp.add_argument("--block", type=int, default=None,
                    help="engine block length / streaming granularity "
                    "(default: policy's 32)")
    vp.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="drain checkpoints + heartbeat under DIR "
                    "(enables RETRY_AFTER resume tokens); multi-process "
                    "mode defaults to a temp dir so per-block recovery "
                    "checkpoints always have a home")
    vp.add_argument("--ds", type=float, default=None,
                    help="prewarm resolution (spacing)")
    vp.add_argument("--n", type=int, default=None,
                    help="prewarm resolution (target fluid count)")
    vp.add_argument("--single-process", action="store_true",
                    help="run engines in the server process (legacy "
                    "mode: no crash containment, no worker restarts)")
    vp.add_argument("--max-restarts", type=int, default=3,
                    help="worker restarts per shape bucket before its "
                    "requests get RETRY_AFTER with resume tokens "
                    "(default 3)")
    vp.add_argument("--hang-timeout", type=float, default=600.0,
                    help="seconds without block progress before a "
                    "heartbeat-alive worker is declared hung and "
                    "SIGKILLed (default 600)")
    vp.add_argument("--save-every", type=int, default=1,
                    help="blocks between per-lane recovery checkpoints "
                    "inside each worker (default 1 = lose at most one "
                    "block on a crash)")
    vp.add_argument("--drain-timeout", type=float, default=60.0,
                    help="seconds to wait for workers to finish final "
                    "saves on SIGTERM drain (default 60)")
    vp.add_argument("--chaos", default=None,
                    choices=["kill", "hang", "oom-sim"],
                    help="fault-injection harness: once a worker is "
                    "busy and progressing, inject this fault (test/CI "
                    "only; proves unattended recovery)")
    vp.add_argument("--device", default=None,
                    help=DEVICE_HELP + " (multi-process mode: the "
                    "engine workers' device)")
    vp.set_defaults(fn=cmd_serve)

    qp = sub.add_parser(
        "request",
        help="send one request to a running serve endpoint and print "
        "the reply frames as JSON lines",
    )
    qp.add_argument("case", nargs="?", default=None,
                    choices=cases_lib.case_names())
    qp.add_argument("--host", default="127.0.0.1")
    qp.add_argument("--port", type=int, default=7853)
    qp.add_argument("--nsteps", type=int, default=None)
    qp.add_argument("--n", type=int, default=None)
    qp.add_argument("--ds", type=float, default=None)
    qp.add_argument("--observe", action="store_true",
                    help="stream per-block observable frames")
    qp.add_argument("--deadline-s", type=float, default=None)
    qp.add_argument("--inject", default=None, choices=["nan", "teleport"],
                    help="poison the request (server answers DIVERGED "
                    "after its lane-masked ladder is exhausted)")
    qp.add_argument("--resume-token", default=None,
                    help="resume drained work from a RETRY_AFTER token")
    qp.add_argument("--timeout", type=float, default=300.0)
    qp.add_argument("--retry", type=int, default=3, metavar="N",
                    help="auto-recovery budget: on RETRY_AFTER resubmit "
                    "the resume token, on mid-stream EOF reconnect, with "
                    "capped exponential backoff (default 3; 0 disables)")
    qp.set_defaults(fn=cmd_request)

    args = ap.parse_args(argv)
    if getattr(args, "fn", None) is cmd_request and not (
            args.case or args.resume_token):
        qp.error("request wants a case or --resume-token")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
