"""`repro-torch`: the port's console entry point over
:class:`repro_torch.api.Session` (port of ``repro/cli.py``: ``verify`` and
``explain``, with the reference's flags and printed table).

    python -m repro_torch.cli verify design.aig            # train, route, verify
    python -m repro_torch.cli verify csa:32 booth:16 --backend groot --partitions 8
    python -m repro_torch.cli verify big.aig --budget-mb 64 --checkpoint-dir ck
    python -m repro_torch.cli explain design.aig --budget-mb 64   # routing only

``verify``/``explain`` accept AIGER files (``.aig``/``.aag``) and
``family:bits`` generator specs interchangeably.  ``explain`` needs no
trained model — routing is host-side only.  A streamed ``verify`` with
``--checkpoint-dir`` journals each partition; run the same command again
after a kill and only the unfinished partitions run.

Everything runs on ``cuda`` unless the caller of :func:`main` passes
``device="cpu"``.  The reference's ``serve`` and ``top`` commands and
``--trace`` (its observability layer, ROADMAP Queue 1, item 6) and
``--devices`` above 1 (the sharded route, item 7) are not ported: they exit
non-zero and say so.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

PROG = "repro-torch"


def _not_ported(what: str, item: int) -> int:
    print(f"{PROG}: {what} is not ported yet (ROADMAP Queue 1, item {item})",
          file=sys.stderr)
    return 2


def _session_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("designs", nargs="+",
                    help="AIGER files (.aig/.aag) or family:bits specs "
                         "(csa:32, booth:16, mapped:8, fpga:8)")
    ap.add_argument("--backend", default="ref",
                    help="aggregation backend: ref | onehot | groot | "
                         "groot_mxu | groot_fused")
    ap.add_argument("--partitions", type=int, default=1)
    ap.add_argument("--no-regrow", action="store_true")
    ap.add_argument("--hops", type=int, default=1,
                    help="re-growth depth (>= GNN layers -> bit-exact)")
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="device memory budget; the router partitions and "
                         "streams designs that exceed it")
    ap.add_argument("--stream-dtype", default=None,
                    help='staged edge-stream dtype (e.g. "bfloat16")')
    ap.add_argument("--devices", type=int, default=None,
                    help="devices the streamed route shards over; more than "
                         "one is not ported (ROADMAP Queue 1, item 7)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="journal streamed partition results under this "
                         "directory so a killed run can resume")
    ap.add_argument("--resume", dest="resume", action="store_true",
                    default=True,
                    help="restore a prior partial run from --checkpoint-dir "
                         "(default)")
    ap.add_argument("--no-resume", dest="resume", action="store_false",
                    help="ignore (wipe) any prior journal and run fresh")
    ap.add_argument("--fault-plan", default=None,
                    help="chaos testing: a repro_torch.faults plan spec, e.g. "
                         '"exec.launch:p=0.1,kind=transient,seed=7" '
                         "(also honoured from $REPRO_FAULT_PLAN)")


def _make_session(args, device):
    from repro_torch.api import Session, SessionConfig

    budget = None
    if args.budget_mb is not None:
        budget = int(args.budget_mb * 1e6)
    return Session(config=SessionConfig(
        backend=args.backend,
        num_partitions=args.partitions,
        regrow=not args.no_regrow,
        regrow_hops=args.hops,
        memory_budget_bytes=budget,
        stream_dtype=args.stream_dtype,
        mesh_devices=args.devices,
        checkpoint_dir=args.checkpoint_dir,
        resume=args.resume,
        fault_plan=args.fault_plan,
        device=device,
    ))


def _resolve(spec: str):
    """A design argument -> (design-or-None, dataset, bits) for the façade.

    Raises SystemExit with a usable message on a bad spec, so callers can
    validate every argument up front (before minutes of training).
    """
    if os.path.exists(spec) or spec.endswith((".aig", ".aag")):
        if not os.path.exists(spec):
            raise SystemExit(f"{PROG}: AIGER file not found: {spec}")
        return spec, None, None
    fam, _, bits = spec.partition(":")
    try:
        return None, fam, int(bits or 8)
    except ValueError:
        raise SystemExit(
            f"{PROG}: bad design spec {spec!r} (want an .aig/.aag path or "
            f"family:bits, e.g. csa:32)"
        ) from None


def _print_decision(label: str, d) -> None:
    # the reference appends " devices=N" in mode "sharded", which the port
    # does not route to
    print(f"{label}: mode={d.mode} backend={d.backend} k={d.k} "
          f"buckets={d.num_buckets}{list(d.buckets) if d.buckets else ''}")
    print(f"    nodes={d.num_nodes} edges={d.num_edges} "
          f"modeled full={d.modeled_full_bytes/1e6:.1f} MB "
          f"peak={d.modeled_peak_bytes/1e6:.1f} MB "
          f"budget={'-' if d.memory_budget_bytes is None else f'{d.memory_budget_bytes/1e6:.1f} MB'}")
    print(f"    {d.reason}")


def cmd_explain(args, device) -> int:
    sess = _make_session(args, device)
    for spec in args.designs:
        design, dataset, bits = _resolve(spec)
        _print_decision(spec, sess.explain(design, dataset=dataset, bits=bits))
    return 0


def cmd_verify(args, device) -> int:
    # resolve every spec BEFORE training: a typo must fail in milliseconds,
    # not after the training run
    resolved = [_resolve(spec) for spec in args.designs]
    sess = _make_session(args, device)
    print(f"training groot-gnn on csa {args.train_bits}b "
          f"({args.epochs} epochs)...")
    sess.train("csa", args.train_bits, epochs=args.epochs)
    print(f"\n{'design':>24} {'route':>12} {'status':>13} {'acc':>7} "
          f"{'nodes':>8} {'peak_MB':>8} {'total_s':>8}")
    bad = 0
    for design, dataset, bits in resolved:
        r = sess.verify(design, dataset=dataset, bits=bits,
                        verify=not args.no_verify)
        bad += r.status in ("falsified", "error")
        print(f"{r.name:>24} {r.routing.mode:>12} {r.status:>13} "
              f"{r.accuracy:7.4f} {r.num_nodes:>8} "
              f"{r.peak_memory_bytes/1e6:8.1f} {r.timings['total']:8.3f}")
        if args.explain:
            _print_decision("  routing", r.routing)
    return 1 if bad else 0


def main(argv: Optional[list] = None, device=None) -> int:
    """Run one command; ``device`` is where sessions run (``cuda`` unless
    named, as every entry point of the port)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("serve", "top"):
        return _not_ported(f"`{argv[0]}` (the batched service and its live view)", 6)

    ap = argparse.ArgumentParser(
        prog=PROG, description="GROOT verification stack on PyTorch (repro_torch.api)"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("verify", help="train a small model, route, verify")
    _session_args(v)
    v.add_argument("--train-bits", type=int, default=8)
    v.add_argument("--epochs", type=int, default=300)
    v.add_argument("--no-verify", action="store_true",
                   help="classification only (skip adder extraction)")
    v.add_argument("--explain", action="store_true",
                   help="also print each design's routing decision")
    v.add_argument("--trace", metavar="OUT.json", default=None,
                   help="span tracing; not ported (ROADMAP Queue 1, item 6)")
    v.set_defaults(fn=cmd_verify)

    e = sub.add_parser("explain",
                       help="print the routing decision without running")
    _session_args(e)
    e.set_defaults(fn=cmd_explain)

    # listed for --help only; refused above before parsing
    sub.add_parser("serve", help="the batched verification service (not ported)")
    sub.add_parser("top", help="live view of a running service (not ported)")

    args = ap.parse_args(argv)
    if getattr(args, "trace", None):
        return _not_ported("--trace (span tracing)", 6)
    if args.devices is not None and args.devices > 1:
        return _not_ported(f"--devices {args.devices} (the sharded route)", 7)
    return args.fn(args, device)


if __name__ == "__main__":
    sys.exit(main())
