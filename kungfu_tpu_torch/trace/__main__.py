"""kftrace CLI: merge per-rank streams into a Perfetto-loadable trace.

    python -m kungfu_tpu_torch.trace --dir $KF_TRACE_DIR -o trace.json
    python -m kungfu_tpu_torch.trace --server http://host:9100 -o trace.json
    python -m kungfu_tpu_torch.trace --dir D --summary
    python -m kungfu_tpu_torch.trace --dir D --goodput
    python -m kungfu_tpu_torch.trace --validate trace.json

The port of `kungfu_tpu/trace/__main__.py` over the port's
`trace.export` and `trace.goodput`: the same flags, output and exit
codes (`tests/test_torch_scenario.py` holds ``--goodput``'s JSON equal
to the reference CLI's on one trace directory).

``--dir`` reads flight-recorder JSONL files, ``--server`` fetches the
config server's collected ``/trace`` snapshot; both may be combined
(events deduplicate on the per-process ``(nonce, id)`` key). The
output is Chrome trace-event JSON — load it at https://ui.perfetto.dev
or chrome://tracing. ``--summary`` prints the cluster timeline
(per-rank span totals, per-rank wallclock span coverage, chaos/
recovery landmarks, and — when a recovery rode the window — the MTTR
decomposition). ``--goodput`` prints the goodput decomposition (text
table + JSON; docs/observability.md) and exits nonzero when the
phase-sum invariant is violated or no useful step survived — the
scenario-replay CI gate (scripts/run-all.sh). ``--validate``
schema-checks an exported file and exits nonzero on malformed output;
the CI smoke gates on it.

Exit codes: 0 ok, 1 validation/invariant failure / no events, 2 usage
error.
"""

from __future__ import annotations

import argparse
import json
import sys

from .export import (fetch_server, merge_sources, read_flight_dir,
                     summarize, to_chrome_trace, validate_chrome_trace)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kungfu_tpu_torch.trace",
        description="merge kftrace streams into Chrome/Perfetto trace "
                    "JSON (docs/observability.md)")
    ap.add_argument("--dir", default="",
                    help="KF_TRACE_DIR holding flight-*.jsonl records")
    ap.add_argument("--server", default="",
                    help="config-server URL (its /trace snapshot is "
                         "fetched; /get suffixes are rewritten)")
    ap.add_argument("-o", "--output", default="",
                    help="write Chrome trace JSON here")
    ap.add_argument("--summary", action="store_true",
                    help="print the cluster timeline summary (JSON)")
    ap.add_argument("--goodput", action="store_true",
                    help="print the goodput phase decomposition "
                         "(table + JSON); exit 1 on invariant failure")
    ap.add_argument("--tolerance", type=float, default=5.0,
                    help="goodput invariant tolerance, %% of wall "
                         "(default 5)")
    ap.add_argument("--device-batch", type=int, default=64,
                    help="samples per rank-step for useful-sample "
                         "goodput (default 64: the continuity trainer)")
    ap.add_argument("--validate", metavar="TRACE_JSON",
                    help="schema-check an exported trace file and exit")
    args = ap.parse_args(argv)

    if args.validate:
        try:
            with open(args.validate, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as e:
            print(f"kftrace: cannot load {args.validate}: {e}",
                  file=sys.stderr)
            return 1
        problems = validate_chrome_trace(doc)
        if problems:
            for p in problems:
                print(f"kftrace: INVALID: {p}", file=sys.stderr)
            return 1
        n = len(doc.get("traceEvents", []))
        print(f"kftrace: {args.validate} valid ({n} events)")
        return 0

    if not args.dir and not args.server:
        ap.error("need --dir and/or --server (or --validate)")

    sources = []
    if args.dir:
        sources += read_flight_dir(args.dir)
    if args.server:
        try:
            sources += fetch_server(args.server)
        except (OSError, ValueError) as e:
            print(f"kftrace: cannot fetch {args.server}: {e}",
                  file=sys.stderr)
            return 1
    events, info = merge_sources(sources)
    if not events:
        print("kftrace: no events found (was the run launched with "
              "KF_TRACE=1 and KF_TRACE_DIR set?)", file=sys.stderr)
        return 1

    if args.goodput:
        from .goodput import decompose, format_table

        decomp = decompose(sources, tolerance_pct=args.tolerance,
                           device_batch=args.device_batch)
        print(format_table(decomp))
        print(json.dumps(decomp, indent=2))
        if not decomp["invariant"]["ok"]:
            print("kftrace: GOODPUT INVARIANT VIOLATED (phases do "
                  "not sum to wallclock within tolerance, or no "
                  "useful step survived)", file=sys.stderr)
            return 1
        return 0

    if args.summary or not args.output:
        print(json.dumps(summarize(events, info), indent=2))
    if args.output:
        doc = to_chrome_trace(events, info)
        problems = validate_chrome_trace(doc)
        if problems:
            # exporting malformed output and exiting 0 would defeat
            # the CI gate that exists to catch exactly this
            for p in problems:
                print(f"kftrace: INVALID EXPORT: {p}", file=sys.stderr)
            return 1
        with open(args.output, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        print(f"kftrace: wrote {args.output} "
              f"({len(doc['traceEvents'])} events, "
              f"{info['sources']} sources)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
