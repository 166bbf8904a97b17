#!/usr/bin/env python
"""Summarize or diff telemetry traces exported by `repro_torch.net.telemetry`.

The PyTorch port's reader of its own exports: `tools/trace_report.py`'s
three modes, flags, output and exit codes, reading through
`repro_torch.net.telemetry` (numpy on the host; no device is touched).
It operates on the JSONL series store (`write_series_jsonl` output, e.g.
the `*.jsonl` files `examples/torch_telemetry_quickstart.py` writes under
`traces/demo/`; the reference's exports are byte-equal) and
sanity-checks Perfetto trace JSON.  Three modes:

    python tools/torch_trace_report.py --summary traces/*.jsonl
        One table row per trace: samples, tick span, channels, final
        allocation profile, discrepancy gauge max, queue p50/p99,
        recovery stats (when the meta block carries event onsets) —
        profile re-convergence p50/p99/max plus the goodput clock
        (`rate_recovery_ticks`) when the trace has a `received` channel.
        Traces whose meta names a `policy` (the recovery bench's
        per-policy exports) are also pooled into a per-policy table:
        rec_p50 / rec_p99 / worst across that policy's traces.  With
        --max-recovery-ticks N, exit 1 if any pooled recovery exceeds N
        ticks or never re-converged (the shell-scriptable regression
        gate over exported trace artifacts).

    python tools/torch_trace_report.py --diff A.jsonl B.jsonl
        Channel-by-channel comparison of two traces on their common
        ticks: max absolute difference and first diverging tick.  Exit
        code 1 when any channel differs (shell-scriptable regression
        gate), 0 when the traces agree.

    python tools/torch_trace_report.py --check-perfetto traces/*.trace.json
        Validate Perfetto/Chrome trace JSON structure (traceEvents list,
        required keys, monotonic-sortable timestamps) — the CI guard
        that a broken exporter fails the workflow, not just the UI.

Every mode re-reads the files through the library's own
`read_series_jsonl`, so a round-trip failure surfaces here first.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", "src"))

from repro_torch.net.telemetry import (  # noqa: E402
    queue_percentiles,
    rate_recovery_ticks,
    read_series_jsonl,
    recovery_ticks,
    summarize_recovery,
)


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e6:
        return str(int(v))
    return f"{v:.3g}"


class UnreadableInput(Exception):
    """Raised for trace paths that cannot be read or parsed."""


def _read_series(path: str):
    """`read_series_jsonl` with unreadable/corrupt inputs turned into a
    clean `UnreadableInput` (exit 2) instead of a traceback."""
    try:
        return read_series_jsonl(path)
    except OSError as e:
        raise UnreadableInput(
            f"{path}: unreadable ({e.strerror or e})"
        ) from e
    except (json.JSONDecodeError, KeyError, ValueError) as e:
        raise UnreadableInput(f"{path}: not a series JSONL ({e})") from e


def _print_table(rows: list[dict]) -> None:
    cols: list[str] = []
    for r in rows:
        cols += [c for c in r if c not in cols]
    widths = {
        c: max(len(c), *(len(str(r.get(c, "-"))) for r in rows)) for c in cols
    }
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        print("  ".join(str(r.get(c, "-")).ljust(widths[c]) for c in cols))


def summarize(paths: list[str], max_recovery_ticks: float | None = None) -> int:
    rows = []
    pooled: dict[str, list[float]] = {}
    for path in paths:
        ser, meta = _read_series(path)
        ticks = ser["tick"]
        row = {
            "trace": os.path.basename(path),
            "samples": len(ticks),
            "ticks": f"{int(ticks[0])}..{int(ticks[-1])}" if len(ticks) else "-",
            "channels": len(ser),
        }
        if "disc" in ser and ser["disc"].size:
            row["disc_max"] = _fmt(float(np.max(ser["disc"])))
        if "link_queue" in ser and ser["link_queue"].size:
            qp = queue_percentiles(ser)
            row["q_p50"] = _fmt(qp["hot_p50"])
            row["q_p99"] = _fmt(qp["hot_p99"])
        onsets = meta.get("onsets", [])
        trace_rec: list[float] = []
        if onsets and "alloc" in ser and ser["alloc"].size:
            # honor the exporter's convergence ball when it recorded one
            rec = recovery_ticks(
                ticks, ser["alloc"], onsets,
                tol=float(meta.get("tol", 0.0)),
            )
            s = summarize_recovery(rec)
            row["events"] = s["events"]
            row["recov%"] = _fmt(100 * s["recovered_frac"])
            row["rec_p50"] = _fmt(s["p50"])
            row["rec_p99"] = _fmt(s["p99"])
            row["rec_max"] = _fmt(s["max"])
            trace_rec += [float(v) for v in np.ravel(rec)]
        if onsets and "received" in ser and ser["received"].size:
            # the goodput clock over the same onsets (worst incident;
            # -1 = an incident never re-converged inside this trace),
            # honoring the exporter's threshold/hold when recorded
            rr = rate_recovery_ticks(
                ticks, ser["received"], onsets,
                frac=float(meta.get("rate_frac", 0.8)),
                min_hold=int(meta.get("min_hold", 2)),
            )
            if rr.size:
                worst = -1.0 if (rr < 0).any() else float(rr.max())
                row["rate_rec"] = _fmt(worst)
                trace_rec += [float(v) for v in rr]
        if "policy" in meta and trace_rec:
            pooled.setdefault(str(meta["policy"]), []).extend(trace_rec)
        rows.append(row)
    _print_table(rows)
    violations = []
    if pooled:
        print()
        agg = []
        for policy in sorted(pooled):
            vals = np.asarray(pooled[policy], np.float64)
            seen = vals[vals >= 0]
            agg.append({
                "policy": policy,
                "events": vals.size,
                "censored": int((vals < 0).sum()),
                "rec_p50": _fmt(float(np.percentile(seen, 50))) if seen.size else "-",
                "rec_p99": _fmt(float(np.percentile(seen, 99))) if seen.size else "-",
                "rec_max": _fmt(float(seen.max())) if seen.size else "-",
            })
            if max_recovery_ticks is not None:
                if (vals < 0).any():
                    violations.append(f"{policy}: never re-converged")
                elif seen.size and seen.max() > max_recovery_ticks:
                    violations.append(
                        f"{policy}: worst recovery {_fmt(float(seen.max()))} "
                        f"> {_fmt(max_recovery_ticks)} ticks"
                    )
        _print_table(agg)
    if max_recovery_ticks is not None and not pooled:
        # the gate is meaningless without per-policy recovery traces —
        # passing silently would hide a broken exporter
        print(
            "torch_trace_report: --max-recovery-ticks given but no trace "
            "carries policy + onsets meta", file=sys.stderr,
        )
        return 2
    if violations:
        for v in violations:
            print(f"recovery gate: {v}", file=sys.stderr)
        return 1
    return 0


def diff(path_a: str, path_b: str) -> int:
    ser_a, _ = _read_series(path_a)
    ser_b, _ = _read_series(path_b)
    ticks_a, ticks_b = ser_a["tick"], ser_b["tick"]
    common, ia, ib = np.intersect1d(ticks_a, ticks_b, return_indices=True)
    print(
        f"{os.path.basename(path_a)}: {len(ticks_a)} samples | "
        f"{os.path.basename(path_b)}: {len(ticks_b)} samples | "
        f"common ticks: {len(common)}"
    )
    names = sorted((set(ser_a) | set(ser_b)) - {"tick"})
    dirty = False
    if len(ticks_a) != len(ticks_b) or not np.array_equal(ticks_a, ticks_b):
        dirty = True
        print("  tick: sample sets differ")
    for name in names:
        if name == "tick":
            continue
        if name not in ser_a or name not in ser_b:
            dirty = True
            print(f"  {name}: only in "
                  f"{'A' if name in ser_a else 'B'}")
            continue
        a, b = ser_a[name][ia], ser_b[name][ib]
        if a.shape != b.shape:
            dirty = True
            print(f"  {name}: shape {a.shape} vs {b.shape}")
            continue
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        if d.size and d.max() > 0:
            dirty = True
            k = int(np.flatnonzero(d.reshape(len(common), -1).max(axis=1))[0])
            print(
                f"  {name}: max |diff| = {d.max():g}, "
                f"first divergence at tick {int(common[k])}"
            )
        else:
            print(f"  {name}: identical on common ticks")
    return 1 if dirty else 0


def check_perfetto(paths: list[str]) -> int:
    bad = 0
    for path in paths:
        try:
            f = open(path)
        except OSError as e:
            raise UnreadableInput(
                f"{path}: unreadable ({e.strerror or e})"
            ) from e
        try:
            with f:
                doc = json.load(f)
            events = doc["traceEvents"]
            if not isinstance(events, list) or not events:
                raise ValueError("traceEvents empty or not a list")
            for ev in events:
                if ev["ph"] not in ("C", "i", "X", "B", "E", "M"):
                    raise ValueError(f"unknown phase {ev['ph']!r}")
                int(ev["ts"])
                str(ev["name"])
            n_counter = sum(1 for ev in events if ev["ph"] == "C")
            n_instant = sum(1 for ev in events if ev["ph"] == "i")
            print(
                f"{path}: OK — {len(events)} events "
                f"({n_counter} counters, {n_instant} instants)"
            )
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            print(f"{path}: INVALID — {e}")
            bad += 1
    return 1 if bad else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python tools/torch_trace_report.py",
        description=__doc__.splitlines()[0],
        epilog=(
            "Inputs are the artifacts `make perf-smoke` drops under "
            "traces/: *.jsonl series stores (--summary/--diff) and "
            "*.trace.json Perfetto exports (--check-perfetto).  Exit: "
            "0 ok, 1 traces differ (--diff) or fail validation "
            "(--check-perfetto), 2 unreadable/corrupt input."
        ),
    )
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--summary", action="store_true",
                      help="one stats row per trace")
    mode.add_argument("--diff", action="store_true",
                      help="compare exactly two traces channel by channel")
    mode.add_argument("--check-perfetto", action="store_true",
                      help="validate Perfetto/Chrome trace JSON files")
    p.add_argument(
        "--max-recovery-ticks", type=float, metavar="N", default=None,
        help="with --summary: exit 1 if any per-policy pooled recovery "
        "exceeds N ticks or never re-converged; exit 2 if no trace "
        "carries the policy/onsets meta the gate needs",
    )
    p.add_argument("paths", nargs="+", help="trace files")
    args = p.parse_args(argv)
    if args.max_recovery_ticks is not None and not args.summary:
        p.error("--max-recovery-ticks only applies to --summary")
    try:
        if args.diff:
            if len(args.paths) != 2:
                p.error("--diff needs exactly two trace files")
            return diff(*args.paths)
        if args.check_perfetto:
            return check_perfetto(args.paths)
        return summarize(args.paths, args.max_recovery_ticks)
    except UnreadableInput as e:
        print(f"torch_trace_report: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
