"""In-scan telemetry: decimated per-tick series captured during one run.

A `TelemetrySpec` on `SenderSpec.telemetry` threads a `TelemetryFrame`
through the sender's tick loop (`repro_torch.net.sender.run_sender`), which
then returns ``(SimResult, frame)``.  Every `stride` ticks, until the run
settles, `record` writes one sample into ring buffers of `window` samples:

  * per path: the allocation profile b(t), cumulative emissions and drops;
  * per flow: ARQ debt, cumulative emitted and received packets, and the
    windowed discrepancy gauge ``max_i |m * hits_i - b_i * X| / m`` (the
    §9 deviation of the selections since the previous sample; exact in
    float32, equal to `core.deviation`'s integer oracle while the profile
    is static);
  * per link (shared fabrics): backlog, cumulative served and dropped
    packets, and an over-ECN-threshold indicator;
  * per path, for the stateful policies: STrack penalty timers and
    CC-coupled windows.

Capture only observes: the `SimResult` is bit-identical with it on or off,
and early exit records the same series as the full horizon.  The frame is
the reference's (`repro.net.telemetry`) leaf for leaf, in its dtypes,
except that the spray counter at the last capture (`prev_j`, uint32 there)
is an int64 holding the same value.  Sweeps stack frames with the
sweep's leading axes on every leaf; `frame_select` peels them.

The host-side functions (series extraction, event onsets, recovery
metrics, queue percentiles, the JSONL store and the Chrome / Perfetto
export) are numpy and write the reference's formats byte for byte, so
`tools/trace_report.py` reads the port's files unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.random import M32

__all__ = [
    "TelemetrySpec",
    "TelemetryFrame",
    "init_frame",
    "record",
    "frame_select",
    "series",
    "event_onsets",
    "degrade_onsets",
    "restore_onsets",
    "merge_onsets",
    "recovery_ticks",
    "rate_recovery_ticks",
    "profile_distance",
    "summarize_recovery",
    "queue_percentiles",
    "write_series_jsonl",
    "read_series_jsonl",
    "chrome_trace",
]


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Capture every `stride`-th tick into a ring of `window` samples;
    `paths`, `links` and `discrepancy` switch channel groups on or off
    (a group that is off has zero width and costs nothing)."""

    stride: int = 1
    window: int = 512
    paths: bool = True
    links: bool = True
    discrepancy: bool = True

    def __post_init__(self):
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")

    def samples(self, horizon: int) -> int:
        """Samples a full `horizon`-tick run can produce (before wrap)."""
        return -(-horizon // self.stride)


@dataclasses.dataclass(frozen=True)
class TelemetryFrame:
    """Ring buffers with a leading sample axis W, then the run's flow axes
    (per-flow and per-path channels) or the link axis (link channels);
    `prev_sent` / `prev_j` open the gauge's window."""

    count: torch.Tensor       # int32: samples written (wraps past W)
    tick: torch.Tensor        # int32[W]
    alloc: torch.Tensor       # int32[W, *lead, n?]
    sent_pp: torch.Tensor     # float32[W, *lead, n?]
    dropped_pp: torch.Tensor  # float32[W, *lead, n?]
    debt: torch.Tensor        # float32[W, *lead]
    emitted: torch.Tensor     # float32[W, *lead]
    received: torch.Tensor    # float32[W, *lead]
    disc: torch.Tensor        # float32[W, *lead]
    link_queue: torch.Tensor    # float32[W, L?]
    link_served: torch.Tensor   # float32[W, L?]
    link_dropped: torch.Tensor  # float32[W, L?]
    link_ecn: torch.Tensor      # float32[W, L?]
    pstate_pen: torch.Tensor  # float32[W, *lead, pen?]
    pstate_ccw: torch.Tensor  # float32[W, *lead, ccw?]
    prev_sent: torch.Tensor   # float32[*lead, n]
    prev_j: torch.Tensor      # int64[*lead]: a uint32 counter's value

    @property
    def window(self) -> int:
        return int(self.tick.shape[-1])


# channel names in export order (buffers with their sample axis first)
_CHANNELS = (
    "tick", "alloc", "sent_pp", "dropped_pp", "debt", "emitted", "received",
    "disc", "link_queue", "link_served", "link_dropped", "link_ecn",
    "pstate_pen", "pstate_ccw",
)


def init_frame(tspec: TelemetrySpec, lead: Tuple[int, ...], n: int, links: int, *,
               pen_width: int = 0, ccw_width: int = 0, device=None) -> TelemetryFrame:
    """A zeroed frame for a run with flow axes `lead`, n paths and `links`
    shared links (0 without a link concept); `pen_width` / `ccw_width` are
    the run's policy-state widths."""
    W = tspec.window
    np_ = n if tspec.paths else 0
    L = links if tspec.links else 0
    pw = pen_width if tspec.paths else 0
    cw = ccw_width if tspec.paths else 0
    lead = tuple(lead)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return TelemetryFrame(
        count=z(dtype=torch.int32), tick=z(W, dtype=torch.int32),
        alloc=z(W, *lead, np_, dtype=torch.int32), sent_pp=z(W, *lead, np_),
        dropped_pp=z(W, *lead, np_), debt=z(W, *lead), emitted=z(W, *lead),
        received=z(W, *lead), disc=z(W, *lead), link_queue=z(W, L), link_served=z(W, L),
        link_dropped=z(W, L), link_ecn=z(W, L), pstate_pen=z(W, *lead, pw),
        pstate_ccw=z(W, *lead, cw), prev_sent=z(*lead, n),
        prev_j=z(*lead, dtype=torch.int64),
    )


def record(tspec: TelemetrySpec, frame: TelemetryFrame, capture: torch.Tensor, *,
           tick: int, m: int, alloc: torch.Tensor, sent_pp: torch.Tensor,
           dropped_pp: torch.Tensor, debt: torch.Tensor, emitted: torch.Tensor,
           received: torch.Tensor, j: torch.Tensor,
           link: Optional[Tuple[torch.Tensor, ...]],
           pen: Optional[torch.Tensor] = None,
           ccw: Optional[torch.Tensor] = None) -> TelemetryFrame:
    """One capture step: where the device predicate `capture` holds, write
    every enabled channel into slot ``count % window`` and open a new gauge
    window; where it does not, every slot keeps its value.  The slot is
    read from the frame's device-side count and the host's `tick` is
    written with a fill (no host-to-device copy), so nothing waits for the
    card.  `j` is the spray counter after the tick (uint32 values in int64)."""
    w = (frame.count.to(torch.int64) % frame.window).reshape(1)

    def put(buf: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
        old = buf.index_select(0, w)
        new = val.to(buf.dtype).expand(old.shape[1:])
        return buf.index_copy(0, w, torch.where(capture, new.unsqueeze(0), old))

    if tspec.discrepancy:
        # the selections since the last capture (uint32 counters, wrapping)
        # as int32 then float32, like the reference's casts; hits, X and
        # the products are integers below 2**24 and /m a power of two, so
        # every step is exact
        d = (j - frame.prev_j) & M32
        x = torch.where(d >= 2 ** 31, d - 2 ** 32, d).to(torch.float32)
        hits = sent_pp - frame.prev_sent
        scaled = m * hits - alloc.to(torch.float32) * x.unsqueeze(-1)
        disc = torch.amax(scaled.abs(), dim=-1) / m
    else:
        disc = torch.zeros_like(debt)

    if tspec.links and link is not None:
        lq, ls, ld, le = link
    else:
        lq = ls = ld = le = frame.link_queue[0]  # [0] when disabled

    pen_v = pen if pen is not None else frame.pstate_pen.index_select(0, w)[0]
    ccw_v = ccw if ccw is not None else frame.pstate_ccw.index_select(0, w)[0]
    pen_v = pen_v[..., : frame.pstate_pen.shape[-1]]
    ccw_v = ccw_v[..., : frame.pstate_ccw.shape[-1]]

    trail = alloc.shape[-1] if tspec.paths else 0
    tick_v = torch.full((), tick, dtype=torch.int32, device=frame.tick.device)
    return TelemetryFrame(
        count=frame.count + capture.to(torch.int32),
        tick=put(frame.tick, tick_v),
        alloc=put(frame.alloc, alloc[..., :trail]),
        sent_pp=put(frame.sent_pp, sent_pp[..., :trail]),
        dropped_pp=put(frame.dropped_pp, dropped_pp[..., :trail]),
        debt=put(frame.debt, debt),
        emitted=put(frame.emitted, emitted),
        received=put(frame.received, received),
        disc=put(frame.disc, disc),
        link_queue=put(frame.link_queue, lq),
        link_served=put(frame.link_served, ls),
        link_dropped=put(frame.link_dropped, ld),
        link_ecn=put(frame.link_ecn, le),
        pstate_pen=put(frame.pstate_pen, pen_v),
        pstate_ccw=put(frame.pstate_ccw, ccw_v),
        prev_sent=torch.where(capture, sent_pp, frame.prev_sent),
        prev_j=torch.where(capture, j, frame.prev_j),
    )


# --- host-side series extraction ------------------------------------------


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def frame_select(frame, idx):
    """Peel leading sweep axes off every tensor leaf: ``frame_select(f,
    (c, p, d))`` is the frame of run (c, p, d).  Like the reference's tree
    map it takes any dataclass of tensors: a swept `SimResult`, or a stacked
    `TopologyParams` / `EventSchedule` (whose static fields stay)."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    return dataclasses.replace(frame, **{
        f.name: getattr(frame, f.name)[idx] for f in dataclasses.fields(frame)
        if torch.is_tensor(getattr(frame, f.name))})


def series(frame: TelemetryFrame) -> Dict[str, np.ndarray]:
    """The valid samples of ONE run's frame in tick order, as numpy arrays
    with the sample axis first; zero-width channels are left out.  After a
    wrap the oldest surviving sample leads."""
    count = _np(frame.count)
    if count.ndim != 0:
        raise ValueError(
            f"frame carries sweep axes {count.shape} — index them off with "
            f"frame_select(frame, idx) first"
        )
    count = int(count)
    W = frame.window
    if count <= W:
        sl = np.arange(count)
    else:
        sl = np.arange(count - W, count) % W
    out: Dict[str, np.ndarray] = {}
    for name in _CHANNELS:
        buf = _np(getattr(frame, name))
        if buf.ndim > 1 and buf.shape[-1] == 0:
            continue  # statically disabled channel group
        out[name] = buf[sl]
    return out


# --- derived metrics (numpy, as the reference's) ----------------------------


def event_onsets(sched: EventSchedule) -> np.ndarray:
    """Ticks where the deterministic event schedule changes its row.

    Row t of the schedule drives tick t (last row persists), so a change
    between rows t-1 and t is an event ONSET at tick t — a flap edge, a
    storm wave, a background burst boundary.  Returns the sorted int64
    onset ticks (empty for a static environment).
    """
    cap = _np(sched.cap_scale)
    bg = _np(sched.bg_arrivals)
    rows = np.concatenate([cap, bg], axis=-1)
    if rows.shape[0] < 2:
        return np.zeros((0,), np.int64)
    change = np.any(rows[1:] != rows[:-1], axis=-1)
    return np.flatnonzero(change).astype(np.int64) + 1


def degrade_onsets(sched: EventSchedule) -> np.ndarray:
    """Ticks where the environment got WORSE: some link's capacity scale
    decreased or its background load increased between consecutive rows.

    `event_onsets` fires on EVERY row change — including restores, which
    are not failures and whose "recovery" is instant by construction.  The
    correlated-failure bench measures recovery from degradations only, so
    this is its onset set.  Returns sorted int64 ticks (subset of
    `event_onsets`)."""
    cap = _np(sched.cap_scale)
    bg = _np(sched.bg_arrivals)
    if cap.shape[0] < 2:
        return np.zeros((0,), np.int64)
    worse = np.any(cap[1:] < cap[:-1], axis=-1) | np.any(
        bg[1:] > bg[:-1], axis=-1
    )
    return np.flatnonzero(worse).astype(np.int64) + 1


def restore_onsets(sched: EventSchedule) -> np.ndarray:
    """Ticks where some link's capacity scale INCREASED (or background
    decreased) — the restore edges.  With `degrade_onsets` this splits
    `event_onsets` into failure and repair events (a tick can be both:
    one SRLG restoring while another fails)."""
    cap = _np(sched.cap_scale)
    bg = _np(sched.bg_arrivals)
    if cap.shape[0] < 2:
        return np.zeros((0,), np.int64)
    better = np.any(cap[1:] > cap[:-1], axis=-1) | np.any(
        bg[1:] < bg[:-1], axis=-1
    )
    return np.flatnonzero(better).astype(np.int64) + 1


def merge_onsets(onsets: Sequence[int], window: int) -> np.ndarray:
    """Cluster onset ticks by gap-chaining: cascade onset detection.

    A hop-by-hop PFC cascade or a burst-flap cluster changes the schedule
    at EVERY wave/flap edge, but the fabric experiences ONE correlated
    incident — measuring recovery from each interior wave would start the
    clock inside the storm.  Merge chains onsets whose gap from the
    previous onset is <= `window` into one cluster and returns each
    cluster's FIRST tick (sorted int64): the incident onsets.  `window`
    should cover the process's intra-incident spacing (cascade
    ``hop_delay``, flap ``flap_len``) and sit well under the
    inter-incident spacing; `window=0` is the identity."""
    onsets = np.sort(np.asarray(list(onsets), np.int64))
    if window < 0:
        raise ValueError(f"merge window must be >= 0, got {window}")
    if onsets.size == 0:
        return onsets
    gaps = np.diff(onsets)
    starts = np.concatenate([[True], gaps > window])
    return onsets[starts]


def recovery_ticks(
    tick: np.ndarray,
    alloc: np.ndarray,
    onsets: Sequence[int],
    *,
    tol: float = 0.0,
    min_hold: int = 2,
) -> np.ndarray:
    """Ticks from each event onset until the allocation profile re-converges.

    For each onset, the segment of samples up to the next onset (or the end
    of the series) defines that event's response; its LAST sample is the
    post-event steady profile.  Recovery is the first sample from which the
    profile stays within `tol` balls (L-infinity over paths) of that steady
    state for the rest of the segment — the paper's whack/restore
    convergence, measured.  A stable suffix shorter than `min_hold` samples
    is right-censored and reported as -1 (the profile was still moving when
    the window closed); onsets with no sample before the next onset are
    also -1.

    Onsets past the last captured sample are dropped, not censored: capture
    freezes when every flow settles, so a schedule row changing after that
    point acts on an idle fabric — there is no response to measure.

    `alloc` is ``[K, *lead, n]`` (any flow axes between the sample and path
    axes); returns ``[n_observed_onsets, *lead]`` float64 tick counts.
    """
    tick = np.asarray(tick)
    alloc = np.asarray(alloc, np.float64)
    onsets = np.asarray(list(onsets), np.int64)
    onsets = onsets[onsets <= int(tick[-1])] if tick.size else onsets[:0]
    lead = alloc.shape[1:-1]
    out = np.full((len(onsets),) + lead, -1.0)
    bounds = np.concatenate([onsets[1:], [np.iinfo(np.int64).max]])
    for i, (t0, t1) in enumerate(zip(onsets, bounds)):
        k0 = int(np.searchsorted(tick, t0))
        k1 = int(np.searchsorted(tick, t1))
        if k1 - k0 < 1:
            continue
        seg = alloc[k0:k1]                                 # [k, *lead, n]
        dev = np.max(np.abs(seg - seg[-1]), axis=-1)       # [k, *lead]
        ok = dev <= tol
        # longest all-True suffix per element: first index where the
        # reversed cumulative-AND still holds
        suffix = np.minimum.accumulate(ok[::-1], axis=0)[::-1]
        first = suffix.argmax(axis=0)                      # [*lead]
        hold = (k1 - k0) - first
        rec = tick[k0 + first].astype(np.float64) - float(t0)
        out[i] = np.where(hold >= min_hold, rec, -1.0)
    return out


def rate_recovery_ticks(
    tick: np.ndarray,
    received: np.ndarray,
    onsets: Sequence[int],
    *,
    frac: float = 0.8,
    min_hold: int = 2,
) -> np.ndarray:
    """Goodput-based recovery: ticks from each onset until the fabric-wide
    delivery rate returns to `frac` of its pre-incident baseline.

    `recovery_ticks` watches the allocation PROFILE, which never moves for
    static policies (ECMP / RR / RAND_STATIC keep spraying into the hole)
    — their profile "recovers" in zero ticks while their packets blackhole
    until the physical restore.  This metric watches what the application
    feels instead: the windowed delivery rate, computed from the cumulative
    `received` channel summed over all flow axes (rate of sample k covers
    the capture window ending at ``tick[k]``).

    The baseline is the mean rate over the samples strictly before the
    first onset (the pre-incident steady state; at least one such rate
    sample is required or everything is censored).  For each onset the
    clock demands a DIP first:
    the rate sample ending at the onset tick still counts pre-onset
    deliveries, and the fabric's pipeline latency keeps goodput at
    baseline for a few ticks after the caps drop — so recovery is only
    declared from the first sample at/after the onset whose rate falls
    BELOW ``frac * baseline``.  The dip is searched before the NEXT onset
    (a later incident's own dip must not be mis-attributed); if none, the
    incident did not touch this policy's goodput (e.g. ECMP's hash dodged
    the failed SRLG) and the recovery is an honest 0.  After the dip,
    recovery is the first sample whose rate is >= ``frac * baseline`` for
    `min_hold` CONSECUTIVE samples, searched to the END of the series:
    overlapping incidents (a double fault striking mid-recovery) push an
    onset's re-convergence past the next onset, which is degradation the
    clock must keep counting, not censor.  The run demand is a run, not a
    stable suffix: goodput legitimately falls to zero later when flows
    complete, which must not un-recover an incident.  Recovery is
    reported as ticks since the ONSET — detection and re-spray latency
    both count, identically for every policy.  Censored (dipped but never
    re-converged, or too few samples) is -1; like `recovery_ticks`,
    onsets past the last captured sample are dropped.  Returns float64
    ``[n_observed_onsets]``.
    """
    tick = np.asarray(tick)
    received = np.asarray(received, np.float64)
    onsets = np.asarray(list(onsets), np.int64)
    onsets = onsets[onsets <= int(tick[-1])] if tick.size else onsets[:0]
    out = np.full((len(onsets),), -1.0)
    if tick.size < 2 or len(onsets) == 0:
        return out
    total = received.reshape(received.shape[0], -1).sum(axis=-1)
    dt = np.diff(tick).astype(np.float64)
    rate = np.diff(total) / np.maximum(dt, 1.0)   # rate[k-1] ends at tick[k]
    rtick = tick[1:]                              # tick of each rate sample
    pre = rate[rtick < onsets[0]]
    if pre.size == 0:
        return out
    need = frac * float(pre.mean())
    ok = rate >= need
    bounds = np.concatenate([onsets[1:], [np.iinfo(np.int64).max]])
    for i, (t0, t1) in enumerate(zip(onsets, bounds)):
        k0 = int(np.searchsorted(rtick, t0))
        k1 = int(np.searchsorted(rtick, t1))
        dips = np.flatnonzero(~ok[k0:k1])
        if dips.size == 0:          # never dipped: goodput untouched
            out[i] = 0.0
            continue
        for k in range(k0 + int(dips[0]), rate.size - min_hold + 1):
            if ok[k: k + min_hold].all():
                out[i] = float(rtick[k]) - float(t0)
                break
    return out


def profile_distance(
    tick: np.ndarray,
    alloc: np.ndarray,
    *,
    before: int,
    after: Optional[int] = None,
    window: int = 8,
) -> float:
    """Total-variation distance between allocation profiles at two times.

    Answers "did the controller RETURN to its pre-incident spraying
    pattern, or settle somewhere else?" — WAM's restore probing walks the
    profile back, STrack's decayed penalties may leave residue, and a
    static policy trivially scores 0.  Takes the mean profile over the
    (up to) `window` samples strictly before tick `before` (pre-incident)
    and the `window` samples at or before tick `after` (post-recovery;
    None = end of series), L1-normalizes each over the path axis, and
    returns the mean over flows of the total-variation distance
    ``0.5 * sum_i |p_i - q_i|`` — 0 when identical, 1 when disjoint.
    Flows whose window-mean profile is all-zero compare as uniform.
    """
    tick = np.asarray(tick)
    alloc = np.asarray(alloc, np.float64)
    k0 = int(np.searchsorted(tick, before))
    if k0 < 1:
        raise ValueError(
            f"no samples before tick {before} to take a baseline from"
        )
    k1 = alloc.shape[0] if after is None else int(
        np.searchsorted(tick, after, side="right")
    )
    if k1 < 1:
        raise ValueError(f"no samples at or before tick {after}")
    pre = alloc[max(0, k0 - window): k0].mean(axis=0)    # [*lead, n]
    post = alloc[max(0, k1 - window): k1].mean(axis=0)

    def norm(p):
        s = p.sum(axis=-1, keepdims=True)
        n = p.shape[-1]
        return np.where(s > 0, p / np.where(s > 0, s, 1.0), 1.0 / n)

    tv = 0.5 * np.abs(norm(pre) - norm(post)).sum(axis=-1)
    return float(tv.mean())


def summarize_recovery(rec: np.ndarray) -> Dict[str, float]:
    """Fold a `recovery_ticks` array into a compact row: median / p99 / max
    over the RECOVERED entries plus the recovered fraction (censored -1
    entries excluded from the percentiles, counted in the fraction)."""
    rec = np.asarray(rec, np.float64).reshape(-1)
    if rec.size == 0:
        return {"events": 0, "recovered_frac": 1.0,
                "p50": 0.0, "p99": 0.0, "max": 0.0}
    good = rec[rec >= 0]
    frac = float(good.size) / rec.size
    if good.size == 0:
        return {"events": int(rec.size), "recovered_frac": 0.0,
                "p50": -1.0, "p99": -1.0, "max": -1.0}
    return {
        "events": int(rec.size),
        "recovered_frac": round(frac, 4),
        "p50": float(np.percentile(good, 50)),
        "p99": float(np.percentile(good, 99)),
        "max": float(good.max()),
    }


def queue_percentiles(
    ser: Dict[str, np.ndarray], qs: Sequence[float] = (50.0, 99.0)
) -> Dict[str, float]:
    """Windowed queue-occupancy percentiles over the captured samples.

    ``all_pXX`` pools every (sample, link) observation; ``hot_pXX`` takes
    the per-sample HOTTEST link first (the head-of-line queue a worst-case
    packet sees) and then the percentile over samples.
    """
    q = np.asarray(ser["link_queue"], np.float64)
    out: Dict[str, float] = {}
    hot = q.max(axis=-1) if q.size else np.zeros((1,))
    for x in qs:
        out[f"all_p{int(x)}"] = float(np.percentile(q, x)) if q.size else 0.0
        out[f"hot_p{int(x)}"] = float(np.percentile(hot, x))
    return out


# --- export: JSONL series store + Chrome/Perfetto trace -------------------


def write_series_jsonl(
    path: str,
    ser: Dict[str, np.ndarray],
    *,
    meta: Optional[Dict] = None,
) -> None:
    """Write a series as line-oriented JSON: one meta line, one line per
    sample.  Lossless for the integer channels; floats round-trip through
    repr (float32 values survive exactly)."""
    names = [k for k in _CHANNELS if k in ser]
    k_samples = len(ser["tick"]) if "tick" in ser else 0
    head = {
        "_meta": dict(meta or {}),
        "channels": {k: list(np.asarray(ser[k]).shape[1:]) for k in names},
        "samples": k_samples,
    }
    with open(path, "w") as f:
        f.write(json.dumps(head) + "\n")
        for k_i in range(k_samples):
            row = {k: np.asarray(ser[k][k_i]).tolist() for k in names}
            f.write(json.dumps(row) + "\n")


def read_series_jsonl(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Inverse of `write_series_jsonl`: returns (series, meta)."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty trace file")
    head = json.loads(lines[0])
    if "_meta" not in head or "channels" not in head:
        raise ValueError(f"{path}: missing series header line")
    rows = [json.loads(ln) for ln in lines[1:]]
    if len(rows) != int(head.get("samples", len(rows))):
        raise ValueError(
            f"{path}: header declares {head.get('samples')} samples, "
            f"found {len(rows)}"
        )
    ser: Dict[str, np.ndarray] = {}
    for name, trail in head["channels"].items():
        vals = np.asarray([r[name] for r in rows])
        dtype = np.int64 if name in ("tick",) else (
            np.int32 if name == "alloc" else np.float32
        )
        ser[name] = vals.reshape((len(rows),) + tuple(trail)).astype(dtype)
    return ser, head["_meta"]


def _counter_event(name: str, ts: int, args: Dict) -> Dict:
    return {"ph": "C", "name": name, "pid": 0, "tid": 0,
            "ts": int(ts), "args": args}


def chrome_trace(
    ser: Dict[str, np.ndarray],
    *,
    onsets: Sequence[int] = (),
    flow: Optional[int] = None,
    max_links: int = 0,
) -> Dict:
    """Render a series as a Chrome/Perfetto ``traceEvents`` dict.

    Counter tracks: per-path allocation and windowed discrepancy of one
    flow (`flow`; None picks flow 0 of multi-flow series, or the only
    flow), per-flow debt/received, and fabric aggregates (total + hottest
    link queue, links over ECN, cumulative drops).  `max_links` > 0 adds
    that many individual per-link queue tracks (link ids sorted by peak
    backlog).  Scenario `onsets` land as instant events, so the whack /
    restore response lines up under the event that caused it in the
    Perfetto UI.  Load via chrome://tracing or https://ui.perfetto.dev.
    """
    ticks = np.asarray(ser["tick"])
    ev: List[Dict] = []

    def flow_view(arr):
        # [K, n] (single flow) / [K, F, n] (coupled flows) -> [K, n]
        a = np.asarray(arr)
        if a.ndim == 3:
            return a[:, 0 if flow is None else flow]
        return a

    if "alloc" in ser:
        alloc = flow_view(ser["alloc"])
        for k_i, t in enumerate(ticks):
            ev.append(_counter_event(
                "flow/alloc", t,
                {f"path{i}": int(v) for i, v in enumerate(alloc[k_i])},
            ))
    scalars = [(nm, f"flow/{nm}") for nm in ("disc", "debt", "received")
               if nm in ser]
    for nm, track in scalars:
        a = np.asarray(ser[nm])
        v = a if a.ndim == 1 else a[:, 0 if flow is None else flow]
        for k_i, t in enumerate(ticks):
            ev.append(_counter_event(track, t, {nm: float(v[k_i])}))
    if "link_queue" in ser:
        q = np.asarray(ser["link_queue"], np.float64)
        ecn = np.asarray(ser.get("link_ecn", np.zeros_like(q)))
        drops = np.asarray(ser.get("link_dropped", np.zeros_like(q)))
        for k_i, t in enumerate(ticks):
            ev.append(_counter_event("fabric/queue", t, {
                "total": float(q[k_i].sum()),
                "hottest": float(q[k_i].max()) if q.shape[-1] else 0.0,
            }))
            ev.append(_counter_event("fabric/health", t, {
                "ecn_links": float(ecn[k_i].sum()),
                "dropped_total": float(drops[k_i].sum()),
            }))
        if max_links and q.shape[-1]:
            hot_ids = np.argsort(-q.max(axis=0))[:max_links]
            for link in hot_ids:
                for k_i, t in enumerate(ticks):
                    ev.append(_counter_event(
                        f"link{int(link)}/queue", t,
                        {"backlog": float(q[k_i, link])},
                    ))
    for t0 in onsets:
        ev.append({"ph": "i", "name": "scenario event", "pid": 0, "tid": 0,
                   "ts": int(t0), "s": "g"})
    ev.sort(key=lambda e: e["ts"])
    return {"traceEvents": ev, "displayTimeUnit": "ms"}
