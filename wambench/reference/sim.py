"""The plain reference of the benchmark's timed path: F coded flows of one
sender on a shared fabric, in plain PyTorch and numpy.

It follows the paper's sender and the shared-fabric semantics as the
system states them, with the float association the system promises (the
jitted JAX model's): each link's sum folds its (hop, flow, path) values
onto the link's base in ascending flattened order, a multiply that feeds
an add is one rounding (`fma32`), and deliveries fold onto the ring path by
path.  It imports nothing of the program: the topology, routing matrix,
per-link orders, ECMP draw, spray seeds and key streams are worked out
again here from the same inputs (configuration, flow pairs, keys).

The sender's policy is found by the mix's name for it in
`wambench.reference.policies` (``WAM``, ``ECMP``, ...): a new policy's
reference is a new module there.

``lowp=True`` is the control: the same program with every float state of
the fabric (link sums, queues, the delivery ring, the per-flow counters)
stored in bfloat16, the precision below the float32 that the system
states.  It must come out not correct.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from wambench.reference import policies
from wambench.reference import threefry as tf

M32 = tf.M32
DEEP = 4096          # links with more entries fold on the host (numpy, in order)


# ----------------------------------------------------------------- numerics

def fma32(a, b, c):
    """float32 ``a * b + c`` with a single rounding.

    The product of two float32 is exact in float64.  The float64 sum is
    rounded to nearest; Dekker's fast two-sum, with the operands ordered by
    magnitude, gives its rounding error exactly.  Where that error is not
    0 and the sum's last bit is even, the sum steps to its neighbour on the
    side of the exact value: the sum rounded to odd, whose one rounding to
    float32 is the exact value's (float64 has 29 bits more than float32).
    """
    p = a.to(torch.float64) * b.to(torch.float64)
    q = c.to(torch.float64)
    p_big = p.abs() >= q.abs()
    big, small = torch.where(p_big, p, q), torch.where(p_big, q, p)
    s = big + small
    err = small - (s - big)
    inf = torch.full_like(s, float("inf"))
    odd = torch.nextafter(s, torch.where(err > 0, inf, -inf))
    even = torch.remainder(s.view(torch.int64), 2) == 0
    return torch.where((err != 0) & even, odd, s).to(torch.float32)


def left_fold(x):
    """Sum along axis 0 in ascending order (the model's reduce of <= 32
    terms)."""
    if x.shape[0] > 32:
        raise ValueError("the reference folds at most 32 hops")
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


# ------------------------------------------------------------------- fabric

class Fabric:
    """The shared fabric's constants on ``device``, and its per-link sums."""

    def __init__(self, spec: dict, device):
        dev = torch.device(device)
        self.device = dev
        route = spec["route"]
        self.H, self.F, self.n = route.shape
        self.route = torch.as_tensor(route, device=dev)
        for k in ("capacity", "queue_limit", "ecn_threshold", "degrade_p", "recover_p",
                  "degrade_factor"):
            setattr(self, k, torch.as_tensor(spec[k], device=dev))
        self.latency = torch.as_tensor(spec["latency"], device=dev)
        self.fb_delay, self.ring_len = spec["fb_delay"], spec["ring_len"]
        self.L = int(self.capacity.shape[0])
        flat = route.reshape(-1)
        counts = np.bincount(flat, minlength=self.L)
        self.entries, self.depth = int(flat.size), int(counts.max())
        order = np.argsort(flat, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(flat.size) - np.repeat(starts, counts)
        rows = np.repeat(np.arange(self.L), counts)
        deep = counts > DEEP
        self.parts = []
        for links, on_host in ((np.nonzero(~deep)[0], False), (np.nonzero(deep)[0], True)):
            if links.size == 0:
                continue
            width = int(counts[links].max())
            slot = np.full(self.L, -1)
            slot[links] = np.arange(links.size)
            index = np.full((links.size, max(width, 1)), self.entries, np.int64)
            mine = slot[rows] >= 0
            index[slot[rows[mine]], pos[mine]] = order[mine]
            self.parts.append((torch.as_tensor(links, device=dev), width,
                               torch.as_tensor(np.ascontiguousarray(index.T), device=dev),
                               on_host))

    def link_sum(self, vals, base):
        """base[l] plus link l's values folded in ascending flattened
        order, then + 0 where the link is shallower than the deepest."""
        flat = torch.cat([vals.reshape(-1), vals.new_zeros(1)])
        out = torch.empty_like(base)
        for links, width, index, on_host in self.parts:
            g = flat[index]                       # [width, links]
            acc = base[links]
            if on_host:
                rows = torch.cat([acc.unsqueeze(0), g]).cpu().numpy()
                acc = torch.as_tensor(np.add.accumulate(rows, axis=0)[-1], device=out.device)
            else:
                for k in range(width):
                    acc = acc + g[k]
            if width < self.depth:
                acc = acc + torch.zeros_like(acc)
            out[links] = acc
        return out


def ring_deposit(ring, slot, vals):
    """``ring`` with each path's ``vals`` added at the path's ``slot`` of
    its flow's row: ``ring[f, slot[f, p]] += vals[f, p]`` for p = 0, 1,
    ... in turn, so a slot that several paths hit takes their values in
    path order.  ``ring`` is [F, R]; ``slot`` and ``vals`` are [F, n]."""
    acc = ring.clone()
    rows = torch.arange(ring.shape[0], device=ring.device)
    for p in range(slot.shape[1]):
        acc.index_put_((rows, slot[:, p].long()), vals[:, p], accumulate=True)
    return acc


def fabric_tick(fab: Fabric, s: dict, arrivals, u, lowp: bool):
    """One tick of the shared fabric: moles, per-link tail drop and
    service over the flows' per-hop queues, ECN, the delivery ring and the
    delayed feedback rings.  Returns (state', feedback)."""
    rnd = bf16 if lowp else (lambda x: x)
    route = fab.route
    t = s["t"]
    go_down = (~s["degraded"]) & (u < fab.degrade_p)
    go_up = s["degraded"] & (u < fab.recover_p)
    degraded = (s["degraded"] | go_down) & ~go_up
    cap = fab.capacity * torch.where(degraded, fab.degrade_factor,
                                     torch.ones_like(fab.degrade_factor))
    inflow = torch.cat([arrivals.unsqueeze(0), s["forward"]], dim=0)
    q_in = s["queue"] + inflow
    bg_q = s["bg_queue"]
    bg_in = torch.zeros_like(bg_q)
    backlog = rnd(fab.link_sum(q_in, bg_q))
    incoming = rnd(fab.link_sum(inflow, bg_in))
    dropable = torch.minimum(torch.clamp_min(backlog - fab.queue_limit, 0.0), incoming)
    zero = torch.zeros_like(incoming)
    drop_frac = torch.where(incoming > 0, dropable / torch.clamp_min(incoming, 1e-9), zero)
    df = drop_frac[route]
    q_in = fma32(-inflow, df, q_in)
    bg_q = fma32(-bg_in, drop_frac, bg_q)
    backlog = backlog - dropable
    served_l = torch.minimum(backlog, cap)
    serve_frac = torch.where(backlog > 0, served_l / torch.clamp_min(backlog, 1e-9), zero)
    sf = serve_frac[route]
    served = rnd(q_in * sf)
    queue = rnd(fma32(-q_in, sf, q_in))
    bg_queue = fma32(-bg_q, serve_frac, bg_q)
    residual = backlog - served_l
    qdelay_l = torch.where(cap > 0, residual / torch.clamp_min(cap, 1e-6), zero)
    path_qdelay = left_fold(qdelay_l[route])
    path_drops = inflow[0] * df[0]
    for h in range(1, fab.H):
        path_drops = fma32(inflow[h], df[h], path_drops)
    over = residual > fab.ecn_threshold
    exiting = served[-1]
    marked = torch.where(over[route].any(dim=0), exiting, torch.zeros_like(exiting))
    delay = torch.clamp_max(fab.latency + torch.round(path_qdelay).to(torch.int32),
                            fab.ring_len - 1)
    ring = rnd(ring_deposit(s["ring"], (t + 1 + delay) % fab.ring_len, exiting))
    cur = t % fab.ring_len
    landed = ring[:, cur].clone()
    ring[:, cur] = 0.0
    w = t % fab.fb_delay
    fb = {}
    new = dict(t=t + 1, queue=queue, forward=served[:-1], bg_queue=bg_queue,
               degraded=degraded, ring=ring, received=rnd(s["received"] + landed),
               dropped=rnd(s["dropped"] + path_drops),
               link_served=rnd(s["link_served"] + served_l),
               link_busy=s["link_busy"] + (served_l > 0).to(torch.float32))
    for name, v in (("sent", arrivals), ("marked", marked), ("dropped", path_drops),
                    ("qdelay", path_qdelay)):
        r = s["fb_" + name]
        fb[name] = r[:, w, :].clone()
        r = r.clone()
        r[:, w, :] = v
        new["fb_" + name] = r
    return new, fb


def _fabric_state(fab: Fabric):
    H, F, n, L, dev = fab.H, fab.F, fab.n, fab.L, fab.device
    z = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
    s = dict(t=0, queue=z(H, F, n), forward=z(H - 1, F, n), bg_queue=z(L),
             degraded=torch.zeros(L, dtype=torch.bool, device=dev), ring=z(F, fab.ring_len),
             received=z(F), dropped=z(F, n), link_served=z(L), link_busy=z(L))
    for name in ("sent", "marked", "dropped", "qdelay"):
        s["fb_" + name] = z(F, fab.fb_delay, n)
    return s


def _quiet(s) -> bool:
    return bool((s["queue"] == 0).all() & (s["forward"] == 0).all()
                & (s["ring"] == 0).all() & (s["fb_dropped"] == 0).all())


# ------------------------------------------------------------------- sender

def run(fab: Fabric, sender: dict, mix: dict, key, sa: int, sb: int, *,
        lowp: bool = False) -> dict:
    """One run of the coded sender: every flow sends ``mix["packets"]``
    packets at ``mix["rate"]`` a tick under ``mix["policy"]`` for up to
    ``mix["horizon"]`` ticks, checking every ``exit_chunk`` ticks whether
    all flows are done and the fabric is empty.  ``key`` is the run's
    threefry key ``(k0, k1)``; ``sa``, ``sb`` the spray seeds.  Returns
    the results as numpy arrays."""
    if not sender["coded"]:
        raise ValueError("the reference runs the coded sender")
    dev, F, n = fab.device, fab.F, fab.n
    rate, horizon = int(mix["rate"]), int(mix["horizon"])
    policy = policies.find(mix["policy"])
    ell = int(sender["ell"])
    m, mask = 1 << ell, (1 << ell) - 1
    lanes = rate  # the system's rate_cap: one lane a packet of the tick
    npk = torch.full((F,), float(mix["packets"]), dtype=torch.float32, device=dev)
    over = npk * torch.full((), sender["code_overhead"], dtype=torch.float32, device=dev)
    need = torch.where(npk <= 4.0, npk, torch.floor(npk + over) + 1.0) - 0.25
    base, extra = divmod(m, n)
    b0 = torch.full((n,), base, dtype=torch.int32, device=dev)
    b0[:extra] += 1
    fidx = torch.arange(F, dtype=torch.int64, device=dev)
    j = torch.zeros(F, dtype=torch.int64, device=dev)
    k = tf.split(tf.key_of(key[0], key[1], dev), 2)
    ctx = types.SimpleNamespace(
        F=F, n=n, m=m, lanes=lanes, ell=ell, method=sender["method"],
        ctrl_interval=int(sender["ctrl_interval"]), b0=b0.expand(F, n).to(torch.int32),
        sa_f=((sa & M32) + fidx * 0x9E3779B9) & mask, sb_f=(((sb & M32) + 2 * fidx) & mask) | 1,
        ecmp=tf.randint(k[0], (F,), 0, n))
    tick_keys = tf.split(tf.fold_in(k[1], torch.arange(horizon, device=dev)), 2)
    latency = fab.latency.to(torch.float32)
    s = _fabric_state(fab)
    done_at = torch.where(need <= 0.0, 0, -1).to(torch.int32)
    sent_pp = torch.zeros(F, n, device=dev)
    path_ids = torch.arange(n, device=dev).unsqueeze(-1)
    lane_ids = torch.arange(lanes, device=dev)

    def ticks(s, j, pol, sent_pp, done_at, keys):
        u = tf.uniform(keys[:, 1], (fab.L,))
        for i in range(keys.shape[0]):
            t = s["t"]
            k_emit = torch.where(done_at >= 0, 0, rate).to(torch.int32)
            paths = policy.paths(ctx, pol, j)
            live = lane_ids < k_emit.unsqueeze(-1)
            arrivals = ((paths.unsqueeze(-2) == path_ids) & live.unsqueeze(-2)).sum(-1)
            arrivals = arrivals.to(torch.float32)
            j = (j + k_emit.to(torch.int64)) & M32
            sent_pp = sent_pp + arrivals
            s, fb = fabric_tick(fab, s, arrivals, u[i], lowp)
            sent_m = torch.clamp_min(fb["sent"], 1e-6)
            seen1 = torch.clamp_max(fb["sent"], 1.0)
            ecn = fb["marked"] / sent_m * seen1
            loss = fb["dropped"] / sent_m * seen1
            pol = policy.feedback(ctx, pol, t, ecn, loss, latency + fb["qdelay"])
            done_now = (s["received"] >= need) & (done_at < 0)
            done_at = torch.where(done_now, t + 1, done_at).to(torch.int32)
        return s, j, pol, sent_pp, done_at

    # whole chunks while the run has not settled, then the remainder (whose
    # keys are the horizon's last), as the system's sender loop runs them
    chunk = max(1, min(int(sender["exit_chunk"]), horizon))
    n_full, rem = divmod(horizon, chunk)
    carry = (s, j, policy.start(ctx), sent_pp, done_at)
    i = 0
    while i < n_full and not (sender["early_exit"] and bool((carry[-1] >= 0).all())
                              and _quiet(carry[0])):
        carry = ticks(*carry, tick_keys[i * chunk:(i + 1) * chunk])
        i += 1
    if rem:
        carry = ticks(*carry, tick_keys[n_full * chunk:])
    s, j, pol, sent_pp, done_at = carry
    t = i * chunk + rem
    cct = torch.where(done_at >= 0, done_at.to(torch.float32),
                      torch.full((), float(horizon), device=dev))
    out = dict(cct=cct, sent_total=sent_pp, dropped_total=s["dropped"],
               final_b=policy.profile(pol), received=s["received"], finished=done_at >= 0,
               link_served=s["link_served"], link_busy=s["link_busy"])
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["ticks_run"] = np.asarray(t, dtype=np.int64)
    return out
