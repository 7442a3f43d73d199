"""Span arithmetic over a profiler trace that holds the program's spans
(homan_tpu_torch/utils_profiling.py `span`): which program span each
device operation belongs to, and which span the host was in while the
device idled.

A device operation belongs to the innermost program span open, at its
launch call, on the host thread that made the call; the launch call is
found by the operation's correlation id. An operation launched by the
autograd engine (inside an `autograd::engine::evaluate_function:` op)
belongs instead to the span in which the forward op that made its backward
node ran: the op with the node's sequence number on the node's forward
thread. Where neither rule finds a span on a thread that runs no fit loop
(the engine's gradient accumulation, which has no forward op), the
operation belongs to the span open at its launch on the fit loop's thread.

The profiler can place a whole profile's device times a constant offset
before the host's (up to 4.3 ms seen on the card, in some profiles and not
others), while the program's spans and the launch calls share the host's
clock. No operation starts before its launch call, so the device's times
are moved later by the largest such lead, and the lead is reported.

Busy time is split, not summed: where device operations overlap, the time
counts once, for the operation that started first, so the seconds by span
add up to the busy time. Idle time is the stretch's wall on the trace's
clock less the busy time; each idle interval belongs to the innermost
span open then on the fit loop's thread (the thread of the `fit.step`
spans). Time that belongs to no span goes to `none`.

Events are plain tuples, so the arithmetic runs on synthetic lists:
`Host` for the host's ranges (program spans, ops, runtime calls), `Device`
for the device's operations; times in ns on the trace's clock.
"""
from __future__ import annotations

from bisect import bisect_right
from collections import Counter, defaultdict, namedtuple

STEP = "fit.step"
# The program's spans, as homan_tpu_torch names them.
SPANS = (STEP, "fit.forward", "fit.backward", "fit.adam", "raster.prep",
         "interactions")
NONE = "none"
BACKWARD = "autograd::engine::evaluate_function:"
RUNTIME = "cu"  # CUDA runtime and driver calls: cudaLaunchKernel, ...

Host = namedtuple("Host", "name start end thread corr seq fwd_thread")
Device = namedtuple("Device", "name start end corr")


def timeline(ranges):
    """(cuts, owners) of one thread's ranges: owners[i], the innermost
    range open (the open one that started last) from cuts[i] to
    cuts[i + 1], None where no range is open."""
    marks = sorted([(r.start, 1, i) for i, r in enumerate(ranges)]
                   + [(r.end, 0, i) for i, r in enumerate(ranges)])
    cuts, owners, open_ = [], [], []
    for t, is_start, i in marks:
        if is_start:
            open_.append(i)
        else:
            open_.remove(i)
        owner = ranges[open_[-1]] if open_ else None
        if cuts and cuts[-1] == t:
            owners[-1] = owner
        else:
            cuts.append(t)
            owners.append(owner)
    return cuts, owners


def owner_at(line, t):
    """The innermost range of a timeline open at t (None without one)."""
    if line is None:
        return None
    cuts, owners = line
    i = bisect_right(cuts, t) - 1
    return owners[i] if i >= 0 else None


def _by_thread(ranges):
    out = defaultdict(list)
    for r in ranges:
        out[r.thread].append(r)
    return {th: timeline(rs) for th, rs in out.items()}


def fit_thread(spans):
    """The thread of the fit loop: the one that holds the `fit.step`
    spans (None without them)."""
    th = Counter(s.thread for s in spans if s.name == STEP)
    return th.most_common(1)[0][0] if th else None


def attribute(spans, host, device):
    """Per device operation, (its span or None, whether the autograd
    engine launched it, its launch call or None)."""
    lines = _by_thread(spans)
    loop = fit_thread(spans)
    launch = {h.corr: h for h in host if h.name.startswith(RUNTIME)}
    evals = _by_thread([h for h in host if h.name.startswith(BACKWARD)])
    forward = {}
    for h in sorted(host, key=lambda h: h.start):
        # The last op to open with a sequence number made its node; ops
        # run by the engine are not forward ops.
        if (h.seq >= 0 and not h.name.startswith(BACKWARD)
                and owner_at(evals.get(h.thread), h.start) is None):
            forward[(h.seq, h.thread)] = h
    out = []
    for d in device:
        r = launch.get(d.corr)
        if r is None:
            out.append((None, False, None))
            continue
        node = owner_at(evals.get(r.thread), r.start)
        op = None if node is None else forward.get((node.seq,
                                                    node.fwd_thread))
        if op is not None:
            span = owner_at(lines.get(op.thread), op.start)
        else:
            span = owner_at(lines.get(r.thread), r.start)
            if span is None and r.thread != loop:
                span = owner_at(lines.get(loop), r.start)
        out.append((span, node is not None, r))
    return out


def exclusive_ns(device, t0, t1):
    """Per device operation, its ns within [t0, t1] that no operation
    which started earlier covers: together, the union of the device's
    operations there."""
    out = [0] * len(device)
    end = t0
    for i in sorted(range(len(device)), key=lambda i: device[i].start):
        a, b = max(device[i].start, end), min(device[i].end, t1)
        if b > a:
            out[i] = b - a
        end = max(end, min(device[i].end, t1))
    return out


def idle_intervals(device, t0, t1):
    """The intervals of [t0, t1] in which no device operation ran."""
    out, end = [], t0
    for d in sorted(device, key=lambda d: d.start):
        if d.start > end:
            out.append((end, min(d.start, t1)))
        end = max(end, d.end)
        if end >= t1:
            break
    if end < t1:
        out.append((end, t1))
    return [(a, b) for a, b in out if b > a]


def split_by_owner(line, intervals):
    """[(owner or None, ns)]: each interval cut where the timeline's
    innermost range changes."""
    out = []
    cuts, owners = line if line is not None else ([], [])
    for a, b in intervals:
        i = bisect_right(cuts, a) - 1
        t = a
        while t < b:
            nxt = cuts[i + 1] if i + 1 < len(cuts) else b
            stop = min(b, nxt)
            out.append((owners[i] if i >= 0 else None, stop - t))
            t = stop
            i += 1
    return out


def ancestors(spans):
    """{span: names of the spans that hold it on its thread, its own
    included}."""
    by = defaultdict(list)
    for s in spans:
        by[s.thread].append(s)
    return {s: {p.name for p in by[s.thread]
                if p.start <= s.start and s.end <= p.end} for s in spans}


def _name(span):
    return NONE if span is None else span.name


def summary(spans, host, device, t0, t1):
    """The stretch's accounting over [t0, t1] (ns on the trace's clock),
    in seconds:
    - wall_s, busy_s, idle_s; overlap_s, what the operations' summed
      durations exceed the busy time by;
    - device_s {span: s}, busy time by the innermost span (with `none`),
      and device_bwd_s, its part launched by the autograd engine;
    - idle_by {span: s}, idle time by the innermost span on the fit
      loop's thread (with `none`);
    - under {span: s} and idle_under {span: s}: the same summed over every
      span that holds the innermost one (`fit.forward` holds `raster.prep`);
    - early: device operations that start before their launch call does
      on the host, and lead_us, the largest such lead; the device's times
      are moved later by that lead before anything else is counted;
    - steps: the `fit.step` spans that started in the stretch."""
    spans = [s for s in spans if s.name in SPANS]
    owners = attribute(spans, host, device)
    leads = [r.start - d.start for d, (_, _, r) in zip(device, owners)
             if r is not None]
    lead = max([0] + leads)
    kept = [(d._replace(start=d.start + lead, end=d.end + lead), o)
            for d, o in zip(device, owners)
            if d.end + lead > t0 and d.start + lead < t1]
    device = [d for d, _ in kept]
    excl = exclusive_ns(device, t0, t1)
    held = ancestors(spans)
    dev_s, bwd_s, under = Counter(), Counter(), Counter()
    for ns, (_, (span, engine, _)) in zip(excl, kept):
        dev_s[_name(span)] += ns
        if engine:
            bwd_s[_name(span)] += ns
        for name in (held[span] if span is not None else (NONE,)):
            under[name] += ns
    idle = idle_intervals(device, t0, t1)
    pieces = split_by_owner(_by_thread(spans).get(fit_thread(spans)), idle)
    idle_by, idle_under = Counter(), Counter()
    for span, ns in pieces:
        idle_by[_name(span)] += ns
        for name in (held[span] if span is not None else (NONE,)):
            idle_under[name] += ns

    def secs(c):
        return {k: v / 1e9 for k, v in sorted(c.items(),
                                              key=lambda kv: -kv[1])}
    busy = sum(excl)
    return {
        "wall_s": (t1 - t0) / 1e9, "busy_s": busy / 1e9,
        "idle_s": sum(b - a for a, b in idle) / 1e9,
        "overlap_s": (sum(min(d.end, t1) - max(d.start, t0)
                          for d in device) - busy) / 1e9,
        "device_s": secs(dev_s), "device_bwd_s": secs(bwd_s),
        "idle_by": secs(idle_by), "under": secs(under),
        "idle_under": secs(idle_under),
        "early": sum(1 for x in leads if x > 0), "lead_us": lead / 1e3,
        "steps": sum(1 for s in spans if s.name == STEP and s.start >= t0),
    }
