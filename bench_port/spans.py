"""The program's stage spans, read from the traced window's record.

The port opens a ``torch.profiler.record_function`` named ``pam.<path>``
at each stage of its chain (``python_audio_mastering_tpu_torch.utils.
tracing``): ``pam.chain``, ``pam.chain/front``, ``pam.chain/front/states``,
``pam.chain/multiband/detector``, ...  They lie in the same record as the
device's activities and the runtime calls that launched them, on the same
clock.  :func:`split` links each device activity to the runtime call that
launched it, and that call to the innermost ``pam.`` span around it on the
host; then it sums, per album:

* the plain-torch device time (every activity not ``pam::*_kernel``, the
  activities ``TraceContext.plain_ms`` counts) by that span's last name,
  so a span's own time leaves out what its inner spans launched;
* the host time in synchronising runtime calls (names holding
  ``Synchronize``) inside ``pam.chain``, and the host time of
  ``pam.chain`` itself;
* the device's idle time while the host was inside each span (innermost),
  and outside every span of the program.

The link is by launch order: every activity here runs on one stream, so
the k-th plain kernel (copy, set) to start is the k-th launch (copy, set
call) made inside an ``aten::`` op (the port's own kernels are launched
from ``ctypes``, outside any op).  That order is taken only where the
counts agree; otherwise those activities are left unattributed.  No
clock is compared: the record's device clock can put an activity before
its launch.  An activity with no launch is counted as unattributed, never
dropped; where more than :data:`UNATTRIBUTED` of the plain time is, the
stage metrics read None (no reading), not a share of the time.

:func:`split` is computed once a context and appends one note to
``ctx.notes``, which the harness prints to standard error.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bench_port import device_trace

__all__ = ["Split", "split", "stage_ms", "PROGRAM", "CHAIN", "UNATTRIBUTED"]

PROGRAM = "pam."          # the program's span names: PROGRAM + path
CHAIN = "chain"           # the chain's span: MasteringChain.forward_tracks
STAGES = ("chain", "front", "states", "multiband", "detector", "loudness",
          "limiter")
UNATTRIBUTED = 0.01       # the share of plain time left unlinked that
                          # turns the stage metrics into no reading
_SYNC = "Synchronize"
_MEMO = "_stage_split"    # where split() keeps its result on a context
_KINDS = {"memcpy": ("Memcpy", ("cudaMemcpy", "cuMemcpy")),
          "memset": ("Memset", ("cudaMemset", "cuMemset"))}


@dataclasses.dataclass
class Split:
    """Per album: ms and counts by a span's last name."""

    plain_ms: dict        # plain-torch device ms launched inside the span
    syncs: dict           # synchronising runtime calls inside it
    wait_ms: dict         # their host ms
    idle_ms: dict         # device idle ms while the host was inside it
    outside_plain_ms: float   # launched outside every span of the program
    outside_idle_ms: float
    unattributed_ms: float    # plain activities with no launch found
    chain_host_ms: float      # pam.chain's host duration
    chain_wait_ms: float      # synchronising calls inside pam.chain
    chain_syncs: float


def _dev_kind(name):
    for kind, (dev, _) in _KINDS.items():
        if name.startswith(dev):
            return kind
    return "kernel"


def _host_kind(name):
    if name in device_trace._LAUNCH_CALLS:
        return "kernel"
    for kind, (_, calls) in _KINDS.items():
        if name.startswith(calls):
            return kind
    return None


def _inside(lo, hi, t):
    """Whether each time ``t`` lies in the union of ``[lo, hi]``
    (sorted, disjoint)."""
    k = np.searchsorted(lo, t, side="right") - 1
    return (k >= 0) & (t <= hi[np.maximum(k, 0)])


def _by_order(ctx, plain):
    """The host index of each plain device activity's launch by launch
    order within each kind (see the module docstring), or -1."""
    launch = np.full(len(ctx.names), -1, dtype=np.int64)
    hs, he = ctx.host_starts, ctx.host_starts + ctx.host_durs
    aten = np.array([n.startswith("aten::") for n in ctx.host_names],
                    dtype=bool)
    lo, hi = device_trace._intervals(hs[aten], ctx.host_durs[aten])
    in_op = _inside(lo, hi, hs) & _inside(lo, hi, he)
    host_kind = [_host_kind(n) for n in ctx.host_names]
    dev_kind = [_dev_kind(n) for n in ctx.names]
    for kind in ("kernel", *_KINDS):
        dev = np.flatnonzero(plain & np.array([k == kind for k in dev_kind],
                                              dtype=bool))
        calls = np.flatnonzero(in_op & np.array([k == kind
                                                 for k in host_kind],
                                                dtype=bool))
        if not len(dev):
            continue
        dev = dev[np.argsort(ctx.starts[dev], kind="stable")]
        calls = calls[np.argsort(hs[calls], kind="stable")]
        if len(calls) == len(dev):
            launch[dev] = calls
        else:
            ctx.notes.append(f"spans: {len(dev)} plain {kind} activities, "
                         f"{len(calls)} launches inside ops: unattributed")
    return launch


def _innermost(lo, hi, t):
    """For each time ``t``, the index of the shortest span ``[lo, hi]``
    holding it (the innermost, spans being nested), or -1."""
    owner = np.full(len(t), -1, dtype=np.int64)
    for k in np.argsort(-(hi - lo), kind="stable"):
        owner[(lo[k] <= t) & (t <= hi[k])] = k
    return owner


def _busy_before(lo, hi, t):
    """Device busy ns before each time ``t`` (``lo``/``hi``: the union)."""
    cum = np.concatenate([[0.0], np.cumsum(hi - lo)])
    k = np.searchsorted(lo, t, side="right")
    j = np.maximum(k - 1, 0)
    part = np.where(k > 0, np.minimum(hi[j], t) - lo[j], 0.0)
    return cum[j] + part


def _window(ctx):
    own = [i for i, n in enumerate(ctx.host_names)
           if n == f"{device_trace.OWN_SPAN}window"]
    if own:
        i = own[0]
        return ctx.host_starts[i], ctx.host_starts[i] + ctx.host_durs[i]
    return ctx.host_starts.min(), (ctx.host_starts + ctx.host_durs).max()


def split(ctx):
    """The traced window's :class:`Split`, or None where the record holds
    no ``pam.chain`` span (a program without stage spans) or no device
    activity (a run on the CPU).  Computed once a context."""
    if _MEMO not in vars(ctx):
        setattr(ctx, _MEMO, _split(ctx))
    return getattr(ctx, _MEMO)


def _split(ctx):
    is_span = np.array([n.startswith(PROGRAM) for n in ctx.host_names],
                       dtype=bool)
    idx = np.flatnonzero(is_span)
    last = [ctx.host_names[i].rsplit("/", 1)[-1].removeprefix(PROGRAM)
            for i in idx]
    if CHAIN not in last or not ctx.names:
        return None
    sp_lo = ctx.host_starts[idx]
    sp_hi = sp_lo + ctx.host_durs[idx]
    albums = ctx.albums
    plain = ~ctx._is_port()

    launch = _by_order(ctx, plain)

    def add(d, key, v):
        d[key] = d.get(key, 0.0) + v

    plain_ms, syncs, wait_ms, idle_ms = {}, {}, {}, {}
    linked = plain & (launch >= 0)
    owner = np.full(len(ctx.names), -1, dtype=np.int64)
    owner[linked] = _innermost(sp_lo, sp_hi,
                               ctx.host_starts[launch[linked]])
    outside_plain = unattributed = 0.0
    for i in np.flatnonzero(plain):
        ms = ctx.durs[i] / 1e6 / albums
        if launch[i] < 0:
            unattributed += ms
        elif owner[i] < 0:
            outside_plain += ms
        else:
            add(plain_ms, last[owner[i]], ms)

    chain = np.array([n == CHAIN for n in last], dtype=bool)
    sync = np.flatnonzero([_SYNC in n for n in ctx.host_names])
    t_sync = ctx.host_starts[sync]
    in_chain = _innermost(sp_lo[chain], sp_hi[chain], t_sync) >= 0
    sync_owner = _innermost(sp_lo, sp_hi, t_sync)
    for j, k in zip(sync, sync_owner):
        if k >= 0:
            add(syncs, last[k], 1.0 / albums)
            add(wait_ms, last[k], ctx.host_durs[j] / 1e6 / albums)
    chain_wait = float(ctx.host_durs[sync[in_chain]].sum()) / 1e6 / albums
    chain_host = float(ctx.host_durs[idx[chain]].sum()) / 1e6 / albums

    w0, w1 = _window(ctx)
    lo, hi = device_trace._intervals(ctx.starts, ctx.durs)
    edges = np.unique(np.clip(np.concatenate([[w0, w1], sp_lo, sp_hi]),
                              w0, w1))
    a, b = edges[:-1], edges[1:]
    idle = (b - a) - (_busy_before(lo, hi, b) - _busy_before(lo, hi, a))
    seg_owner = _innermost(sp_lo, sp_hi, (a + b) / 2)
    outside_idle = float(idle[seg_owner < 0].sum()) / 1e6 / albums
    for k, v in zip(seg_owner[seg_owner >= 0], idle[seg_owner >= 0]):
        add(idle_ms, last[k], v / 1e6 / albums)

    s = Split(plain_ms=plain_ms, syncs=syncs, wait_ms=wait_ms,
              idle_ms=idle_ms, outside_plain_ms=outside_plain,
              outside_idle_ms=outside_idle, unattributed_ms=unattributed,
              chain_host_ms=chain_host, chain_wait_ms=chain_wait,
              chain_syncs=float(in_chain.sum()) / albums)
    ctx.notes.append(_note(s))
    return s


def stage_ms(ctx, name):
    """Plain-torch device ms per album launched inside spans last named
    ``name`` (their own time), or None: nothing to read (see
    :func:`split`), or more than :data:`UNATTRIBUTED` of the plain time
    linked to no launch."""
    s = split(ctx)
    if s is None:
        return None
    total = sum(s.plain_ms.values()) + s.outside_plain_ms + s.unattributed_ms
    if s.unattributed_ms > UNATTRIBUTED * total:
        return None
    return s.plain_ms.get(name, 0.0)


def _note(s):
    names = [n for n in STAGES if n in set(s.plain_ms) | set(s.syncs)
             | set(s.idle_ms)]
    names += sorted((set(s.plain_ms) | set(s.syncs) | set(s.idle_ms))
                    - set(names))
    parts = [f"{n} plain {float(s.plain_ms.get(n, 0.0))!r} ms, "
             f"{float(s.syncs.get(n, 0.0))!r} syncs, wait "
             f"{float(s.wait_ms.get(n, 0.0))!r} ms, idle "
             f"{float(s.idle_ms.get(n, 0.0))!r} ms" for n in names]
    parts.append("outside the program plain "
                 f"{float(s.outside_plain_ms)!r} ms, idle "
                 f"{float(s.outside_idle_ms)!r} ms")
    parts.append(f"unattributed plain {float(s.unattributed_ms)!r} ms")
    return "stage spans a call: " + "; ".join(parts)
