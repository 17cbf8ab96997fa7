"""The traced window's record, read from ``torch.profiler``'s timeline.

:func:`read` turns the profiler's events into a :class:`TraceContext`,
the one object every per-layer metric reader (``metrics/*.py``) takes.
What it derives:

* ``busy_s``: the union of every device activity's interval (kernels,
  copies, sets), so that overlapping activities count once;
* a kernel's device time per album: the mean duration of the launches
  the timeline holds, times the launches the port's counters say were
  made (``launch_counts()``), since a profiler window may hold fewer; a
  window that holds fewer is noted in ``notes``;
* the device time of everything the port's kernel library did not
  launch (its kernels are ``pam::*_kernel``), scaled up the same way
  where the timeline holds fewer kernels than the host launched;
* the longest idle gaps, each named by the innermost host operation
  that was running at its middle.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TraceContext", "read", "PORT_PREFIX"]

PORT_PREFIX = "pam::"
OWN_SPAN = "bench_port."          # the harness's own record_function spans
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
_GAPS_NAMED = 500                 # the longest gaps that get a host name
_TOP = 10


@dataclasses.dataclass
class TraceContext:
    albums: int                 # album calls inside the traced window
    window_s: float             # the traced window's wall (host clock)
    names: list                 # device activity names
    starts: np.ndarray          # device activity starts, ns
    durs: np.ndarray            # device activity durations, ns
    host_names: list
    host_starts: np.ndarray
    host_durs: np.ndarray
    launches: dict              # port kernel launches made, per album
    host_syncs: float | None    # host synchronisations a call
    shape: list                 # each traced album's shapes (rooflines)
    notes: list = dataclasses.field(default_factory=list)

    @property
    def busy_s(self):
        return _union_ns(self.starts, self.durs) / 1e9

    def _is_port(self):
        return np.array([PORT_PREFIX in n for n in self.names], dtype=bool)

    def kernel_ms(self, launch_names):
        """Device ms per album of the port kernels ``launch_names`` (their
        launch-counter names), or None when the timeline holds none of a
        kernel that was launched, or none was launched."""
        total, any_made = 0.0, False
        for n in launch_names:
            made = self.launches.get(n, 0.0) * self.albums
            if made <= 0:
                continue
            any_made = True
            tag = f"{PORT_PREFIX}{n}_kernel"
            hits = np.array([tag in x for x in self.names], dtype=bool)
            seen = int(hits.sum())
            if seen == 0:
                self.notes.append(f"profiler window: no launch of {n} seen "
                                  f"of {made:.0f} made")
                return None
            if seen != round(made):
                self.notes.append(f"profiler window short: {n} {seen} "
                                  f"launches seen of {made:.0f} made")
            total += self.durs[hits].mean() / 1e6 * made / self.albums
        return total if any_made else None

    def plain_ms(self):
        """Device ms per album of every activity the port's kernel
        library did not launch."""
        if not self.names:
            return None
        port = self._is_port()
        plain = float(self.durs[~port].sum()) / 1e6
        kernels = np.array([not (n.startswith("Memcpy")
                                 or n.startswith("Memset"))
                            for n in self.names], dtype=bool)
        launched = sum(1 for n in self.host_names if n in _LAUNCH_CALLS)
        seen = int(kernels.sum())
        if launched > seen:
            port_made = sum(self.launches.values()) * self.albums
            plain_seen = int((kernels & ~port).sum())
            plain_missing = launched - seen - max(
                0.0, port_made - int((kernels & port).sum()))
            self.notes.append(f"profiler window short: {seen} kernels seen "
                              f"of {launched} launched; plain torch's "
                              f"{plain_seen} scaled by {plain_missing:.0f} "
                              "missing")
            if plain_seen and plain_missing > 0:
                k_ms = float(self.durs[kernels & ~port].sum()) / 1e6
                plain += k_ms * plain_missing / plain_seen
        return plain / self.albums

    def copy_ms(self, direction):
        """Device ms per album of the copies ``direction`` (``"HtoD"``,
        ``"DtoH"``) the record holds, or None where it holds none."""
        tag = f"Memcpy {direction}"
        hits = np.array([n.startswith(tag) for n in self.names], dtype=bool)
        if not hits.any():
            return None
        return float(self.durs[hits].sum()) / 1e6 / self.albums

    def device_ops(self, top=_TOP):
        """The device activities that took most time: ``[[name,
        seconds], ...]`` over the traced window."""
        by = {}
        for n, d in zip(self.names, self.durs.tolist()):
            key = n[:120]
            by[key] = by.get(key, 0.0) + d / 1e9
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, window, top=_TOP):
        """The idle time by what the host was doing: ``[[name, seconds],
        ...]``, summed over the :data:`_GAPS_NAMED` longest gaps of the
        window ``(start_ns, end_ns)``; the rest as one entry."""
        if not self.names:
            return []
        lo, hi = _intervals(self.starts, self.durs)
        edges_a = np.concatenate([[window[0]], hi])
        edges_b = np.concatenate([lo, [window[1]]])
        gaps = np.clip(edges_b - edges_a, 0, None)
        order = np.argsort(-gaps)
        named = order[:_GAPS_NAMED]
        hs, hd = self.host_starts, self.host_durs
        he = hs + hd
        own = np.array([n.startswith(OWN_SPAN) for n in self.host_names],
                       dtype=bool)
        by = {}
        for i in named:
            if gaps[i] <= 0:
                break
            mid = (edges_a[i] + edges_b[i]) / 2
            cover = (hs <= mid) & (he >= mid) & ~own
            name = ("host: between recorded operations" if not cover.any()
                    else self.host_names[int(np.flatnonzero(cover)[
                        np.argmin(hd[cover])])])
            by[name] = by.get(name, 0.0) + gaps[i] / 1e9
        rest = float(gaps[order[_GAPS_NAMED:]].sum()) / 1e9
        out = sorted(by.items(), key=lambda kv: -kv[1])
        if rest > 0:
            out.append((f"gaps shorter than the {_GAPS_NAMED} longest",
                        rest))
        return [[k, v] for k, v in out[:top]]


def _intervals(starts, durs):
    """The union of ``[start, start + dur)`` as sorted disjoint
    ``(lo, hi)`` arrays."""
    if len(starts) == 0:
        return np.zeros(0), np.zeros(0)
    order = np.argsort(starts)
    s = starts[order].astype(np.float64)
    e = s + durs[order]
    run_end = np.maximum.accumulate(e)
    new = np.concatenate([[True], s[1:] > run_end[:-1]])
    idx = np.flatnonzero(new)
    lo = s[idx]
    hi = np.concatenate([run_end[idx[1:] - 1], [run_end[-1]]])
    return lo, hi


def _union_ns(starts, durs):
    lo, hi = _intervals(starts, durs)
    return float((hi - lo).sum())


def _is_device(e):
    return str(e.device_type()).split(".")[-1] != "CPU"


def _is_annotation(e):
    """A ``record_function`` span mirrored onto the device's timeline,
    which is no device activity."""
    own = e.name().startswith(OWN_SPAN)
    return own or bool(getattr(e, "is_user_annotation", lambda: False)())


def read(prof, albums, window_s, launches, host_syncs, shape):
    """A :class:`TraceContext` of a finished ``torch.profiler.profile``
    and the window's own counts; also returns the window's
    ``(start_ns, end_ns)`` on the timeline (the harness's
    ``bench_port.window`` span)."""
    events = prof.profiler.kineto_results.events()
    dev = [e for e in events if _is_device(e) and not _is_annotation(e)]
    host = [e for e in events if not _is_device(e)]
    win = [e for e in host if e.name() == f"{OWN_SPAN}window"]
    window = ((win[0].start_ns(), win[0].start_ns() + win[0].duration_ns())
              if win else (0, 0))
    ctx = TraceContext(
        albums=albums, window_s=window_s,
        names=[e.name() for e in dev],
        starts=np.array([e.start_ns() for e in dev], dtype=np.float64),
        durs=np.array([e.duration_ns() for e in dev], dtype=np.float64),
        host_names=[e.name() for e in host],
        host_starts=np.array([e.start_ns() for e in host], dtype=np.float64),
        host_durs=np.array([e.duration_ns() for e in host],
                           dtype=np.float64),
        launches=launches, host_syncs=host_syncs, shape=shape)
    return ctx, window
