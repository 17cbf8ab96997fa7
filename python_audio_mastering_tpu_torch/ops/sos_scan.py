"""K8: the exact SOS cascade recurrence, one CTA a column, a warp a
section.

Counterpart of the JAX package's ``iir.sosfilt_scan`` (an XLA
``lax.scan``, not a Pallas kernel): direct-form II transposed, per sample
and section

    y  = b0·x + z0
    z0 = (b1·x − a1·y) + z1
    z1 = b2·x − a2·y

every product and sum rounded on its own, in this order (scipy's
``sosfilt`` order).  :func:`sos_scan` launches ``csrc/sos_scan.cu`` for a
CUDA tensor (or raises) and runs its plain version :func:`sos_scan_ref`
for a CPU tensor; the two agree bit for bit.  One launch runs F cascades
over the same R columns (the crossovers' low and high pass), each column
from its own ``zi``, its final state taken after its own valid length.

The kernel gives each column a CTA and each section a walker warp;
section ``j − 1``'s output reaches section ``j`` through a ring of tiles
in shared memory, x's tiles come in and the output's go out by bulk
(TMA) copies, so the sections overlap.  :func:`launch_plan` is its
geometry (tile, ring depth, warps, shared memory) and :func:`_tile_split`
the split of each tile around its 16-byte aligned middle that the copies
need; both are the kernel's arithmetic in Python, for the tests.

The plain version is a torch loop over time, vectorised over the
columns and, as a wavefront, over the sections: at step ``s`` section
``j`` takes sample ``s − j``, so one step is a handful of tensor ops on
``(K, columns)`` tensors, and a cascade of K sections over N samples is
``N + K − 1`` steps.  It repeats the kernel's arithmetic and is no
yardstick of speed.

Under autograd (:class:`_SosScanFn`, one cascade) the forward is one
launch and the backward runs K8 again.  With ``g`` the gradient of a
section's output ``y`` and ``u`` its input, ``λ = (1/A)ᵀ g`` (the
all-pole section ``(1, 0, 0, 1, a1, a2)`` over the time-reversed ``g``)
gives ``∂u = Bᵀ λ`` (the FIR section ``(b0, b1, b2, 1, 0, 0)`` over the
time-reversed ``λ``: the section's adjoint), ``∂b_i = Σ_t λ(t)·u(t−i)``,
``∂a_i = −Σ_t λ(t)·y(t−i)`` and ``∂zi = (λ(0), λ(1))``.  So the whole
backward is one launch of the 2K-section adjoint cascade (each section
from the last, its all-pole part then its FIR part) over the reversed
upstream gradient, every section's output recorded (the λ's, and the
input's gradient at the end); and, only when the coefficients need a
gradient, one launch of the cascade over its input with the sections'
outputs recorded (the ``u``'s and ``y``'s).  The final state is not
differentiable.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from python_audio_mastering_tpu_torch.ops import _kernels
from python_audio_mastering_tpu_torch.ops._kernels import ptr as _ptr
from python_audio_mastering_tpu_torch.ops._kernels import raise_on as _raise_on
from python_audio_mastering_tpu_torch.ops._kernels import upload

__all__ = ["sos_scan", "sos_scan_ref", "SECTIONS_MAX", "launch_plan"]

SECTIONS_MAX = 8   # the kernel's walker warps; longer cascades run in pieces
_DTYPES = (torch.float32, torch.float64)
# the kernel's constants (csrc/sos_scan.cu)
_TILE_BYTES = 4096   # a ring slot's tile
_DEPTH = 4           # slots a ring
_ALIGN = 16          # bulk copies: addresses and sizes


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One K8 launch's geometry: ``tile`` samples a ring slot, ``depth``
    slots a ring, ``warps`` a CTA (a walker a section, the producer and
    the drainer) and ``smem_bytes`` of dynamic shared memory (``k + 1``
    rings of ``depth`` slots of ``tile + 16 / elem`` elements, then a
    full and an empty mbarrier a slot)."""

    tile: int
    depth: int
    warps: int
    smem_bytes: int


def launch_plan(k, dtype):
    """The geometry of a launch of at most ``k`` sections in ``dtype``;
    the kernel refuses any other shared-memory size."""
    if not 1 <= k <= SECTIONS_MAX or dtype not in _DTYPES:
        raise ValueError(f"K8 takes 1 to {SECTIONS_MAX} sections in "
                         f"float32 or float64, got {k} in {dtype}")
    elem = torch.finfo(dtype).bits // 8
    tile = _TILE_BYTES // elem
    slot = (tile + _ALIGN // elem) * elem
    return LaunchPlan(tile=tile, depth=_DEPTH, warps=k + 2,
                      smem_bytes=(k + 1) * _DEPTH * (slot + 2 * 8))


def _tile_split(n, phase, dtype):
    """How the kernel copies a column of ``n`` samples whose sample 0
    lies ``phase`` elements past a 16-byte boundary: for each tile
    ``[t0, t1)``, ``(head, body, tail)`` ranges, the body the aligned
    middle (one bulk copy, 16-byte aligned start and size), head and tail
    the samples around it (plain loads and stores); a tile with no
    aligned 16 bytes is all head."""
    plan = launch_plan(1, dtype)
    vec = _ALIGN // (torch.finfo(dtype).bits // 8)
    out = []
    for t0 in range(0, n, plan.tile):
        t1 = min(t0 + plan.tile, n)
        a, b = t0 + (vec - phase) % vec, t1 - (phase + t1) % vec
        if b <= a:
            a = b = t1
        out.append(((t0, a), (a, b), (b, t1)))
    return out


def _as_sos(sos, like):
    """A ``(K, 6)`` cascade as a tensor in ``like``'s dtype and device
    (numpy coefficients cast as the JAX package casts them, to the
    signal's dtype)."""
    if isinstance(sos, torch.Tensor):
        sos = sos.to(device=like.device, dtype=like.dtype)
    else:
        sos = upload(np.asarray(sos, np.float64), like.dtype, like.device)
    if sos.ndim != 2 or sos.shape[1] != 6 or sos.shape[0] == 0:
        raise ValueError(f"sos must have shape (K, 6), got "
                         f"{tuple(sos.shape)}")
    return sos


def _as_zi(zi, k, r, like):
    if zi is None:
        return like.new_zeros((k, 2, r))
    zi = torch.as_tensor(zi).to(device=like.device, dtype=like.dtype)
    if zi.ndim == 2:
        zi = zi[:, :, None]
    if tuple(zi.shape) != (k, 2, r):
        raise ValueError(f"zi must be ({k}, 2, {r}), got {tuple(zi.shape)}")
    return zi


def _valid(n_valid, r, n):
    """Per-column valid lengths as a list of R ints in ``[0, N]``."""
    if n_valid is None:
        return [n] * r
    vals = [int(n_valid)] * r if np.ndim(n_valid) == 0 else \
        [int(v) for v in n_valid]
    if len(vals) != r or min(vals) < 0 or max(vals) > n:
        raise ValueError(f"n_valid must be {r} lengths in [0, {n}], got "
                         f"{vals}")
    return vals


def _check_x(x):
    if x.ndim != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"x must be (R, N) with R, N > 0, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or float64, got {x.dtype}")


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _wavefront(x, sos, z0, z1, nv, record=False):
    """One group of cascades of K sections each over ``x`` ``(M, N)``:
    ``sos`` ``(6, K, M)`` (each column its cascade's coefficients),
    states ``z0``/``z1`` ``(K, M)``, ``nv`` the M valid lengths.  Returns
    ``(y (M, N), zf0, zf1)``, and with ``record`` every section's output
    ``(K, M, N)`` after them."""
    k = z0.shape[0]
    m, n = x.shape
    b, a = sos[0:3], sos[4:6]
    y = x.new_zeros((k, m))
    out = torch.empty_like(x)
    # section j's output at step s is its sample s − j: skewed by j here
    skew = x.new_zeros((n + k - 1, k, m)) if record else None
    # the steps where a section passes a column's last valid sample:
    # section j takes sample s − j at step s
    snaps = {}
    for v in sorted(set(nv)):
        if 0 < v < n:
            mask = torch.tensor([u == v for u in nv], device=x.device)
            for j in range(k):
                snaps.setdefault(v - 1 + j, []).append((j, mask))
    zf0, zf1 = z0.clone(), z1.clone()   # columns of no valid sample
    xt = x.T[:, None]                   # (N, 1, M): sample s is xt[s]
    out_t = out.T                       # (N, M) view: a sample is a row
    b0, b12 = b[0], b[1:]
    for s in range(n + k - 1):
        lo, hi = max(0, s - n + 1), min(k, s + 1)
        if lo == 0 and hi == k:          # every section busy: no slices
            p = b12 * (inp := torch.cat((xt[s], y[:-1])))
            y = b0 * inp + z0
            d = p - a * y
            z0, z1 = d[0] + z1, d[1]
        else:                            # the wavefront's ramps
            inp = (torch.cat((xt[s], y[:hi - 1])) if lo == 0
                   else y[lo - 1:hi - 1])
            ys = b0[lo:hi] * inp + z0[lo:hi]
            d = b12[:, lo:hi] * inp - a[:, lo:hi] * ys
            y, z0, z1 = y.clone(), z0.clone(), z1.clone()
            y[lo:hi], z0[lo:hi], z1[lo:hi] = ys, d[0] + z1[lo:hi], d[1]
        if hi == k:
            out_t[s - k + 1] = y[k - 1]
        if record:
            skew[s] = y
        for j, mask in snaps.get(s, ()):
            zf0[j] = torch.where(mask, z0[j], zf0[j])
            zf1[j] = torch.where(mask, z1[j], zf1[j])
    full_cols = torch.tensor([u == n for u in nv], device=x.device)
    zf0 = torch.where(full_cols, z0, zf0)
    zf1 = torch.where(full_cols, z1, zf1)
    if record:
        return out, zf0, zf1, torch.stack(
            [skew[j:j + n, j].T for j in range(k)])
    return out, zf0, zf1


def sos_scan_ref(x, sos_list, zi_list=None, n_valid=None):
    """Plain version of :func:`sos_scan` (same arguments and results),
    the cascades of one section count run together as one wavefront."""
    sos_scan_ref.calls += 1
    _check_x(x)
    r, n = x.shape
    sos_list = [_as_sos(s, x) for s in sos_list]
    zis = [_as_zi(None if zi_list is None else zi_list[f], s.shape[0], r, x)
           for f, s in enumerate(sos_list)]
    nv = _valid(n_valid, r, n)
    ys = x.new_empty((len(sos_list), r, n))
    zfs = [None] * len(sos_list)
    for k in sorted({s.shape[0] for s in sos_list}):
        group = [f for f, s in enumerate(sos_list) if s.shape[0] == k]
        coefs = torch.cat([sos_list[f].T[:, :, None].expand(6, k, r)
                           for f in group], dim=2)
        z0 = torch.cat([zis[f][:, 0] for f in group], dim=1)
        z1 = torch.cat([zis[f][:, 1] for f in group], dim=1)
        xg = x.repeat(len(group), 1)
        y, zf0, zf1 = _wavefront(xg, coefs, z0, z1, nv * len(group))
        for i, f in enumerate(group):
            ys[f] = y[i * r:(i + 1) * r]
            zfs[f] = torch.stack([zf0[:, i * r:(i + 1) * r],
                                  zf1[:, i * r:(i + 1) * r]], dim=1)
    return ys, zfs


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _launch(x, sos_list, zis, nv, record=False):
    """One K8 launch: cascades of at most :data:`SECTIONS_MAX` sections
    (with ``record``, one cascade, and its sections' outputs ``(K, R, N)``
    returned third, the output being the last of them)."""
    r, n = x.shape
    f_count = len(sos_list)
    ks = [s.shape[0] for s in sos_list]
    kmax = max(ks)
    plan = launch_plan(kmax, x.dtype)
    sos = x.new_zeros((f_count, kmax, 6))
    zi = x.new_zeros((f_count, kmax, 2, r))
    for f, (s, z) in enumerate(zip(sos_list, zis)):
        sos[f, :ks[f]] = s
        zi[f, :ks[f]] = z
    nsec = upload(ks, torch.int32, x.device)
    nvt = upload(nv, torch.int64, x.device)
    zf = torch.empty_like(zi)
    if record:   # one cascade: its last section's record is the output
        ysec = x.new_empty((kmax, r, n))
        y = ysec[-1:]
    else:
        ysec, y = None, x.new_empty((f_count, r, n))
    lib = _kernels.library().lib
    fn = (lib.pam_sos_scan_f32 if x.dtype == torch.float32
          else lib.pam_sos_scan_f64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_ptr(x), _ptr(sos), _ptr(nsec), _ptr(zi), _ptr(nvt),
                 None if record else _ptr(y), _ptr(zf),
                 _ptr(ysec) if record else None, f_count, r, n, kmax,
                 plan.smem_bytes, stream)
    _raise_on("sos_scan", err)
    sos_scan.launches += 1
    zfs = [zf[f, :k] for f, k in enumerate(ks)]
    return (y, zfs, ysec) if record else (y, zfs)


def _scan_nograd(x, sos_list, zis, nv):
    if x.device.type == "cpu":
        return sos_scan_ref(x, sos_list, zis, nv)
    if x.device.type != "cuda":
        raise ValueError(f"sos_scan: no kernel for device {x.device}")
    x = x.contiguous()
    if max(s.shape[0] for s in sos_list) <= SECTIONS_MAX:
        return _launch(x, sos_list, zis, nv)
    # a long cascade: its pieces of SECTIONS_MAX sections in turn, each
    # piece's output the next one's input (the same operations, in order)
    ys, zfs = [], []
    for s, z in zip(sos_list, zis):
        cur, zf = x, []
        for p in range(0, s.shape[0], SECTIONS_MAX):
            y, (zp,) = _launch(cur, [s[p:p + SECTIONS_MAX]],
                               [z[p:p + SECTIONS_MAX]], nv)
            cur = y[0]
            zf.append(zp)
        ys.append(cur)
        zfs.append(torch.cat(zf))
    return torch.stack(ys), zfs


def sos_scan(x, sos_list, zi_list=None, n_valid=None):
    """F SOS cascades over the R columns of ``x``, exactly (K8).

    Args:
      x: ``(R, N)`` float32 or float64, each row one column's samples
        (rows ``(C, T, nb, L)`` reshaped to ``(C·T, nb·L)``).
      sos_list: F ``(K_f, 6)`` cascades ``[b0, b1, b2, 1, a1, a2]``,
        numpy or tensors, cast to ``x``'s dtype.
      zi_list: None, or F initial states (each None or scipy-layout
        ``(K_f, 2, R)``).
      n_valid: the samples of each column before its padding (None: all
        N; an int for every column, or R of them): a column's final state
        is the one after them.  The output runs over all N samples.

    Returns ``(y (F, R, N), zfs)``, ``zfs`` the F final states ``(K_f,
    2, R)``.  Under autograd (an input or a coefficient tensor that
    requires grad) each cascade runs through :class:`_SosScanFn`.
    """
    _check_x(x)
    r, n = x.shape
    sos_list = [_as_sos(s, x) for s in sos_list]
    zis = [_as_zi(None if zi_list is None else zi_list[f], s.shape[0], r, x)
           for f, s in enumerate(sos_list)]
    nv = _valid(n_valid, r, n)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, *sos_list, *zis]):
        ys, zfs = [], []
        for s, z in zip(sos_list, zis):
            y, zf = _SosScanFn.apply(x, s, z, nv)
            ys.append(y)
            zfs.append(zf)
        return torch.stack(ys), zfs
    return _scan_nograd(x, sos_list, zis, nv)


sos_scan.launches = 0
sos_scan_ref.calls = 0


def _sections(x, sos, zi):
    """Every section's output ``(K, R, N)`` of one cascade ``sos`` (a
    tensor in ``x``'s dtype) over ``x`` ``(R, N)`` from ``zi`` ``(K, 2,
    R)``, the last the cascade's output: K8 launches of at most
    :data:`SECTIONS_MAX` sections with their outputs recorded (the plain
    version's wavefront on the CPU)."""
    r, n = x.shape
    if x.device.type == "cpu":
        sos_scan_ref.calls += 1
        _, _, _, rec = _wavefront(
            x, sos.T[:, :, None].expand(6, sos.shape[0], r).contiguous(),
            zi[:, 0].contiguous(), zi[:, 1].contiguous(), [n] * r,
            record=True)
        return rec
    outs, cur = [], x.contiguous()
    for p in range(0, sos.shape[0], SECTIONS_MAX):
        _, _, rec = _launch(cur, [sos[p:p + SECTIONS_MAX]],
                            [zi[p:p + SECTIONS_MAX]], [n] * r, record=True)
        outs.append(rec)
        cur = rec[-1]
    return torch.cat(outs)


def _adjoint_sos(sos):
    """The ``2K`` sections of a cascade's adjoint in reversed time: for
    each section from the last, its all-pole part ``(1, 0, 0, 1, a1,
    a2)`` then its FIR part ``(b0, b1, b2, 1, 0, 0)``."""
    one, zero = sos.new_ones(()), sos.new_zeros(())
    rows = []
    for j in reversed(range(sos.shape[0])):
        b0, b1, b2, _, a1, a2 = sos[j].unbind()
        rows += [torch.stack([one, zero, zero, one, a1, a2]),
                 torch.stack([b0, b1, b2, one, zero, zero])]
    return torch.stack(rows)


def _lagged_dot(a, b, lag):
    """``Σ_t a(t)·b(t − lag)`` over every column, in float64."""
    n = a.shape[1]
    if lag >= n:
        return a.new_zeros((), dtype=torch.float64)
    return (a[:, lag:].double() * b[:, :n - lag].double()).sum()


class _SosScanFn(torch.autograd.Function):
    """K8 under autograd for one cascade: ``(x (R, N), sos (K, 6), zi (K,
    2, R), n_valid list) -> (y (R, N), zf)``.  Forward: one launch (the
    plain version on the CPU).  Backward: K8 again, per section from the
    last (see the module docstring); ``zf`` carries no gradient."""

    @staticmethod
    def forward(ctx, x, sos, zi, nv):
        with torch.no_grad():
            y, (zf,) = _scan_nograd(x, [sos], [zi], nv)
        ctx.save_for_backward(x, sos, zi)
        ctx.mark_non_differentiable(zf)
        return y[0], zf

    @staticmethod
    def backward(ctx, gy, _gzf=None):
        x, sos, zi = ctx.saved_tensors
        need_x, need_sos, need_zi = ctx.needs_input_grad[:3]
        k, n = sos.shape[0], x.shape[1]
        if gy is None:
            gy = torch.zeros_like(x)
        with torch.no_grad():
            # the adjoint cascade over the reversed gradient: its section
            # 2(K−1−j) is section j's λ, its last the input's gradient
            adj = _sections(gy.to(x.dtype).flip(1), _adjoint_sos(sos),
                            x.new_zeros((2 * k, 2, x.shape[0])))
            lams = [adj[2 * (k - 1 - j)].flip(1) for j in range(k)]
            d_sos = d_zi = None
            if need_sos:
                outs = _sections(x, sos, zi)
                d_sos = torch.zeros((k, 6), dtype=torch.float64,
                                    device=x.device)
                for j, lam in enumerate(lams):
                    u = x if j == 0 else outs[j - 1]
                    for i in range(3):
                        d_sos[j, i] = _lagged_dot(lam, u, i)
                    for i in (1, 2):
                        d_sos[j, 3 + i] = -_lagged_dot(lam, outs[j], i)
                d_sos = d_sos.to(sos.dtype)
            if need_zi:
                d_zi = torch.zeros_like(zi)
                for j, lam in enumerate(lams):
                    d_zi[j, 0] = lam[:, 0]
                    if n > 1:
                        d_zi[j, 1] = lam[:, 1]
        return (adj[-1].flip(1) if need_x else None, d_sos, d_zi, None)
