"""Exact compressor ballistics over a band-major ``(B, T)`` timeline.

Counterpart of the driver half of ``python_audio_mastering_tpu.ops.
pallas_kernels`` (``_run``, ``_run_collapse``,
``ballistics_pallas_rates_bt``).  The per-step map (pydub's contract with
the rate factors folded in, see ``csrc/ballistics.cuh``) is

    att ← att ≤ m ? min(att + m·ca, m) : max(att − m·cr, 0)

and the timeline is cut into blocks of 128 steps.  Four kernels
(``csrc/ballistics.cu``), each with a plain PyTorch version that runs the
same float operations in the same order, so that kernel and plain agree
bit for bit:

* :func:`pass1_bnd` (K5) — each block's outgoing state as the serial walk
  gives it, as a segmented exact walk of two launches:
  :func:`pass1_hull` (every block's interval of outgoing states; a block
  whose interval is one float has collapsed) and :func:`pass1_runs` (the
  runs of non-collapsed blocks walked serially, all runs in parallel).
  :func:`pass1_bnd_ref`, the serial walk itself, is its oracle;
* :func:`replay` (K6) — every block replayed from its incoming state,
  per-step output;
* :func:`replay_bnd` (K7) — rounds of the block-boundary fixed point, as
  many as asked for (until the loop stops) in one cooperative launch.

Two exact modes (:func:`ballistics_rates_bt`): ``"serial"`` walks the
timeline (K5) and replays (K6); ``"collapse"`` iterates the boundary
states block-parallel (K7) to a bitwise fixed point and replays from it,
falling back to the serial walk when the fixed point does not certify
within ``iters`` rounds.  The loop runs without host synchronisation: the
rounds' count and stopping rule live in a device-side ``ctrl`` record
that the kernels read and update (see :func:`new_ctrl`).

Each wrapper takes its plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor or raises; each counts its launches in
``<wrapper>.launches`` (read with ``cuda_multiband.launch_counts``).
"""

from __future__ import annotations

import torch

from python_audio_mastering_tpu_torch.ops import _kernels
from python_audio_mastering_tpu_torch.ops._kernels import ptr as _ptr
from python_audio_mastering_tpu_torch.ops._kernels import raise_on as _raise_on
from python_audio_mastering_tpu_torch.ops._kernels import upload

__all__ = ["ballistics_rates_bt", "pass1_bnd", "pass1_bnd_ref",
           "pass1_hull", "pass1_hull_ref", "pass1_runs", "pass1_runs_ref",
           "hull_runs", "replay", "replay_ref", "replay_bnd",
           "replay_bnd_ref", "new_ctrl", "BLOCK", "FIXPOINT_ITERS"]

BLOCK = 128           # control steps per block (part of the algorithm)
FIXPOINT_ITERS = 12   # certification cap before the serial fallback
_STALL_GRACE = 4      # rounds before the stall rule may stop the loop

# the ctrl record, int32 (see csrc/ballistics.cu; the two counters are
# the kernel's scratch, 0 between launches)
ACTIVE, CNT, CNT_PREV, ROUND, CHANGED_EVEN, CHANGED_ODD = range(6)
_CTRL0 = (1, 1, 1 << 30, 0, 0, 0)


def new_ctrl(device):
    """A fresh fixed-point ``ctrl`` record: active, last count 1, no
    rounds run."""
    return upload(_CTRL0, torch.int32, device)


def _step(att, m, ca, cr):
    """One ballistics step, the kernels' exact op order."""
    attack = torch.minimum(att + m * ca, m)
    release = torch.clamp_min(att - m * cr, 0.0)
    return torch.where(att <= m, attack, release)


def _blocks(m):
    b, t = m.shape
    return m.reshape(b, t // BLOCK, BLOCK)


def _incomes(s_out, att0, idx_ex):
    """Incoming state of each block: the outgoing state of the last
    non-frozen block before it (``idx_ex`` is its 1-based index, 0 for
    none), else ``att0``."""
    gathered = torch.gather(s_out, 1, (idx_ex - 1).clamp_min(0))
    return torch.where(idx_ex == 0, att0[:, None], gathered)


def _hull_step(lo, hi, m, ca, cr):
    """One step of the block hull pass (``ballistics_hull_step`` in
    ``csrc/ballistics.cuh``, where the argument is): the interval is split
    at ``m`` and each part's ends go through :func:`_step`."""
    inf = torch.full_like(m, float("inf"))
    att_part = lo <= m
    rel_part = hi > m
    a_lo = _step(lo, m, ca, cr)
    a_hi = _step(torch.minimum(hi, m), m, ca, cr)
    r_lo = _step(torch.maximum(lo, torch.nextafter(m, inf)), m, ca, cr)
    r_hi = _step(hi, m, ca, cr)
    new_lo = torch.minimum(torch.where(att_part, a_lo, inf),
                           torch.where(rel_part, r_lo, inf))
    new_hi = torch.maximum(torch.where(att_part, a_hi, -inf),
                           torch.where(rel_part, r_hi, -inf))
    return new_lo, new_hi


def _skipped(ctrl):
    return ctrl is not None and int(ctrl[CNT]) == 0


def pass1_hull_ref(m, ca, cr, hmax, ctrl=None):
    """Plain version of :func:`pass1_hull`, every block at once."""
    b, t = m.shape
    lo = torch.zeros((b, t // BLOCK), dtype=m.dtype, device=m.device)
    if _skipped(ctrl):
        return lo, lo.clone()
    hi = hmax[:, None].expand_as(lo).clone()
    mb = _blocks(m)
    ca, cr = ca[:, None], cr[:, None]
    for j in range(BLOCK):
        lo, hi = _hull_step(lo, hi, mb[:, :, j], ca, cr)
    return lo, hi


def pass1_runs_ref(m, ca, cr, att0, lo, hi, ctrl=None):
    """Plain version of :func:`pass1_runs`: collapsed blocks take their
    constant, and the runs of non-collapsed blocks are walked together,
    one block of every unfinished run per round."""
    nblk = lo.shape[1]
    if _skipped(ctrl):
        return torch.zeros_like(lo)
    collapsed = lo == hi
    bnd = torch.where(collapsed, lo, 0.0)
    before = torch.cat([torch.ones_like(collapsed[:, :1]),
                        collapsed[:, :-1]], dim=1)
    band, k = torch.nonzero(~collapsed & before, as_tuple=True)
    if band.numel() == 0:
        return bnd
    att = torch.where(k == 0, att0[band], lo[band, (k - 1).clamp_min(0)])
    mb = _blocks(m)
    ca, cr = ca[band], cr[band]
    while band.numel():
        steps = mb[band, k]
        for j in range(BLOCK):
            att = _step(att, steps[:, j], ca, cr)
        bnd[band, k] = att
        k = k + 1
        inside = k < nblk
        go = inside.clone()   # the run goes on into a non-collapsed block
        go[inside] = ~collapsed[band[inside], k[inside]]
        band, k, att, ca, cr = band[go], k[go], att[go], ca[go], cr[go]
    return bnd


def hull_runs(lo, hi):
    """Per band: ``(collapsed blocks, runs of non-collapsed blocks,
    longest run in blocks)`` of a hull pass (host ints)."""
    out = []
    for c in (lo == hi).cpu().tolist():
        runs, longest, cur = 0, 0, 0
        for done in c:
            cur = 0 if done else cur + 1
            runs += cur == 1
            longest = max(longest, cur)
        out.append((sum(c), runs, longest))
    return out


def pass1_bnd_ref(m, ca, cr, att0, ctrl=None):
    """The serial walk, a Python loop over T steps: the oracle of
    :func:`pass1_bnd` (same output, bit for bit)."""
    bnd = torch.zeros((m.shape[0], m.shape[1] // BLOCK), dtype=m.dtype,
                      device=m.device)
    if _skipped(ctrl):
        return bnd
    att = att0
    for i, m_i in enumerate(m.T.contiguous().unbind(0)):
        att = _step(att, m_i, ca, cr)
        if (i + 1) % BLOCK == 0:
            bnd[:, i // BLOCK] = att
    return bnd


def replay_ref(m, ca, cr, incomes):
    """Plain version of :func:`replay`, every block at once."""
    mb = _blocks(m)
    out = torch.empty_like(mb)
    ca, cr = ca[:, None], cr[:, None]
    att = incomes
    for j in range(BLOCK):
        att = _step(att, mb[:, :, j], ca, cr)
        out[:, :, j] = att
    return out.reshape(m.shape)


def _stop_rule(ctrl, iters):
    k = int(ctrl[ROUND])
    cnt, prev = int(ctrl[CNT]), int(ctrl[CNT_PREV])
    return int(cnt != 0 and k < iters
               and (k <= _STALL_GRACE or 4 * cnt < 3 * prev))


def replay_bnd_ref(m, ca, cr, att0, idx_ex, s_out, ctrl,
                   iters=FIXPOINT_ITERS, rounds=1):
    """Plain version of :func:`replay_bnd` (updates ``ctrl`` in place):
    ``rounds`` one-round calls in a row.  Refuses a ``ctrl`` whose two
    counters are not 0: the kernel relies on them being 0 on entry."""
    if int(ctrl[CHANGED_EVEN]) or int(ctrl[CHANGED_ODD]):
        raise ValueError(f"replay_bnd: ctrl's counters must be 0 on entry, "
                         f"got {ctrl.tolist()} (see new_ctrl)")
    s = s_out
    for _ in range(rounds):
        s = _replay_bnd_round(m, ca, cr, att0, idx_ex, s, ctrl, iters)
    return s


def _replay_bnd_round(m, ca, cr, att0, idx_ex, s_out, ctrl, iters):
    """One fixed-point round; a round on a stopped loop returns a copy of
    ``s_out`` and leaves ``ctrl`` as it is."""
    if int(ctrl[ACTIVE]) == 0:
        return s_out.clone()
    att = _incomes(s_out, att0, idx_ex)
    mb = _blocks(m)
    ca, cr = ca[:, None], cr[:, None]
    for j in range(BLOCK):
        att = _step(att, mb[:, :, j], ca, cr)
    cnt = int((att != s_out).sum())
    ctrl[CNT_PREV] = ctrl[CNT].clone()
    ctrl[CNT] = cnt
    ctrl[ROUND] += 1
    ctrl[ACTIVE] = _stop_rule(ctrl, iters)
    return att


def _check(name, m, vecs, mats=()):
    """Validate the ballistics kernels' operands; returns ``(B, T)``."""
    if m.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {m.device}")
    if m.ndim != 2 or m.shape[1] % BLOCK != 0 or m.shape[1] == 0:
        raise ValueError(f"{name}: m must be (B, T) with T a positive "
                         f"multiple of {BLOCK}, got {tuple(m.shape)}")
    b, t = m.shape
    want = [("m", m, (b, t), torch.float32)]
    want += [(what, v, (b,), torch.float32) for what, v in vecs]
    want += [(what, v, (b, t // BLOCK), dt) for what, v, dt in mats]
    for what, ten, shape, dt in want:
        if tuple(ten.shape) != shape or ten.dtype != dt:
            raise ValueError(f"{name}: {what} must be {shape} {dt}, got "
                             f"{tuple(ten.shape)} {ten.dtype}")
        if ten.device != m.device or not ten.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous on "
                             f"{m.device}")
    return b, t


def _check_ctrl(name, ctrl, device):
    if (tuple(ctrl.shape) != (len(_CTRL0),) or ctrl.dtype != torch.int32
            or ctrl.device != device):
        raise ValueError(f"{name}: ctrl must be an int32 ({len(_CTRL0)},) "
                         f"tensor on {device} (see new_ctrl)")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def pass1_hull(m, ca, cr, hmax, ctrl=None):
    """K5's first launch: each block's interval ``(lo, hi)`` ``(B, T/128)``
    of outgoing states over every incoming state in ``[0, hmax]``
    (``csrc/ballistics.cu`` has the argument).  ``lo == hi``: the block has
    collapsed to that state.  Gated on ``ctrl`` as :func:`pass1_bnd`."""
    if m.device.type == "cpu":
        return pass1_hull_ref(m, ca, cr, hmax, ctrl)
    b, t = _check("pass1_hull", m,
                  (("ca", ca), ("cr", cr), ("hmax", hmax)))
    if ctrl is not None:
        _check_ctrl("pass1_hull", ctrl, m.device)
    lo = torch.empty((b, t // BLOCK), dtype=m.dtype, device=m.device)
    hi = torch.empty_like(lo)
    lib = _kernels.library().lib
    with torch.cuda.device(m.device):
        err = lib.pam_pass1_hull(_ptr(m), _ptr(ca), _ptr(cr), _ptr(hmax),
                                 _ptr(lo), _ptr(hi), None if ctrl is None
                                 else _ptr(ctrl), b, t, _stream(m.device))
    _raise_on("pass1_hull", err)
    pass1_hull.launches += 1
    return lo, hi


def pass1_runs(m, ca, cr, att0, lo, hi, ctrl=None):
    """K5's second launch: the outgoing state of every block ``(B,
    T/128)``, collapsed blocks from their constant, every run of
    non-collapsed blocks walked serially from the exact state before it,
    all runs in parallel.  Gated on ``ctrl`` as :func:`pass1_bnd`."""
    if m.device.type == "cpu":
        return pass1_runs_ref(m, ca, cr, att0, lo, hi, ctrl)
    b, t = _check("pass1_runs", m, (("ca", ca), ("cr", cr), ("att0", att0)),
                  (("lo", lo, torch.float32), ("hi", hi, torch.float32)))
    if ctrl is not None:
        _check_ctrl("pass1_runs", ctrl, m.device)
    bnd = torch.zeros((b, t // BLOCK), dtype=m.dtype, device=m.device)
    lib = _kernels.library().lib
    with torch.cuda.device(m.device):
        err = lib.pam_pass1_runs(_ptr(m), _ptr(ca), _ptr(cr), _ptr(att0),
                                 _ptr(lo), _ptr(hi), _ptr(bnd),
                                 None if ctrl is None else _ptr(ctrl), b, t,
                                 _stream(m.device))
    _raise_on("pass1_runs", err)
    pass1_runs.launches += 1
    return bnd


def pass1_bnd(m, ca, cr, att0, ctrl=None):
    """Outgoing attenuation of every 128-step block ``(B, T/128)``, bit for
    bit the serial walk of the timeline (K5): :func:`pass1_hull`, then
    :func:`pass1_runs`, no host synchronisation.

    Args:
      m: ``(B, T)`` per-step targets (dB ≥ 0, no -0.0), float32, T a
        multiple of 128.
      ca / cr: ``(B,)`` attack / release rate factors; att0: ``(B,)``
        incoming attenuation (≥ 0, no -0.0).
      ctrl: a fixed-point record (:func:`new_ctrl`); when given, the walk
        runs only if the fixed point's last round changed a boundary, and
        the output is zeros otherwise.
    """
    hmax = torch.maximum(att0, m.amax(dim=1)).contiguous()
    lo, hi = pass1_hull(m, ca, cr, hmax, ctrl)
    return pass1_runs(m, ca, cr, att0, lo, hi, ctrl)


def replay(m, ca, cr, incomes):
    """Per-step attenuation ``(B, T)``, every block replayed from its
    incoming state ``incomes (B, T/128)`` (K6)."""
    if m.device.type == "cpu":
        return replay_ref(m, ca, cr, incomes)
    b, t = _check("replay", m, (("ca", ca), ("cr", cr)),
                  (("incomes", incomes, torch.float32),))
    out = torch.empty_like(m)
    lib = _kernels.library().lib
    with torch.cuda.device(m.device):
        err = lib.pam_replay(_ptr(m), _ptr(ca), _ptr(cr), _ptr(incomes),
                             _ptr(out), b, t, _stream(m.device))
    _raise_on("replay", err)
    replay.launches += 1
    return out


def replay_bnd(m, ca, cr, att0, idx_ex, s_out, ctrl, iters=FIXPOINT_ITERS,
               rounds=1):
    """Up to ``rounds`` fixed-point rounds (K7), one launch.  A round
    replays every block from the incoming state that the outgoing states
    of the round before give it (:func:`_incomes` with the frozen-block
    index ``idx_ex``, int64), starting from ``s_out (B, T/128)``; returns
    the outgoing states of the last round run.  ``ctrl`` is updated in
    place, as by ``rounds`` one-round calls: the changed-boundary counts,
    the rounds run, and whether the loop goes on (``iters`` caps the
    rounds).  Rounds on a stopped loop return their input unchanged.
    ``ctrl``'s two counters must be 0 on entry, as :func:`new_ctrl` and
    every launch leave them (not checked here: that would read ``ctrl``
    back to the host)."""
    if m.device.type == "cpu":
        return replay_bnd_ref(m, ca, cr, att0, idx_ex, s_out, ctrl, iters,
                              rounds)
    b, t = _check("replay_bnd", m, (("ca", ca), ("cr", cr), ("att0", att0)),
                  (("idx_ex", idx_ex, torch.int64),
                   ("s_out", s_out, torch.float32)))
    _check_ctrl("replay_bnd", ctrl, m.device)
    if rounds < 1:
        raise ValueError(f"replay_bnd: rounds must be >= 1, got {rounds}")
    if m.data_ptr() % 16:
        raise ValueError("replay_bnd: m must start on a 16-byte boundary "
                         "(the kernel loads 16-byte chunks)")
    s_new = torch.empty_like(s_out)
    s_alt = torch.empty_like(s_out) if rounds > 1 else None
    lib = _kernels.library().lib
    with torch.cuda.device(m.device):
        err = lib.pam_replay_bnd(_ptr(m), _ptr(ca), _ptr(cr), _ptr(att0),
                                 _ptr(idx_ex), _ptr(s_out), _ptr(s_new),
                                 None if s_alt is None else _ptr(s_alt),
                                 _ptr(ctrl), b, t, int(iters), int(rounds),
                                 _stream(m.device))
    _raise_on("replay_bnd", err)
    replay_bnd.launches += 1
    return s_new


pass1_hull.launches = 0
pass1_runs.launches = 0
replay.launches = 0
replay_bnd.launches = 0


def _run(m, ca, cr, att0):
    """Serial mode: the boundary walk, then the replay."""
    bnd = pass1_bnd(m, ca, cr, att0)
    return replay(m, ca, cr, torch.cat([att0[:, None], bnd[:, :-1]], dim=1))


def _frozen_index(m):
    """``idx_ex (B, nblk)`` int64: 1-based index of the last non-frozen
    block before each block (0 for none).  Frozen blocks (``m ≡ 0``) are
    identities, so a block's income reads through them in one gather."""
    b, t = m.shape
    nblk = t // BLOCK
    frozen = _blocks(m).amax(dim=2) == 0.0
    seq = torch.where(frozen, 0, torch.arange(1, nblk + 1, device=m.device))
    last = torch.cummax(seq, dim=1).values
    return torch.cat([torch.zeros((b, 1), dtype=last.dtype, device=m.device),
                      last[:, :-1]], dim=1).contiguous()


def _run_collapse(m, ca, cr, att0, iters=FIXPOINT_ITERS):
    """Collapse mode: the block-boundary fixed point.

    Why it converges in a few rounds, and why any bitwise fixed point is
    the exact answer, is set out in the JAX package's ``_run_collapse``:
    ``s_{k+1} = g_k(s_k)`` is a triangular system, a 128-step block's map
    collapses to a constant once a clamp saturates, and frozen blocks are
    read through.  Every round runs in one launch of K7, which stops
    where the loop's rule stops it (at most ``iters`` rounds).  The serial
    walk then runs only if the last round still changed a boundary.

    Returns ``(att (B, T), ctrl)``; ``ctrl[ROUND]`` is the rounds run and
    ``ctrl[CNT] == 0`` means the fixed point certified.
    """
    idx_ex = _frozen_index(m)
    ctrl = new_ctrl(m.device)
    s = torch.zeros((m.shape[0], m.shape[1] // BLOCK), dtype=m.dtype,
                    device=m.device)
    s = replay_bnd(m, ca, cr, att0, idx_ex, s, ctrl, iters, rounds=iters)
    bnd = pass1_bnd(m, ca, cr, att0, ctrl)
    serial = torch.cat([att0[:, None], bnd[:, :-1]], dim=1)
    incomes = torch.where(ctrl[CNT] == 0, _incomes(s, att0, idx_ex), serial)
    return replay(m, ca, cr, incomes.contiguous()), ctrl


def ballistics_rates_bt(max_att_bt, attack_rate, release_rate, att0=None,
                        mode: str = "collapse", iters: int = FIXPOINT_ITERS):
    """Exact ballistics of a band-major ``(B, T)`` target timeline.

    Args:
      max_att_bt: ``(B, T)`` per-step attenuation targets (dB ≥ 0).
      attack_rate / release_rate: ``(B,)`` per-step rate factors
        (``hop / attack_frames``, ``hop / release_frames``).
      att0: ``(B,)`` incoming attenuation (zeros when None).
      mode: ``"collapse"`` (block-parallel fixed point with the serial
        fallback) or ``"serial"``; both give the same bits.
      iters: the fixed point's round cap (collapse only).

    T is padded to whole 128-step blocks with zero targets, which freeze
    the state.  The targets and ``att0`` get +0.0 added, which turns a
    -0.0 into +0.0 and leaves every other value as it is: K5 compares
    states by value (see :func:`pass1_bnd`).  Returns ``(att (B, T),
    att_final (B,))``.
    """
    m = max_att_bt
    b, t = m.shape
    dt, dev = m.dtype, m.device
    t_pad = max(1, -(-t // BLOCK)) * BLOCK
    m_p = torch.nn.functional.pad(m + 0.0, (0, t_pad - t)).contiguous()
    ca, cr = (r.to(dt).contiguous() if torch.is_tensor(r)
              else upload(r, dt, dev) for r in (attack_rate, release_rate))
    if att0 is None:
        a0 = torch.zeros((b,), dtype=dt, device=dev)
    elif torch.is_tensor(att0):
        a0 = att0.to(device=dev, dtype=dt).contiguous()
    else:
        a0 = upload(att0, dt, dev)
    a0 = a0 + 0.0
    if mode == "collapse":
        out, _ = _run_collapse(m_p, ca, cr, a0, iters)
    elif mode == "serial":
        out = _run(m_p, ca, cr, a0)
    else:
        raise ValueError(f"mode must be 'collapse' or 'serial', got {mode!r}")
    return out[:, :t], out[:, -1]
