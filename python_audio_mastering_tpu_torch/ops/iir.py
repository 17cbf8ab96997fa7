"""Blocked IIR (SOS cascade) execution over the rows form ``(C, nb, L)``.

Counterpart of the rows-form half of ``python_audio_mastering_tpu.ops.iir``.
A biquad cascade is the linear recurrence ``s[n] = A s[n-1] + B x[n]``,
``y[n] = C s[n-1] + D x[n]``.  Cut the signal into blocks of ``L`` samples:

* a block's zero-state output is a causal FIR with the cascade's impulse
  response, ``x_blk @ T`` (``T`` an ``(L, L)`` upper-triangular Toeplitz);
* a block's end-state summary is ``x_blk @ G``;
* the incoming states ``s_in`` follow ``s_in[b+1] = A^L s_in[b] + t[b]``,
  solved without a sequential scan by the recursive superblock prefix
  :func:`_affine_prefix_static`;
* the output is ``y = x_blk @ T + s_in @ Wᵀ``.

The operators are built in float64 numpy on the host from concrete
coefficients: the K-weighting high-pass has poles near the unit circle,
where a float32 build loses ~1e-2 relative energy.  The states pass
(``rows @ G`` and the prefix) is plain torch and runs in float64: it is
small (``S`` = 4 or 8 columns), and in float32 its roundoff, carried by the
K-weighting's slow poles, reached 2.5e-5 of the states' scale on a test
signal, above the 2e-5 the JAX package holds its states pass to.  The
states are cast to the working dtype for the output recompute ``x @ T + s_in @
Wᵀ``, which is the CUDA kernels' job (``ops.cuda_multiband``), with
:func:`sosfilt_blocked_rows` here as its plain version.
:func:`sosfilt_states_multi_rows` serves several cascades of one signal
(the multiband crossovers) from one shared read.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = [
    "BlockedOps",
    "blocked_ops",
    "cascade_state_space",
    "zi_to_state",
    "state_to_zi",
    "sosfilt_states_rows",
    "sosfilt_states_multi_rows",
    "sosfilt_blocked_rows",
]


@functools.lru_cache(maxsize=64)
def _state_space_static(sos_bytes, k):
    """Float64 numpy ``(A, B, C, D)`` of a cascade in DF2T coordinates.

    States of consecutive sections are stacked, so the full state is
    exactly scipy's ``zi`` ``(K, 2)`` flattened (see :func:`zi_to_state`).
    """
    sos = np.frombuffer(sos_bytes, dtype=np.float64).reshape(k, 6)
    a = np.zeros((2 * k, 2 * k))
    b = np.zeros(2 * k)
    c = np.zeros(2 * k)
    d = 1.0
    for j in range(k):
        b0, b1, b2, _, a1, a2 = sos[j]
        a_j = np.array([[-a1, 1.0], [-a2, 0.0]])
        b_j = np.array([b1 - a1 * b0, b2 - a2 * b0])
        s = 2 * j
        a[s:s + 2, s:s + 2] = a_j
        if j == 0:
            b[:2] = b_j
            c[:2] = [1.0, 0.0]
            d = b0
        else:
            a[s:s + 2, :s] = np.outer(b_j, c[:s])
            b[s:s + 2] = b_j * d
            c = np.concatenate([c[:s] * b0, [1.0, 0.0],
                                np.zeros(2 * k - s - 2)])
            d = d * b0
    return a, b, c, d


def cascade_state_space(sos):
    """``(A, B, C, D)`` of a ``(K, 6)`` cascade, float64 numpy."""
    sos = np.ascontiguousarray(sos, np.float64)
    return _state_space_static(sos.tobytes(), sos.shape[0])


@functools.lru_cache(maxsize=64)
def _blocked_operators_static(sos_bytes, k, block_size):
    """Float64 ``(T (L, L), G (L, S), W (L, S), AL (S, S))`` for blocks of
    ``L = block_size``: ``y0 = x_blk @ T``, ``t = x_blk @ G``,
    ``yc = s_in @ Wᵀ``, ``s_end = AL @ s_in + t``."""
    a, b, c, d = _state_space_static(sos_bytes, k)
    s_dim = a.shape[0]
    L = block_size
    powers = np.empty((L, s_dim, s_dim))
    powers[0] = np.eye(s_dim)
    for t in range(1, L):
        powers[t] = a @ powers[t - 1]
    al = a @ powers[L - 1]
    v = powers @ b
    h = np.concatenate([[d], v[: L - 1] @ c])
    ii = np.arange(L)
    idx = ii[None, :] - ii[:, None]
    t_mat = np.where(idx >= 0, h[np.clip(idx, 0, L - 1)], 0.0)
    g = v[::-1].copy()
    w = np.einsum("i,tij->tj", c, powers)
    return t_mat, g, w, al


@functools.lru_cache(maxsize=32)
def _boundary_operators_from_a(a_bytes, s_dim, group):
    """Superblock operators for ``s[i+1] = A s[i] + t[i]`` in groups of
    ``M = group`` steps: ``powers_m (M, S, S)`` (``A^m``), the
    block-lower-triangular ``tbig_t (M·S, M·S)`` with
    ``cum_flat = t_flat @ tbig_t``, and ``A^M`` for the next level."""
    a = np.frombuffer(a_bytes, dtype=np.float64).reshape(s_dim, s_dim)
    m_grp = group
    powers = np.empty((m_grp + 1, s_dim, s_dim))
    powers[0] = np.eye(s_dim)
    for t in range(1, m_grp + 1):
        powers[t] = a @ powers[t - 1]
    tbig_t = np.zeros((m_grp * s_dim, m_grp * s_dim))
    for j in range(m_grp):
        for m in range(j, m_grp):
            tbig_t[j * s_dim:(j + 1) * s_dim, m * s_dim:(m + 1) * s_dim] = \
                powers[m - j].T
    return powers[:m_grp], tbig_t, powers[m_grp]


def _prefix_ops(a_np, s_dim, group, device, dtype, cache):
    """Device copies of :func:`_boundary_operators_from_a`; full-size
    groups are kept in ``cache`` (a dict owned by the caller's
    :class:`BlockedOps`), the small last level is rebuilt each call."""
    key = (a_np.tobytes(), s_dim, group, device, dtype)
    ops = None if cache is None else cache.get(key)
    if ops is None:
        powers_m, tbig_t, a_m = _boundary_operators_from_a(
            a_np.tobytes(), s_dim, group)
        ops = (torch.as_tensor(powers_m, dtype=dtype, device=device),
               torch.as_tensor(tbig_t, dtype=dtype, device=device),
               np.ascontiguousarray(a_m))
        if cache is not None and group == _PREFIX_GROUP:
            cache[key] = ops
    return ops


_PREFIX_GROUP = 128
_STATES_DTYPE = torch.float64


def _affine_prefix_static(t_vec, s0, a_np, m_grp=_PREFIX_GROUP, cache=None):
    """Prefix states of ``s[i+1] = a s[i] + t[i]`` with ``s[0] = s0``.

    ``t_vec`` is ``(C, n, S)``, ``s0`` is ``(C, S)`` and ``a_np`` a float64
    ``(S, S)``; returns the incoming states ``(C, n, S)``.  Scan-free at
    every level: within superblocks of ``M`` steps the cumulative sums are
    one matmul with ``tbig_t``, and the superblock hand-offs follow the
    same recurrence with ``A^M``, so they recurse.
    """
    c, n, s_dim = t_vec.shape
    m = min(n, m_grp)
    powers_m, tbig_t, a_m = _prefix_ops(a_np, s_dim, m, t_vec.device,
                                        t_vec.dtype, cache)
    ng = -(-n // m)
    t_pad = torch.nn.functional.pad(t_vec, (0, 0, 0, ng * m - n))
    cum = (t_pad.reshape(c, ng, m * s_dim) @ tbig_t).reshape(c, ng, m, s_dim)
    if ng == 1:
        sg_in = s0[:, None]
    else:
        sg_in = _affine_prefix_static(cum[:, :, m - 1, :], s0, a_m,
                                      m_grp=m_grp, cache=cache)
    shifted = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]],
                        dim=2)
    s_in = torch.einsum("mij,cgj->cgmi", powers_m, sg_in) + shifted
    return s_in.reshape(c, ng * m, s_dim)[:, :n]


@dataclasses.dataclass(frozen=True, eq=False)
class BlockedOps:
    """One cascade's blocked operators on a device.

    ``t``/``w`` (the output recompute) are in the working dtype; ``g``/``al``
    (the states pass) are float64.  ``al64`` is ``A^L`` as a numpy array,
    from which the boundary prefix builds its operators, and ``prefix``
    keeps the prefix's device operators between calls.
    """

    t: torch.Tensor
    g: torch.Tensor
    w: torch.Tensor
    al: torch.Tensor
    al64: np.ndarray
    k: int
    prefix: dict = dataclasses.field(default_factory=dict)


def blocked_ops(sos, block_size, device="cpu", dtype=torch.float32):
    """Blocked operators of a concrete ``(K, 6)`` cascade, float64-built
    on the host (cached there) and put on ``device``: ``T``/``W`` cast to
    ``dtype``, ``G``/``A^L`` kept in float64."""
    sos = np.ascontiguousarray(sos, np.float64)
    t, g, w, al = _blocked_operators_static(sos.tobytes(), sos.shape[0],
                                            int(block_size))

    def on(m, dt):
        return torch.as_tensor(m, dtype=dt, device=device)

    return BlockedOps(t=on(t, dtype), g=on(g, _STATES_DTYPE),
                      w=on(w, dtype), al=on(al, _STATES_DTYPE),
                      al64=np.ascontiguousarray(al), k=sos.shape[0])


def zi_to_state(zi):
    """scipy-layout ``(K, 2[, C])`` state → cascade state ``(2K[, C])``."""
    return zi.reshape((zi.shape[0] * 2,) + tuple(zi.shape[2:]))


def state_to_zi(s, k):
    """Cascade state ``(2K[, C])`` → scipy-layout ``(K, 2[, C])``."""
    return s.reshape((k, 2) + tuple(s.shape[1:]))


def _initial_state(zi, k, c, like):
    """``(C, S)`` starting states from an optional scipy-layout ``zi``
    ``(K, 2, C)`` (or ``(K, 2)`` for one channel)."""
    if zi is None:
        return torch.zeros((c, 2 * k), dtype=like.dtype, device=like.device)
    zi = torch.as_tensor(zi, dtype=like.dtype, device=like.device)
    if zi.ndim == 2:
        zi = zi[:, :, None]
    return zi_to_state(zi).T.contiguous()


def _states_from_summaries(t_vec, zi, ops, dtype, return_state):
    """Incoming states ``(C, nb, S)`` in ``dtype`` and the scipy-layout
    final state from one cascade's float64 block summaries ``t_vec``."""
    s0 = _initial_state(zi, ops.k, t_vec.shape[0], t_vec)
    s_in64 = _affine_prefix_static(t_vec, s0, ops.al64, cache=ops.prefix)
    s_in = s_in64.to(dtype).contiguous()
    if not return_state:
        return s_in, zi
    s_last = s_in64[:, -1] @ ops.al.T + t_vec[:, -1]           # (C, S)
    return s_in, state_to_zi(s_last.T, ops.k).to(dtype)


def sosfilt_states_rows(sos, xrows, zi=None, return_state=True, ops=None):
    """Per-block incoming states of one cascade over rows ``(C, nb, L)``.

    One ``rows @ G`` read of the signal plus the scan-free boundary
    prefix.  ``ops`` (from :func:`blocked_ops`) skips the operator lookup
    when the caller holds them already.

    Returns ``(s_in (C, nb, S), zf, ops)`` with ``zf`` the final state in
    scipy layout ``(K, 2, C)`` (``zi`` unchanged when ``return_state`` is
    False).
    """
    c, nb, L = xrows.shape
    if ops is None:
        ops = blocked_ops(sos, L, xrows.device, xrows.dtype)
    rows = xrows.reshape(c * nb, L).to(_STATES_DTYPE)
    t_vec = (rows @ ops.g).reshape(c, nb, -1)
    s_in, zf = _states_from_summaries(t_vec, zi, ops, xrows.dtype,
                                      return_state)
    return s_in, zf, ops


def sosfilt_states_multi_rows(sos_list, xrows, zi_list=None,
                              return_state=True, ops_list=None):
    """Per-block incoming states of F cascades over rows ``(C, nb, L)``,
    from ONE shared float64 ``rows @ [G_1 | … | G_F]`` read of the signal
    (the multiband crossovers: the band kernels recompute each block's
    band samples from these states).  ``ops_list``: the cascades'
    :func:`blocked_ops`, looked up when not given.

    Returns ``(s_ins, zfs)``: per-filter ``(C, nb, S_f)`` incoming states
    and scipy-layout ``(K, 2, C)`` final states (the ``zi`` given, when
    ``return_state`` is False).
    """
    c, nb, L = xrows.shape
    if ops_list is None:
        ops_list = [blocked_ops(s, L, xrows.device, xrows.dtype)
                    for s in sos_list]
    if zi_list is None:
        zi_list = [None] * len(ops_list)
    rows = xrows.reshape(c * nb, L).to(_STATES_DTYPE)
    tv_cat = rows @ torch.cat([o.g for o in ops_list], dim=1)
    s_ins, zfs = [], []
    col = 0
    for ops, zi in zip(ops_list, zi_list):
        s_dim = ops.g.shape[1]
        t_vec = tv_cat[:, col:col + s_dim].reshape(c, nb, s_dim)
        col += s_dim
        s_in, zf = _states_from_summaries(t_vec, zi, ops, xrows.dtype,
                                          return_state)
        s_ins.append(s_in)
        zfs.append(zf)
    return tuple(s_ins), tuple(zfs)


def sosfilt_blocked_rows(sos, xrows, zi=None, return_state=True, ops=None):
    """Plain blocked filter over rows ``(C, nb, L)``: the states pass, then
    ``y = rows @ T + s_in @ Wᵀ``.  Returns ``(yrows, zf)``."""
    c, nb, L = xrows.shape
    s_in, zf, ops = sosfilt_states_rows(sos, xrows, zi=zi,
                                        return_state=return_state, ops=ops)
    y = xrows.reshape(c * nb, L) @ ops.t + \
        s_in.reshape(c * nb, -1) @ ops.w.T
    return y.reshape(c, nb, L), zf
