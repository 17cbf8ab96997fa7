"""IIR (SOS cascade) execution: blocked over the rows form ``(C, nb, L)``,
and the row-major filters of ``(N,)`` / ``(N, C)`` audio with their
dispatcher.

Counterpart of ``python_audio_mastering_tpu.ops.iir`` (but its ``(C, N)``
channel-major functions, on the ROADMAP's "Do not port" list).  The exact
filter, :func:`sosfilt_scan`, is the direct-form II transposed recurrence
on the scan kernel K8 (``ops.sos_scan``); :func:`sosfilt_blocked` and
:func:`sosfilt_blocked_multi` run the blocked decomposition below over
rows of ``(N, C)`` audio; :func:`sosfilt` picks one by JAX ``sosfilt``'s
rule (:func:`uses_scan`).
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

:func:`sosfilt_sharded` lifts the same decomposition one level, to a
signal sharded over the ranks of a mesh (``parallel.mesh``): each rank
filters its shard from a zero state, the shards' end states (a few
hundred bytes) are all-gathered, and every rank folds them through the
shard transition ``A^n`` (float64, host-built, :func:`_a_pow`) into its
true incoming state (:func:`_fold_shard_states`).

Coefficients that are a tensor in the autograd graph (the automaster's EQ)
take a traced route instead (:func:`blocked_ops_traced`, the counterpart
of the JAX package's ``_blocked_operators`` and ``_affine_prefix_traced``):
the operators are built on the signal's device in float64, as functions
of the coefficients.  Torch has no associative scan, so the powers
``A^0 … A^{L−1}`` come by doubling, ``P[2^k : 2^{k+1}] = P[:2^k] @
A^{2^k}`` (9 batched products at L = 384); the boundary prefix builds its
superblock operators from the traced ``A^L`` the same way at every level.
``T``/``W`` are cast to the working dtype for the kernels, ``G``/``A^L``
stay float64 for the states pass.  Nothing of this route is cached.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from python_audio_mastering_tpu_torch.ops.sos_scan import (
    sos_scan,
    sos_scan_ref,
)

__all__ = [
    "BlockedOps",
    "blocked_ops",
    "blocked_ops_traced",
    "cascade_state_space_traced",
    "cascade_state_space",
    "zi_to_state",
    "state_to_zi",
    "sosfilt_states_rows",
    "sosfilt_states_multi_rows",
    "sosfilt_blocked_rows",
    "sosfilt_sharded",
    "recompute_rows",
    "to_rows",
    "from_rows",
    "sosfilt_scan",
    "sosfilt_scan_ref",
    "sosfilt_blocked",
    "sosfilt_blocked_multi",
    "sosfilt_blocked_multi_rows",
    "sosfilt",
    "uses_scan",
    "DEFAULT_BLOCK",
    "METHODS",
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
    keeps the prefix's device operators between calls.  Traced operators
    (:func:`blocked_ops_traced`) have no ``al64``: they carry the powers
    ``A^0 … A^{L−1}`` instead, and the prefix is built in the graph.
    """

    t: torch.Tensor
    g: torch.Tensor
    w: torch.Tensor
    al: torch.Tensor
    al64: np.ndarray
    k: int
    prefix: dict = dataclasses.field(default_factory=dict)
    sos: np.ndarray | None = None
    powers: torch.Tensor | None = None

    @property
    def traced(self):
        return self.al64 is None


def blocked_ops(sos, block_size, device="cpu", dtype=torch.float32):
    """Blocked operators of a concrete ``(K, 6)`` cascade, float64-built
    on the host (cached there) and put on ``device``: ``T``/``W`` cast to
    ``dtype``, ``G``/``A^L`` kept in float64."""
    if isinstance(sos, torch.Tensor):
        sos = sos.detach().cpu().numpy()
    sos = np.ascontiguousarray(sos, np.float64)
    t, g, w, al = _blocked_operators_static(sos.tobytes(), sos.shape[0],
                                            int(block_size))

    def on(m, dt):
        return torch.as_tensor(m, dtype=dt, device=device)

    return BlockedOps(t=on(t, dtype), g=on(g, _STATES_DTYPE),
                      w=on(w, dtype), al=on(al, _STATES_DTYPE),
                      al64=np.ascontiguousarray(al), k=sos.shape[0], sos=sos)


def cascade_state_space_traced(sos):
    """``(A, B, C, D)`` of a ``(K, 6)`` cascade tensor, in its dtype and on
    its device, as functions of it (:func:`_state_space_static`'s
    algebra)."""
    k = sos.shape[0]
    s_dim = 2 * k
    a = sos.new_zeros((s_dim, s_dim))
    b = sos.new_zeros(s_dim)
    c = sos.new_zeros(s_dim)
    one, zero = sos.new_ones(()), sos.new_zeros(())
    d = None
    for j in range(k):
        b0, b1, b2, _, a1, a2 = sos[j].unbind()
        a_j = torch.stack([torch.stack([-a1, one]), torch.stack([-a2, zero])])
        b_j = torch.stack([b1 - a1 * b0, b2 - a2 * b0])
        s = 2 * j
        a[s:s + 2, s:s + 2] = a_j
        if j == 0:
            b[:2] = b_j
            c[0] = 1.0
            d = b0
        else:
            a[s:s + 2, :s] = torch.outer(b_j, c[:s])
            b[s:s + 2] = b_j * d
            c = torch.cat([c[:s] * b0, one[None],
                           sos.new_zeros(s_dim - s - 1)])
            d = d * b0
    return a, b, c, d


def _powers_traced(a, n):
    """``A^0 … A^{n−1}`` ``(n, S, S)`` of a tensor ``a`` by doubling:
    ``P[2^k : 2^{k+1}] = P[:2^k] @ A^{2^k}`` (powers of one matrix
    commute), ~log2(n) batched products."""
    p = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)[None]
    a_k = a
    while p.shape[0] < n:
        p = torch.cat([p, p @ a_k])
        if p.shape[0] < n:
            a_k = a_k @ a_k
    return p[:n]


def blocked_ops_traced(sos, block_size, dtype=torch.float32):
    """Blocked operators of a ``(K, 6)`` coefficient tensor, built in the
    graph on its device in float64 (counterpart of JAX
    ``_blocked_operators``): ``T``/``W`` cast to ``dtype``, ``G``/``A^L``
    float64, and the powers ``A^0 … A^{L−1}`` for final states.  Not
    cached."""
    sos = sos.to(_STATES_DTYPE)
    a, b, c, d = cascade_state_space_traced(sos)
    L = int(block_size)
    powers = _powers_traced(a, L)                       # A^0 … A^{L−1}
    al = a @ powers[L - 1]
    v = powers @ b                                      # v[t] = A^t B
    h = torch.cat([d[None], v[: L - 1] @ c])            # impulse response
    t_mat = _toeplitz_rows(torch.cat([h, torch.zeros_like(h)]), L)
    g = v.flip(0)                                       # G[j] = A^{L−1−j} B
    w = torch.einsum("i,tij->tj", c, powers)            # W[t] = C A^t
    return BlockedOps(t=t_mat.to(dtype), g=g, w=w.to(dtype), al=al,
                      al64=None, k=sos.shape[0], powers=powers)


def _toeplitz_rows(hc, n):
    """``out[j, i] = hc[i − j]`` for ``i ≥ j``, else 0 (``hc[n:2n]`` must be
    zeros), over the leading axis of ``hc`` ``(2n, ...)``, by the
    stride-(2n−1) tile trick (JAX ``_blocked_operators``): row ``j`` of the
    tiled array cut into rows of ``2n − 1`` starts at ``hc[−j mod 2n]``.
    Only repeats, reshapes and slices: a gather here (``hc[idx]``) has an
    index-put backward that took most of a fit step's device time."""
    rest = hc.shape[1:]
    tiled = hc.repeat(n, *([1] * len(rest)))[: n * (2 * n - 1)]
    return tiled.reshape(n, 2 * n - 1, *rest)[:, :n]


def _affine_prefix_traced(t_vec, s0, a, m_grp=_PREFIX_GROUP):
    """Traced-matrix twin of :func:`_affine_prefix_static` (JAX
    ``_affine_prefix_traced``): the superblock operators are built in the
    graph from the tensor ``a`` (powers by doubling, the block-Toeplitz
    ``tbig_t`` by :func:`_toeplitz_rows`), and the recursion runs on the
    superblock totals with ``A^M``."""
    c, n, s_dim = t_vec.shape
    m = min(n, m_grp)
    powers = _powers_traced(a, m + 1)
    powers_m, a_m = powers[:m], powers[m]
    # blocks[j, m'] = A^{m'−j} for m' ≥ j, else 0, and
    # tbig_t[j·S + sj, m'·S + sm] = A^{m'−j}[sm, sj]
    blocks = _toeplitz_rows(torch.cat([powers_m, torch.zeros_like(powers_m)]),
                            m)
    tbig_t = blocks.permute(0, 3, 1, 2).reshape(m * s_dim, m * s_dim)
    ng = -(-n // m)
    t_pad = torch.nn.functional.pad(t_vec, (0, 0, 0, ng * m - n))
    cum = (t_pad.reshape(c, ng, m * s_dim) @ tbig_t).reshape(c, ng, m, s_dim)
    if ng == 1:
        sg_in = s0[:, None]
    else:
        sg_in = _affine_prefix_traced(cum[:, :, m - 1, :], s0, a_m,
                                      m_grp=m_grp)
    shifted = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]],
                        dim=2)
    s_in = torch.einsum("mij,cgj->cgmi", powers_m, sg_in) + shifted
    return s_in.reshape(c, ng * m, s_dim)[:, :n]


def _boundary_states_traced(t_vec, s0, al):
    """Incoming block states ``(C, nb, S)`` and the state after the last
    block ``(C, S)`` for a traced ``A^L`` (JAX ``_boundary_states_traced``)."""
    s_in = _affine_prefix_traced(t_vec, s0, al)
    return s_in, s_in[:, -1] @ al.T + t_vec[:, -1]


def _final_state_traced(s_in_last, x_last, powers, g, rem):
    """The state after ``rem < L`` samples of a block entered in
    ``s_in_last`` ``(C, S)``: ``A^rem s_in + Σ_{j<rem} A^{rem−1−j} B x[j]``,
    ``A^rem`` read from the block's ``powers`` and the drive terms a slice
    of ``G`` (``G[j] = A^{L−1−j} B``) (JAX ``_final_state_traced``, which
    builds ``A^rem`` by ``_matpow_traced``).  ``x_last`` is ``(C, rem)``."""
    L = g.shape[0]
    return s_in_last @ powers[rem].T + x_last @ g[L - rem:]


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


def _states_from_summaries(t_vec, zi, ops, dtype, return_state,
                           rows64=None, n_valid=None):
    """Incoming states ``(C, nb, S)`` in ``dtype`` and the scipy-layout
    final state from one cascade's float64 block summaries ``t_vec``.

    ``n_valid``: the final state is the one after the first ``n_valid``
    samples (the rest is padding): the incoming state of the block it
    falls in, carried over that block's first samples by the operators of
    a block of their length (float64, host-built).  ``rows64`` ``(C, nb,
    L)`` is the float64 signal, needed then."""
    c, nb, _ = t_vec.shape
    s0 = _initial_state(zi, ops.k, c, t_vec)
    if ops.traced:
        s_in64, s_end = _boundary_states_traced(t_vec, s0, ops.al)
    else:
        s_in64 = _affine_prefix_static(t_vec, s0, ops.al64, cache=ops.prefix)
    s_in = s_in64.to(dtype).contiguous()
    if not return_state:
        return s_in, zi
    L = rows64.shape[2] if rows64 is not None else None
    if n_valid is None or n_valid >= nb * L:
        s_last = (s_end if ops.traced
                  else s_in64[:, -1] @ ops.al.T + t_vec[:, -1])    # (C, S)
    else:
        j, r = divmod(int(n_valid), L)
        s_last = s_in64[:, j]
        if r and ops.traced:
            s_last = _final_state_traced(s_last, rows64[:, j, :r], ops.powers,
                                         ops.g, r)
        elif r:
            _, g_r, _, al_r = _blocked_operators_static(
                ops.sos.tobytes(), ops.k, r)
            s_last = (s_last @ torch.as_tensor(al_r.T, device=s_last.device)
                      + rows64[:, j, :r] @ torch.as_tensor(
                          g_r, device=s_last.device))
    return s_in, state_to_zi(s_last.T, ops.k).to(dtype)


def sosfilt_states_rows(sos, xrows, zi=None, n_valid=None,
                        return_state=True, ops=None):
    """Per-block incoming states of one cascade over rows ``(C, nb, L)``.

    One ``rows @ G`` read of the signal plus the scan-free boundary
    prefix.  ``ops`` (from :func:`blocked_ops`) skips the operator lookup
    when the caller holds them already.  A ``sos`` tensor that requires
    grad takes the traced route (:func:`blocked_ops_traced`).  ``n_valid``: the samples of the
    signal before its zero padding, where ``zf`` is taken (all of them
    when None).

    Returns ``(s_in (C, nb, S), zf, ops)`` with ``zf`` the final state in
    scipy layout ``(K, 2, C)`` (``zi`` unchanged when ``return_state`` is
    False).
    """
    c, nb, L = xrows.shape
    if ops is None and isinstance(sos, torch.Tensor) and sos.requires_grad:
        ops = blocked_ops_traced(sos, L, xrows.dtype)
    elif ops is None:
        ops = blocked_ops(sos, L, xrows.device, xrows.dtype)
    rows = xrows.reshape(c * nb, L).to(_STATES_DTYPE)
    t_vec = (rows @ ops.g).reshape(c, nb, -1)
    s_in, zf = _states_from_summaries(t_vec, zi, ops, xrows.dtype,
                                      return_state, rows.view(c, nb, L),
                                      n_valid)
    return s_in, zf, ops


def sosfilt_states_multi_rows(sos_list, xrows, zi_list=None, n_valid=None,
                              return_state=True, ops_list=None):
    """Per-block incoming states of F cascades over rows ``(C, nb, L)``,
    from ONE shared float64 ``rows @ [G_1 | … | G_F]`` read of the signal
    (the multiband crossovers: the band kernels recompute each block's
    band samples from these states).  ``ops_list``: the cascades'
    :func:`blocked_ops`, looked up when not given.

    Returns ``(s_ins, zfs)``: per-filter ``(C, nb, S_f)`` incoming states
    and scipy-layout ``(K, 2, C)`` final states (the ``zi`` given, when
    ``return_state`` is False), taken after ``n_valid`` samples as in
    :func:`sosfilt_states_rows`.
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
                                          return_state, rows.view(c, nb, L),
                                          n_valid)
        s_ins.append(s_in)
        zfs.append(zf)
    return tuple(s_ins), tuple(zfs)


def sosfilt_blocked_rows(sos, xrows, zi=None, n_valid=None,
                         return_state=True, ops=None):
    """Plain blocked filter over rows ``(C, nb, L)``: the states pass, then
    ``y = rows @ T + s_in @ Wᵀ``.  Returns ``(yrows, zf)``."""
    c, nb, L = xrows.shape
    s_in, zf, ops = sosfilt_states_rows(sos, xrows, zi=zi,
                                        return_state=return_state, ops=ops,
                                        n_valid=n_valid)
    return recompute_rows(xrows, s_in, ops), zf


@functools.lru_cache(maxsize=128)
def _a_pow_static(a_bytes, s_dim, n):
    a = np.frombuffer(a_bytes, dtype=np.float64).reshape(s_dim, s_dim)
    return np.linalg.matrix_power(a, n)


def _a_pow(a_np, n, device):
    """``A^n`` of a float64 ``(S, S)`` matrix, built on the host (cached
    per matrix and ``n``) and put on ``device`` in float64: the shard
    transition, whose filters' poles may sit near the unit circle."""
    a_np = np.ascontiguousarray(a_np, np.float64)
    return torch.as_tensor(_a_pow_static(a_np.tobytes(), a_np.shape[0], n),
                           device=device)


def _fold_shard_states(t_all, index, a_shard, s0):
    """Incoming state of shard ``index`` and the state after the last
    shard, from every shard's zero-state end state ``t_all`` ``(D, C,
    S)``: ``s_{j+1} = A^n s_j + t_j`` from ``s_0 = s0`` ``(C, S)``, all in
    float64."""
    s_acc, s_in = s0, s0
    for j in range(t_all.shape[0]):
        if j == index:
            s_in = s_acc
        s_acc = s_acc @ a_shard.T + t_all[j]
    return s_in, s_acc


def sosfilt_sharded(sos, x_shard, mesh, axis="seq", zi=None, block_size=512):
    """Blocked SOS filtering of a signal sharded over ``mesh``'s ``axis``
    (JAX ``sosfilt_sharded``): this rank's ``(n,)`` or ``(n, C)`` shard,
    every shard of one length ``n``.

    The shard is filtered from a zero state in rows of ``L =
    min(block_size, max(8, n))`` samples (the states pass in float64),
    its state after its ``n`` samples is all-gathered along ``axis``, the
    shards' end states fold through the shard transition ``A^n`` into
    this shard's true incoming state, and the output is recomputed from
    it (``rows @ T + s_in @ Wᵀ``, plain torch).  ``zi``: the global
    initial state (scipy layout), entering at the first shard.  The
    coefficients are concrete (a numpy ``(K, 6)``).

    Returns ``(y_shard, zf)``, ``zf`` the state after the last shard
    (the same on every rank), in the signal's dtype.
    """
    squeeze = x_shard.ndim == 1
    x = x_shard[:, None] if squeeze else x_shard
    n, c = x.shape
    sos = np.ascontiguousarray(sos, np.float64)
    L = min(block_size, max(8, n))
    ops = blocked_ops(sos, L, x.device, x.dtype)
    rows = to_rows(x, L)
    nb = rows.shape[1]
    rows64 = rows.reshape(c * nb, L).to(_STATES_DTYPE)
    t_vec = (rows64 @ ops.g).reshape(c, nb, -1)
    _, z_loc = _states_from_summaries(t_vec, None, ops, _STATES_DTYPE, True,
                                      rows64.view(c, nb, L), n_valid=n)
    t_all = mesh.all_gather(zi_to_state(z_loc).T.contiguous(), axis)
    a_shard = _a_pow(cascade_state_space(sos)[0], n, x.device)
    s_in, s_end = _fold_shard_states(t_all, mesh.index(axis), a_shard,
                                     _initial_state(zi, ops.k, c, t_vec))
    s_blocks, _ = _states_from_summaries(
        t_vec, state_to_zi(s_in.T, ops.k), ops, x.dtype, False)
    y = from_rows(recompute_rows(rows, s_blocks, ops), n)
    zf = state_to_zi(s_end.T, ops.k).to(x.dtype)
    return (y[:, 0], zf[:, :, 0]) if squeeze else (y, zf)


def recompute_rows(xrows, s_in, ops):
    """A blocked filter's output from its incoming states:
    ``rows @ T + s_in @ Wᵀ`` over ``(C, nb, L)``, in the rows' dtype."""
    c, nb, L = xrows.shape
    y = xrows.reshape(c * nb, L) @ ops.t + \
        s_in.reshape(c * nb, -1) @ ops.w.T
    return y.reshape(c, nb, L)


# the block of the (N, C) functions' rows: a multiple of the kernels' 128
# columns that the gpu_default hops divide
NC_BLOCK = 384


def to_rows(x, block_size=NC_BLOCK):
    """``(N, C)`` audio as zero-padded rows ``(C, nb, L)``."""
    n, c = x.shape
    nb = max(1, -(-n // block_size))
    return torch.nn.functional.pad(x.T, (0, nb * block_size - n)).reshape(
        c, nb, block_size)


def from_rows(yrows, n):
    """Rows ``(C, nb, L)`` back to ``(N, C)`` audio, cut at ``n``."""
    return yrows.reshape(yrows.shape[0], -1)[:, :n].T


# ---------------------------------------------------------------------------
# The row-major filters of ``(N,)`` / ``(N, C)`` audio and their dispatcher
# ---------------------------------------------------------------------------

DEFAULT_BLOCK = 512     # JAX sosfilt's block_size default
METHODS = ("auto", "scan", "blocked")


def uses_scan(method, n_frames, block_size=DEFAULT_BLOCK):
    """JAX ``sosfilt``'s choice: the exact scan for ``"scan"``, and for
    ``"auto"`` below ``4 · block_size`` frames (where the blocked setup
    does not pay); the blocked filter otherwise."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}: one of {METHODS}")
    return method == "scan" or (method == "auto"
                                and n_frames < 4 * block_size)


def _columns(x):
    """``(N,)`` or ``(N, C)`` audio as ``(C, N)`` columns; ``squeeze``."""
    x = torch.as_tensor(x)
    squeeze = x.ndim == 1
    return (x[None] if squeeze else x.T).contiguous(), squeeze


def _scan_nc(scan, sos, x, zi):
    xc, squeeze = _columns(x)
    y, (zf,) = scan(xc, [sos], None if zi is None else [zi])
    y = y[0]
    return (y[0], zf[:, :, 0]) if squeeze else (y.T, zf)


def sosfilt_scan(sos, x, zi=None):
    """Direct-form II transposed SOS filter, the exact recurrence (JAX
    ``sosfilt_scan``): kernel K8 (``ops.sos_scan``) on a CUDA tensor, its
    plain version on a CPU one.

    Args:
      sos: ``(K, 6)`` sections ``[b0, b1, b2, 1, a1, a2]`` (cast to
        ``x``'s dtype).
      x: ``(N,)`` or ``(N, C)`` signal, float32 or float64.
      zi: optional initial state ``(K, 2)`` (1-D x) or ``(K, 2, C)``.

    Returns ``(y, zf)``, ``y`` shaped like ``x`` and ``zf`` like ``zi``.
    """
    return _scan_nc(sos_scan, sos, x, zi)


def sosfilt_scan_ref(sos, x, zi=None):
    """:func:`sosfilt_scan` through K8's plain version on any device."""
    return _scan_nc(sos_scan_ref, sos, x, zi)


def _blocked_nc(sos_list, x, zi_list, block_size, return_state):
    xc, squeeze = _columns(x)
    c, n = xc.shape
    L = min(block_size, max(8, n))
    rows = to_rows(xc.T, L)
    traced = [isinstance(s, torch.Tensor) and s.requires_grad
              for s in sos_list]
    ops = [blocked_ops_traced(s, L, xc.dtype) if tr
           else blocked_ops(s, L, xc.device, xc.dtype)
           for s, tr in zip(sos_list, traced)]
    ys, zfs = sosfilt_blocked_multi_rows(None, rows, zi_list, n_valid=n,
                                         return_state=return_state,
                                         ops_list=ops)
    ys = [from_rows(y, n) for y in ys]
    if squeeze:
        ys = [y[:, 0] for y in ys]
        zfs = [None if z is None else z[:, :, 0] for z in zfs]
    return tuple(ys), tuple(zfs)


def sosfilt_blocked(sos, x, zi=None, block_size=512, return_state=True):
    """Blocked execution of an SOS cascade over ``(N,)`` or ``(N, C)``
    audio (JAX ``sosfilt_blocked``): blocks of ``L = min(block_size,
    max(8, N))`` samples, the float64 states pass and ``rows @ T + s_in @
    Wᵀ`` (:func:`sosfilt_blocked_rows`); the final state is the one after
    the N samples.  A coefficient tensor that requires grad takes the
    traced operators.  Returns ``(y, zf)`` as :func:`sosfilt_scan`
    (``zf`` is ``zi`` when not ``return_state``)."""
    (y,), (zf,) = _blocked_nc([sos], x, None if zi is None else [zi],
                              block_size, return_state)
    return y, zf


def sosfilt_blocked_multi(sos_list, x, zi_list=None, block_size=512,
                          return_state=True):
    """F static SOS cascades over the same ``(N, C)`` audio, one shared
    states read (JAX ``sosfilt_blocked_multi``).  Returns ``(ys, zfs)``:
    tuples of per-filter outputs and scipy-layout final states."""
    return _blocked_nc(list(sos_list), x, zi_list, block_size, return_state)


def sosfilt_blocked_multi_rows(sos_list, xrows, zi_list=None, n_valid=None,
                               return_state=True, ops_list=None):
    """F static cascades over rows ``(C, nb, L)`` (JAX
    ``sosfilt_blocked_multi_rows``): one float64 states pass for all
    (:func:`sosfilt_states_multi_rows`), then each output ``rows @ T +
    s_in @ Wᵀ`` in plain torch.  Returns tuples of per-filter ``(C, nb,
    L)`` outputs and scipy-layout final states (taken after ``n_valid``
    samples)."""
    c, nb, L = xrows.shape
    if ops_list is None:
        ops_list = [blocked_ops(s, L, xrows.device, xrows.dtype)
                    for s in sos_list]
    s_ins, zfs = sosfilt_states_multi_rows(
        None, xrows, zi_list, n_valid=n_valid, return_state=return_state,
        ops_list=ops_list)
    return (tuple(recompute_rows(xrows, s, o)
                  for s, o in zip(s_ins, ops_list)), zfs)


def sosfilt(sos, x, zi=None, method="auto", block_size=512,
            return_state=True):
    """Dispatch between the exact scan (:func:`sosfilt_scan`, K8) and the
    blocked filter (:func:`sosfilt_blocked`) by JAX ``sosfilt``'s rule
    (:func:`uses_scan`)."""
    if uses_scan(method, torch.as_tensor(x).shape[0], block_size):
        return sosfilt_scan(sos, x, zi)
    return sosfilt_blocked(sos, x, zi, block_size=block_size,
                           return_state=return_state)
