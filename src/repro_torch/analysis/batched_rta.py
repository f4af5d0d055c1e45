"""Batched, vectorized response-time analysis (DESIGN.md §13).

The acceptance grid's inner loop — the Audsley fixed point of
``core/rta.response_time`` — is embarrassingly parallel across tasksets:
each (taskset, task) lane only ever reads its own iterate plus the static
(C, P, prio) vectors of its taskset.  This module pads a shard of tasksets
into dense ``(n_tasksets, max_tasks)`` float64 arrays and steps every lane
of the fixed point together until all lanes have converged or diverged.

Exactness contract: for every lane the returned WCRT is bit-for-bit equal
to the scalar ``core/rta.response_time`` result — same 1e-12 convergence
tolerance, same ``1000 * period`` divergence cutoff, same max_iter, same
convergence-before-divergence check order, and the same left-to-right
``(C + blocking) + interference`` summation with interference accumulated
in taskset order.  Padded lanes never contribute: the interference sum is
a *masked* accumulation (non-hp terms are not added at all, mirroring the
scalar generator expression), so padding cannot perturb a single ulp.

Two backends share the same iteration structure:

- ``numpy`` (default): no import or compile latency, which matters because
  the grid fans the shards out to short-lived multiprocessing workers.
- ``torch``: one masked lockstep fixed point over the whole ``(S, T)``
  shard in float64 on a device (the card unless ``device="cpu"``), the
  iteration of the JAX package's ``jax`` backend: every lane marches
  from ``base`` with no jump start, and the hp terms are added one
  column at a time in taskset order. Select with ``backend="torch"`` or
  ``REPRO_RTA_BACKEND=torch``. Its WCRTs agree with the numpy backend's
  to a relative 1e-12 and its verdicts are equal; bit parity is not
  promised (the numpy path's jump start may land an ulp away).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.rta import gang_wcet

TOL = 1e-12
DIVERGENCE_FACTOR = 1000.0
MAX_ITER = 10_000

_PAD_PERIOD = 1.0  # padded lanes divide by this; value is masked out anyway


@dataclasses.dataclass
class PaddedBatch:
    """A shard of tasksets padded to dense ``(n_tasksets, max_tasks)``.

    ``valid`` masks real lanes; padded lanes carry C=0, P=1, prio=0 and are
    excluded from both analysis and interference.  ``names`` keeps the
    original per-taskset task names so results can be re-keyed.
    """

    C: np.ndarray       # (S, T) gang WCETs, float64 (may contain +inf)
    P: np.ndarray       # (S, T) periods, float64
    prio: np.ndarray    # (S, T) priorities, float64
    valid: np.ndarray   # (S, T) bool, real-lane mask
    names: List[List[str]]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.C.shape


def pad_rows(rows: Sequence[Sequence[Tuple[str, float, float, float]]]
             ) -> PaddedBatch:
    """Pad ``(name, C, P, prio)`` rows, one inner sequence per taskset."""
    S = len(rows)
    T = max((len(r) for r in rows), default=0)
    C = np.zeros((S, T))
    P = np.full((S, T), _PAD_PERIOD)
    prio = np.zeros((S, T))
    valid = np.zeros((S, T), dtype=bool)
    names: List[List[str]] = []
    for s, row in enumerate(rows):
        n = len(row)
        if not n:
            names.append([])
            continue
        nm, c, p, pr = zip(*row)
        names.append(list(nm))
        C[s, :n] = c
        P[s, :n] = p
        prio[s, :n] = pr
        valid[s, :n] = True
    return PaddedBatch(C=C, P=P, prio=prio, valid=valid, names=names)


def pad_tasksets(tasksets: Sequence[Sequence]) -> PaddedBatch:
    """Pad a shard of ``RTTask`` tasksets (uses ``gang_wcet`` like scalar)."""
    return pad_rows([[(t.name, gang_wcet(t), t.period, t.prio) for t in ts]
                     for ts in tasksets])


def accept_bits(batch: PaddedBatch, R: np.ndarray) -> np.ndarray:
    """Vectorized per-set admission bits from a ``fixed_point`` result:
    accepted iff every real lane converged and met its deadline
    (``R <= P + TOL``).  NaN lanes (divergent, or skipped inf-WCET) fail
    their set, exactly like the scalar ``ok=False``."""
    with np.errstate(invalid="ignore"):
        ok = R <= batch.P + TOL      # NaN compares False
    return np.all(ok | ~batch.valid, axis=1)


def default_backend() -> str:
    env = os.environ.get("REPRO_RTA_BACKEND", "").strip().lower()
    if env in ("numpy", "torch"):
        return env
    return "numpy"


def _as_blocking(blocking, S: int) -> np.ndarray:
    arr = np.asarray(blocking, dtype=np.float64)
    if arr.ndim == 0:
        arr = np.full(S, float(arr))
    if arr.shape != (S,):
        raise ValueError(f"blocking must be scalar or shape ({S},)")
    return arr


def _as_crpd(crpd, shape: Tuple[int, int]) -> np.ndarray:
    arr = np.asarray(crpd, dtype=np.float64)
    if arr.ndim == 0:
        arr = np.full(shape, float(arr))
    if arr.shape != shape:
        raise ValueError(f"crpd must be scalar or shape {shape}")
    return arr


def fixed_point(batch: PaddedBatch, blocking=0.0, crpd=0.0,
                analyze: Optional[np.ndarray] = None,
                max_iter: int = MAX_ITER, backend: str = "auto",
                device=None) -> np.ndarray:
    """Run the masked batched Audsley fixed point on a padded shard.

    ``crpd`` is scalar or ``(S, T)`` keyed by the *analyzed* lane: lane
    (s, i) solves ``R = (C_i + crpd_si) + blocking_s +
    sum_{j in hp(i)} ceil(R / P_j) * (C_j + crpd_si)`` — the per-analyzed-
    task CRPD inflates every term, exactly as the scalar path does.

    ``analyze`` (default: all valid lanes) restricts which lanes are
    solved; excluded lanes still interfere with the lanes that are.
    Returns an ``(S, T)`` float64 array of WCRTs with NaN where the lane
    diverged (scalar ``None``) or was not analyzed.

    ``device`` is read by the ``torch`` backend only: ``None`` means the
    card (and raises without one), ``"cpu"`` runs it on the host.
    """
    if backend == "auto":
        backend = default_backend()
    S, T = batch.shape
    if T == 0 or S == 0:
        return np.full((S, T), np.nan)
    blocking_arr = _as_blocking(blocking, S)
    crpd_arr = _as_crpd(crpd, (S, T))
    if analyze is None:
        analyze = batch.valid
    # Scalar callers never analyze an infinite-WCET task (they pre-skip it);
    # keep such lanes as interferers only.
    active0 = analyze & batch.valid & np.isfinite(batch.C)
    if backend == "torch":
        return _fixed_point_torch(batch, blocking_arr, crpd_arr, active0,
                                  max_iter, device)
    if backend != "numpy":
        raise ValueError(f"unknown RTA backend {backend!r}")
    return _fixed_point_numpy(batch, blocking_arr, crpd_arr, active0,
                              max_iter)


# Below this many live lanes the per-iteration numpy dispatch overhead
# exceeds the scalar recurrence; hand the stragglers to a Python tail
# that uses the *same* ops as core/rta.response_time, so bit-exactness
# holds by construction.
_TAIL_LANES = 8


def _fixed_point_numpy(batch: PaddedBatch, blocking: np.ndarray,
                       crpd: np.ndarray, active0: np.ndarray,
                       max_iter: int) -> np.ndarray:
    """Lane-compacted batched iteration with guarded fast classification.

    Every analyzed (taskset, task) lane is an independent recurrence, so
    the batch is flattened to one row per lane, full-width with an hp
    mask (masked terms carry C=0 in taskset order).  The interference
    sum uses a sequential ``cumsum``: numpy's pairwise ``sum`` would
    re-associate the addends, but cumulative sums are left-to-right and
    adding an exact 0.0 to a non-negative partial sum cannot change a
    bit, so each lane reproduces the scalar ``sum(...)`` partial-sum
    sequence exactly.  Settled lanes are compacted away so late
    iterations only pay for live lanes.

    The scalar recurrence's cost is dominated by a long tail of lanes
    near utilization 1 that march for hundreds-to-thousands of
    iterations.  Those lanes are classifiable without marching, and
    *provably bit-exactly* under the numerical guard below:

    * **Instant divergence.**  With hp utilization ``U = sum c_j/P_j``,
      ``ceil(x) >= x`` gives ``f(R) - R >= base + (U-1)*R >= base`` for
      ``U >= 1``.  Under the guard (``base`` well above the accumulated
      rounding error and the 1e-12 tolerance), the computed increment can
      never fall inside the convergence band, so the scalar always
      returns None (cutoff or ``max_iter`` exhaustion).  Verdict: None,
      zero iterations.
    * **Jump-start.**  For ``U < 1`` every (exact or computed) fixed
      point R' satisfies ``f(R') <~ R'`` hence ``R' >= (base - err)/(1-U)``,
      so iterating from ``L = 0.99 * base/(1-U)`` visits no fixed point
      the from-``base`` trajectory would have stopped at earlier, and the
      monotone computed map lands on the *same* plateau value
      (identical ceil vector => identical bits).  Under the guard, a
      computed increment is either exactly 0 (plateau: unchanged ceil
      vector => bitwise-identical sum) or exceeds the 1e-12 tolerance,
      so "converged" means "exact plateau" for both paths.  A
      crossing-count bound then confirms the scalar would reach that
      plateau within its own ``max_iter`` (each scalar iteration except
      the last crosses at least one ``P_j`` multiple); lanes failing the
      bound are re-run faithfully from ``base``.

    The guard requires every hp term and ``base`` to clear both an
    absolute floor (1e-9) and 1e4x the worst-case float summation error
    along the trajectory; lanes with ``|U - 1| <= 1e-9`` or failing the
    guard take the faithful from-``base`` path unchanged.
    """
    C, P, prio, valid = batch.C, batch.P, batch.prio, batch.valid
    S, T = C.shape
    result = np.full((S, T), np.nan)
    lanes = np.argwhere(active0)
    if lanes.size == 0:
        return result
    s_idx, i_idx = lanes[:, 0], lanes[:, 1]
    # hp[s, i, j]: lane j interferes with analyzed lane i (strictly higher
    # prio, both real) — never self, duplicate prios never interfere.
    hp = (prio[:, None, :] > prio[:, :, None]) \
        & valid[:, None, :] & valid[:, :, None]
    hp_mask = hp[s_idx, i_idx, :]                   # (L, T), taskset j-order
    crpd_l = crpd[s_idx, i_idx]
    # Full-width term layout: masked (non-hp) columns carry C=0, which a
    # left-to-right cumsum cannot observe.  No gather/argsort needed.
    C_hp = np.where(hp_mask, C[s_idx] + crpd_l[:, None], 0.0)
    P_hp = P[s_idx]
    n_hp = hp_mask.sum(axis=1)
    H = T
    base = (C[s_idx, i_idx] + crpd_l) + blocking[s_idx]
    cutoff = DIVERGENCE_FACTOR * P[s_idx, i_idx]
    flat_result = result.reshape(-1)
    lane_flat = s_idx * T + i_idx

    # --- guarded fast classification -----------------------------------
    with np.errstate(invalid="ignore", over="ignore"):
        U = np.sum(C_hp / P_hp, axis=1)     # masked cols: 0 / P == 0
        sum_c = np.sum(C_hp, axis=1)
        # Worst-case float error of one interference evaluation below the
        # cutoff: n terms, each bounded by the evaluation's own magnitude
        # f(R) <= base + sum_c + U*cutoff.
        err = n_hp * 2.3e-16 * (base + sum_c + U * cutoff)
        min_c = np.min(np.where(hp_mask, C_hp, np.inf), axis=1)
        floor = np.maximum(1e4 * err, 1e-9)
        guard = np.isfinite(err) & (base >= floor) \
            & ((min_c >= floor) | (n_hp == 0))
        # U >= 1 (or an inf hp term): the scalar can never converge.
        instant = (U >= 1.0 + 1e-9) & (guard | np.isinf(U)) & (base > 0)
        jumped = guard & (U <= 1.0 - 1e-9) & ~instant
        R = np.where(jumped & (n_hp > 0),
                     np.maximum(base, 0.99 * (base / (1.0 - U))), base)
    if instant.any():
        keep = ~instant
        R, base, cutoff = R[keep], base[keep], cutoff[keep]
        P_hp, C_hp, hp_mask = P_hp[keep], C_hp[keep], hp_mask[keep]
        lane_flat, n_hp, jumped = lane_flat[keep], n_hp[keep], jumped[keep]

    # Jumped lanes that converge must also pass the scalar-iteration
    # bound; failing rows are re-run faithfully from base at the end.
    refit: list = []
    iters = 0
    while lane_flat.size > _TAIL_LANES and iters < max_iter:
        if H:
            D = np.ceil(R[:, None] / P_hp)
            acc = np.cumsum(D * C_hp, axis=1)[:, -1]
        else:
            acc = np.zeros_like(R)
        R_new = base + acc
        conv = np.abs(R_new - R) < TOL
        if conv.any():
            ok = conv
            jc = conv & jumped
            if jc.any():
                rows = np.where(jc)[0]
                steps = np.floor((R_new[rows, None] - base[rows, None])
                                 / P_hp[rows])
                bound = np.sum(steps * hp_mask[rows], axis=1) \
                    + n_hp[rows] + 4
                bad = rows[bound > max_iter]
                if bad.size:
                    ok = conv.copy()
                    ok[bad] = False
                    for r in bad:
                        refit.append((P_hp[r].copy(), C_hp[r].copy(),
                                      hp_mask[r].copy(), float(base[r]),
                                      float(cutoff[r]), int(lane_flat[r])))
            flat_result[lane_flat[ok]] = R_new[ok]
        # Convergence wins over divergence, in scalar check order.
        still = ~conv & ~(R_new > cutoff)
        iters += 1
        if still.all():
            R = R_new
        else:
            R = R_new[still]
            base, cutoff = base[still], cutoff[still]
            P_hp, C_hp, hp_mask = P_hp[still], C_hp[still], hp_mask[still]
            lane_flat, n_hp = lane_flat[still], n_hp[still]
            jumped = jumped[still]
    _scalar_tail(P_hp, C_hp, hp_mask, R, base, cutoff, lane_flat,
                 flat_result, max_iter - iters, jumped=jumped,
                 bound_iter=max_iter, refit=refit)
    for P_r, C_r, m_r, base_l, cutoff_l, lf in refit:
        _scalar_tail(P_r[None, :], C_r[None, :], m_r[None, :],
                     np.array([base_l]), np.array([base_l]),
                     np.array([cutoff_l]), np.array([lf]), flat_result,
                     max_iter)
    return result


def _scalar_tail(P_hp, C_hp, hp_mask, R, base, cutoff, lane_flat,
                 flat_result, iter_budget: int, jumped=None,
                 bound_iter: int = 0, refit=None) -> None:
    """Finish straggler lanes with the scalar recurrence, resuming from
    the batched iterate.  Mirrors ``response_time``'s loop body exactly
    (``sum`` over hp terms in taskset order, ``math.ceil``).

    Jump-started lanes (``jumped``) converge to the same plateau as the
    faithful trajectory but need the scalar-iteration bound confirmed
    before their value counts (see ``_fixed_point_numpy``); a lane
    failing the bound — or exhausting the budget without resolving — is
    queued on ``refit`` for a faithful from-``base`` re-run."""
    for idx in range(lane_flat.size):
        hp_terms = [(float(P_hp[idx, j]), float(C_hp[idx, j]))
                    for j in np.flatnonzero(hp_mask[idx])]
        h = len(hp_terms)
        R_cur = float(R[idx])
        base_l = float(base[idx])
        cutoff_l = float(cutoff[idx])
        is_jumped = jumped is not None and bool(jumped[idx])
        for _ in range(iter_budget):
            interference = sum(math.ceil(R_cur / p) * c for p, c in hp_terms)
            R_new = base_l + interference
            if abs(R_new - R_cur) < TOL:
                if is_jumped:
                    bound = sum(math.floor((R_new - base_l) / p)
                                for p, _ in hp_terms) + h + 4
                    if bound > bound_iter:
                        refit.append((P_hp[idx].copy(), C_hp[idx].copy(),
                                      hp_mask[idx].copy(), base_l, cutoff_l,
                                      int(lane_flat[idx])))
                        break
                flat_result[lane_flat[idx]] = R_new
                break
            if R_new > cutoff_l:
                break
            R_cur = R_new
        else:
            if is_jumped:
                # Budget ran out mid-march from the jump start: no claim
                # about the faithful trajectory is possible — redo it.
                refit.append((P_hp[idx].copy(), C_hp[idx].copy(),
                              hp_mask[idx].copy(), base_l, cutoff_l,
                              int(lane_flat[idx])))


# Lockstep iterations between two host reads of the "any lane active"
# flag: each read waits for the device, so the loop checks it only this
# often. Lanes that settled in between are masked and change nothing.
_TORCH_CHECK_EVERY = 16


def _fixed_point_torch(batch: PaddedBatch, blocking: np.ndarray,
                       crpd: np.ndarray, active0: np.ndarray,
                       max_iter: int, device=None) -> np.ndarray:
    """The masked lockstep Audsley iteration over the whole shard at once,
    in float64 on ``device``: for lane (s, i),

        R_new = base + sum_j hp[s, i, j] * ceil(R / P_j) * (C_j + crpd_si)

    with ``base = (C_i + crpd_si) + blocking_s``, starting from ``base``;
    a lane settles when ``|R_new - R| < TOL`` (its WCRT is ``R_new``) or,
    checked after convergence, when ``R_new > DIVERGENCE_FACTOR * P_i``
    (NaN). The hp terms are added one column at a time in taskset order,
    each add a separate elementwise op (no fused multiply-add), so each lane
    follows the scalar recurrence's left-to-right sum; a masked column
    adds an exact 0.0. An iteration is T + 8 elementwise launches."""
    import torch

    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    S, T = batch.shape

    def f64(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=dev)

    C, P, prio = f64(batch.C), f64(batch.P), f64(batch.prio)
    valid = torch.as_tensor(batch.valid, device=dev)
    crpd_t = f64(crpd)
    hp = (prio[:, None, :] > prio[:, :, None]) & valid[:, None, :] \
        & valid[:, :, None]                       # (S, i, j)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    # term weights (C_j + crpd_si) where j interferes with i, else 0
    w = torch.where(hp, C[:, None, :] + crpd_t[:, :, None], zero)
    P_j = P[:, None, :]
    base = (C + crpd_t) + f64(blocking)[:, None]
    cutoff = DIVERGENCE_FACTOR * P
    R = base.clone()
    active = torch.as_tensor(active0, device=dev)
    result = torch.full((S, T), float("nan"), dtype=torch.float64,
                        device=dev)
    it = 0
    while it < max_iter:
        for _ in range(min(_TORCH_CHECK_EVERY, max_iter - it)):
            terms = torch.ceil(R[:, :, None] / P_j) * w      # (S, i, j)
            acc = torch.zeros_like(R)
            for j in range(T):
                acc = acc + terms[:, :, j]
            R_new = base + acc
            conv = torch.abs(R_new - R) < TOL
            result = torch.where(active & conv, R_new, result)
            active = active & ~conv & ~(R_new > cutoff)
            R = torch.where(active, R_new, R)
            it += 1
        if not bool(active.any()):
            break
    return result.cpu().numpy()


def batched_response_times(tasksets: Sequence[Sequence], blocking=0.0,
                           crpd=0.0, max_iter: int = MAX_ITER,
                           backend: str = "auto", device=None
                           ) -> List[List[Optional[float]]]:
    """Per-taskset lists of WCRTs (``None`` where scalar RTA diverges)."""
    batch = pad_tasksets(tasksets)
    R = fixed_point(batch, blocking=blocking, crpd=crpd, max_iter=max_iter,
                    backend=backend, device=device)
    out: List[List[Optional[float]]] = []
    for s, ts in enumerate(tasksets):
        out.append([None if math.isnan(R[s, i]) else float(R[s, i])
                    for i in range(len(ts))])
    return out


def batched_schedulable(tasksets: Sequence[Sequence], blocking=0.0,
                        crpd=0.0, backend: str = "auto", device=None
                        ) -> List[Dict[str, Dict]]:
    """Batched drop-in for ``core/rta.schedulable`` over a shard.

    Returns one ``{name: {"wcrt", "deadline", "ok"}}`` dict per taskset,
    bit-identical to calling the scalar path taskset by taskset.
    """
    wcrts = batched_response_times(tasksets, blocking=blocking, crpd=crpd,
                                   backend=backend, device=device)
    out = []
    for ts, Rs in zip(tasksets, wcrts):
        res = {}
        for t, R in zip(ts, Rs):
            res[t.name] = {"wcrt": R, "deadline": t.period,
                           "ok": R is not None and R <= t.period + TOL}
        out.append(res)
    return out


def batched_accepts(tasksets: Sequence[Sequence], blocking=0.0, crpd=0.0,
                    backend: str = "auto", device=None) -> List[bool]:
    """Accept bit per taskset: every task meets its deadline."""
    results = batched_schedulable(tasksets, blocking=blocking, crpd=crpd,
                                  backend=backend, device=device)
    return [all(r["ok"] for r in res.values()) for res in results]


# ---------------------------------------------------------------------
# Vectorized closed-form window evaluation — the verdict-phase scalar
# hot spot of the rtgT / rtgT+dr grid columns (vgang/rta). The scalar
# bounds walk a tiny piecewise (seg_len, slowdown) profile per member
# per vgang; here the profiles of every lane in a shard are padded to a
# dense (L, K) pair and the whole closed form (work per window, number
# of full windows, finish offset in the last window) evaluates as a
# handful of array ops. Pads carry d=0, s=1 so d/s contributes an exact
# 0.0 and every lane stays bit-identical to its scalar walk.
# ---------------------------------------------------------------------


def pad_profiles(profiles: Sequence[Sequence[Tuple[float, float]]]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad piecewise ``(seg_len, slowdown)`` profiles to dense ``(L, K)``
    arrays ``(D, S, valid)``; pads carry d=0, s=1."""
    L = len(profiles)
    K = max((len(p) for p in profiles), default=0) or 1
    D = np.zeros((L, K))
    S = np.ones((L, K))
    valid = np.zeros((L, K), dtype=bool)
    for i, prof in enumerate(profiles):
        for j, (d, s) in enumerate(prof):
            D[i, j] = d
            S[i, j] = s
            valid[i, j] = True
    return D, S, valid


def window_eval(D: np.ndarray, S: np.ndarray, valid: np.ndarray,
                needs: Sequence[float]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized closed form of the scalar per-member window loop in
    ``vgang/rta.rtg_throttle_wcet`` / ``reclaim_wcet``, lane by lane:

        work   = sum(d / s)                       (left-to-right)
        full   = trunc((need - 1e-12) / work)     (= scalar int())
        rem    = need - full * work
        offset = walk the profile: first segment with
                 rem <= d/s + 1e-15 closes at offset += rem * s,
                 earlier segments add d and consume d/s of rem.

    Returns ``(work, full, offset, feasible)``; lanes with
    ``work <= 1e-12`` are infeasible (the scalar paths return/skip inf)
    and their full/offset are meaningless. ``np.trunc`` (not floor)
    matches Python ``int()`` truncation-toward-zero when ``need`` is
    below the 1e-12 slack.
    """
    L, K = D.shape
    needs_a = np.asarray(needs, dtype=np.float64)
    seg = D / S                          # pads: 0/1 == exact 0.0
    work = np.cumsum(seg, axis=1)[:, -1]
    feasible = work > 1e-12
    safe = np.where(feasible, work, 1.0)
    full = np.trunc((needs_a - 1e-12) / safe)
    rem = needs_a - full * safe
    offset = np.zeros(L)
    done = ~feasible
    for j in range(K):
        live = ~done & valid[:, j]
        hit = live & (rem <= seg[:, j] + 1e-15)
        step = live & ~hit
        offset = np.where(hit, offset + rem * S[:, j], offset)
        offset = np.where(step, offset + D[:, j], offset)
        rem = np.where(step, rem - seg[:, j], rem)
        done = done | hit
    return work, full, offset, feasible


def _intf_list(interferences, n: int) -> list:
    return [interferences] * n if callable(interferences) \
        else list(interferences)


def batched_rtg_throttle_wcet(vgangs: Sequence, interferences,
                              interval: float = 1.0) -> List[float]:
    """One ``rtg_throttle_wcet`` per vgang, the closed-form window
    evaluation vectorized across every member lane of the shard.
    ``interferences`` is one shared callable or one per vgang.
    Bit-identical to the scalar bound (shared profile builder, same
    float ops in the same order)."""
    from repro_torch.vgang.rta import _throttle_profile, _window_runtimes
    intfs = _intf_list(interferences, len(vgangs))
    out: List[Optional[float]] = [None] * len(vgangs)
    profiles, needs, owner = [], [], []
    for idx, (vg, intf) in enumerate(zip(vgangs, intfs)):
        if len(vg.members) == 1:
            out[idx] = vg.inflated_wcet(intf)
            continue
        run = _window_runtimes(vg, intf, interval)
        if any(run[m.name] <= 0.0 for m in vg.members):
            out[idx] = float("inf")
            continue
        out[idx] = 0.0                   # scalar worst starts at 0.0
        for m in vg.members:
            profiles.append(_throttle_profile(vg, m, run, intf))
            needs.append(gang_wcet(m))
            owner.append(idx)
    if profiles:
        D, S, valid = pad_profiles(profiles)
        work, full, offset, feasible = window_eval(D, S, valid, needs)
        bounds = np.where(feasible, full * interval + offset, np.inf)
        for b, idx in zip(bounds, owner):
            out[idx] = max(out[idx], float(b))
    return out  # type: ignore[return-value]


def batched_reclaim_wcet(vgangs: Sequence, interferences,
                         interval: float = 1.0) -> List[float]:
    """One ``reclaim_wcet`` per vgang, phase iterations run in lockstep
    so each phase's closed-form window evaluation vectorizes across all
    still-iterating vgangs of the shard. Bit-identical to the scalar
    bound: same profiles, same float ops, same first-wins tie break on
    the (windows, offset) completion order."""
    from repro_torch.vgang.formation import critical_member, rtg_sibling_budget
    from repro_torch.vgang.rta import (_presence_profile, _reclaim_extensions,
                                       _window_runtimes)
    intfs = _intf_list(interferences, len(vgangs))
    out: List[Optional[float]] = [None] * len(vgangs)
    states = []
    for idx, (vg, intf) in enumerate(zip(vgangs, intfs)):
        members = list(vg.members)
        if len(members) == 1:
            out[idx] = vg.inflated_wcet(intf)
            continue
        crit = critical_member(vg, intf)
        Q = rtg_sibling_budget(vg, intf, interval)
        run = _window_runtimes(vg, intf, interval)
        u_sup: Dict[str, float] = {}
        for m in members:
            if run[m.name] >= interval - 1e-12:
                u_sup[m.name] = interval
                continue
            others = [o for o in members if o is not m and o is not crit]
            u_sup[m.name] = _reclaim_extensions(
                vg, intf, interval, Q, run,
                donors=others, drawers=[m], victims=[])[m.name]
        states.append({
            "idx": idx, "vg": vg, "intf": intf, "members": members,
            "crit": crit, "Q": Q, "run": run, "u_sup": u_sup,
            "remaining": {m.name: gang_wcet(m) for m in members},
            "alive": list(members), "completion": {}, "t": 0.0,
        })
    while states:
        profiles, needs = [], []
        for st in states:
            members, crit = st["members"], st["crit"]
            run, u_sup, alive = st["run"], st["u_sup"], st["alive"]
            done = [m for m in members if m.name in st["completion"]]
            u_grt = _reclaim_extensions(
                st["vg"], st["intf"], interval, st["Q"], run,
                donors=[m for m in done if m is not crit],
                drawers=[m for m in alive if m is not crit],
                victims=members)
            st["lanes"] = []
            for m in alive:
                u_m = interval if (m is crit or
                                   run[m.name] >= interval - 1e-12) \
                    else u_grt[m.name]
                present = {o.name: u_sup[o.name]
                           for o in alive if o is not m}
                st["lanes"].append((m, len(needs)))
                profiles.append(
                    _presence_profile(m, present, u_m, st["intf"]))
                needs.append(st["remaining"][m.name])
        D, S, valid = pad_profiles(profiles)
        work, full, offset, feasible = window_eval(D, S, valid, needs)
        next_states = []
        for st in states:
            best = None
            phase_work = {}
            for m, li in st["lanes"]:
                phase_work[m.name] = float(work[li])
                if not feasible[li]:
                    continue
                row = (int(full[li]) + 1, float(offset[li]), m)
                if best is None or (row[0], row[1]) < (best[0], best[1]):
                    best = row
            if best is None:
                out[st["idx"]] = float("inf")
                continue
            k, offv, m = best
            st["completion"][m.name] = st["t"] + (k - 1) * interval + offv
            for o in st["alive"]:
                if o is not m:
                    st["remaining"][o.name] = max(
                        0.0, st["remaining"][o.name]
                        - k * phase_work[o.name])
            st["t"] += k * interval
            st["alive"].remove(m)
            if st["alive"]:
                next_states.append(st)
            else:
                out[st["idx"]] = max(st["completion"].values())
        states = next_states
    return out  # type: ignore[return-value]
