"""Sort-segmented reductions in place of per-point scatter/gather.

Any "per-cell statistics, then per-point comparison" pattern (robust
gridding, voxel filters, per-cell z-gates) is computed as:

  1. ONE ``lax.sort`` keyed on cell id, payloads carried along (no explicit
     permutation gathers),
  2. per-segment totals via blocked NATIVE cumulative ops (below),
  3. per-point elementwise work in the sorted domain,
  4. a single (optionally multi-payload) ``segment_sum`` only for the final
     grid write.

Implementation constraints discovered on this toolchain (keep them):

* ``lax.associative_scan`` with tuple operands compiled pathologically at
  multi-million-element sizes, in both 1-D and blocked 2-D form, so
  everything below is built from the NATIVE cumulative primitives
  (``cumsum``, ``cummax``/``cummin``) plus one tiny sequential
  ``lax.scan`` over block carries.
* The segmented running sum "reset at each boundary" is recovered
  gather-free via monotonicity: for NON-NEGATIVE payloads the in-block
  cumsum ``S`` is non-decreasing, so the prefix value at each point's most
  recent segment boundary is ``cummax(where(boundary, S_exclusive, -1))``
  — the latest boundary always carries the largest prefix. Signed payloads
  are handled by shifting with their global min and adding
  ``min * segment_count`` back (counts are a non-negative payload).
* Per-point segment TOTALS need no second propagation pass:
  ``total = forward_run + backward_run - x`` (inclusive from both sides,
  self counted twice). The backward run is the same primitive on reversed
  arrays with end-marks as starts.
* Global cumsum differences are NOT an alternative: at tens of millions of
  f32 samples the prefix magnitude makes per-segment differences cancel
  catastrophically. Blocked per-segment running sums keep magnitudes
  segment-local.

No counterpart in the reference: its fusion stage was advertised but never
implemented (SURVEY §2.2); scipy/PCL equivalents are host-side.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

# Block width of the two-level scans. The per-block carry combine is a
# sequential lax.scan over N/_LANES steps, the dominant cost at small
# widths; a wide block keeps it short. In-block cumsum magnitude stays
# ≤ _LANES·max|x| ≈ 4e5 for metre-scale payloads → f32 ulp ~0.03 on
# segment totals, far below the sigma-gate's noise floor.
_LANES = 16384


def sort_by_segment(ids: jnp.ndarray, *payloads: jnp.ndarray):
    """Sort ``ids`` ascending, carrying ``payloads`` along.

    Returns ``(ids_sorted, payloads_sorted..., boundary)`` where
    ``boundary[i]`` marks the first element of each equal-id run.
    """
    sorted_ops = jax.lax.sort((ids, *payloads), num_keys=1)
    ids_s = sorted_ops[0]
    boundary = jnp.concatenate([
        jnp.ones((1,), bool), ids_s[1:] != ids_s[:-1]])
    return (*sorted_ops, boundary)


def _blocked_run_sums(boundary: jnp.ndarray,
                      xs: Sequence[jnp.ndarray]) -> List[jnp.ndarray]:
    """Within-segment INCLUSIVE running sums of non-negative ``xs``.

    Blocked ``(nb, LANES)`` layout; native cumsum/cummax in-block, one tiny
    sequential scan combines the per-block carries (the running sum of a
    block's last open run flows into the next block's pre-first-boundary
    prefix).
    """
    n = boundary.shape[0]
    nb = -(-n // _LANES)
    pad = nb * _LANES - n
    # padding opens a fresh zero-weight segment: it cannot leak carries
    f2 = jnp.pad(boundary, (0, pad), constant_values=True).reshape(nb, _LANES)
    seen = jnp.cumsum(f2.astype(jnp.int32), axis=1) > 0
    any_b = f2.any(axis=1)

    outs: List[jnp.ndarray] = []
    run_ins = []
    tails = []
    for x in xs:
        x2 = jnp.pad(x, (0, pad)).reshape(nb, _LANES)
        s2 = jnp.cumsum(x2, axis=1)
        # prefix at the most recent in-block boundary: monotone s ⇒ cummax
        base = jax.lax.cummax(jnp.where(f2, s2 - x2, -1.0), axis=1)
        run_in = s2 - jnp.where(seen, jnp.maximum(base, 0.0), 0.0)
        run_ins.append(run_in)
        tails.append(run_in[:, -1])

    def carry_step(c, inp):
        any_j, tail_j = inp
        nxt = [jnp.where(any_j, t, cj + t) for cj, t in zip(c, tail_j)]
        return nxt, c

    zeros = [jnp.zeros((), x.dtype) for x in xs]
    _, carries = jax.lax.scan(carry_step, zeros,
                              (any_b, [t for t in tails]))
    for run_in, carry in zip(run_ins, carries):
        out = run_in + jnp.where(seen, 0.0, carry[:, None])
        outs.append(out.reshape(-1)[:n])
    return outs


def _totals_nonneg(boundary: jnp.ndarray,
                   xs: Sequence[jnp.ndarray]) -> List[jnp.ndarray]:
    """Per-point segment totals of non-negative ``xs``:
    forward run + backward run − self."""
    fwd = _blocked_run_sums(boundary, xs)
    end = jnp.concatenate([boundary[1:], jnp.ones((1,), bool)])
    bwd = _blocked_run_sums(end[::-1], [x[::-1] for x in xs])
    return [f + b[::-1] - x for f, b, x in zip(fwd, bwd, xs)]


def segment_totals_at_points(boundary: jnp.ndarray,
                             *vals: jnp.ndarray) -> Tuple[jnp.ndarray, ...]:
    """Per-point segment totals of each of ``vals`` (sorted domain).

    Signed values are shifted non-negative by their global min and the
    shift is restored via the per-segment member count.

    ``vals`` must be finite everywhere — a single NaN/Inf (or wild
    magnitude) entry, even one a caller considers masked-out, poisons or
    degrades the global shift. Callers neutralise zero-weight members
    first (e.g. ``v = where(w > 0, v, 0)``).
    """
    ones = jnp.ones_like(vals[0])
    mins = [jnp.minimum(jnp.min(v), 0.0) for v in vals]
    shifted = [v - m for v, m in zip(vals, mins)]
    outs = _totals_nonneg(boundary, [ones, *shifted])
    counts = outs[0]
    return tuple(o + m * counts for o, m in zip(outs[1:], mins))


def robust_sigma_gate(
    boundary: jnp.ndarray,
    v: jnp.ndarray,
    w0: jnp.ndarray,
    sigma: float,
    rounds: int = 3,
) -> jnp.ndarray:
    """Iterated per-segment sigma-clipping weights (sorted domain).

    Per round: weighted mean/std per segment from totals, drop members
    beyond ``sigma`` stddevs, recompute from the survivors. Semantics match
    the scatter/gather formulation it replaces
    (:func:`pcmi_tpu.pipelines.streaming.dsm_update`'s tile-local gate) at
    ~an order of magnitude less random memory access.

    The mean/std are shift-invariant, so the non-negativity shift of the
    value payloads (``v - min(v)``) drops out of the gate comparison.

    Zero-weight members are neutralised before the global-min shift so a
    NaN/Inf or wild value riding along with w0 == 0 cannot poison the
    whole tile (it only ever contributed 0 to the totals).
    """
    valid = w0 > 0
    vmin = jnp.min(jnp.where(valid, v, jnp.inf))
    vmin = jnp.where(jnp.isfinite(vmin), jnp.minimum(vmin, 0.0), 0.0)
    vshift = jnp.where(valid, v - vmin, 0.0)  # w0 ≥ 0, vshift ≥ 0 on valid
    w = w0
    for _ in range(max(rounds, 1)):
        ws, vs, vq = _totals_nonneg(
            boundary, [w, w * vshift, w * vshift * vshift])
        mean = vs / jnp.maximum(ws, 1e-12)
        std = jnp.sqrt(jnp.maximum(vq / jnp.maximum(ws, 1e-12) - mean**2,
                                   0.0))
        keep = jnp.abs(vshift - mean) <= sigma * std + 1e-6
        w = w0 * keep
    return w


def grid_segment_sums(ids_sorted: jnp.ndarray, boundary: jnp.ndarray,
                      payloads: Sequence[jnp.ndarray],
                      num: int) -> jnp.ndarray:
    """Per-cell sums of sorted-by-id payloads; returns ``(num, k)``.

    The direct ``segment_sum`` grid write scatters every POINT row —
    N-sized random access. This form instead:

      1. per-point segment totals via the blocked run sums (streaming),
      2. compacts each segment's END row to the front with one more
         multi-payload ``lax.sort`` (ends keep their cell id as key,
         interior rows park at ``num``; end ids are unique and ascending,
         so the sort is a stable compaction),
      3. scatters only ``min(num, n)`` compacted rows — the scatter the
         hardware floor actually charges for is now cell-sized, not
         point-sized.

    Bit-comparable to the segment_sum form within f32 reduction-order slack (the totals come
    from the same blocked run sums the robust gate uses).
    """
    n = ids_sorted.shape[0]
    totals = segment_totals_at_points(boundary, *payloads)
    is_end = jnp.concatenate([boundary[1:], jnp.ones((1,), bool)])
    key = jnp.where(is_end, ids_sorted, jnp.int32(num))
    masked = [jnp.where(is_end, t, 0.0) for t in totals]
    sorted_ops = jax.lax.sort((key, *masked), num_keys=1)
    m = min(num, n)
    key_c = sorted_ops[0][:m]
    vals_c = jnp.stack([p[:m] for p in sorted_ops[1:]], axis=-1)
    out = jnp.zeros((num + 1, len(payloads)), jnp.float32)
    out = out.at[key_c].add(vals_c, indices_are_sorted=True)
    return out[:num]
