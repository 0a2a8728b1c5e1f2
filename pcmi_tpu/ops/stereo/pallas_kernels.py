"""Pallas kernel (Triton route) for the SGM recurrence on the GPU.

The XLA form of semi-global aggregation
(:func:`pcmi_tpu.ops.stereo.matching._sgm_scan`) is a ``lax.scan`` of
~1,000 steps per direction, each a small (D, span) elementwise op chained
by the recurrence; on a GPU every step is its own set of kernel launches.
Here one program owns ``block`` neighbouring scanlines and walks the whole
scan axis in a loop inside the kernel, keeping the (D, block) carry in
registers:

* Layout ``(D, S, L)``: S is the scan axis, L the scanlines. Each step
  reads a (D, block) slab whose rows are ``block`` contiguous floats.
  Vertical paths read the matcher's (D, H, W) volume as it is; horizontal
  paths read its (D, W, H) transpose.
* Grid ``(L / block, 2)``: the second axis is the direction (forward,
  reverse), so both directions of an orientation run concurrently and
  write separate outputs that one fused XLA add combines.
* The d±1 neighbour exchange goes through a per-program scratch strip
  (``2 * Dp`` rows) that stays in L1/L2: the carry is stored one row
  down, and the two neighbour views are loads at row offsets 0 and 2,
  with BIG rows at both ends acting as the no-neighbour edge. Barriers
  order the store and the loads across the block's warps.

Recurrence (Hirschmüller 2008, bit-exact with ``matching._sgm_scan``):
    L(p, d) = C(p, d) + min(L', L'[d-1]+P1, L'[d+1]+P1, min_d L' + P2) - min_d L'
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# plain float: a jnp scalar would be a captured constant inside the kernel
BIG = 1e9


def _scan_kernel(vol_ref, out_ref, scratch_ref, *, p1, p2, d_count, dp,
                 span, lanes, block, interpret):
    lb = pl.program_id(0)
    rev = pl.program_id(1)
    pid = lb * 2 + rev
    l0 = lb * block
    d_ok = (jnp.arange(dp) < d_count)[:, None]
    mask = d_ok & ((l0 + jnp.arange(block)) < lanes)[None, :]
    d_all = pl.ds(0, dp)
    l_sl = pl.ds(l0, block)

    def barrier():
        if not interpret:
            plgpu.debug_barrier()

    big = jnp.full((dp, block), BIG, jnp.float32)
    plgpu.store(scratch_ref.at[pid, pl.ds(0, dp), :], big)
    plgpu.store(scratch_ref.at[pid, pl.ds(dp, dp), :], big)
    barrier()

    def body(i, prev):
        s = jnp.where(rev == 1, span - 1 - i, i)
        c = plgpu.load(vol_ref.at[d_all, s, l_sl], mask=mask, other=0.0)
        barrier()  # every warp is done reading the previous neighbours
        plgpu.store(scratch_ref.at[pid, pl.ds(1, dp), :], prev)
        barrier()
        up = plgpu.load(scratch_ref.at[pid, pl.ds(0, dp), :])
        dn = plgpu.load(scratch_ref.at[pid, pl.ds(2, dp), :])
        m = jnp.min(prev, axis=0, keepdims=True)
        best = jnp.minimum(jnp.minimum(prev, m + p2),
                           jnp.minimum(up + p1, dn + p1))
        cur = c + best - m
        plgpu.store(out_ref.at[rev, d_all, s, l_sl], cur, mask=mask)
        return jnp.where(d_ok, cur, BIG)

    init = jnp.where(d_ok, jnp.zeros((dp, block), jnp.float32), BIG)
    jax.lax.fori_loop(0, span, body, init)


@partial(jax.jit, static_argnames=("p1", "p2", "block", "num_warps",
                                   "interpret"))
def sgm_scan_pair(vol: jnp.ndarray, p1: float, p2: float, block: int = 32,
                  num_warps: int = 4, interpret: bool = False) -> jnp.ndarray:
    """Both SGM directions along axis 1 of a (D, S, L) float32 volume.

    Returns ``(2, D, S, L)``: index 0 is the forward (increasing S) path,
    index 1 the reverse path, each equal to ``matching._sgm_scan`` over
    that axis. ``block=32, num_warps=4`` was the fastest of block
    {8, 16, 32} x warps {2, 4, 8} on an H100 at D=144, 1152^2 (2.7 ms
    against 3.3-4.0 ms for the others)."""
    d, span, lanes = vol.shape
    dp = pl.next_power_of_2(d)
    nl = pl.cdiv(lanes, block)
    kernel = partial(_scan_kernel, p1=float(p1), p2=float(p2), d_count=d,
                     dp=dp, span=span, lanes=lanes, block=block,
                     interpret=interpret)
    out, _ = pl.pallas_call(
        kernel,
        grid=(nl, 2),
        out_shape=(jax.ShapeDtypeStruct((2, d, span, lanes), jnp.float32),
                   jax.ShapeDtypeStruct((nl * 2, 2 * dp, block),
                                        jnp.float32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="sgm_scan_pair",
    )(vol.astype(jnp.float32))
    return out


def sgm_aggregate_pallas(vol: jnp.ndarray, p1: float, p2: float,
                         dirs: str = "4", interpret: bool = False
                         ) -> jnp.ndarray:
    """:func:`pcmi_tpu.ops.stereo.matching.sgm_aggregate` through
    :func:`sgm_scan_pair`, same ``dirs`` values and the same sums."""
    dt = vol.dtype
    vol = vol.astype(jnp.float32)
    horiz = None
    if dirs in ("4", "h"):
        hp = sgm_scan_pair(jnp.transpose(vol, (0, 2, 1)), p1, p2,
                           interpret=interpret)
        horiz = jnp.transpose(hp[0] + hp[1], (0, 2, 1))
        if dirs == "h":
            return (horiz / 2.0).astype(dt)
    vp = sgm_scan_pair(vol, p1, p2, interpret=interpret)
    vert = vp[0] + vp[1]
    if dirs == "v":
        return (vert / 2.0).astype(dt)
    return ((horiz + vert) / 4.0).astype(dt)
