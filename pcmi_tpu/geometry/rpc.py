"""RPC00B rational polynomial camera model — jittable JAX.

Replaces the reference's use of GDAL's RPC transformer
(``preprocessing.py:29-44``, ``METHOD=RPC`` world->pixel) and rasterio's
``src.rpcs`` (``nitf_utils.py:33``). The RPC00B model maps normalized
geodetic coordinates through ratios of 20-term cubic polynomials:

    row = LINE_OFF  + LINE_SCALE * num_row(P, L, H) / den_row(P, L, H)
    col = SAMP_OFF  + SAMP_SCALE * num_col(P, L, H) / den_col(P, L, H)

with P = (lat-LAT_OFF)/LAT_SCALE, L = (lon-LONG_OFF)/LONG_SCALE,
H = (h-HEIGHT_OFF)/HEIGHT_SCALE, and the standard RPC00B monomial order.

Inverse projection (pixel + height -> lon/lat) is Newton iteration on the
forward model — fully batched, fixed iteration count, jit-safe.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# RPC00B / GDAL coefficient ordering: monomials of (L=lon_n, P=lat_n, H=h_n)
# 1, L, P, H, LP, LH, PH, L^2, P^2, H^2,
# PLH, L^3, LP^2, LH^2, L^2P, P^3, PH^2, L^2H, P^2H, H^3


def _monomials_np(L, P, H):
    """float64 numpy twin of :func:`_monomials` for host-side geometry fits."""
    one = np.ones_like(L)
    return np.stack(
        [
            one, L, P, H,
            L * P, L * H, P * H, L * L, P * P, H * H,
            P * L * H, L ** 3, L * P * P, L * H * H, L * L * P,
            P ** 3, P * H * H, L * L * H, P * P * H, H ** 3,
        ],
        axis=-1,
    )


def _dot(m, coeffs):
    return jnp.matmul(m, coeffs, precision=jax.lax.Precision.HIGHEST)


def _monomials(L, P, H):
    one = jnp.ones_like(L)
    return jnp.stack(
        [
            one, L, P, H,
            L * P, L * H, P * H, L * L, P * P, H * H,
            P * L * H, L ** 3, L * P * P, L * H * H, L * L * P,
            P ** 3, P * H * H, L * L * H, P * P * H, H ** 3,
        ],
        axis=-1,
    )


@jax.tree_util.register_pytree_node_class
@dataclass
class RPCCamera:
    """RPC00B camera. All fields are scalars or (20,) float arrays."""

    line_off: jnp.ndarray
    samp_off: jnp.ndarray
    lat_off: jnp.ndarray
    long_off: jnp.ndarray
    height_off: jnp.ndarray
    line_scale: jnp.ndarray
    samp_scale: jnp.ndarray
    lat_scale: jnp.ndarray
    long_scale: jnp.ndarray
    height_scale: jnp.ndarray
    line_num: jnp.ndarray  # (20,)
    line_den: jnp.ndarray
    samp_num: jnp.ndarray
    samp_den: jnp.ndarray

    def tree_flatten(self):
        fields = (
            self.line_off, self.samp_off, self.lat_off, self.long_off,
            self.height_off, self.line_scale, self.samp_scale, self.lat_scale,
            self.long_scale, self.height_scale, self.line_num, self.line_den,
            self.samp_num, self.samp_den,
        )
        return fields, None

    @classmethod
    def tree_unflatten(cls, aux, fields):
        return cls(*fields)

    @classmethod
    def from_dict(cls, d: dict) -> "RPCCamera":
        """Build from a GDAL-style RPC tag dict (LINE_OFF, LINE_NUM_COEFF...).

        Device fields are float32, but the ORIGINAL float64 values are kept
        on the instance (outside the pytree) for the host geometry-fitting
        path: rounding LAT_OFF/LONG_OFF to f32 before ``project_np`` injects
        a ~0.3 px near-constant per-camera bias at WV3 scale — differential
        between the two cameras of a pair, i.e. ~1 m of systematic height
        error, exactly what the float64 host path exists to avoid.
        """
        f64: dict = {}

        def arr(key):
            v = d[key]
            if isinstance(v, str):
                v = [float(t) for t in v.split()]
            f64[key] = np.asarray(v, np.float64)
            return jnp.asarray(f64[key], jnp.float32)

        def scal(key):
            f64[key] = float(d[key])
            return jnp.float32(f64[key])

        cam = cls(
            line_off=scal("LINE_OFF"), samp_off=scal("SAMP_OFF"),
            lat_off=scal("LAT_OFF"), long_off=scal("LONG_OFF"),
            height_off=scal("HEIGHT_OFF"), line_scale=scal("LINE_SCALE"),
            samp_scale=scal("SAMP_SCALE"), lat_scale=scal("LAT_SCALE"),
            long_scale=scal("LONG_SCALE"), height_scale=scal("HEIGHT_SCALE"),
            line_num=arr("LINE_NUM_COEFF"), line_den=arr("LINE_DEN_COEFF"),
            samp_num=arr("SAMP_NUM_COEFF"), samp_den=arr("SAMP_DEN_COEFF"),
        )
        cam._f64 = f64  # plain attribute; not part of the pytree
        return cam

    _F64_KEYS = {
        "line_off": "LINE_OFF", "samp_off": "SAMP_OFF", "lat_off": "LAT_OFF",
        "long_off": "LONG_OFF", "height_off": "HEIGHT_OFF",
        "line_scale": "LINE_SCALE", "samp_scale": "SAMP_SCALE",
        "lat_scale": "LAT_SCALE", "long_scale": "LONG_SCALE",
        "height_scale": "HEIGHT_SCALE", "line_num": "LINE_NUM_COEFF",
        "line_den": "LINE_DEN_COEFF", "samp_num": "SAMP_NUM_COEFF",
        "samp_den": "SAMP_DEN_COEFF",
    }

    def _host(self, field: str):
        """Float64 value of a field when available (from_dict), else the
        f32 device value upcast (constructed-by-hand cameras)."""
        f64 = getattr(self, "_f64", None)
        if f64 is not None:
            return f64[self._F64_KEYS[field]]
        return np.asarray(getattr(self, field), np.float64)

    def project(self, lon, lat, h):
        """Forward: geodetic -> (col, row) pixel coordinates. Batched."""
        L = (lon - self.long_off) / self.long_scale
        P = (lat - self.lat_off) / self.lat_scale
        H = (h - self.height_off) / self.height_scale
        m = _monomials(L, P, H)
        # HIGHEST: a float32 dot that names no precision may run in TF32 on
        # a GPU, ~1e-3 relative — tens of pixels at RPC line/sample scales
        row_n = _dot(m, self.line_num)
        row_d = _dot(m, self.line_den)
        col_n = _dot(m, self.samp_num)
        col_d = _dot(m, self.samp_den)
        row = self.line_off + self.line_scale * row_n / row_d
        col = self.samp_off + self.samp_scale * col_n / col_d
        return col, row

    def project_np(self, lon, lat, h):
        """Host float64 forward projection.

        Geodetic degrees carry ~1e-6 deg of float32 quantization, which at
        WV3 GSD is ~0.5 px — so host-side geometry *fitting* (affine cameras,
        fundamental matrix, rectifying transforms) uses this float64 path;
        bulk device compute stays float32 in local metric coordinates.
        """
        lon = np.asarray(lon, np.float64)
        lat = np.asarray(lat, np.float64)
        h = np.asarray(h, np.float64)
        L = (lon - self._host("long_off")) / self._host("long_scale")
        P = (lat - self._host("lat_off")) / self._host("lat_scale")
        H = (h - self._host("height_off")) / self._host("height_scale")
        m = _monomials_np(L, P, H)
        row_n = m @ self._host("line_num")
        row_d = m @ self._host("line_den")
        col_n = m @ self._host("samp_num")
        col_d = m @ self._host("samp_den")
        row = self._host("line_off") + self._host("line_scale") * row_n / row_d
        col = self._host("samp_off") + self._host("samp_scale") * col_n / col_d
        return col, row

    @partial(jax.jit, static_argnames=("iters",))
    def localize(self, col, row, h, iters: int = 10):
        """Inverse: (col, row, height) -> (lon, lat) via Newton iteration.

        Runs in *normalized* RPC coordinates (L, P ~ O(1)) with analytic
        jacobians from ``jax.jvp``, so float32 is sufficient.
        """
        H = (h - self.height_off) / self.height_scale
        cn_t = (col - self.samp_off) / self.samp_scale
        rn_t = (row - self.line_off) / self.line_scale

        def fwd(L, P):
            m = _monomials(L, P, jnp.broadcast_to(H, jnp.shape(L)))
            cn = _dot(m, self.samp_num) / _dot(m, self.samp_den)
            rn = _dot(m, self.line_num) / _dot(m, self.line_den)
            return cn - cn_t, rn - rn_t

        def step(_, LP):
            L, P = LP
            (f0, g0), (fL, gL) = jax.jvp(
                fwd, (L, P), (jnp.ones_like(L), jnp.zeros_like(P))
            )
            (_, _), (fP, gP) = jax.jvp(
                fwd, (L, P), (jnp.zeros_like(L), jnp.ones_like(P))
            )
            det = fL * gP - fP * gL
            det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
            dL = (-f0 * gP + g0 * fP) / det
            dP = (-fL * g0 + gL * f0) / det
            return (L + dL, P + dP)

        zero = jnp.zeros(jnp.shape(col), jnp.float32)
        L, P = jax.lax.fori_loop(0, iters, step, (zero, zero))
        return (
            L * self.long_scale + self.long_off,
            P * self.lat_scale + self.lat_off,
        )


def make_affine_rpc(
    a_col: np.ndarray, a_row: np.ndarray,
    offsets: dict | None = None,
) -> RPCCamera:
    """Construct an exact-RPC wrapper of an affine camera (for tests).

    ``a_col``/``a_row`` are length-4 [const, dlon, dlat, dh] in *normalized*
    coordinates; denominators are 1 so the RPC equals the affine map exactly.
    """
    offsets = offsets or {}
    num_col = np.zeros(20, np.float32)
    num_row = np.zeros(20, np.float32)
    num_col[[0, 1, 2, 3]] = a_col
    num_row[[0, 1, 2, 3]] = a_row
    den = np.zeros(20, np.float32)
    den[0] = 1.0
    d = dict(
        LINE_OFF=offsets.get("LINE_OFF", 512.0),
        SAMP_OFF=offsets.get("SAMP_OFF", 512.0),
        LAT_OFF=offsets.get("LAT_OFF", -34.49),
        LONG_OFF=offsets.get("LONG_OFF", -58.58),
        HEIGHT_OFF=offsets.get("HEIGHT_OFF", 25.0),
        LINE_SCALE=offsets.get("LINE_SCALE", 512.0),
        SAMP_SCALE=offsets.get("SAMP_SCALE", 512.0),
        LAT_SCALE=offsets.get("LAT_SCALE", 0.01),
        LONG_SCALE=offsets.get("LONG_SCALE", 0.01),
        HEIGHT_SCALE=offsets.get("HEIGHT_SCALE", 50.0),
        LINE_NUM_COEFF=num_row, LINE_DEN_COEFF=den,
        SAMP_NUM_COEFF=num_col, SAMP_DEN_COEFF=den,
    )
    return RPCCamera.from_dict(d)
