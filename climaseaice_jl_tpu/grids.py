"""Staggered C-grid layer with precomputed metric arrays.

JAX equivalent of the Oceananigans grid subsystem used by the reference
(`RectilinearGrid`, `LatitudeLongitudeGrid`, `ImmersedBoundaryGrid`, `Flat`
topologies; see /root/reference/src/ClimaSeaIce.jl:36-37 and SURVEY.md §2.3).

Design
======
Every 2-D field is a halo-inclusive padded array of shape
``(Nx + 2*Hx, Ny + 2*Hy)``.  All four staggered locations (cc, fc, cf, ff)
share that one shape; the convention (Oceananigans-compatible, see
`src/Rheologies/Rheologies.jl:10-17`) is:

* center index ``i`` lives at padded array index ``Hx + i``;
* a face with the same array index sits at the *left/south* edge of that
  center, so ``u[I]`` is the x-face between centers ``I-1`` and ``I``.

Metric "arrays" are stored broadcast-ready: scalars for uniform rectilinear
grids, ``(1, nyp)`` arrays for latitude-longitude grids (metrics vary with
latitude only).  XLA folds the broadcasts into the fused stencil loops, so
nothing is wasted keeping them small.

Degenerate (``flat``) directions — used by the reference for 0-D/1-D column
models (`examples/freezing_bucket.jl:43`) — have size 1, halo 0 and unit
metrics.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .utils import pytree_dataclass, static_field

PERIODIC = "periodic"
BOUNDED = "bounded"
FLAT = "flat"

EARTH_RADIUS = 6371.0e3  # m


@pytree_dataclass
class Grid:
    # --- static configuration -------------------------------------------------
    Nx: int = static_field()
    Ny: int = static_field()
    Hx: int = static_field()
    Hy: int = static_field()
    topology: tuple = static_field()  # (TX, TY) each in {periodic, bounded, flat}
    dtype: str = static_field()
    kind: str = static_field(default="rectilinear")  # rectilinear | latlon

    # --- distributed shard info (None on serial grids) ------------------------
    # When set, this Grid describes ONE shard of a global domain inside a
    # shard_map: halo fills along a meshed direction become ppermute exchanges,
    # with physical BCs applied only at the global-domain edges
    # (see parallel/stepper.py).  mesh_axes: axis names; mesh_shape: (Px, Py).
    mesh_axes: tuple = static_field(default=None)
    mesh_shape: tuple = static_field(default=None)

    # Zipper fold across the north edge (tripolar-style grids): the top
    # boundary folds back onto itself with x reversed; u, v change sign across
    # the fold (`src/sea_ice_model.jl:57-64` Zipper sign flip).  Requires
    # periodic x and bounded y.
    north_fold: bool = static_field(default=False)

    # --- coordinates (padded 1-D arrays) -------------------------------------
    xc: object = None  # (nxp,) cell-center x (or longitude, degrees)
    xf: object = None  # (nxp,) x-face positions
    yc: object = None  # (nyp,)
    yf: object = None  # (nyp,)

    # --- metric terms, broadcastable against (nxp, nyp) -----------------------
    dx_cc: object = None
    dx_fc: object = None
    dx_cf: object = None
    dx_ff: object = None
    dy_cc: object = None
    dy_fc: object = None
    dy_cf: object = None
    dy_ff: object = None
    az_cc: object = None
    az_fc: object = None
    az_cf: object = None
    az_ff: object = None

    # --- physical coordinates for curvilinear grids ---------------------------
    # Padded (nxp, nyp) cell-center longitude/latitude in degrees (None on
    # rectilinear grids, whose xc/yc are already physical).  The analog of
    # Oceananigans `λnodes`/`φnodes` the reference uses for initial conditions
    # and spatially varying forcing.  Halo values are periodic in x and
    # edge-clamped in y (adequate for IC/forcing evaluation, which only the
    # interior of survives the halo fill).
    lon_cc: object = None
    lat_cc: object = None

    # --- immersed boundary ----------------------------------------------------
    # Boolean (nxp, nyp) array, True where the cell is solid (land); or None.
    solid_cc: object = None

    # ------------------------------------------------------------------------
    @property
    def np_dtype(self):
        return np.dtype(self.dtype)

    @property
    def nxp(self):
        return self.Nx + 2 * self.Hx

    @property
    def nyp(self):
        return self.Ny + 2 * self.Hy

    @property
    def shape(self):
        """Padded field shape."""
        return (self.nxp, self.nyp)

    @property
    def interior_shape(self):
        return (self.Nx, self.Ny)

    def interior(self, q):
        """View of the interior region of a padded field."""
        return q[self.Hx:self.Hx + self.Nx, self.Hy:self.Hy + self.Ny]

    def set_interior(self, q, values):
        values = jnp.broadcast_to(jnp.asarray(values, q.dtype), self.interior_shape)
        return q.at[self.Hx:self.Hx + self.Nx, self.Hy:self.Hy + self.Ny].set(values)

    def new_field(self, fill=0.0):
        """Allocate a padded field (location is a usage convention, not state)."""
        return jnp.full(self.shape, fill, dtype=self.np_dtype)

    def field_from(self, values):
        """Build a padded field whose interior equals ``values`` (scalar/array/callable).

        Callables receive (x, y) broadcast arrays of cell-center coordinates,
        mirroring Oceananigans ``set!(field, f(x, y))``.
        """
        q = self.new_field()
        if callable(values):
            x = self.xc[self.Hx:self.Hx + self.Nx, None]
            y = self.yc[None, self.Hy:self.Hy + self.Ny]
            values = values(x, y)
        return self.set_interior(q, values)

    def field_from_latlon(self, values):
        """Like ``field_from`` but the callable receives padded (lon, lat)
        cell-center arrays in degrees (curvilinear grids only) — the analog
        of Oceananigans ``set!(field, f(λ, φ))`` on lat-lon/tripolar grids."""
        if self.lon_cc is None:
            raise ValueError("field_from_latlon requires a curvilinear grid "
                             "with stored lon_cc/lat_cc")
        q = self.new_field()
        if callable(values):
            values = self.interior(
                jnp.asarray(values(self.lon_cc, self.lat_cc)))
        return self.set_interior(q, values)

    @property
    def is_immersed(self):
        return self.solid_cc is not None


def _topo(t):
    if t not in (PERIODIC, BOUNDED, FLAT):
        raise ValueError(f"unknown topology {t!r}")
    return t


def _pad_coords(N, H, lo, hi, dtype):
    """Padded center & face coordinate vectors for a uniform spacing."""
    if N == 0:
        N = 1
    d = (hi - lo) / N
    idx = np.arange(-H, N + H)
    xf = lo + idx * d
    xc = xf + 0.5 * d
    return xc.astype(dtype), xf.astype(dtype), d


def RectilinearGrid(size=None, x=(0.0, 1.0), y=(0.0, 1.0),
                    topology=None, halo=None, dtype="float64",
                    north_fold=False):
    """Uniform rectilinear grid (subset of Oceananigans' RectilinearGrid used by
    the reference; see e.g. `examples/ice_advected_by_anticyclone.jl:41-46`).

    ``size`` may be ``()`` (0-D column), ``(Nx,)`` (1-D) or ``(Nx, Ny)``.
    ``topology`` entries: 'periodic' | 'bounded' | 'flat'; flat directions are
    implied by the missing sizes.
    """
    if size is None:
        size = ()
    size = tuple(size)
    if len(size) == 0:
        Nx, Ny = 1, 1
        topo = (FLAT, FLAT)
    elif len(size) == 1:
        Nx, Ny = size[0], 1
        topo = topology or (PERIODIC, FLAT)
    else:
        Nx, Ny = size
        topo = topology or (PERIODIC, PERIODIC)
    topo = (_topo(topo[0]), _topo(topo[1]))

    if halo is None:
        halo = 4
    Hx = 0 if topo[0] == FLAT else halo
    Hy = 0 if topo[1] == FLAT else halo

    npdt = np.dtype(dtype)
    xc, xf, dx = _pad_coords(Nx, Hx, *x, npdt) if topo[0] != FLAT else \
        (np.zeros(Nx, npdt) + 0.5, np.zeros(Nx, npdt), 1.0)
    yc, yf, dy = _pad_coords(Ny, Hy, *y, npdt) if topo[1] != FLAT else \
        (np.zeros(Ny, npdt) + 0.5, np.zeros(Ny, npdt), 1.0)

    dx = np.asarray(dx, npdt)[()]
    dy = np.asarray(dy, npdt)[()]
    az = dx * dy

    if north_fold:
        if topo[0] != PERIODIC or topo[1] != BOUNDED:
            raise ValueError("north_fold requires (periodic, bounded) topology")
        if Nx % 2:
            raise ValueError("north_fold requires even Nx (fold pairs i ↔ Nx-1-i)")

    mk = lambda v: jnp.asarray(v, npdt)
    return Grid(
        Nx=Nx, Ny=Ny, Hx=Hx, Hy=Hy, topology=topo, dtype=str(npdt),
        kind="rectilinear", north_fold=north_fold,
        xc=mk(xc), xf=mk(xf), yc=mk(yc), yf=mk(yf),
        dx_cc=mk(dx), dx_fc=mk(dx), dx_cf=mk(dx), dx_ff=mk(dx),
        dy_cc=mk(dy), dy_fc=mk(dy), dy_cf=mk(dy), dy_ff=mk(dy),
        az_cc=mk(az), az_fc=mk(az), az_cf=mk(az), az_ff=mk(az),
        solid_cc=None,
    )


def LatitudeLongitudeGrid(size, longitude=(0.0, 360.0), latitude=(-80.0, 80.0),
                          topology=None, halo=None, dtype="float64",
                          radius=EARTH_RADIUS):
    """Uniform latitude-longitude spherical-shell grid.

    Metrics follow the exact spherical-cell formulas: ``Δy = R Δφ``,
    ``Δx(φ) = R cos φ Δλ`` and ``Az = R² Δλ (sin φ₊ − sin φ₋)``.  Used for the
    SBP adjointness test, mirroring `test/test_rheology_energy_budget.jl:50-125`
    which runs on a LatitudeLongitudeGrid.
    """
    Nx, Ny = size
    topo = topology or (PERIODIC, BOUNDED)
    topo = (_topo(topo[0]), _topo(topo[1]))
    if halo is None:
        halo = 4
    Hx = 0 if topo[0] == FLAT else halo
    Hy = 0 if topo[1] == FLAT else halo

    npdt = np.dtype(dtype)
    lamc, lamf, dlam = _pad_coords(Nx, Hx, *longitude, np.dtype("float64"))
    phic, phif, dphi = _pad_coords(Ny, Hy, *latitude, np.dtype("float64"))

    deg = np.pi / 180.0
    dlam_r = dlam * deg
    dphi_r = dphi * deg

    # y-metrics: constant
    dy = radius * dphi_r

    # x-metrics: vary with latitude; rows are the y-location of each staggering
    cos_c = np.cos(phic * deg)
    cos_f = np.cos(phif * deg)
    dx_at_c = radius * cos_c * dlam_r   # (nyp,) at center latitudes
    dx_at_f = radius * cos_f * dlam_r   # (nyp,) at face latitudes

    # areas: R^2 dλ (sin φ_{j+1/2} - sin φ_{j-1/2})
    sin_f = np.sin(phif * deg)
    sin_c = np.sin(phic * deg)
    az_at_c = np.empty_like(sin_c)
    az_at_c[:-1] = radius**2 * dlam_r * (sin_f[1:] - sin_f[:-1])
    az_at_c[-1] = az_at_c[-2]
    az_at_f = np.empty_like(sin_c)
    az_at_f[1:] = radius**2 * dlam_r * (sin_c[1:] - sin_c[:-1])
    az_at_f[0] = az_at_f[1]

    row = lambda v: jnp.asarray(v[None, :], npdt)   # (1, nyp) broadcast rows
    mk = lambda v: jnp.asarray(v, npdt)

    return Grid(
        Nx=Nx, Ny=Ny, Hx=Hx, Hy=Hy, topology=topo, dtype=str(npdt),
        kind="latlon",
        xc=mk(lamc), xf=mk(lamf), yc=mk(phic), yf=mk(phif),
        dx_cc=row(dx_at_c), dx_fc=row(dx_at_c),
        dx_cf=row(dx_at_f), dx_ff=row(dx_at_f),
        dy_cc=mk(dy), dy_fc=mk(dy), dy_cf=mk(dy), dy_ff=mk(dy),
        az_cc=row(az_at_c), az_fc=row(az_at_c),
        az_cf=row(az_at_f), az_ff=row(az_at_f),
        solid_cc=None,
    )


def _gc_dist(lam1, phi1, lam2, phi2, radius):
    """Great-circle distance between (λ, φ) points in degrees."""
    d = np.pi / 180.0
    l1, p1, l2, p2 = lam1 * d, phi1 * d, lam2 * d, phi2 * d
    s = (np.sin((p2 - p1) / 2) ** 2
         + np.cos(p1) * np.cos(p2) * np.sin((l2 - l1) / 2) ** 2)
    return 2 * radius * np.arcsin(np.minimum(1.0, np.sqrt(s)))


def _fold_metric_halo(full, Nx, Hx, Ny, Hy, xface, yface):
    """Rewrite a padded metric array's north y-halo with exact fold images
    (north_fold grids).  Metrics are scalars under the 180° fold rotation
    (sign +1); the x-mirror follows the array's staggered location like
    `fields._fill_y_fold`.  The y-face seam column is symmetrized
    (0.5·(q + q_mirror)) so the seam row's update is exactly x-mirror
    symmetric.  Without this the y-halo keeps edge-clamped values, which
    match the fold image only approximately (by the cap construction's symmetry)."""
    if Hy == 0:
        return full
    p = np.arange(full.shape[0])
    if xface:
        src = ((Nx - (p - Hx)) % Nx) + Hx
    else:
        src = ((Nx - 1 - (p - Hx)) % Nx) + Hx
    r = full[src, :]
    if not yface:
        for k in range(Hy):
            full[:, Hy + Ny + k] = r[:, Hy + Ny - 1 - k]
    else:
        full[:, Hy + Ny] = 0.5 * (full[:, Hy + Ny] + r[:, Hy + Ny])
        for k in range(1, Hy):
            full[:, Hy + Ny + k] = full[src, Hy + Ny - k]
    return full


# staggered location (xface, yface) of each Grid metric-array field
_METRIC_LOCS = {
    "dx_cc": (False, False), "dy_cc": (False, False), "az_cc": (False, False),
    "dx_fc": (True, False), "dy_fc": (True, False), "az_fc": (True, False),
    "dx_cf": (False, True), "dy_cf": (False, True), "az_cf": (False, True),
    "dx_ff": (True, True), "dy_ff": (True, True), "az_ff": (True, True),
}


def CurvilinearGrid(corner_longitude, corner_latitude,
                    topology=(PERIODIC, BOUNDED), halo=4, dtype="float64",
                    radius=EARTH_RADIUS, north_fold=False):
    """General curvilinear (orthogonal spherical shell) grid from corner-node
    coordinate arrays — the machinery behind Oceananigans'
    `OrthogonalSphericalShellGrid`/`TripolarGrid` (SURVEY.md §2.3).

    ``corner_longitude``/``corner_latitude``: (Nx+1, Ny+1) arrays of the cell
    corner (f,f) node coordinates in degrees.  With periodic x, column Nx must
    duplicate column 0's physical position (seam closure).

    Staggered metric arrays are built from great-circle distances:
    Δx along the cell at each y-location, Δy along the cell at each
    x-location, and Az ≈ Δx·Δy at each staggered location.  Because the
    stress-divergence/strain operators are *algebraically* adjoint for any
    positive metric set, the SBP energy identity holds on any grid built
    here (tests/test_rheology_energy_budget.py covers the lat-lon case,
    tests/test_curvilinear.py a warped grid).
    """
    lam = np.asarray(corner_longitude, float)
    phi = np.asarray(corner_latitude, float)
    Nx, Ny = lam.shape[0] - 1, lam.shape[1] - 1
    topo = (_topo(topology[0]), _topo(topology[1]))
    Hx = 0 if topo[0] == FLAT else halo
    Hy = 0 if topo[1] == FLAT else halo
    npdt = np.dtype(dtype)

    # midpoints and centers from corners (index [i, j] = corner i-1/2, j-1/2),
    # averaged as 3-D unit vectors: naive λ averaging breaks at the ±180°
    # branch cut (a tripolar cap column straddling it got a ~180°-off
    # midpoint → a 5800 km cell) and degrades near the poles.
    def _to_xyz(lam_d, phi_d):
        lr, pr = np.deg2rad(lam_d), np.deg2rad(phi_d)
        cp = np.cos(pr)
        return np.stack([cp * np.cos(lr), cp * np.sin(lr), np.sin(pr)])

    def _to_ll(v):
        v = v / np.linalg.norm(v, axis=0, keepdims=True)
        return (np.rad2deg(np.arctan2(v[1], v[0])),
                np.rad2deg(np.arcsin(np.clip(v[2], -1.0, 1.0))))

    xyz = _to_xyz(lam, phi)
    lam_xm, phi_xm = _to_ll(xyz[:, :-1] + xyz[:, 1:])      # y-face midpoints (c,f)
    lam_ym, phi_ym = _to_ll(xyz[:, :, :-1] + xyz[:, :, 1:])  # x-face midpoints (f,c)
    lam_c, phi_c = _to_ll(xyz[:, :-1, :-1] + xyz[:, 1:, :-1]
                          + xyz[:, :-1, 1:] + xyz[:, 1:, 1:])

    # --- interior metric arrays ------------------------------------------------
    # Δx at (c,c): between the cell's west/east x-face midpoints
    dx_cc = _gc_dist(lam_ym[:-1], phi_ym[:-1], lam_ym[1:], phi_ym[1:], radius)
    # Δx at (c,f): length of the y-face (corner to corner)
    dx_cf_i = _gc_dist(lam[:-1], phi[:-1], lam[1:], phi[1:], radius)  # (Nx, Ny+1)
    # Δx at (f,c): between adjacent cell centers (periodic wrap in x)
    cm = np.roll(lam_c, 1, 0), np.roll(phi_c, 1, 0)
    dx_fc = _gc_dist(cm[0], cm[1], lam_c, phi_c, radius)              # (Nx, Ny)
    # Δx at (f,f): between adjacent y-face midpoints
    xm_m = np.roll(lam_xm, 1, 0), np.roll(phi_xm, 1, 0)
    dx_ff_i = _gc_dist(xm_m[0], xm_m[1], lam_xm, phi_xm, radius)      # (Nx, Ny+1)

    # Δy at (c,c): between south/north y-face midpoints
    dy_cc = _gc_dist(lam_xm[:, :-1], phi_xm[:, :-1], lam_xm[:, 1:], phi_xm[:, 1:], radius)
    # Δy at (f,c): length of the x-face
    dy_fc_i = _gc_dist(lam[:, :-1], phi[:, :-1], lam[:, 1:], phi[:, 1:], radius)  # (Nx+1, Ny)
    # Δy at (c,f): between adjacent cell centers in y (edge rows clamped)
    dy_cf_i = np.empty((Nx, Ny + 1))
    dy_cf_i[:, 1:-1] = _gc_dist(lam_c[:, :-1], phi_c[:, :-1], lam_c[:, 1:], phi_c[:, 1:], radius)
    dy_cf_i[:, 0] = dy_cf_i[:, 1]
    dy_cf_i[:, -1] = dy_cf_i[:, -2]
    # Δy at (f,f): between adjacent x-face midpoints in y (edge rows clamped)
    dy_ff_i = np.empty((Nx + 1, Ny + 1))
    dy_ff_i[:, 1:-1] = _gc_dist(lam_ym[:, :-1], phi_ym[:, :-1], lam_ym[:, 1:], phi_ym[:, 1:], radius)
    dy_ff_i[:, 0] = dy_ff_i[:, 1]
    dy_ff_i[:, -1] = dy_ff_i[:, -2]

    def _pad(q_int, fc_x, fc_y):
        """Periodic/edge-extend an interior metric array into padded form.
        fc_x/fc_y: whether the array's first/second dim is face-located
        (face arrays come in with Nx+1/Ny+1 entries; drop the duplicate).
        On folded grids the north y-halo gets exact fold images instead of
        the edge clamp (see `_fold_metric_halo`)."""
        q = q_int[:Nx, :Ny]
        full = np.empty((Nx + 2 * Hx, Ny + 2 * Hy))
        full[Hx:Hx + Nx, Hy:Hy + Ny] = q
        if Hx:
            if topo[0] == PERIODIC:
                full[:Hx, Hy:Hy + Ny] = q[Nx - Hx:, :]
                full[Hx + Nx:, Hy:Hy + Ny] = q[:Hx, :]
            else:
                full[:Hx, Hy:Hy + Ny] = q[:1, :]
                full[Hx + Nx:, Hy:Hy + Ny] = q[-1:, :]
        if Hy:
            full[:, :Hy] = full[:, Hy:Hy + 1]
            full[:, Hy + Ny:] = full[:, Hy + Ny - 1:Hy + Ny]
            if north_fold:
                full = _fold_metric_halo(full, Nx, Hx, Ny, Hy, fc_x, fc_y)
        return jnp.asarray(full, npdt)

    dx_cc_p = _pad(dx_cc, False, False)
    dx_fc_p = _pad(dx_fc, True, False)
    dx_cf_p = _pad(dx_cf_i, False, True)
    dx_ff_p = _pad(dx_ff_i, True, True)
    dy_cc_p = _pad(dy_cc, False, False)
    dy_fc_p = _pad(dy_fc_i, True, False)
    dy_cf_p = _pad(dy_cf_i, False, True)
    dy_ff_p = _pad(dy_ff_i, True, True)

    if north_fold:
        if topo[0] != PERIODIC or Nx % 2:
            raise ValueError("north_fold requires periodic x and even Nx")

    # 1-D coordinate stand-ins (index space); physical coords kept as metrics
    idx_x = np.arange(-Hx, Nx + Hx, dtype=float) + 0.5
    idx_xf = np.arange(-Hx, Nx + Hx, dtype=float)
    idx_y = np.arange(-Hy, Ny + Hy, dtype=float) + 0.5
    idx_yf = np.arange(-Hy, Ny + Hy, dtype=float)

    return Grid(
        Nx=Nx, Ny=Ny, Hx=Hx, Hy=Hy, topology=topo, dtype=str(npdt),
        kind="curvilinear", north_fold=north_fold,
        xc=jnp.asarray(idx_x, npdt), xf=jnp.asarray(idx_xf, npdt),
        yc=jnp.asarray(idx_y, npdt), yf=jnp.asarray(idx_yf, npdt),
        dx_cc=dx_cc_p, dx_fc=dx_fc_p, dx_cf=dx_cf_p, dx_ff=dx_ff_p,
        dy_cc=dy_cc_p, dy_fc=dy_fc_p, dy_cf=dy_cf_p, dy_ff=dy_ff_p,
        az_cc=dx_cc_p * dy_cc_p, az_fc=dx_fc_p * dy_fc_p,
        az_cf=dx_cf_p * dy_cf_p, az_ff=dx_ff_p * dy_ff_p,
        lon_cc=_pad(lam_c, False, False), lat_cc=_pad(phi_c, False, False),
        solid_cc=None,
    )


def TripolarGrid(size, southernmost_latitude=-80.0, transition_latitude=62.0,
                 cap_smoothness=2.5, poles_longitude=90.0,
                 halo=4, dtype="float64", radius=EARTH_RADIUS):
    """Tripolar-style global grid: latitude-longitude south of
    ``transition_latitude``, a conformal bipolar cap north of it with two
    grid poles joined by a Zipper fold (Murray 1996-class construction;
    Oceananigans `TripolarGrid` analog).

    The cap uses **elliptic conformal coordinates** on the polar
    stereographic plane: z = a·cosh(u + iv).  Constant-u curves are confocal
    ellipses around both foci (the grid poles at z = ±a) that degenerate
    onto the pole-joining segment at u = 0 — the fold seam; constant-v
    curves are confocal hyperbolae converging into the poles.  The map is
    conformal, so the grid is orthogonal in the cap; at the transition
    circle the ellipse has eccentricity ~(1 − tanh u_t), so larger
    ``cap_smoothness`` (= u_t) gives rounder transition rows.  The u-steps
    are geometrically graded (Madec & Imbard 1996-style smooth junction) so
    the first cap row spacing matches the lat-lon Δφ row spacing: the
    junction Δy kink stays within the cap's own row-to-row grading ratio.

    ``size = (Nx, Ny)``: Nx pseudo-longitudes (even), Ny total rows; about a
    quarter of the rows go to the cap.  ``poles_longitude``: longitude of
    one grid pole (the other sits at +180°).
    """
    Nx, Ny = size
    if Nx % 2:
        raise ValueError("TripolarGrid requires even Nx")
    Ny_cap = max(4, Ny // 4)
    Ny_s = Ny - Ny_cap

    deg = np.pi / 180.0

    # --- south: plain lat-lon rows φ_s .. φ_t --------------------------------
    i = np.arange(Nx + 1)
    lam_1d = 360.0 * i / Nx  # pseudo-longitude (offset applied at the end)
    phi_rows_s = southernmost_latitude + (transition_latitude
                                          - southernmost_latitude) * np.arange(Ny_s + 1) / Ny_s

    # --- cap: elliptic conformal coordinates on the stereographic plane ------
    # north-polar stereographic projection: r = tan((90 − φ)/2 · deg)
    r_t = np.tan((90.0 - transition_latitude) / 2 * deg)
    u_t = float(cap_smoothness)
    a = r_t / np.cosh(u_t)

    lam_corners = np.empty((Nx + 1, Ny + 1))
    phi_corners = np.empty((Nx + 1, Ny + 1))
    lam_corners[:, :Ny_s + 1] = lam_1d[:, None]
    phi_corners[:, :Ny_s + 1] = phi_rows_s[None, :]

    v = lam_1d * deg                       # pseudo-longitude angle

    # geometrically graded u-steps: first physical step ≈ the lat-lon row
    # spacing R·Δφ (v-averaged conformal factor a|sinh(u+iv)|·2/(1+r²)),
    # common ratio g solved so the steps sum to u_t.
    dphi = (transition_latitude - southernmost_latitude) / Ny_s * deg

    def _factor(u):
        w = np.sinh(u + 1j * v[:-1])
        r2 = np.abs(a * np.cosh(u + 1j * v[:-1])) ** 2
        return float(np.mean(np.abs(w) * 2.0 / (1.0 + r2)))

    du0 = dphi / (a * _factor(u_t))
    if 0 < du0 < u_t:
        lo, hi = 1e-3, 100.0
        for _ in range(200):
            g = 0.5 * (lo + hi)
            # np.power: overflow at large Ny_cap yields inf (shrinks hi)
            # instead of a Python-float OverflowError
            with np.errstate(over="ignore"):
                tot = du0 * (Ny_cap if abs(g - 1) < 1e-12
                             else (np.power(g, float(Ny_cap)) - 1) / (g - 1))
            lo, hi = (g, hi) if tot < u_t else (lo, g)
        # a cap with few rows relative to its extent would need runaway
        # growth; bound the grading ratio and let the junction keep a
        # modest residual kink instead of blowing up the inner rows
        if g > 1.25:
            g = 1.25
            du0 = u_t * (g - 1) / (g ** Ny_cap - 1)
        du = du0 * g ** np.arange(Ny_cap)
    else:  # degenerate sizing: fall back to uniform steps
        du = np.full(Ny_cap, u_t / Ny_cap)
    u_rows = u_t - np.concatenate([np.cumsum(du)[:-1], [u_t]])

    for j in range(1, Ny_cap + 1):
        z = a * np.cosh(u_rows[j - 1] + 1j * v)
        r = np.abs(z)
        lam_corners[:, Ny_s + j] = np.angle(z) / deg
        phi_corners[:, Ny_s + j] = 90.0 - 2.0 * np.arctan(r) / deg

    # rotate so the grid poles sit at poles_longitude / poles_longitude+180
    lam_corners = lam_corners + poles_longitude
    # the south block's pseudo-longitude equals real longitude; keep the seam
    # duplicated: column Nx = column 0 + 360 in the lat-lon block only.
    lam_corners[Nx, :Ny_s + 1] = lam_corners[0, :Ny_s + 1] + 360.0
    phi_corners[Nx, :] = phi_corners[0, :]
    lam_corners[Nx, Ny_s + 1:] = lam_corners[0, Ny_s + 1:]

    grid = CurvilinearGrid(lam_corners, phi_corners,
                           topology=(PERIODIC, BOUNDED), halo=halo,
                           dtype=dtype, radius=radius, north_fold=True)
    return grid


def ImmersedBoundaryGrid(grid: Grid, solid_mask):
    """Attach a land mask to ``grid``.

    ``solid_mask``: interior-shaped boolean array (True = land), or a callable
    ``f(x, y) -> bool`` over cell centers.  Equivalent in role to Oceananigans'
    `ImmersedBoundaryGrid` + `GridFittedBottom` as used by
    `examples/ice_advected_on_coastline.jl:54-98`.
    """
    if callable(solid_mask):
        x = np.asarray(grid.xc)[grid.Hx:grid.Hx + grid.Nx, None]
        y = np.asarray(grid.yc)[None, grid.Hy:grid.Hy + grid.Ny]
        solid_mask = solid_mask(x, y)
    solid_mask = np.asarray(solid_mask, bool)
    full = np.zeros(grid.shape, bool)
    full[grid.Hx:grid.Hx + grid.Nx, grid.Hy:grid.Hy + grid.Ny] = solid_mask
    # halo continuation consistent with the topology (periodic wrap / edge copy)
    full = _extend_mask(full, grid)
    return grid.evolve(solid_cc=jnp.asarray(full))


def _extend_mask(mask, grid):
    Hx, Hy, Nx, Ny = grid.Hx, grid.Hy, grid.Nx, grid.Ny
    if Hx > 0:
        if grid.topology[0] == PERIODIC:
            mask[:Hx] = mask[Nx:Nx + Hx]
            mask[Hx + Nx:] = mask[Hx:2 * Hx]
        else:  # bounded: outside the domain counts as solid
            mask[:Hx] = True
            mask[Hx + Nx:] = True
    if Hy > 0:
        if grid.topology[1] == PERIODIC:
            mask[:, :Hy] = mask[:, Ny:Ny + Hy]
            mask[:, Hy + Ny:] = mask[:, Hy:2 * Hy]
        else:
            mask[:, :Hy] = True
            if grid.north_fold:
                # the folded north edge is connected, not a wall: halo cells
                # are the fold image of the top interior rows (matching the
                # Zipper halo fill for cc fields, fields._fill_y_fold)
                p = np.arange(mask.shape[0])
                src = ((Nx - 1 - (p - Hx)) % Nx) + Hx
                for k in range(Hy):
                    mask[:, Hy + Ny + k] = mask[src, Hy + Ny - 1 - k]
            else:
                mask[:, Hy + Ny:] = True
    return mask


def with_halo(grid: Grid, halo):
    """Return a copy of ``grid`` with new halo widths (same interior).

    Analog of Oceananigans `with_halo`, used by the reference for the
    communication-avoiding split-explicit solver
    (`src/SeaIceDynamics/split_explicit_momentum_equations.jl:51-64`).

    ``halo``: one width for both dimensions, or a ``(halo_x, halo_y)`` pair —
    the wide-halo distributed solver inflates only mesh-split dimensions
    (an unmeshed dimension keeps its serial halo: its fills are local, and a
    halo wider than the interior extent would be unfillable).
    """
    hx, hy = (int(halo), int(halo)) if np.ndim(halo) == 0 else map(int, halo)
    Hx = 0 if grid.topology[0] == FLAT else hx
    Hy = 0 if grid.topology[1] == FLAT else hy
    if (Hx, Hy) == (grid.Hx, grid.Hy):
        return grid
    halo = max(Hx, Hy)  # constructors take one width; shrunk per-dim below
    if grid.kind == "rectilinear":
        x0 = float(grid.xf[grid.Hx])
        x1 = float(grid.xf[grid.Hx] + grid.Nx * (grid.xf[1] - grid.xf[0])) \
            if grid.topology[0] != FLAT else 1.0
        y0 = float(grid.yf[grid.Hy])
        y1 = float(grid.yf[grid.Hy] + grid.Ny * (grid.yf[1] - grid.yf[0])) \
            if grid.topology[1] != FLAT else 1.0
        g = RectilinearGrid((grid.Nx, grid.Ny), x=(x0, x1), y=(y0, y1),
                            topology=grid.topology, halo=halo, dtype=grid.dtype,
                            north_fold=grid.north_fold)
        # Preserve the original uniform metric scalars bit-exactly: the
        # float(xf[1]-xf[0]) round-trip above shifts Δx by ulps, and a
        # metric-perturbed wide grid seeds γ-sensitive EVP differences
        # between wide-halo and plain runs (serial ≡ distributed demands
        # identical arithmetic inputs).
        mets = {f: v for f in ("dx_cc", "dx_fc", "dx_cf", "dx_ff",
                               "dy_cc", "dy_fc", "dy_cf", "dy_ff",
                               "az_cc", "az_fc", "az_cf", "az_ff")
                if (v := getattr(grid, f)) is not None and np.ndim(v) == 0}
        if mets:
            g = g.evolve(**mets)
    elif grid.kind == "latlon":
        # reconstruct the constructor arguments from the stored grid: uniform
        # spacings, so extent = first face + N·Δ; radius from Δy = R Δφ_rad
        dlam = float(grid.xf[1] - grid.xf[0])
        dphi = float(grid.yf[1] - grid.yf[0])
        lon0 = float(grid.xf[grid.Hx])
        lat0 = float(grid.yf[grid.Hy])
        radius = float(jnp.ravel(jnp.asarray(grid.dy_cc))[0]) / (dphi * np.pi / 180.0)
        g = LatitudeLongitudeGrid((grid.Nx, grid.Ny),
                                  longitude=(lon0, lon0 + grid.Nx * dlam),
                                  latitude=(lat0, lat0 + grid.Ny * dphi),
                                  topology=grid.topology, halo=halo,
                                  dtype=grid.dtype, radius=radius)
    else:
        g = _curvilinear_with_halo(grid, Hx, Hy)
    if (g.Hx, g.Hy) != (Hx, Hy):
        g = _shrink_dim_halos(g, Hx, Hy)
    if grid.solid_cc is not None:
        interior_mask = np.asarray(grid.interior(grid.solid_cc))
        g = ImmersedBoundaryGrid(g, interior_mask)
    return g


def solid_crop_rows(g: Grid) -> int:
    """Count of southernmost interior rows that are FULLY solid (land across
    every x) on a serial immersed grid; 0 when there are none, when the
    grid is meshed (a per-shard crop would differ between shards), when the
    mask is traced, or when the whole domain is solid.

    On such a row every face is peripheral, so flux divergences are exactly
    zero and velocities stay zero; callers may skip the rows outright (see
    :func:`south_crop_grid`).  The land-masked tripolar Arctic basin of
    ``validation/run_tripolar_basin.py`` has 468 of its 960 rows fully
    solid (the 45–58°N closure)."""
    if g.mesh_axes is not None or g.solid_cc is None:
        return 0
    if isinstance(g.solid_cc, jax.core.Tracer):
        return 0
    s = np.asarray(g.solid_cc) > 0.5
    inter = s[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny]
    first = np.where(inter.all(axis=1), g.Ny, np.argmin(inter, axis=1))
    cs = int(first.min())
    return 0 if cs >= g.Ny else cs


def south_crop_grid(g: Grid, cs: int):
    """Grid view of padded rows [cs, nyp): same halos, Ny − cs interior rows
    (exact sub-array views of the same metric values).  Used to skip
    fully-solid southern rows (:func:`solid_crop_rows`) in pointwise and
    stencil passes: outputs for rows whose stencil stays ≥ Hy inside the
    view are bitwise those of the full pass.
    The view's south boundary semantics are meaningless — callers must
    discard its first Hy output rows (full rows [cs, cs+Hy), fully solid)."""

    def cutm(m):
        if m is None or np.ndim(m) == 0:
            return m
        m = jnp.asarray(m)
        if m.ndim == 2 and m.shape == g.shape:
            return m[:, cs:]
        if m.ndim == 2 and m.shape[0] == 1:   # (1, nyp) latitude row
            return m[:, cs:]
        raise NotImplementedError(f"south crop of metric shape {m.shape}")

    def cut1(c):
        return None if c is None else jnp.asarray(c)[cs:]

    return g.evolve(
        Ny=g.Ny - cs, yc=cut1(g.yc), yf=cut1(g.yf),
        **{f: cutm(getattr(g, f)) for f in _METRIC_LOCS},
        lon_cc=cutm(g.lon_cc), lat_cc=cutm(g.lat_cc),
        solid_cc=cutm(g.solid_cc))


def _shrink_dim_halos(g: Grid, Hx, Hy):
    """Slice a uniform-halo grid's coordinate/metric paddings down to
    per-dimension widths (exact: pure sub-array views of the same values)."""
    cx, cy = g.Hx - Hx, g.Hy - Hy
    assert cx >= 0 and cy >= 0

    def cut1(c, k, n):
        return c if (c is None or k == 0) else jnp.asarray(c)[k:k + n]

    def cutm(m):
        if m is None or np.ndim(m) == 0:
            return m
        m = jnp.asarray(m)
        if m.ndim == 2 and m.shape == g.shape:
            return m[cx:cx + g.Nx + 2 * Hx, cy:cy + g.Ny + 2 * Hy]
        if m.ndim == 2 and m.shape[0] == 1:   # (1, nyp) latitude row
            return m[:, cy:cy + g.Ny + 2 * Hy]
        raise NotImplementedError(f"halo shrink of metric shape {m.shape}")

    nxp, nyp = g.Nx + 2 * Hx, g.Ny + 2 * Hy
    return g.evolve(
        Hx=Hx, Hy=Hy,
        xc=cut1(g.xc, cx, nxp), xf=cut1(g.xf, cx, nxp),
        yc=cut1(g.yc, cy, nyp), yf=cut1(g.yf, cy, nyp),
        **{f: cutm(getattr(g, f)) for f in _METRIC_LOCS},
        lon_cc=cutm(g.lon_cc), lat_cc=cutm(g.lat_cc),
        solid_cc=None)


def _curvilinear_with_halo(grid: Grid, Hx, Hy):
    """Re-pad a curvilinear grid's metric arrays with new halo widths using
    the same extension rules as construction (periodic-x wrap / bounded edge
    clamp in x, edge clamp in y) — bit-identical to building the grid with
    the wider halo directly."""
    Nx, Ny = grid.Nx, grid.Ny
    npdt = grid.np_dtype

    def repad(m, fc_x=False, fc_y=False):
        q = np.asarray(grid.interior(m))
        full = np.empty((Nx + 2 * Hx, Ny + 2 * Hy))
        full[Hx:Hx + Nx, Hy:Hy + Ny] = q
        if Hx:
            if grid.topology[0] == PERIODIC:
                full[:Hx, Hy:Hy + Ny] = q[Nx - Hx:, :]
                full[Hx + Nx:, Hy:Hy + Ny] = q[:Hx, :]
            else:
                full[:Hx, Hy:Hy + Ny] = q[:1, :]
                full[Hx + Nx:, Hy:Hy + Ny] = q[-1:, :]
        if Hy:
            full[:, :Hy] = full[:, Hy:Hy + 1]
            full[:, Hy + Ny:] = full[:, Hy + Ny - 1:Hy + Ny]
            if grid.north_fold:
                full = _fold_metric_halo(full, Nx, Hx, Ny, Hy, fc_x, fc_y)
        return jnp.asarray(full, npdt)

    idx_x = np.arange(-Hx, Nx + Hx, dtype=float) + 0.5
    idx_xf = np.arange(-Hx, Nx + Hx, dtype=float)
    idx_y = np.arange(-Hy, Ny + Hy, dtype=float) + 0.5
    idx_yf = np.arange(-Hy, Ny + Hy, dtype=float)
    return grid.evolve(
        Hx=Hx, Hy=Hy,
        xc=jnp.asarray(idx_x, npdt), xf=jnp.asarray(idx_xf, npdt),
        yc=jnp.asarray(idx_y, npdt), yf=jnp.asarray(idx_yf, npdt),
        **{f: repad(getattr(grid, f), *_METRIC_LOCS[f]) for f in _METRIC_LOCS},
        lon_cc=None if grid.lon_cc is None else repad(grid.lon_cc),
        lat_cc=None if grid.lat_cc is None else repad(grid.lat_cc),
        solid_cc=None)
