"""Time-dependent forcing helpers: FieldTimeSeries with cyclical linear
time interpolation.

Replaces the Oceananigans `FieldTimeSeries` + `Cyclical()` time indexing used
by the reference's seasonal-cycle configuration
(`examples/arctic_basin_seasonal_cycle.jl:85-110`,
`thermodynamic_time_step.jl:326-334`).  Interpolation is jit-compatible
(`jnp.interp` on a periodically-wrapped clock time).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .utils import pytree_dataclass, static_field


@pytree_dataclass
class FieldTimeSeries:
    """A (time, field) series with linear interpolation in time.

    ``times``: (Nt,) sample times; ``data``: (Nt,) scalars or (Nt, ...) field
    snapshots.  With ``cyclical=True``, lookups wrap with period
    ``times[-1] − times[0] + Δt_last`` unless ``period`` is given.
    """
    times: object = None
    data: object = None
    period: object = None
    cyclical: bool = static_field(default=False)

    def __post_init__(self):
        # Convert host input only: pytree unflattening (jit, AOT lowering)
        # passes leaves that must stay as they are.
        for name in ("times", "data"):
            x = getattr(self, name)
            if isinstance(x, (list, tuple, np.ndarray)):
                object.__setattr__(self, name, jnp.asarray(x))
        if self.cyclical and self.period is None:
            times = self.times
            dt_last = times[-1] - times[-2]
            object.__setattr__(self, "period", times[-1] - times[0] + dt_last)

    def at_time(self, t):
        times = self.times
        if self.cyclical:
            t = times[0] + jnp.mod(t - times[0], self.period)
        data = self.data
        if data.ndim == 1:
            return jnp.interp(t, times, data,
                              left=data[0], right=data[-1])
        # field series: manual lerp over the leading axis
        idx = jnp.clip(jnp.searchsorted(times, t, side="right") - 1,
                       0, times.shape[0] - 2)
        t0, t1 = times[idx], times[idx + 1]
        w = jnp.where(t1 > t0, (t - t0) / jnp.where(t1 > t0, t1 - t0, 1.0), 0.0)
        w = jnp.clip(w, 0.0, 1.0)
        return (1 - w) * data[idx] + w * data[idx + 1]

    # allow use directly as a heat-flux specification
    def __call__(self, grid, Tu, clock, fields):
        return self.at_time(clock.time)
