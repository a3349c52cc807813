"""f-plane Coriolis, port of :mod:`swmhd_tpu.physics.coriolis`.

The v felt by the u-equation lives at (f,c) and is the 4-point mean
ℑxyᶠᶜ(v); symmetrically for u in the v-equation."""

from __future__ import annotations

import dataclasses

from .. import operators as op


@dataclasses.dataclass(frozen=True)
class FPlane:
    f: float = 0.0

    def tendency_u(self, v, grid):
        """+f v̄ at (f,c)."""
        return self.f * op.ixy_fc(v, grid)

    def tendency_v(self, u, grid):
        """−f ū at (c,f)."""
        return -self.f * op.ixy_cf(u, grid)
