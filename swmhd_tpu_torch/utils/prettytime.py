"""Human-readable durations — the `prettytime` the reference logs with
(jacobian_formulation/SWMHD_example.jl:55)."""

from __future__ import annotations


def prettytime(seconds: float) -> str:
    s = float(seconds)
    if s < 1e-6:
        return f"{s * 1e9:.3f} ns"
    if s < 1e-3:
        return f"{s * 1e6:.3f} µs"
    if s < 1.0:
        return f"{s * 1e3:.3f} ms"
    if s < 60.0:
        return f"{s:.3f} seconds"
    if s < 3600.0:
        m, rem = divmod(s, 60.0)
        return f"{int(m)} minutes {rem:.1f} seconds" if rem else f"{int(m)} minutes"
    h, rem = divmod(s, 3600.0)
    m = rem / 60.0
    return f"{int(h)} hours {m:.1f} minutes"
