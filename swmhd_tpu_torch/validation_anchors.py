"""Scenario anchors and acceptance logic of the validation runs, port of
``examples/validation_anchors.py``: the same ``REFERENCE`` table,
``TOL`` and ``judge``; ``summarize`` on the port's reader; and
:func:`compare_series`, which holds a series against the JAX package's
series of the same case row by row.

Anchors are transcribed from the reference's recorded energy plots (one
per scenario × formulation); ``examples/validate_reference.py`` gives
their provenance and tolerances.
"""

import numpy as np

from .io.readers import ScalarTimeSeries

# "dev_max" is the peak of the reference's "relative energy error (%)"
# panel = |E - E0| * 100 (an absolute deviation, SURVEY §2.3.4). Stop
# times differ per formulation (whatever the recorded runs used). ke0 is
# omitted for rest starts (== 0).
REFERENCE = {
    ("vector_invariant", "64x64_two_Gaussians_low_B"):
        dict(stop=70.0, ke_end=0.0027, me0=0.0217, me_end=0.0187,
             dev_max=0.027),
    ("vector_invariant", "64x64_two_Gaussians_high_B"):
        dict(stop=35.0, ke_end=0.051, me0=0.542, me_end=0.455, dev_max=3.7),
    ("vector_invariant", "64x64_low_B_low_U"):
        dict(stop=15.0, ke0=0.3927, ke_end=0.18, me0=0.125, me_end=0.313,
             dev_max=0.78),
    ("vector_invariant", "128x128_two_Gaussians_low_B"):
        dict(stop=60.0, ke_end=0.0029, me0=0.0218, me_end=0.0187,
             dev_max=0.010),
    ("vector_invariant", "128x128_two_Gaussians_high_B"):
        dict(stop=35.0, ke_end=0.079, me0=0.546, me_end=0.50, dev_max=5.3),
    ("vector_invariant", "128x128_low_B_low_U"):
        dict(stop=15.0, ke0=0.393, ke_end=0.155, me0=0.125, me_end=0.357,
             dev_max=0.53),
    ("conservative", "64x64_two_Gaussians_low_B"):
        dict(stop=60.0, ke_end=0.00315, me0=0.0217, me_end=0.0195,
             dev_max=0.107),
    ("conservative", "64x64_two_Gaussians_high_B"):
        dict(stop=10.0, ke_end=0.076, me0=0.542, me_end=0.470, dev_max=1.2),
    ("conservative", "64x64_low_B_low_U"):
        dict(stop=15.0, ke0=0.392, ke_end=0.18, me0=0.125, me_end=0.313,
             dev_max=1.03),
    ("conservative", "128x128_two_Gaussians_low_B"):
        dict(stop=60.0, ke_end=0.0035, me0=0.0218, me_end=0.0216,
             dev_max=0.35),
    ("conservative", "128x128_two_Gaussians_high_B"):
        dict(stop=35.0, ke_end=0.135, me0=0.545, me_end=0.537, dev_max=22.0),
    ("conservative", "128x128_low_B_low_U"):
        dict(stop=15.0, ke0=0.393, ke_end=0.155, me0=0.125, me_end=0.355,
             dev_max=0.39),
}

# Acceptance: exact anchors (initial energies are pure functions of the
# pinned ICs) tight; end-state anchors loose (different WENO details and
# rounding legitimately shift trajectories); the deviation envelope —
# the reference's own conservation gate — within 3x the recorded peak.
TOL = dict(ic_rel=0.03, end_rel=0.30, dev_factor=3.0)

# the 12 (formulation, scenario) pairs in the order of the JAX package's
# f32 validation on the TPU (examples/validate_tpu_fused.py)
CASES = [(f, f"{N}x{N}_{tag}")
         for N in (64, 128)
         for tag in ("two_Gaussians_low_B", "two_Gaussians_high_B",
                     "low_B_low_U")
         for f in ("vector_invariant", "conservative")]

ENERGIES = ("kinetic_energy", "magnetic_energy", "potential_energy",
            "total_energy")


def summarize(csv):
    ts = ScalarTimeSeries(csv)
    dev = np.abs(ts.total_energy - ts.total_energy[0]) * 100.0
    return dict(ke0=float(ts.kinetic_energy[0]),
                ke_end=float(ts.kinetic_energy[-1]),
                me0=float(ts.magnetic_energy[0]),
                me_end=float(ts.magnetic_energy[-1]),
                pe_dev_end=float(ts.potential_energy[-1]),
                dev_max=float(dev.max()))


def judge(ref, got, tol=None):
    tol = tol or TOL
    checks = {}
    checks["me0"] = abs(got["me0"] - ref["me0"]) <= tol["ic_rel"] * ref["me0"]
    if "ke0" in ref:
        checks["ke0"] = (abs(got["ke0"] - ref["ke0"])
                         <= tol["ic_rel"] * ref["ke0"])
    else:
        checks["ke0"] = got["ke0"] <= tol.get("ke0_abs", 1e-12)
    for k in ("ke_end", "me_end"):
        checks[k] = (abs(got[k] - ref[k]) <= tol["end_rel"] * ref[k])
    checks["dev_max"] = got["dev_max"] <= tol["dev_factor"] * ref["dev_max"]
    return checks


def compare_series(csv, jax_csv, early_rows=500, prefix=False):
    """How far the energy series ``csv`` lies from ``jax_csv``: for each
    of :data:`ENERGIES`, ``{"early_max": max |Δ| over the first
    ``early_rows`` rows, "all_max": max |Δ| over all rows, "early_rows",
    "rows"}``.

    The two series must have the same rows: a different row count or an
    ``iteration`` or ``time`` column that differs (beyond the last digits
    of a sum of time steps) raises ``ValueError``, never a truncation.
    With ``prefix`` the series may be a shorter run of the same case, held
    against as many leading rows of ``jax_csv``."""
    ours, theirs = ScalarTimeSeries(csv), ScalarTimeSeries(jax_csv)
    n, m = len(ours.time), len(theirs.time)
    if n != m and not (prefix and n <= m):
        raise ValueError(f"{csv} has {n} rows, {jax_csv} has {m}")
    rows = slice(0, n)
    if not np.array_equal(ours.iteration, theirs.iteration[rows]):
        raise ValueError(f"the iteration columns of {csv} and {jax_csv} "
                         f"differ")
    t, t_jax = ours.time, theirs.time[rows]
    if not np.allclose(t, t_jax, rtol=1e-12, atol=1e-12):
        k = int(np.argmax(np.abs(t - t_jax)))
        raise ValueError(f"the time columns of {csv} and {jax_csv} differ: "
                         f"row {k} has {t[k]!r} against {t_jax[k]!r}")
    early = min(early_rows, n)
    out = {}
    for name in ENERGIES:
        d = np.abs(ours[name] - theirs[name][rows])
        out[name] = dict(early_max=float(d[:early].max()),
                         all_max=float(d.max()), early_rows=early, rows=n)
    return out
