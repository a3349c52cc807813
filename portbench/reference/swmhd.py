"""Plain PyTorch reference of the SWMHD RK3 step and its energy series.

A frozen, self-contained copy of the shallow-water MHD scheme the
benchmark's configurations state: an Arakawa C-grid of ``(Nx, Ny)``
arrays (axis 0 = x), periodic in x, periodic or walled in y, WENO5-Z
reconstruction of momentum (the VelocityStencil vorticity flux in the
vector-invariant formulation), mass and tracer, an f-plane, the jacobian
Lorentz force (vector-invariant) or the divergence form ∇·(hB⊗B) with
UpwindBiased3 B (conservative), a static background γ·y of A, and the
Le–Moin low-storage RK3. The energies are the five of the CLI's series.

It imports no part of the program under test. It computes in the dtype of
the fields it is given: float64 is the benchmark's reference; its control
is one step below the configuration's dtype, bfloat16 for a float32
configuration and float32 for a float64 one (``portbench.check.CONTROL``).
Float32 keeps the exponent-bit rescaling of the WENO smoothness
indicators; any other type below float64 rescales by a division.
"""

from __future__ import annotations

import dataclasses

import torch

PERIODIC = "periodic"
BOUNDED = "bounded"
VECTOR_INVARIANT = "vector_invariant"
CONSERVATIVE = "conservative"
RK3_GAMMA = (8.0 / 15.0, 5.0 / 12.0, 3.0 / 4.0)
RK3_ZETA = (0.0, -17.0 / 60.0, -5.0 / 12.0)
WENO_EPS = 1e-8
WENO_GAMMA = (0.1, 0.6, 0.3)
ENERGY_NAMES = ("cross_helicity", "kinetic_energy", "magnetic_energy",
                "potential_energy", "total_energy")


# the scheme this reference computes: what a configuration has to state
SCHEME = {"momentum_advection": "weno5", "mass_advection": "weno5",
          "tracer_advection": "weno5", "closure": None,
          "time_stepper": "Le-Moin low-storage RK3"}
SCHEME_OF = {VECTOR_INVARIANT: {"lorentz": "jacobian",
                                "vector_invariant_stencil": "velocity"},
             CONSERVATIVE: {"lorentz": "divergence",
                            "lorentz_reconstruction": "upwind3"}}


def check_scheme(conf: dict):
    """Raise where the configuration ``conf`` states a scheme other than
    the one this reference computes."""
    want = {**SCHEME, **SCHEME_OF[conf["formulation"]]}
    wrong = {k: conf.get(k, "(none)") for k, v in want.items()
             if conf.get(k, "(none)") != v}
    if wrong:
        raise ValueError(f"the reference computes {want}; the "
                         f"configuration states {wrong}")


@dataclasses.dataclass(frozen=True)
class Grid:
    """The square domain [-L/2, L/2]² of ``n``² cells."""
    n: int
    L: float
    topology_y: str = PERIODIC

    @property
    def dx(self):
        return self.L / self.n

    dy = dx

    def nodes(self, loc, dtype=torch.float64, device="cpu"):
        """Coordinate meshes of ``loc`` in {cc, fc, cf}: a face is the
        left edge of its cell."""
        k = torch.arange(self.n, dtype=dtype, device=device)
        x = -self.L / 2 + self.dx * (k + (0.5 if loc[0] == "c" else 0.0))
        y = -self.L / 2 + self.dy * (k + (0.5 if loc[1] == "c" else 0.0))
        return torch.meshgrid(x, y, indexing="ij")


@dataclasses.dataclass(frozen=True)
class Model:
    grid: Grid
    formulation: str
    g: float
    f: float
    gamma: float = 0.0          # the background gradient of A in y


# -- shifts, differences, means -------------------------------------------------

def sx(a, n, G):
    """out[i, j] = a[i + n, j]; x is periodic."""
    return a if n == 0 else torch.roll(a, -n, 0)


def sy(a, n, G):
    """out[i, j] = a[i, j + n], periodic or clamped at the walls."""
    if n == 0:
        return a
    if G.topology_y == PERIODIC:
        return torch.roll(a, -n, 1)
    idx = torch.clamp(torch.arange(a.shape[1], device=a.device) + n, 0,
                      a.shape[1] - 1)
    return torch.index_select(a, 1, idx)


def ddx_f(a, G):
    return (a - sx(a, -1, G)) / G.dx


def ddy_f(a, G):
    return (a - sy(a, -1, G)) / G.dy


def dx_f(a, G):
    return a - sx(a, -1, G)


def dx_c(a, G):
    return sx(a, 1, G) - a


def dy_f(a, G):
    return a - sy(a, -1, G)


def dy_c(a, G):
    return sy(a, 1, G) - a


def ddx_c_flux(f, G):
    return (sx(f, 1, G) - f) / G.dx


def ddy_c_flux(f, G):
    up = sy(f, 1, G)
    if G.topology_y == BOUNDED:       # no flux through the far wall
        j = torch.arange(f.shape[1], device=f.device).unsqueeze(0)
        up = torch.where(j == G.n - 1, 0.0, up)
    return (up - f) / G.dy


def ix_f(a, G):
    return 0.5 * (a + sx(a, -1, G))


def ix_c(a, G):
    return 0.5 * (sx(a, 1, G) + a)


def iy_f(a, G):
    return 0.5 * (a + sy(a, -1, G))


def iy_c(a, G):
    return 0.5 * (sy(a, 1, G) + a)


def ixy_fc(a, G):
    return ix_f(iy_c(a, G), G)


def ixy_cf(a, G):
    return ix_c(iy_f(a, G), G)


def _jy(a):
    return torch.arange(a.shape[1], device=a.device).unsqueeze(0)


# -- reconstructions ------------------------------------------------------------

def upwind(u_t, pl_, pr):
    return 0.5 * ((u_t + torch.abs(u_t)) * pl_ + (u_t - torch.abs(u_t)) * pr)


def _left3(c, sh):
    return (2.0 * c + 5.0 * sh(c, -1) - sh(c, -2)) / 6.0


def _right3(c, sh):
    return (-sh(c, 1) + 5.0 * c + 2.0 * sh(c, -1)) / 6.0


def _degrade3(r3, c, G, left):
    """Third order falls to first within two cells of a wall in y."""
    if G.topology_y != BOUNDED:
        return r3
    j, N = _jy(c), G.n
    first = sy(c, -1, G) if left else c
    if left:
        return torch.where(j > N - 1, first, torch.where(j < 2, first, r3))
    return torch.where(j > N - 2, first, torch.where(j < 1, first, r3))


def left3_x_f(c, G):
    return _left3(c, lambda a, n: sx(a, n, G))


def right3_x_f(c, G):
    return _right3(c, lambda a, n: sx(a, n, G))


def left3_y_f(c, G):
    return _degrade3(_left3(c, lambda a, n: sy(a, n, G)), c, G, True)


def right3_y_f(c, G):
    return _degrade3(_right3(c, lambda a, n: sy(a, n, G)), c, G, False)


def _sq(x):
    return x * x


def _normalize_betas(b, eps):
    s = b[0] + b[1] + b[2] + eps
    if s.dtype == torch.float32:
        bits = s.view(torch.int32)
        inv = torch.clamp(0x7F000000 - (bits & 0x7F800000),
                          min=0x00800000).to(torch.int32).view(torch.float32)
    else:
        inv = 1.0 / s
    return (b[0] * inv, b[1] * inv, b[2] * inv), eps * inv


def _combine(ps, b):
    """WENO-Z weights in the divide-free rational form."""
    eps = WENO_EPS
    if b[0].dtype != torch.float64:
        b, eps = _normalize_betas(b, eps)
    tau2 = _sq(b[0] - b[2])
    q0, q1, q2 = _sq(b[0] + eps), _sq(b[1] + eps), _sq(b[2] + eps)
    a0 = WENO_GAMMA[0] * (q0 + tau2) * (q1 * q2)
    a1 = WENO_GAMMA[1] * (q1 + tau2) * (q0 * q2)
    a2 = WENO_GAMMA[2] * (q2 + tau2) * (q0 * q1)
    return (a0 * ps[0] + a1 * ps[1] + a2 * ps[2]) / (a0 + a1 + a2)


def _betas(c, sh):
    cm3, cm2, cm1, c0, cp1 = sh(c, -3), sh(c, -2), sh(c, -1), c, sh(c, 1)
    b0 = (13.0 / 12.0) * _sq(cm3 - 2 * cm2 + cm1) \
        + 0.25 * _sq(cm3 - 4 * cm2 + 3 * cm1)
    b1 = (13.0 / 12.0) * _sq(cm2 - 2 * cm1 + c0) + 0.25 * _sq(cm2 - c0)
    b2 = (13.0 / 12.0) * _sq(cm1 - 2 * c0 + cp1) \
        + 0.25 * _sq(3 * cm1 - 4 * c0 + cp1)
    return (b0, b1, b2)


def _right_betas(bl, sh):
    return (sh(bl[2], 1), sh(bl[1], 1), sh(bl[0], 1))


def _cand_left(c, sh):
    cm3, cm2, cm1, c0, cp1 = sh(c, -3), sh(c, -2), sh(c, -1), c, sh(c, 1)
    return ((2.0 * cm3 - 7.0 * cm2 + 11.0 * cm1) / 6.0,
            (-cm2 + 5.0 * cm1 + 2.0 * c0) / 6.0,
            (2.0 * cm1 + 5.0 * c0 - cp1) / 6.0)


def _cand_right(c, sh):
    cm2, cm1, c0, cp1, cp2 = sh(c, -2), sh(c, -1), c, sh(c, 1), sh(c, 2)
    return ((2.0 * cp2 - 7.0 * cp1 + 11.0 * c0) / 6.0,
            (-cp1 + 5.0 * c0 + 2.0 * cm1) / 6.0,
            (2.0 * c0 + 5.0 * cm1 - cm2) / 6.0)


def _weno_pair(c, sh):
    bl = _betas(c, sh)
    return (_combine(_cand_left(c, sh), bl),
            _combine(_cand_right(c, sh), _right_betas(bl, sh)))


def weno_x_f(c, G):
    return _weno_pair(c, lambda a, n: sx(a, n, G))


def weno_y_f(c, G):
    l, r = _weno_pair(c, lambda a, n: sy(a, n, G))
    if G.topology_y != BOUNDED:
        return l, r
    j, N = _jy(c), G.n
    return (torch.where((j < 3) | (j > N - 2), left3_y_f(c, G), l),
            torch.where((j < 2) | (j > N - 3), right3_y_f(c, G), r))


def weno_x_c(u, G):
    l, r = weno_x_f(u, G)
    return sx(l, 1, G), sx(r, 1, G)


def weno_y_c(v, G):
    l, r = weno_y_f(v, G)
    return sy(l, 1, G), sy(r, 1, G)


# -- tendencies -----------------------------------------------------------------

def _mask_v(v, G):
    """No flow through the wall face 0 of a walled y."""
    if G.topology_y == BOUNDED:
        return torch.where(_jy(v) == 0, 0.0, v)
    return v


def _tracer(A, h, Uf, Vf, divU, m):
    G = m.grid
    fx = upwind(Uf, *weno_x_f(A, G))
    fy = upwind(Vf, *weno_y_f(A, G))
    GA = (A * divU - (ddx_c_flux(fx, G) + ddy_c_flux(fy, G))) / h
    if m.gamma:
        GA = GA - m.gamma * iy_c(Vf, G) / h
    return GA


def _vorticity_flux(u, v, G):
    """⟨ζ v⟩ᵘᵖ at (f,c) and −⟨ζ u⟩ᵘᵖ at (c,f), WENO5 candidates of ζ
    weighted by the mean smoothness of u and v at corners."""
    zeta = ddx_f(v, G) - ddy_f(u, G)
    u_ff, v_ff = iy_f(u, G), ix_f(v, G)

    def flux(sh, transverse):
        z = sh(zeta, 1)
        bu, bv = _betas(sh(u_ff, 1), sh), _betas(sh(v_ff, 1), sh)
        bl = tuple(0.5 * (x + y) for x, y in zip(bu, bv))
        zl = _combine(_cand_left(z, sh), bl)
        zr = _combine(_cand_right(z, sh), _right_betas(bl, sh))
        return upwind(transverse, zl, zr)

    return (flux(lambda a, n: sy(a, n, G), ixy_fc(v, G)),
            -flux(lambda a, n: sx(a, n, G), ixy_cf(u, G)))


def _lorentz_jacobian(A, h, m):
    G = m.grid
    dAdx = ddx_f(A, G)
    dAdy = ddy_f(A, G) + m.gamma
    Bx = -iy_c(dAdy, G) / h
    By = ix_c(dAdx, G) / h
    jx = dAdx * ixy_fc(ddy_f(Bx, G), G) - ixy_fc(dAdy, G) * ddx_f(Bx, G)
    jy = ixy_cf(dAdx, G) * ddy_f(By, G) - dAdy * ixy_cf(ddx_f(By, G), G)
    return jx / ix_f(h, G), jy / iy_f(h, G)


def _lorentz_divergence(A, h, m):
    G = m.grid
    hBx = -ixy_fc(ddy_f(A, G) + m.gamma, G)
    hBy = ixy_cf(ddx_f(A, G), G)
    Bx, By = hBx / ix_f(h, G), hBy / iy_f(h, G)
    Ax, Ay, Az = G.dy, G.dx, G.dx * G.dy
    fxx = Ax * upwind(ix_c(hBx, G), sx(left3_x_f(Bx, G), 1, G),
                      sx(right3_x_f(Bx, G), 1, G))
    fyx = Ay * upwind(ix_f(hBy, G), left3_y_f(Bx, G), right3_y_f(Bx, G))
    fu = (dx_f(fxx, G) + dy_c(fyx, G)) / Az
    fxy = Ax * upwind(iy_f(hBx, G), left3_x_f(By, G), right3_x_f(By, G))
    fyy = Ay * upwind(iy_c(hBy, G), sy(left3_y_f(By, G), 1, G),
                      sy(right3_y_f(By, G), 1, G))
    fv = (dx_c(fxy, G) + dy_f(fyy, G)) / Az
    return fu, fv


def tendencies(m: Model, h, u, v, A):
    """∂t of (h, u, v, A); u, v are the transports uh, vh in the
    conservative formulation."""
    G = m.grid
    if m.formulation == VECTOR_INVARIANT:
        Uf = upwind(u, *weno_x_f(h, G))
        Vf = upwind(v, *weno_y_f(h, G))
        divU = ddx_c_flux(Uf, G) + ddy_c_flux(Vf, G)
        vu, vv = _vorticity_flux(u, v, G)
        K = 0.5 * (ix_c(u * u, G) + iy_c(v * v, G))
        Gu = vu - ddx_f(K + m.g * h, G)
        Gv = vv - ddy_f(K + m.g * h, G)
        Gu = Gu + m.f * ixy_fc(v, G)
        Gv = Gv + -m.f * ixy_cf(u, G)
        GA = _tracer(A, h, Uf, Vf, divU, m)
        fu, fv = _lorentz_jacobian(A, h, m)
    else:
        uh, vh = u, v
        h_fx, h_fy = ix_f(h, G), iy_f(h, G)
        uu, vv_ = uh / h_fx, vh / h_fy
        fxx = upwind(ix_c(uh, G), *weno_x_c(uu, G))
        fyx = upwind(ix_f(vh, G), *weno_y_f(uu, G))
        Gu = -(ddx_f(fxx, G) + ddy_c_flux(fyx, G))
        fxy = upwind(iy_f(uh, G), *weno_x_f(vv_, G))
        fyy = upwind(iy_c(vh, G), *weno_y_c(vv_, G))
        Gv = -(ddx_c_flux(fxy, G) + ddy_f(fyy, G))
        Gu = Gu - m.g * h_fx * ddx_f(h, G)
        Gv = Gv - m.g * h_fy * ddy_f(h, G)
        Gu = Gu + m.f * ixy_fc(vh, G)
        Gv = Gv + -m.f * ixy_cf(uh, G)
        divU = ddx_c_flux(uh, G) + ddy_c_flux(vh, G)
        GA = _tracer(A, h, uh, vh, divU, m)
        fu, fv = _lorentz_divergence(A, h, m)
    Gh = -divU
    return Gh, Gu + fu, _mask_v(Gv + fv, G), GA


def step(m: Model, fields, dt):
    """One Le–Moin RK3 step of the tuple (h, u, v, A)."""
    s, g_prev = tuple(fields), None
    for gamma, zeta in zip(RK3_GAMMA, RK3_ZETA):
        G = tendencies(m, *s)
        if g_prev is None:
            s = tuple(x + dt * gamma * gn for x, gn in zip(s, G))
        else:
            s = tuple(x + dt * (gamma * gn + zeta * gp)
                      for x, gn, gp in zip(s, G, g_prev))
        g_prev = G
    return s


# -- energies -------------------------------------------------------------------

def energies(m: Model, fields, h0):
    """The CLI's five series values of the fields (h, u, v, A) as 0-d
    tensors; potential energy against the initial height ``h0``."""
    G = m.grid
    h, u, v, A = fields
    if m.formulation == CONSERVATIVE:
        u, v = u / ix_f(h, G), v / iy_f(h, G)
    area = G.L * G.L

    def integral(a):
        return torch.mean(a) * area

    Bx = -iy_c(ddy_f(A, G) + m.gamma, G) / h
    By = ix_c(ddx_f(A, G), G) / h
    ke = integral(0.5 * h * (ix_c(u * u, G) + iy_c(v * v, G)))
    me = integral(0.5 * h * (Bx * Bx + By * By))
    pe = integral(0.5 * m.g * (h - h0) ** 2)
    ch = integral(h * (ix_c(u, G) * Bx + iy_c(v, G) * By))
    return {"cross_helicity": ch, "kinetic_energy": ke,
            "magnetic_energy": me, "potential_energy": pe,
            "total_energy": ke + me + pe}


# -- initial states -------------------------------------------------------------

def _two_gaussians(amplitude):
    return lambda x, y: (amplitude * torch.exp(-((x - 0.5) ** 2 + y ** 2))
                         - amplitude * torch.exp(-((x + 0.5) ** 2 + y ** 2)))


def _vortex(U):
    return (lambda x, y: U * y * torch.exp(-(x ** 2 + y ** 2)),
            lambda x, y: -U * x * torch.exp(-(x ** 2 + y ** 2)))


def bumps(spec, loc, grid, dtype, device):
    """Σ a·exp(-((x-x0)² + (y-y0)²)/w²) over ``spec`` = [(x0, y0, a, w)]
    on the mesh of ``loc``."""
    X, Y = grid.nodes(loc, dtype, device)
    out = torch.zeros_like(X)
    for x0, y0, a, w in spec:
        out = out + a * torch.exp(-((X - x0) ** 2 + (Y - y0) ** 2) / w ** 2)
    return out


def initial_state(m: Model, initial: dict, perturbation: dict,
                  dtype=torch.float64, device="cpu"):
    """(h, u, v, A) of a scenario's initial state plus the seeded bumps:
    ``initial`` names the scenario's fields (``A``: ["two_gaussians", a];
    ``uv``: ["vortex", U] or null; ``h0``), ``perturbation`` holds the
    bumps of h and A (:func:`bumps`)."""
    G = m.grid
    h0 = float(initial["h0"])
    A = torch.zeros((G.n, G.n), dtype=dtype, device=device)
    if initial.get("A"):
        kind, amp = initial["A"]
        if kind != "two_gaussians":
            raise ValueError(f"no initial A {kind!r} in the reference")
        A = _two_gaussians(amp)(*G.nodes("cc", dtype, device))
    u = torch.zeros_like(A)
    v = torch.zeros_like(A)
    if initial.get("uv"):
        kind, U = initial["uv"]
        if kind != "vortex":
            raise ValueError(f"no initial velocity {kind!r} in the reference")
        fu, fv = _vortex(U)
        scale = h0 if m.formulation == CONSERVATIVE else 1.0
        u = fu(*G.nodes("fc", dtype, device)) * scale
        v = fv(*G.nodes("cf", dtype, device)) * scale
    v = _mask_v(v, G)
    h = torch.full_like(A, h0) + bumps(perturbation["h"], "cc", G, dtype,
                                       device)
    A = A + bumps(perturbation["A"], "cc", G, dtype, device)
    return (h, u, v, A)
