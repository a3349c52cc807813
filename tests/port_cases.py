"""Model cases shared by the port's tests, their worker processes and
``chip_smoke.py``: the ``bench.py`` configuration and its initial
fields, the model options the kernels take as runtime switches, the
branches the kernel is held to its plain version on, and tiles cut from a
whole-grid state as a halo exchange would give them.

Imports nothing of the card: each function imports ``torch`` and the
package where it needs them.
"""

VI, CONS = "vector_invariant", "conservative"
PERIODIC = ("periodic", "periodic")
BOUNDED_Y = ("periodic", "bounded")
BOUNDED_XY = ("bounded", "bounded")
# (formulation, topology, A background gradient) of :func:`branch_cases`
CONFIGS = [(VI, PERIODIC, 0.0), (CONS, PERIODIC, 0.0),
           (VI, BOUNDED_Y, -0.05), (CONS, BOUNDED_Y, -0.05),
           (VI, BOUNDED_XY, -0.05), (CONS, BOUNDED_XY, -0.05)]
TILE_HALO = 6             # model.exchange_halo


def rel_err(a, b, scale=None):
    """max|a-b| / max|b| (or / scale), in float64."""
    a, b = a.double(), b.double()
    s = float(b.abs().max()) if scale is None else scale
    return float((a - b).abs().max()) / max(s, 1e-300)


def initial_fields(xp, h_bump=0.0, walls=False):
    """The bench.py initial condition as ``initial_state`` keyword
    functions of the array module ``xp``: vortex, Gaussian dipole A and
    h = 1 + h_bump·e^{-r²} (the vortex is the transport in the
    conservative formulation; h = 1 makes it the same velocity). With
    ``walls``, plus smooth terms (periodic in x over the [-5, 5]² domain)
    that stay O(0.1) at the domain edges, so the rows next to a wall have
    structure where the rest is ≈e^-25."""
    e = lambda x, y: xp.exp(-(x ** 2 + y ** 2))
    f = dict(
        u=lambda x, y: 5 * y * e(x, y),
        v=lambda x, y: -5 * x * e(x, y),
        h=lambda x, y: 1.0 + h_bump * e(x, y),
        A=lambda x, y: 0.5 * xp.exp(-((x - 0.5) ** 2 + y ** 2))
        - 0.5 * xp.exp(-((x + 0.5) ** 2 + y ** 2)))
    if not walls:
        return f
    k = xp.pi / 5
    add = dict(
        u=lambda x, y: 0.3 * xp.cos(0.6 * y) + 0.1 * xp.sin(k * x),
        v=lambda x, y: 0.2 * xp.cos(k * x) * (1 + 0.3 * y),
        h=lambda x, y: 0.05 * xp.cos(k * x) * xp.sin(0.3 * y + 0.5),
        A=lambda x, y: 0.1 * xp.sin(k * x) * xp.cos(0.5 * y))
    return {n: (lambda a, b: lambda x, y: a(x, y) + b(x, y))(f[n], add[n])
            for n in f}


def bench_model(N, dtype, device, formulation=VI, topology=PERIODIC,
                gamma=0.0, walls=False, M=None, h_bump=0.0):
    """The bench.py configuration on an N×M grid (M: N), with
    :func:`initial_fields`, and with ``h_bump`` a Gaussian of that height
    added to h at (1, 0): off the vortex's centre, so that the vortex
    carries it (a bump at the centre it leaves where it is, the G of h
    ≈0)."""
    import torch
    from swmhd_tpu_torch import (Grid, ShallowWaterModel, FPlane,
                                 jacobian_lorentz_forcing,
                                 divergence_lorentz_forcing)
    g = Grid.regular(N, M or N, (-5.0, 5.0), (-5.0, 5.0),
                     topology=topology, dtype=dtype, device=device)
    forcing = (divergence_lorentz_forcing(gamma) if formulation == CONS
               else jacobian_lorentz_forcing(gamma))
    model = ShallowWaterModel(grid=g, formulation=formulation,
                              gravitational_acceleration=9.81,
                              coriolis=FPlane(1.0), forcing=forcing,
                              A_background_gradient_y=gamma)
    fields = initial_fields(torch, walls=walls)
    if h_bump:
        h = fields["h"]
        fields["h"] = lambda x, y: h(x, y) + h_bump * torch.exp(
            -((x - 1.0) ** 2 + y ** 2))
    return model, model.initial_state(**fields)


# the model options beyond the default model (no closure, WENO5 everywhere,
# VelocityStencil) that the kernel runs as runtime switches
OPTIONS = ("laplacian", "biharmonic", "vorticity stencil",
           "centered2 momentum", "upwind3 momentum",
           "upwind3 mass, centered2 tracer", "centered2 mass, upwind3 tracer")


def option_kwargs(options, pkg, nu):
    """``ShallowWaterModel`` keywords of one entry of OPTIONS (None: the
    default model), the closures taken from ``pkg`` (either package) with
    viscosity ``nu`` and diffusivity 1.5 ``nu``."""
    closures = {"laplacian": "LaplacianDiffusion",
                "biharmonic": "BiharmonicDiffusion"}
    if options in closures:
        return {"closure": getattr(pkg, closures[options])(
            nu=nu, kappa=1.5 * nu)}
    kw = {}
    for part in (options or "").split(", "):
        if part == "vorticity stencil":
            kw["vector_invariant_stencil"] = "vorticity"
        elif part:
            scheme, field = part.split()
            kw[f"{field}_advection"] = scheme
    return kw


def stable_nu(grid, dt, options):
    """The viscosity with ν·dt/dx^p = 0.01 (p = 2, or 4 for a biharmonic
    closure), the largest the cases run."""
    p = 4 if options == "biharmonic" else 2
    return 0.01 * min(grid.dx, grid.dy) ** p / dt


def with_options(model, options, dt):
    """``model`` with ``options`` (an entry of OPTIONS or None), its
    closure at :func:`stable_nu` for steps of ``dt``."""
    import dataclasses
    import swmhd_tpu_torch
    return dataclasses.replace(model, **option_kwargs(
        options, swmhd_tpu_torch, stable_nu(model.grid, dt, options)))


def branch_cases():
    """The kernel's branch cases ``((formulation, topology, γ), options)``
    (``chip_smoke.py``'s phase 3): each entry of CONFIGS with no closure,
    a Laplacian and a biharmonic one, and bounded in x and y with the
    other OPTIONS."""
    cases = [(cfg, None) for cfg in CONFIGS]
    cases += [(cfg, o) for cfg in CONFIGS for o in ("laplacian",
                                                    "biharmonic")]
    cases += [((f, BOUNDED_XY, -0.05), o) for f in (VI, CONS)
              for o in OPTIONS[2:] if f == VI or o != "vorticity stencil"]
    return cases


def wall_model(N, dtype, device, formulation, topology, gamma):
    """The bench configuration with the wall terms of
    :func:`initial_fields`."""
    return bench_model(N, dtype, device, formulation, topology, gamma,
                       walls=True)


def cut_tile(s, b, hx, hy):
    """Tile ``b = (x0, x1, y0, y1)`` of stacked fields ``s`` padded by
    ``(hx, hy)`` cells, wrapping at the domain's ends: what a halo
    exchange over periodic axes gives."""
    import torch
    x0, x1, y0, y1 = b
    ix = torch.arange(x0 - hx, x1 + hx, device=s.device) % s.shape[1]
    iy = torch.arange(y0 - hy, y1 + hy, device=s.device) % s.shape[2]
    return s[:, ix][:, :, iy].contiguous()


def tile_layout(N, M, mesh, halo=TILE_HALO):
    """``(bounds of each tile, (hx, hy))`` of a ``mesh`` of an N×M grid:
    a halo of ``halo`` on each axis that is cut."""
    px, py = mesh
    nx, ny = N // px, M // py
    tiles = [(ix * nx, (ix + 1) * nx, iy * ny, (iy + 1) * ny)
             for ix in range(px) for iy in range(py)]
    return tiles, (halo if px > 1 else 0, halo if py > 1 else 0)


def split_launches(K, model, p, dt, stage, g_prev, halo):
    """Substage ``stage`` on the padded tile ``p`` as region launches
    (``substage(..., out=, at=)``) that cover the tile: the interior on
    the unpadded tile, then each band of ``band_slabs`` on its slab of
    ``p``, every launch writing its region in place; ``(s_new, G)``."""
    import torch
    from swmhd_tpu_torch.parallel.decomposition import band_slabs
    hx, hy = halo
    nx, ny = p.shape[1] - 2 * hx, p.shape[2] - 2 * hy
    s = p[:, hx:hx + nx, hy:hy + ny].contiguous()
    write_G = stage < 2
    out = (torch.empty_like(s), torch.empty_like(s) if write_G else None)
    K.substage(model, s, dt, stage, g_prev, write_G, halo=halo, out=out,
               at=halo)
    for rows, cols, at in band_slabs(nx, ny, hx, hy):
        K.substage(model, p[:, rows, cols], dt, stage, g_prev, write_G,
                   halo=halo, out=out, at=at)
    return out


def split_against_tile(K, model, p, dt, halo):
    """The region launches of :func:`split_launches` against the one tile
    launch on the padded tile ``p``, substages 0 and 1 (each taking the tile launch's
    G of substage 0): the worst error relative to each array's scale, and
    whether every value agreed bit for bit."""
    import torch
    t1, h1 = K.substage(model, p, dt, 0, halo=halo)
    t2, h2 = K.substage(model, p, dt, 1, h1, halo=halo)
    u1, k1 = split_launches(K, model, p, dt, 0, None, halo)
    u2, k2 = split_launches(K, model, p, dt, 1, h1, halo)
    worst, bitwise = 0.0, True
    for got, want in ((k1, h1), (u1, t1), (k2, h2), (u2, t2)):
        worst = max(worst, rel_err(got, want, float(want.abs().max())))
        bitwise &= bool(torch.equal(got, want))
    return worst, bitwise
