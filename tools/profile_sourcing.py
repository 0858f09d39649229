"""Micro-profile of the sourcing/tally path components at bench shapes.

Times each component standalone under jit on the current default device
(the GPU when run without platform overrides)."""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def bench_fn(fn, *args, iters=20, warmup=2):
    jfn = jax.jit(fn)
    for _ in range(warmup):
        out = jfn(*args)
    jax.tree_util.tree_map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready")
        else x, out,
    )
    t0 = time.time()
    for _ in range(iters):
        out = jfn(*args)
    jax.tree_util.tree_map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready")
        else x, out,
    )
    return (time.time() - t0) / iters


def main():
    from compton2d_tpu.examples import small_corona
    from compton2d_tpu.physics.emissivity import volume_em, equipartition_b
    from compton2d_tpu.physics.compton import zone_sigma_table
    from compton2d_tpu.physics.planck import sample_planck
    from compton2d_tpu.transport import sourcing
    from compton2d_tpu.transport.tracking import census_tally

    sim = small_corona(
        nz=8, nr=4, nst=60000, n_slots=1 << 17, num_nt=200,
        n_vol=400, nphfield=400, t_const=True,
    )
    sim.step()
    sim.step()
    s = sim.state
    t = sim.tables
    g = sim.grid
    cfg = sim.cfg
    sc = sim.scales
    zones = s.zones
    n = cfg.run.n_slots

    res = {}
    res["volume_em"] = bench_fn(
        lambda f_nt, tea, n_e, B: volume_em(
            t.e_ph, t.gnt, f_nt, tea, n_e, B, zones.amxwl, g.vol,
            g.zone_surf, jnp.minimum(g.dz, g.dr) * jnp.ones_like(g.vol),
            s.dt, t.sync, sc, f_pair=zones.f_pair,
        ),
        zones.f_nt, zones.tea, zones.n_e, zones.B_field,
    )
    res["zone_sigma"] = bench_fn(
        lambda f_nt, n_e: zone_sigma_table(t.sigma_e, f_nt, t.gnt, n_e),
        zones.f_nt, zones.n_e,
    )
    res["planck_n"] = bench_fn(
        lambda k: sample_planck(k, jnp.full((n,), 0.5, jnp.float32)),
        jax.random.PRNGKey(0),
    )

    ve = volume_em(
        t.e_ph, t.gnt, zones.f_nt, zones.tea, zones.n_e, zones.B_field,
        zones.amxwl, g.vol, g.zone_surf,
        jnp.minimum(g.dz, g.dr) * jnp.ones_like(g.vol), s.dt, t.sync, sc,
        f_pair=zones.f_pair,
    )
    budget = sourcing.compute_budget(
        sim.src_static, ve.eloss_tot, jnp.zeros_like(ve.eloss_tot),
        s.ed_abs, g.area_lower, g.area_upper, g.area_inner, g.area_outer,
        s.dt, s.dt_prev, cfg.source.nst, cfg.source.bias_cap,
        sc.sigma_sb,
    )
    res["budget"] = bench_fn(
        lambda fas: sourcing.compute_budget(
            sim.src_static, fas, jnp.zeros_like(fas), s.ed_abs,
            g.area_lower, g.area_upper, g.area_inner, g.area_outer,
            s.dt, s.dt_prev, cfg.source.nst, cfg.source.bias_cap,
            sc.sigma_sb,
        ),
        ve.eloss_tot,
    )
    res["emit"] = bench_fn(
        lambda ph, k: sourcing.emit(
            ph, k, budget, sim.src_static, g.r_edges, g.z_edges,
            g.zone_surf, ve.eps_tot, ve.eps_th, ve.eloss_th,
            ve.eloss_tot, t.e_ph, s.dt, cfg.grid.nz, cfg.grid.nr,
            c_scaled=sc.c,
        ),
        s.photons, jax.random.PRNGKey(1),
    )

    from compton2d_tpu.transport.population import census_roulette
    from compton2d_tpu.state import EventBuffer, Tallies

    res["roulette"] = bench_fn(
        lambda ph, k: census_roulette(ph, k, 0.85, 0.6),
        s.photons, jax.random.PRNGKey(2),
    )

    # full zero-iteration step: everything except flight iterations + FP
    import dataclasses

    from compton2d_tpu.driver import Simulation, _step_impl
    from compton2d_tpu.config import ZoneInit

    cfg0 = cfg.replace(
        physics=dataclasses.replace(cfg.physics, t_const=True),
        run=dataclasses.replace(cfg.run, max_flight_iters=0),
    )
    sim0 = sim.with_config(cfg0)
    sim0.state = sim0.state._replace(photons=s.photons)
    res["step_no_flight_no_fp"] = bench_fn(
        lambda st: _step_impl(
            st, sim0.src_static, sim0.grid, sim0.tables, cfg0, sim0.scales
        ),
        sim0.state, iters=10,
    )

    print({k: round(v * 1e3, 2) for k, v in res.items()}, "(ms)")


if __name__ == "__main__":
    main()
