"""Smoke test of the simulation on an NVIDIA GPU.

    python chip_smoke.py          # phases 1-4 on one GPU
    python chip_smoke.py --four   # phase 5 only, on four GPUs

Drives ``Simulation.step`` through the entry points a user calls, at
the sizes the science runs use, and checks what comes out:

1. Mrk 421 SSC flare at production sizes (tools/run_mrk421.py), with
   outputs attached: energy audit on every step, finite zone
   temperatures, a nonzero escaping spectrum, event records written.
2. Thermal corona with pairs at bench shape: the same checks, then
   same-seed determinism (bit-identical tallies from two fresh
   simulations).
3. GPU against CPU in this process: the deterministic zone phases
   (zone_sigma_table, volume_em, fp_step, pair tensors) elementwise
   within stated tolerances, and the whole step by a K-seed z-test.
4. A census of realistic size (4M slots, ~2e6 photons per step).
5. ``--four``: the photon-sharded step on a 4-GPU mesh (audit on every
   step) and the 1-vs-4-device z-test at bench scale.

Exits non-zero, with no result line, when JAX finds no GPU or any check
fails. The last line of standard output is one JSON object naming the
device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from compton2d_tpu import runtime
from compton2d_tpu.validation import max_rel_err, replicate_totals, ztest

AUDIT_TOL = 5e-3   # per-step energy balance, |balance - 1|
Z_MAX = 4.0        # z-test threshold on each channel


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def peak_gib(dev=None) -> float:
    """Peak device memory in use since the process started [GiB]."""
    dev = dev or jax.devices()[0]
    return dev.memory_stats()["peak_bytes_in_use"] / 2**30


def run_steps(sim, n_steps: int, name: str) -> dict:
    """Step ``n_steps`` times, checking the energy audit after each step
    (outside the timed region). Step 1 is cold (compile included)."""
    times, hist, rounds, balances = [], [], [], []
    for i in range(n_steps):
        t0 = time.perf_counter()
        out = sim.step()
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
        bal = sim.energy_audit()["balance"]
        balances.append(bal)
        check(abs(bal - 1.0) < AUDIT_TOL,
              f"{name}: step {i + 1} audit balance {bal!r}")
        hist.append(int(out.n_tracked))
        rounds.append(int(out.tallies.trk_rounds))
    warm = slice(1, None) if n_steps > 1 else slice(None)
    stats = {
        "cold_step_s": times[0],
        "warm_step_s": float(np.mean(times[warm])),
        "histories_per_s": sum(hist[warm]) / sum(times[warm]),
        "rounds_per_step": float(np.mean(rounds[warm])),
        "balances": balances,
        "peak_gib_since_start": peak_gib(),
    }
    check(bool(np.all(np.isfinite(np.asarray(sim.state.zones.tea)))),
          f"{name}: non-finite zone temperature")
    log(f"{name}: " + json.dumps(stats))
    return stats


# ---------------------------------------------------------------------------
# phase 1: Mrk 421 at production sizes, outputs attached
# ---------------------------------------------------------------------------
def phase_mrk421(steps: int = 5) -> None:
    from compton2d_tpu.examples import mrk421

    sim = mrk421(nst=60000, n_slots=1 << 17)
    sim = sim.with_config(dataclasses.replace(
        sim.cfg, source=dataclasses.replace(sim.cfg.source,
                                            strat_split=True),
    ))
    with tempfile.TemporaryDirectory() as out_dir:
        sim.attach_outputs(out_dir)
        run_steps(sim, steps, "phase1 mrk421 10x4 nst=60000 slots=2^17")
        sim.finalize_outputs()
        sim.event_writer.close()
        spec = float(np.sum(sim.outputs.fout))
        check(spec > 0.0, "phase1: escaping spectrum is zero")
        check(sim.event_writer.n_written > 0, "phase1: no event records")
        ev_bytes = os.path.getsize(os.path.join(out_dir, "evb.dat"))
        check(ev_bytes > 0, "phase1: event file is empty")
        log(f"phase1: escaping spectrum sum {spec:.6e}, "
            f"{sim.event_writer.n_written} event records "
            f"({ev_bytes} bytes)")


# ---------------------------------------------------------------------------
# phase 2: thermal corona with pairs; same-seed determinism
# ---------------------------------------------------------------------------
def corona_full(**kw):
    from compton2d_tpu.examples import small_corona

    args = dict(nz=8, nr=4, nst=60000, n_slots=1 << 17, num_nt=200,
                n_vol=400, nphfield=400, pair_switch=1)
    args.update(kw)
    return small_corona(**args)


def host_tallies(out):
    return jax.tree_util.tree_map(np.asarray, out.tallies)


def phase_corona(steps: int = 4):
    sim = corona_full()
    run_steps(sim, steps, "phase2 corona 8x4 pairs nst=60000 slots=2^17")
    t = sim.last_outputs.tallies
    check(float(jnp.sum(t.fout)) > 0.0, "phase2: escaping spectrum zero")
    check(int(np.sum(np.asarray(sim.last_outputs.events.count))) > 0,
          "phase2: no event records")

    # determinism: two fresh simulations, one seed, bit-identical tallies
    n_det = 2
    a, b = corona_full(), corona_full()
    for i in range(n_det):
        ta, tb = host_tallies(a.step()), host_tallies(b.step())
        for name, x, y in zip(ta._fields, ta, tb):
            check(np.array_equal(x, y),
                  f"phase2: step {i + 1} tally {name} differs between "
                  "two same-seed simulations")
    log(f"phase2: same-seed tallies bit-identical over {n_det} steps")
    return sim


# ---------------------------------------------------------------------------
# phase 3: GPU against CPU
# ---------------------------------------------------------------------------
def run_on(device, fn, args):
    """jit(fn)(args) with every input committed to ``device``; returns
    the outputs as host numpy arrays."""
    out = jax.jit(fn)(*jax.device_put(args, device))
    return jax.tree_util.tree_map(np.asarray, out)


def compare_on_devices(name, fn, args, dev, ref_dev, rtol, atol_frac,
                       why):
    """Run ``fn`` on the same host inputs on both devices and require
    :func:`max_rel_err` <= rtol on every output leaf."""
    got = jax.tree_util.tree_leaves(run_on(dev, fn, args))
    ref = jax.tree_util.tree_leaves(run_on(ref_dev, fn, args))
    err = max(max_rel_err(g, r, atol_frac) for g, r in zip(got, ref))
    log(f"phase3 {name}: max rel err {err:.3e} (tol {rtol:g}, floor "
        f"{atol_frac:g} x max; {why})")
    check(err <= rtol, f"phase3 {name}: {err:.3e} > {rtol:g}")
    return err


def ztest_on_devices(make_sim, dev, ref_dev, seeds, ref_seeds, steps=3):
    """K-seed z-test of whole-step totals: the same configuration built
    and stepped on each device (``seeds`` on ``dev``, ``ref_seeds`` on
    ``ref_dev``)."""
    totals = []
    for d, s in ((dev, seeds), (ref_dev, ref_seeds)):
        with jax.default_device(d):
            sim = make_sim()
            totals.append(replicate_totals(sim, s, steps))
            sim.step()
            placed = sim.state.zones.tea.devices()
            check(placed == {d}, f"z-test ran on {placed}, not {d}")
    a, b = totals
    return ztest(a, b), a, b


def deterministic_phases(sim):
    """(name, fn, host args, rtol, atol_frac, reason) for each
    deterministic zone phase, fed from ``sim``'s current state."""
    from compton2d_tpu.fp.update import fp_step
    from compton2d_tpu.physics import pairs
    from compton2d_tpu.physics.compton import zone_sigma_table
    from compton2d_tpu.physics.emissivity import volume_em

    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    z, tab, grid = host(sim.state.zones), host(sim.tables), host(sim.grid)
    o = sim.last_outputs
    n_field = np.asarray(o.tallies.n_field)
    dt = np.asarray(sim.state.dt)
    l_min = np.minimum(grid.dz, grid.dr) * np.ones_like(grid.vol)
    scales, phys, cfg = sim.scales, sim.cfg.physics, sim.cfg
    pt = host(sim.pair_tables)
    Z = z.tea.size

    def ve_fn(z, tab, grid, l_min, dt):
        return volume_em(
            tab.e_ph, tab.gnt, z.f_nt, z.tea, z.n_e, z.B_field, z.amxwl,
            grid.vol, grid.zone_surf, l_min, dt, tab.sync, scales,
            f_pair=z.f_pair,
        )

    ve = run_on(jax.devices("cpu")[0], ve_fn, (z, tab, grid, l_min, dt))

    def fp_fn(z, n_field, tab, grid, dt, time, eloss_sy, eloss_br):
        r = fp_step(
            z, n_field, tab, grid.vol, float(cfg.grid.z_max), grid.dz,
            dt, time, eloss_sy, phys, scales, eloss_br=eloss_br,
        )
        return r.zones.tea, r.zones.f_nt

    nph = np.asarray(o.nph_fit).reshape(Z, -1).astype(np.float32)
    f_flat = z.f_nt.reshape(Z, -1)
    npos_flat = z.n_pos.reshape(Z, -1)
    ne_flat = z.n_e.reshape(-1)
    hi = jax.lax.Precision.HIGHEST
    sums = "f32 sums of positive terms, <= K*eps ~ 1.2e-5 for K = 200"
    return [
        ("zone_sigma_table",
         lambda z, tab: zone_sigma_table(tab.sigma_e, z.f_nt, tab.gnt,
                                         z.n_e, z.f_pair),
         (z, tab), 1e-4, 0.0, sums),
        ("volume_em", ve_fn, (z, tab, grid, l_min, dt), 2e-3, 1e-6,
         "exp/log/pow ulp differences amplified by exponents up to ~90"
         " and a signed absorption integral"),
        ("fp_step", fp_fn,
         (z, n_field, tab, grid, dt, np.asarray(sim.state.time),
          ve.eloss_sy, ve.eloss_br), 1e-3, 1e-6,
         "implicit Chang-Cooper substeps whose count adapts to the rates"),
        ("pairs.kgg_mat", lambda n, m: jnp.matmul(n, m.T, precision=hi),
         (nph, pt.kgg_mat), 1e-4, 0.0, sums),
        ("pairs.dn_pp_from_field", pairs.dn_pp_from_field,
         (nph, pt.pp_tensor), 1e-4, 0.0, sums),
        ("pairs.pa_rates", pairs.pa_rates,
         (f_flat, npos_flat, ne_flat, pt.vsigma,
          tab.gnt.astype(np.float32)), 1e-4, 0.0, sums),
    ]


def ztest_corona():
    from compton2d_tpu.examples import small_corona

    return small_corona(nz=4, nr=3, nst=4000, n_slots=1 << 13, num_nt=64,
                        n_vol=64, nphfield=64, pair_switch=1)


def phase_gpu_vs_cpu(sim) -> None:
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    for name, fn, args, rtol, atol_frac, why in deterministic_phases(sim):
        compare_on_devices(name, fn, args, gpu, cpu, rtol, atol_frac, why)
    zs, a, b = ztest_on_devices(
        ztest_corona, gpu, cpu, seeds=[7 + 31 * i for i in range(8)],
        ref_seeds=[1000 + 31 * i for i in range(8)],
    )
    log("phase3 whole-step z-test GPU vs CPU (8 seeds, 3 steps, corona "
        "4x3 nst=4000): " + ", ".join(
            f"{k}: z={zs[k]:.2f} (mean {a[k].mean():.5e} vs "
            f"{b[k].mean():.5e})" for k in zs))
    for k, v in zs.items():
        check(v < Z_MAX, f"phase3 z-test {k}: z={v:.2f}")


# ---------------------------------------------------------------------------
# phase 4: a census of realistic size
# ---------------------------------------------------------------------------
def phase_big_census(steps: int = 3) -> None:
    sim = corona_full(nst=2_000_000, n_slots=1 << 22)
    run_steps(sim, steps, "phase4 corona 8x4 nst=2e6 slots=2^22")
    log(f"phase4: census {int(jnp.sum(sim.state.photons.alive))} photons")


# ---------------------------------------------------------------------------
# phase 5 (--four): the photon-sharded step on four GPUs
# ---------------------------------------------------------------------------
def phase_four(steps: int = 3) -> None:
    from compton2d_tpu.parallel.mesh import make_photon_mesh

    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 GPUs, found {len(devs)}")
    mesh = make_photon_mesh(devs[:4])

    def bench(mesh=None, **kw):
        return corona_full(n_slots=1 << 17, mesh=mesh, **kw)

    sim = bench(mesh, fp_include_coulomb=True)
    run_steps(sim, steps, "phase5 4-GPU mesh corona 8x4 pairs+coulomb "
              "nst=60000 slots=2^17 (2^15/device)")
    a = replicate_totals(bench(mesh), [7 + 31 * i for i in range(5)])
    b = replicate_totals(bench(), [1000 + 31 * i for i in range(5)])
    zs = ztest(a, b)
    log("phase5 1-vs-4-GPU z-test (5 seeds, 3 steps, bench scale): "
        + ", ".join(f"{k}: z={zs[k]:.2f} (mean {a[k].mean():.5e} vs "
                    f"{b[k].mean():.5e})" for k in zs))
    for k, v in zs.items():
        check(v < Z_MAX, f"phase5 z-test {k}: z={v:.2f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU phase")
    args = ap.parse_args(argv)

    runtime.require_gpu()
    log(f"compile cache: {runtime.enable_compile_cache()}")
    log(f"jax {jax.__version__} devices: {jax.devices()}")
    log(f"nvidia-smi: {runtime.gpu_name_and_power_limit()}")

    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_mrk421()
        sim = phase_corona()
        phase_gpu_vs_cpu(sim)
        phase_big_census()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)


if __name__ == "__main__":
    main()
