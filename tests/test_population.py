"""Census population control: the weight-window Russian roulette must
keep slots available for fresh emission in scattering-dominated runs
(replacing the reference's census hard stop, general.pa:7 /
imctrk2d.f:573-577), preserve expected energy, and keep the per-step
audit exact."""
import jax
import jax.numpy as jnp
import numpy as np

from compton2d_tpu.examples import small_corona
from compton2d_tpu.state import PhotonArray
from compton2d_tpu.transport.population import census_roulette


def _population(key, n, frac_alive=1.0):
    ph = PhotonArray.empty(n)
    k1, k2 = jax.random.split(key)
    w = jax.random.exponential(k1, (n,), jnp.float32) + 1e-3
    alive = jax.random.uniform(k2, (n,)) < frac_alive
    return ph._replace(w=jnp.where(alive, w, 0.0), alive=alive)


def test_roulette_triggers_and_preserves_energy():
    n = 4096
    ph = _population(jax.random.PRNGKey(0), n, frac_alive=0.95)
    e_before = float(jnp.sum(jnp.where(ph.alive, ph.w, 0.0)))
    ph2, e_rr, n_rr = census_roulette(
        ph, jax.random.PRNGKey(1), occupancy_hi=0.85, occupancy_lo=0.5
    )
    n_after = int(jnp.sum(ph2.alive))
    # survivor count lands near the target
    assert abs(n_after - 0.5 * n) < 0.05 * n
    assert int(n_rr) == int(jnp.sum(ph.alive)) - n_after
    # realized energy delta is tallied exactly
    e_after = float(jnp.sum(jnp.where(ph2.alive, ph2.w, 0.0)))
    assert np.isclose(e_before - e_after, float(e_rr), rtol=1e-5)
    # and is small relative to the total (weight window, not uniform RR)
    assert abs(float(e_rr)) < 0.05 * e_before


def test_roulette_unbiased_in_expectation():
    """Mean surviving energy over many independent roulettes matches the
    pre-roulette energy (weight preservation in expectation)."""
    n = 2048
    ph = _population(jax.random.PRNGKey(2), n, frac_alive=1.0)
    e_before = float(jnp.sum(ph.w))
    deltas = []
    for s in range(20):
        _, e_rr, _ = census_roulette(
            ph, jax.random.PRNGKey(100 + s), 0.85, 0.4
        )
        deltas.append(float(e_rr))
    assert abs(np.mean(deltas)) < 3.0 * np.std(deltas) / np.sqrt(20) + \
        1e-3 * e_before


def test_roulette_noop_below_threshold():
    n = 1024
    ph = _population(jax.random.PRNGKey(3), n, frac_alive=0.5)
    ph2, e_rr, n_rr = census_roulette(ph, jax.random.PRNGKey(4), 0.85, 0.6)
    assert float(e_rr) == 0.0 and int(n_rr) == 0
    assert bool(jnp.all(ph2.alive == ph.alive))


def test_scattering_dominated_run_never_starves():
    """50-step optically-thick run at tiny slot capacity: with census
    RR on, fresh emission never starves (e_src_lost ~ 0) and the audit
    stays exact; with it off, the census saturates and source energy is
    dropped."""
    def run(census_rr):
        import dataclasses

        base = small_corona(
            nz=2, nr=2, nst=400, n_slots=2048, num_nt=40, n_vol=32,
            nphfield=32, t_const=True, n_e=3e11, tbb=0.5,
            max_flight_iters=128,
        )
        cfg = base.cfg.replace(
            run=dataclasses.replace(base.cfg.run, census_rr=census_rr)
        )
        from compton2d_tpu.driver import Simulation
        from compton2d_tpu.config import ZoneInit

        zi = ZoneInit.uniform(cfg.grid, tea=100.0, tna=100.0, n_e=3e11,
                              B_field=10.0)
        sim = Simulation(cfg, zi)
        lost, rolled = 0.0, 0
        for _ in range(50):
            out = sim.step()
            a = sim.energy_audit()
            assert np.isclose(a["balance"], 1.0, atol=5e-3), a
            lost += a["src_lost"]
            rolled += a["n_rr"]
        alive = int(jnp.sum(sim.state.photons.alive))
        return lost, rolled, alive

    lost_on, rolled_on, alive_on = run(True)
    assert lost_on == 0.0
    assert rolled_on > 0          # the roulette actually engaged
    assert alive_on < 2048        # slots remain for fresh emission

    lost_off, _, _ = run(False)
    assert lost_off > 0.0         # without control the source starves
