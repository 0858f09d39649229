"""End-to-end driver tests on CPU: energy conservation, determinism,
and multi-device equivalence on the virtual 8-device mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from compton2d_tpu.examples import small_corona


def _tiny(t_const=True, seed=0, mesh=None, n_slots=2048):
    return small_corona(
        nz=3, nr=2, nst=500, n_slots=n_slots, num_nt=50,
        n_vol=48, nphfield=48, t_const=t_const, seed=seed, mesh=mesh,
    )


def test_energy_conservation_per_step():
    sim = _tiny()
    for _ in range(3):
        sim.step()
        a = sim.energy_audit()
        assert np.isclose(a["balance"], 1.0, atol=1e-4), a


def test_determinism_same_seed():
    s1 = _tiny(seed=7)
    s2 = _tiny(seed=7)
    for _ in range(2):
        o1 = s1.step()
        o2 = s2.step()
    assert np.array_equal(
        np.asarray(o1.tallies.ecens), np.asarray(o2.tallies.ecens)
    )
    assert np.array_equal(
        np.asarray(s1.state.photons.w), np.asarray(s2.state.photons.w)
    )


def test_different_seed_differs():
    o1 = _tiny(seed=1).step()
    o2 = _tiny(seed=2).step()
    assert not np.array_equal(
        np.asarray(o1.tallies.ecens), np.asarray(o2.tallies.ecens)
    )


def test_fp_cools_hot_electrons():
    """With an intense soft radiation field, FP must cool the electrons
    (Compton cooling dominates)."""
    sim = _tiny(t_const=False, n_slots=4096)
    t0 = float(sim.state.zones.tea[0, 0])
    for _ in range(3):
        sim.step()
    t1 = float(sim.state.zones.tea[0, 0])
    assert t1 < t0
    assert np.isfinite(t1)


def test_escaping_spectrum_nonempty():
    sim = _tiny()
    sim.step()
    sim.step()
    out = sim.last_outputs
    assert float(jnp.sum(out.tallies.fout)) > 0
    assert int(out.events.count.sum()) > 0


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_step_runs_and_conserves(ndev):
    from compton2d_tpu.parallel.mesh import make_photon_mesh

    mesh = make_photon_mesh(jax.devices()[:ndev])
    sim = _tiny(mesh=mesh, n_slots=2048)
    for _ in range(2):
        sim.step()
        a = sim.energy_audit()
        assert np.isclose(a["balance"], 1.0, atol=1e-4), a
    assert int(jnp.sum(sim.state.photons.alive)) > 0


def test_sharded_self_determinism():
    from compton2d_tpu.parallel.mesh import make_photon_mesh

    mesh = make_photon_mesh(jax.devices()[:4])
    s1 = _tiny(seed=3, mesh=mesh)
    s2 = _tiny(seed=3, mesh=mesh)
    o1 = s1.step()
    o2 = s2.step()
    assert np.array_equal(
        np.asarray(o1.tallies.ecens), np.asarray(o2.tallies.ecens)
    )


def test_checkpoint_roundtrip(tmp_path):
    from compton2d_tpu.io.checkpoint import load_checkpoint, save_checkpoint

    sim = _tiny(seed=5)
    sim.step()
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, sim.state, {"ncycle": int(sim.state.ncycle)})
    sim2 = _tiny(seed=5)
    sim2.state = load_checkpoint(path, sim2.state)
    # both advance one more step identically
    o1 = sim.step()
    o2 = sim2.step()
    assert np.array_equal(
        np.asarray(o1.tallies.ecens), np.asarray(o2.tallies.ecens)
    )


@pytest.mark.parametrize("with_injection", [False, True])
def test_zone_shard_matches_replicated(with_injection):
    """run.zone_shard=True (FP/emissivity/pair zone farm over the mesh,
    update2d.f:190-214 analogue) must produce bitwise-identical zone
    state and tallies vs the fully-replicated zone path: per-zone
    computation is placement-independent, and the photon stream is
    keyed by (step, device) either way.

    The injection variant covers the pad-zone gating: Z=6 zones on 4
    devices pads to 8, and both pick-up and shock injection are
    zone-state-independent, so without the fp_step zone_valid mask the
    pad zones would inject particles and inflate the psummed e_el_new
    audit (advisor round-3 finding #1)."""
    import dataclasses

    from compton2d_tpu.config import InjectionConfig
    from compton2d_tpu.parallel.mesh import make_photon_mesh
    from compton2d_tpu.examples import small_corona

    mesh = make_photon_mesh(jax.devices()[:4])
    phys_kw = {}
    if with_injection:
        phys_kw["injection"] = InjectionConfig(
            switch=1, distribution=2, g1=2.0, g2=1.0e3, p=2.4,
            t_start=0.0, luminosity=1.0e38,
            pickup=True, pickup_rate=1.0e-2,
        )

    def build(zone_shard):
        sim = small_corona(
            nz=3, nr=2, nst=1000, n_slots=2048, num_nt=40,
            n_vol=48, nphfield=48, t_const=False, seed=11, mesh=mesh,
            pair_switch=True, **phys_kw,
        )
        # rebuild with the flag toggled (frozen dataclass);
        # with_config keeps the example's zone init
        cfg = dataclasses.replace(
            sim.cfg, run=dataclasses.replace(
                sim.cfg.run, zone_shard=zone_shard
            )
        )
        return sim.with_config(cfg, mesh=mesh)

    s_rep = build(False)
    s_shard = build(True)
    for _ in range(3):
        o_rep = s_rep.step()
        o_shard = s_shard.step()
        # the pad-zone audit bug inflates only the sharded e_el sums
        # (replicated path has no padding), so compare them directly
        assert np.isclose(
            float(o_rep.e_el_new), float(o_shard.e_el_new), rtol=1e-6
        )
        assert np.isclose(
            float(o_rep.e_el_old), float(o_shard.e_el_old), rtol=1e-6
        )
    for name in ("tea", "f_nt", "n_e", "gmin", "p_nth", "f_pair"):
        a = np.asarray(getattr(s_rep.state.zones, name))
        b = np.asarray(getattr(s_shard.state.zones, name))
        assert np.array_equal(a, b), name
    assert np.array_equal(
        np.asarray(o_rep.tallies.ecens), np.asarray(o_shard.tallies.ecens)
    )
    assert np.array_equal(
        np.asarray(o_rep.tallies.edep), np.asarray(o_shard.tallies.edep)
    )
    assert np.array_equal(
        np.asarray(s_rep.state.k_gg), np.asarray(s_shard.state.k_gg)
    )
    a_rep = s_rep.energy_audit()
    a_shard = s_shard.energy_audit()
    assert np.isclose(a_rep["balance"], a_shard["balance"], rtol=1e-6)


def test_degenerate_emission_spectrum_no_topbin_photons():
    """Regression (round 4): with a weak B field the zone synchrotron
    spectrum falls entirely below the e_ph grid, the emission CDF
    cumsum underflows to zero, and the inverse-CDF sampler used to put
    EVERY volume photon in the TOP energy bin (~7e9 keV garbage that
    later wrecks pair physics and scatter statistics). The degenerate
    CDF must collapse to a step at bin 0 instead."""
    from compton2d_tpu.config import ZoneInit
    from compton2d_tpu.driver import Simulation

    sim = small_corona(
        nz=3, nr=2, nst=4000, n_slots=8192, num_nt=60, n_vol=64,
        nphfield=64, t_const=True, seed=3,
    )
    # default-uniform zones: B = 1 G puts the sync peak ~1e-17 keV,
    # far below the e_ph grid floor
    sim = Simulation(sim.cfg)
    sim.step()
    e = np.asarray(sim.state.photons.e)
    al = np.asarray(sim.state.photons.alive)
    assert ((e > 1.0e4) & al).sum() == 0, (
        "degenerate emission CDF produced top-bin photons"
    )


def test_hist2d_accum_matches_scatter_add_exactly():
    """hist2d_accum (the one-hot matmul histogram that replaced
    scatter-adds) must reproduce the f64 scatter-add reference to f32
    accumulation accuracy — guards the Precision.HIGHEST requirement
    (a reduced matmul precision truncates the value operand to bf16
    or TF32 and costs ~3 digits)."""
    import jax
    import numpy as np

    from compton2d_tpu.transport.tracking import hist2d_accum, zone_accum

    n, nzr, nb = 20000, 37, 9
    rng = np.random.default_rng(0)
    vals = rng.gamma(0.3, size=n).astype(np.float32)  # heavy-tailed
    zid = rng.integers(0, nzr, n).astype(np.int32)
    bins = rng.integers(0, nb, n).astype(np.int32)
    ref = np.zeros((nzr, nb), np.float64)
    np.add.at(ref, (zid, bins), vals.astype(np.float64))
    got = np.asarray(hist2d_accum(
        jax.numpy.asarray(vals), jax.numpy.asarray(zid), nzr,
        jax.numpy.asarray(bins), nb,
    ), np.float64)
    rel = np.abs(got - ref) / np.maximum(ref, 1e-30)
    assert rel[ref > 0].max() < 5e-6, rel[ref > 0].max()
    gz = np.asarray(zone_accum(
        jax.numpy.asarray(vals), jax.numpy.asarray(zid), nzr
    ), np.float64)
    rz = np.abs(gz - ref.sum(1)) / ref.sum(1)
    assert rz.max() < 5e-6, rz.max()
