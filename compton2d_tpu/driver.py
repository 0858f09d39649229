"""Simulation driver: the per-step orchestration and time loop.

Re-implements the reference driver pair ``compton2d.f`` (main) +
``xec2d.f`` (xec time loop) as one jitted ``step`` function over the
``SimState`` pytree, in the reference's phase order (SURVEY.md §3.2):

    budget (imcgen2d) -> census replay + sourcing (imcfield2d/imcvol2d/
    imcsurf2d) -> tracking (imctrk2d) -> census tallies -> FP update
    (update2d) -> output tallies

The MPI choreography (xec_bcast / xec_add / task farms / imcredist /
graphics_collect) disappears: zone state is replicated, photons are a
device-shardable batch axis, tallies reduce with psum (see
compton2d_tpu.parallel).

Time stepping matches the active reference behavior: dt is constant —
the adaptive dt_new of update2d.f:232-243 is dead code there (the
``dt(1) =`` updates are commented out, update2d.f:248-261, and
xec2d.f:100-106 only ever advances time by the fixed dt). We
deliberately do the same; FPResult still reports dT_max so a future
adaptive mode has the signal it needs.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from compton2d_tpu import constants as cn
from compton2d_tpu.config import SimConfig, ZoneInit
from compton2d_tpu.fp.update import FPResult, fp_step
from compton2d_tpu.grid import Grid, initial_dt, make_grid
from compton2d_tpu.physics.compton import SIGMA_T as compton_sigma_t
from compton2d_tpu.physics.compton import zone_sigma_table
from compton2d_tpu.physics.emissivity import equipartition_b, volume_em
from compton2d_tpu.state import (
    EventBuffer,
    PhotonArray,
    SimState,
    Tallies,
    ZoneState,
    init_zone_state,
)
from compton2d_tpu.tables import Tables, build_pair_tables, build_tables
from compton2d_tpu.transport import sourcing
from compton2d_tpu.transport.tracking import (
    TrackContext,
    TrackStatics,
    census_tally,
    transport_step,
)
from compton2d_tpu.units import Scales, make_scales


class StepOutputs(NamedTuple):
    """Per-step host-visible results."""

    tallies: Tallies
    events: EventBuffer
    bingo: jnp.ndarray        # total energy input [erg]
    e_el_old: jnp.ndarray
    e_el_new: jnp.ndarray
    dT_max: jnp.ndarray
    fp_substeps: jnp.ndarray
    fp_incomplete: jnp.ndarray  # () zones whose FP substep loop ran out
                                # of budget (0 with the d_t floor)
    n_tracked: jnp.ndarray    # () photons tracked this step (histories)
    nph_raw: jnp.ndarray      # (nz, nr, n_gg) gamma-gamma field before
                              # smoothing (n_ph1.dat, imcgen2d.f:198-201)
    nph_fit: jnp.ndarray      # (nz, nr, n_gg) after nph_smooth (n_ph2)


class WindowSources(NamedTuple):
    """Per-time-window boundary sources sharing one spectrum bank.

    The reference re-selects the boundary window by ``time + dt/2`` every
    step (imcgen2d.f:111-120) and re-reads the per-ring spectrum files
    (file_sp); here all windows are prebuilt on the host with identical
    array shapes so swapping them under the jitted step never recompiles.
    ``off`` variants zero the file flux — the reference only activates a
    file boundary once ``time + dt/2 >= t0`` (imcgen2d.f:127,139,156,173).
    """

    t0: np.ndarray                 # (n_windows,) start times [s]
    t1: np.ndarray                 # (n_windows,) end times [s]
    on: Tuple[sourcing.SourceStatic, ...]
    off: Tuple[sourcing.SourceStatic, ...]

    def select(self, time: float, dt: float, ncycle: int):
        """Window pick: first t with t1 > time + dt/2, clamped to the
        last (imcgen2d.f:111-120; ncycle 0 always uses window 1)."""
        t_avg = time + 0.5 * dt
        if ncycle == 0:
            idx = 0
        else:
            idx = min(
                int(np.searchsorted(self.t1, t_avg, side="right")),
                len(self.on) - 1,
            )
        return self.on[idx] if t_avg >= float(self.t0[idx]) else self.off[idx]


def _spectrum_bank(cfg: SimConfig, scales: Scales, names):
    """Load each distinct external-spectrum file once (file_sp,
    imcsurf2d_para.f:544-685) into a padded (n_spec, nf) bank. Row 0 is
    the dummy 'no file' row; flux is in scaled E/(L^2 s) units."""
    from compton2d_tpu.io.legacy import external_spectrum

    rows = []
    for nm in names:
        e_file, _, p_file, int_file = external_spectrum(
            nm, cfg.source.external
        )
        rows.append(
            (
                np.asarray(e_file, np.float32),
                np.asarray(p_file[: len(e_file)], np.float32),
                float(int_file) * scales.L2 / scales.E,
            )
        )
    nf = max([2] + [len(r[0]) for r in rows])
    spec_e = np.ones((len(rows) + 1, nf), np.float32)
    spec_cdf = np.ones((len(rows) + 1, nf), np.float32)
    spec_cdf[0, 0] = 0.0
    flux = np.zeros((len(rows) + 1,), np.float32)
    # inverse-CDF quantile table (log e at uniform u), host f64: the
    # device sampler is then one lerp instead of a per-photon binary
    # search down the CDF (O(log nf) (n,)-sized gathers per step)
    M = sourcing.SPEC_INV_M
    spec_inv = np.zeros((len(rows) + 1, M), np.float32)
    u_q = np.linspace(0.0, 1.0, M)
    for i, (e, p, fl) in enumerate(rows, start=1):
        spec_e[i, : len(e)] = e
        spec_e[i, len(e):] = e[-1]
        spec_cdf[i, : len(p)] = p
        flux[i] = fl
        spec_inv[i] = np.interp(
            u_q, np.asarray(p[: len(e)], np.float64),
            np.log(np.asarray(e, np.float64)),
        )
    return (
        jnp.asarray(spec_e), jnp.asarray(spec_cdf),
        jnp.asarray(spec_inv), flux,
    )


def build_window_sources(cfg: SimConfig, scales: Scales) -> WindowSources:
    """Build the full per-window SourceStatic sequence from the config
    (reader.f:222-283: per-window per-ring temperatures + spectrum
    files)."""
    from compton2d_tpu.config import TimeWindow

    g = cfg.grid
    windows = cfg.windows or (
        TimeWindow(
            t0=0.0, t1=float("inf"),
            tbb_upper=(0.0,) * g.nr, tbb_lower=(0.0,) * g.nr,
            tbb_inner=(0.0,) * g.nz, tbb_outer=(0.0,) * g.nz,
        ),
    )
    names: list = []
    for w in windows:
        for nm in tuple(w.lower_spectra) + tuple(w.upper_spectra):
            if nm and nm not in names:
                names.append(nm)
    spec_e, spec_cdf, spec_inv, flux = _spectrum_bank(cfg, scales, names)
    row_of = {nm: i + 1 for i, nm in enumerate(names)}
    star = cfg.physics
    dilution = (
        (star.r_star / star.dist_star) ** 2 if star.star_switch else 1.0
    )

    def ring_rows(tbbs, specs, n):
        idx = np.zeros((n,), np.int32)
        fl = np.zeros((n,), np.float32)
        specs = tuple(specs) + (None,) * n
        for k in range(n):
            if tbbs[k] < 0.0 and specs[k]:
                idx[k] = row_of[specs[k]]
                fl[k] = flux[idx[k]]
        return idx, fl

    on, off = [], []
    for w in windows:
        sl, fl_l = ring_rows(w.tbb_lower, w.lower_spectra, g.nr)
        su, fl_u = ring_rows(w.tbb_upper, w.upper_spectra, g.nr)
        src = sourcing.SourceStatic(
            tbb_lower=jnp.asarray(np.asarray(w.tbb_lower, float)),
            tbb_upper=jnp.asarray(np.asarray(w.tbb_upper, float)),
            tbb_inner=jnp.asarray(np.asarray(w.tbb_inner, float)),
            tbb_outer=jnp.asarray(np.asarray(w.tbb_outer, float)),
            spec_e=spec_e,
            spec_cdf=spec_cdf,
            spec_inv=spec_inv,
            spec_lower=jnp.asarray(sl),
            spec_upper=jnp.asarray(su),
            flux_lower=jnp.asarray(fl_l),
            flux_upper=jnp.asarray(fl_u),
            star_dilution=jnp.asarray(dilution),
        )
        on.append(src)
        off.append(
            src._replace(
                flux_lower=jnp.zeros_like(src.flux_lower),
                flux_upper=jnp.zeros_like(src.flux_upper),
            )
            if (fl_l.any() or fl_u.any())
            else src
        )
    return WindowSources(
        t0=np.asarray([w.t0 for w in windows], float),
        t1=np.asarray([w.t1 for w in windows], float),
        on=tuple(on),
        off=tuple(off),
    )


def source_static_with_spectrum(
    cfg: SimConfig,
    window,
    scales: Scales,
    spectrum_file: Optional[str] = None,
) -> sourcing.SourceStatic:
    """SourceStatic for one window with a single spectrum file attached
    to every tbb<0 ring (the pre-per-ring convenience API)."""
    import dataclasses

    if window is not None and spectrum_file is not None:
        window = dataclasses.replace(
            window,
            lower_spectra=tuple(
                spectrum_file if t < 0.0 else None
                for t in window.tbb_lower
            ),
            upper_spectra=tuple(
                spectrum_file if t < 0.0 else None
                for t in window.tbb_upper
            ),
        )
    cfg2 = cfg.replace(windows=(window,) if window is not None else ())
    return build_window_sources(cfg2, scales).on[0]


def _estimate_energy_scale(cfg: SimConfig, zone_init: ZoneInit) -> float:
    """Order-of-magnitude energy unit E0 so per-step scaled energies sit
    around 1e6 (f32 has ~38 decades of headroom; precision only needs
    the magnitude to be sane)."""
    g = cfg.grid
    dt0 = (
        cfg.run.mcdt
        * min(g.r_max / g.nr, g.z_max / g.nz)
        / cfg.physics.injection.v
    )
    area = np.pi * g.r_max**2
    tbb_max = 0.0
    for w in cfg.windows:
        for arr in (w.tbb_lower, w.tbb_upper, w.tbb_inner, w.tbb_outer):
            tbb_max = max(tbb_max, max((abs(t) for t in arr), default=0.0))
    bb = cn.SIGMA_SB_KEV * tbb_max**4 * area * dt0
    vol_tot = np.pi * g.r_max**2 * g.z_max
    sy = (
        1.058e-15
        * float(np.max(zone_init.n_e))
        * float(np.max(zone_init.B_field)) ** 2
        * float(np.max(zone_init.gmax))
        * vol_tot * dt0 * 0.01
    )
    inj = cfg.physics.injection.luminosity * dt0
    return max(bb, sy, inj, 1.0) / 1e6


class Simulation:
    """Owns the static configuration, tables, and the jitted step.

    Host clock mirror: ``time``/``dt``/``ncycle`` advance
    deterministically (dt is constant by design, see module docstring),
    so the driver tracks them host-side instead of fetching the device
    scalars every step — each ``float(state.time)`` is a blocking
    device round trip that serializes against the in-flight step and
    stalls the host's dispatch of the next one. Externally assigning
    ``sim.state`` (checkpoint restore) marks the mirror dirty; the next
    ``step()`` resyncs it with one fetch.
    """

    @property
    def state(self) -> SimState:
        return self._state

    @state.setter
    def state(self, s: SimState):
        self._state = s
        self._clock_dirty = True

    def _sync_clock(self):
        if getattr(self, "_clock_dirty", True):
            self._host_time = float(self._state.time)
            self._host_dt = float(self._state.dt)
            self._host_dt_prev = float(self._state.dt_prev)
            self._host_ncycle = int(self._state.ncycle)
            self._clock_dirty = False

    def __init__(
        self,
        cfg: SimConfig,
        zone_init: Optional[ZoneInit] = None,
        source_static: Optional[sourcing.SourceStatic] = None,
        mesh=None,
    ):
        self.cfg = cfg
        if zone_init is None:
            zone_init = ZoneInit.uniform(cfg.grid)
        # kept so with_config() can rebuild without silently dropping
        # the caller's zone initialization (a `Simulation(replace(cfg))`
        # rebuild otherwise reverts to default zones — e.g. B = 1 G)
        self.zone_init = zone_init
        e_scale = cfg.run.energy_scale or _estimate_energy_scale(
            cfg, zone_init
        )
        self.scales: Scales = make_scales(
            cfg.grid.z_max, cfg.grid.r_max, e_scale
        )
        self.grid: Grid = make_grid(cfg.grid, self.scales.L)
        self.tables: Tables = build_tables(cfg.grid, self.scales.L)
        zones = init_zone_state(cfg, zone_init, self.tables)

        dt0 = initial_dt(
            self.grid, cfg.run.mcdt, cfg.physics.injection.v,
            length_scale=self.scales.L,
        )
        g = cfg.grid
        self.state = SimState(
            zones=zones,
            photons=PhotonArray.empty(cfg.run.n_slots),
            time=np.float32(0.0),
            dt=np.float32(dt0),
            dt_prev=np.float32(dt0),
            ncycle=np.int32(0),
            key=jax.random.PRNGKey(cfg.run.seed),
            ed_abs=np.zeros((g.nr,), np.float32),
            ed_ref=np.zeros((g.nr,), np.float32),
            k_gg=np.zeros((g.nz, g.nr, g.n_gg), np.float32),
            dn_pp=np.zeros((g.nz, g.nr, g.num_nt), np.float32),
            dne_pa=np.zeros((g.nz, g.nr, g.num_nt), np.float32),
            dnp_pa=np.zeros((g.nz, g.nr, g.num_nt), np.float32),
        )
        if source_static is not None:
            # explicit override: window switching disabled
            self.window_sources: Optional[WindowSources] = None
            self.src_static = source_static
        else:
            self.window_sources = build_window_sources(cfg, self.scales)
            self.src_static = self.window_sources.select(0.0, dt0, 0)
        self.pair_tables = (
            build_pair_tables(cfg.grid, self.scales.L)
            if cfg.physics.pair_switch
            else None
        )
        pair_tables = self.pair_tables
        if cfg.physics.fp_include_coulomb:
            from compton2d_tpu.physics.coulomb import build_coulomb_tables

            self.coulomb_tables = build_coulomb_tables(
                np.asarray(self.tables.gnt), lnL=cfg.physics.lnL
            )
        else:
            self.coulomb_tables = None
        coulomb_tables = self.coulomb_tables
        self.mesh = mesh
        scales = self.scales
        if mesh is None:
            self._step_jit = jax.jit(
                lambda s, src, grid, tab: _step_impl(
                    s, src, grid, tab, cfg, scales,
                    pair_tables=pair_tables,
                    coulomb_tables=coulomb_tables,
                )
            )
        else:
            from compton2d_tpu.parallel import mesh as pmesh

            ndev = int(np.prod(mesh.devices.shape))
            if cfg.run.n_slots % ndev:
                raise ValueError(
                    f"n_slots={cfg.run.n_slots} must divide evenly over "
                    f"{ndev} devices"
                )
            # outputs: tallies & scalars replicated (psum'd inside),
            # events per-device
            dummy_out = StepOutputs(
                tallies=Tallies.zeros(
                    cfg.grid.nz, cfg.grid.nr, cfg.grid.num_nt,
                    cfg.grid.nphfield, cfg.grid.n_gg, cfg.grid.nmu,
                    cfg.grid.nphtotal, cfg.grid.nph_lc,
                ),
                events=EventBuffer.empty(1),
                bingo=jnp.zeros(()),
                e_el_old=jnp.zeros(()),
                e_el_new=jnp.zeros(()),
                dT_max=jnp.zeros(()),
                fp_substeps=jnp.zeros((), jnp.int32),
                fp_incomplete=jnp.zeros((), jnp.int32),
                n_tracked=jnp.zeros((), jnp.int32),
                nph_raw=jnp.zeros(()),
                nph_fit=jnp.zeros(()),
            )
            # everything replicated (psum'd inside) except the
            # per-device event buffers
            out_specs = (
                pmesh.simstate_specs(self.state),
                pmesh.replicated_specs(dummy_out)._replace(
                    events=pmesh.sharded_specs(dummy_out.events),
                ),
            )
            in_specs = (
                pmesh.simstate_specs(self.state),
                pmesh.replicated_specs(self.src_static),
                pmesh.replicated_specs(self.grid),
                pmesh.replicated_specs(self.tables),
            )
            fn = pmesh.shard_map(
                lambda s, src, grid, tab: _step_impl(
                    s, src, grid, tab, cfg, scales,
                    axis_name=pmesh.AXIS, n_devices=ndev,
                    pair_tables=pair_tables,
                    coulomb_tables=coulomb_tables,
                ),
                mesh=mesh,
                in_specs=in_specs,
                out_specs=out_specs,
            )
            self._step_jit = jax.jit(fn)
            if pmesh.is_multiprocess(mesh):
                # multi-process meshes need global jax.Arrays up front
                # (every process computed the identical initial state)
                self.state = pmesh.put_global(
                    self.state, pmesh.simstate_specs(self.state), mesh
                )
                self.grid = pmesh.put_global(
                    self.grid, pmesh.replicated_specs(self.grid), mesh
                )
                self.tables = pmesh.put_global(
                    self.tables, pmesh.replicated_specs(self.tables),
                    mesh,
                )
                self.src_static = pmesh.put_global(
                    self.src_static,
                    pmesh.replicated_specs(self.src_static), mesh,
                )
                if self.window_sources is not None:
                    ws = self.window_sources
                    rep = lambda s: pmesh.put_global(
                        s, pmesh.replicated_specs(s), mesh
                    )
                    self.window_sources = ws._replace(
                        on=tuple(rep(s) for s in ws.on),
                        off=tuple(rep(s) for s in ws.off),
                    )
        self.last_outputs: Optional[StepOutputs] = None

    def with_config(self, cfg: SimConfig, mesh=None) -> "Simulation":
        """Fresh Simulation with a modified config but THIS sim's zone
        initialization — the safe way to toggle run/physics flags on an
        example setup (``Simulation(replace(cfg, ...))`` silently
        reverts to default uniform zones)."""
        return Simulation(cfg, self.zone_init, mesh=mesh)

    def attach_outputs(self, out_dir: str, event_file: str = "evb.dat"):
        """Enable run-level output accumulation + event-file spooling
        (the reference's graphics + pNNN_evb.dat outputs)."""
        import os

        from compton2d_tpu.io.events import EventFileWriter
        from compton2d_tpu.io.outputs import OutputAccumulator

        self.out_dir = out_dir
        self.outputs = OutputAccumulator(
            np.asarray(self.tables.hu),
            np.asarray(self.tables.mu_edges),
            self.cfg.grid.lc_bands,
            self.scales.E,
        )
        self.event_writer = EventFileWriter(
            os.path.join(out_dir, event_file), self.scales.E
        )
        return self

    def step(self) -> StepOutputs:
        self._sync_clock()
        if self.window_sources is not None:
            # per-step boundary-window pick by time + dt/2
            # (imcgen2d.f:111-120); host-side, shapes fixed by the
            # spectrum bank so this never recompiles the step
            self.src_static = self.window_sources.select(
                self._host_time, self._host_dt, self._host_ncycle
            )
        self._state, out = self._step_jit(
            self._state, self.src_static, self.grid, self.tables
        )
        # advance the host clock mirror exactly as _step_impl does
        # (xec2d.f:100-106: time += dt, constant dt)
        self._host_time += self._host_dt
        self._host_dt_prev = self._host_dt
        self._host_ncycle += 1
        if self.cfg.run.adaptive_dt:
            # the ladder picked the next dt on device; mirror it (one
            # small blocking fetch — the documented cost of the opt-in)
            self._host_dt = float(self._state.dt)
        self.last_outputs = out
        if getattr(self, "outputs", None) is not None:
            # writing already syncs; account event-buffer overflow here
            # (without attached outputs, _check_event_overflow() runs in
            # summary()/energy_audit() so the loss is never silent)
            self._check_event_overflow(out)
            self.outputs.add_step(
                out.tallies,
                self._host_time - self._host_dt_prev,
                self._host_dt_prev,
                tea=np.asarray(self.state.zones.tea),
            )
            self.event_writer.write(out.events)
        return out

    # NOTE: a multi-step lax.scan fast path (one dispatch per chunk,
    # per-step outputs stacked) was tried and dropped: stacking the
    # StepOutputs (events buffer, field tallies) per iteration defeats
    # XLA's buffer reuse inside the scan, while the plain step() loop's
    # async dispatch already overlaps the per-call host latency with
    # device work. Not re-measured on the GPU (see PERF.md).
    def run(self, n_steps: int):
        for _ in range(n_steps):
            self.step()
        return self.last_outputs

    def run_to_stop(
        self,
        walltime_budget_s: float = 0.0,
        checkpoint_path: Optional[str] = None,
        max_steps: int = 1_000_000,
        verbose: bool = False,
    ) -> bool:
        """Advance until time - dt_prev >= t_stop (xec2d.f:110), with the
        reference's walltime-triggered self-checkpoint (xec2d.f:50-55).
        Returns True if the run completed (False = checkpointed out)."""
        from compton2d_tpu.io.checkpoint import WalltimeGuard, save_checkpoint

        guard = WalltimeGuard(
            walltime_budget_s or self.cfg.run.walltime_budget_s,
            self.cfg.run.checkpoint_frac,
        )
        for _ in range(max_steps):
            self._sync_clock()
            if (
                self._host_time - self._host_dt_prev
                >= self.cfg.run.t_stop
            ):
                break
            if guard.should_checkpoint():
                if checkpoint_path:
                    save_checkpoint(
                        checkpoint_path, self.state,
                        {"ncycle": int(self.state.ncycle),
                         "time": float(self.state.time)},
                    )
                return False
            self.step()
            if verbose:
                print(self.summary())
        if getattr(self, "outputs", None) is not None:
            self.finalize_outputs()
        return True

    def finalize_outputs(self):
        import os

        elapsed = float(self.state.time) + float(self.state.dt)
        self.outputs.write_spectrum(
            os.path.join(self.out_dir, "spectrum.dat"), elapsed
        )
        self.outputs.write_spectrum(
            os.path.join(self.out_dir, "photons.dat"), elapsed,
            photons=True,
        )
        self.outputs.write_light_curves(
            os.path.join(self.out_dir, "lc")
        )
        self.outputs.write_temperature_profile(
            os.path.join(self.out_dir, "temp_profile.dat"),
            np.asarray(self.grid.r_edges) * self.scales.L,
            n_e=np.asarray(self.state.zones.n_e),
        )

    # ---------------- diagnostics -----------------------------------
    def _check_event_overflow(self, out) -> int:
        """Surface escaping-photon records dropped beyond the per-step
        buffer (the reference writes every escape, imcleak2d.f:181;
        silent loss would bias LC/SED tails). Syncs on the small count
        vector — called only from paths that sync anyway."""
        if getattr(self, "_overflow_checked", None) is out:
            return getattr(self, "n_events_dropped", 0)
        self._overflow_checked = out
        counts = np.atleast_1d(np.asarray(out.events.count))
        cap = out.events.data.shape[0] // counts.shape[0]
        dropped = int(np.sum(np.maximum(counts - cap, 0)))
        if dropped:
            self.n_events_dropped = (
                getattr(self, "n_events_dropped", 0) + dropped
            )
            import warnings

            warnings.warn(
                f"step {int(self.state.ncycle)}: {dropped} escaping-"
                f"photon event records dropped (buffer capacity {cap}); "
                f"raise RunConfig.event_capacity", RuntimeWarning,
                stacklevel=2,
            )
        return getattr(self, "n_events_dropped", 0)

    def photon_fill_diagnostic(self):
        """First-cycle explicit thermal-rate table (photon_fill,
        update2d.f:1747-1921): the reference computes and logs this for
        ncycle <= 1 before the FP farm (its Te_new is then overwritten
        by FP_calc). Uses the last step's tallied radiation field."""
        from compton2d_tpu.fp.update import photon_fill

        if self.last_outputs is None:
            raise RuntimeError("run at least one step first")
        zones = self.state.zones
        l_min = jnp.minimum(self.grid.dz, self.grid.dr) * jnp.ones_like(
            self.grid.vol
        )
        ve = volume_em(
            self.tables.e_ph, self.tables.gnt, zones.f_nt, zones.tea,
            zones.n_e, zones.B_field, zones.amxwl, self.grid.vol,
            self.grid.zone_surf, l_min, self.state.dt_prev,
            self.tables.sync, self.scales, f_pair=zones.f_pair,
        )
        return photon_fill(
            zones, self.last_outputs.tallies.n_field, self.tables,
            self.grid.vol, self.state.dt_prev, ve.eloss_sy, ve.eloss_br,
            self.cfg.physics, self.scales,
        )

    def summary(self) -> str:
        o = self.last_outputs
        s = self.state
        esc = float(jnp.sum(o.tallies.fout)) * self.scales.E
        alive = int(jnp.sum(s.photons.alive))
        self._check_event_overflow(o)
        extras = ""
        if int(o.tallies.n_rr):
            extras += f" rr={int(o.tallies.n_rr)}"
        if float(o.tallies.e_src_lost):
            extras += (
                f" src_lost={float(o.tallies.e_src_lost) * self.scales.E:.2e}"
            )
        if getattr(self, "n_events_dropped", 0):
            extras += f" evt_dropped={self.n_events_dropped}"
        if int(o.fp_incomplete):
            extras += f" fp_incomplete={int(o.fp_incomplete)}"
        return (
            f"cycle={int(s.ncycle)} t={float(s.time):.4e}s "
            f"dt={float(s.dt):.3e}s census={alive} "
            f"E_in={float(o.bingo) * self.scales.E:.4e} E_esc={esc:.4e} "
            f"Te[0,0]={float(s.zones.tea[0, 0]):.2f}keV "
            f"dT_max={float(o.dT_max):.3f}" + extras
        )

    def energy_audit(self) -> dict:
        """E_add_up-style audit (update2d.f:1993-2078) in erg."""
        o = self.last_outputs
        t = o.tallies
        scale = self.scales.E
        census = float(jnp.sum(t.ecens)) * scale
        escaped = (
            float(
                jnp.sum(t.erlk_inner) + jnp.sum(t.erlk_outer)
                + jnp.sum(t.erlk_upper) + jnp.sum(t.erlk_lower)
            )
            * scale
        )
        deposited = float(jnp.sum(t.edep)) * scale
        killed = float(t.e_killed) * scale
        scatter_gain = float(t.e_scatter) * scale
        src_lost = float(t.e_src_lost) * scale
        pair_abs = float(t.e_pair_abs) * scale
        absorbed = deposited - scatter_gain
        e_in = float(o.bingo) * scale
        e_rr = float(t.e_rr) * scale
        # photon-side balance: (input - lost - rouletted) +
        #   gain_from_electrons = census + escaped + absorbed + killed
        #   + pair_abs (gamma-gamma absorption above 47 keV converts
        #   photon energy to pairs, excluded from edep heat,
        #   imctrk2d.f:429-434; it re-enters via dn_pp, audited on the
        #   electron side)
        # (bingo counts the pre-roulette census energy; e_rr is the
        # realized roulette delta, zero in expectation)
        avail = e_in - src_lost + scatter_gain - e_rr
        return {
            "input": e_in,
            "census": census,
            "escaped": escaped,
            "absorbed": absorbed,
            "scatter_gain": scatter_gain,
            "killed": killed,
            "src_lost": src_lost,
            "pair_abs": pair_abs,
            "rr": e_rr,
            "n_rr": int(t.n_rr),
            "events_dropped": self._check_event_overflow(o),
            "balance": (census + escaped + absorbed + killed + pair_abs)
            / avail
            if avail > 0
            else float("nan"),
        }


def _step_impl(
    state: SimState,
    src: sourcing.SourceStatic,
    grid: Grid,
    tables: Tables,
    cfg: SimConfig,
    scales: Scales,
    axis_name: Optional[str] = None,
    n_devices: int = 1,
    pair_tables=None,
    coulomb_tables=None,
) -> Tuple[SimState, StepOutputs]:
    g = cfg.grid
    phys = cfg.physics
    run = cfg.run
    nz, nr = g.nz, g.nr
    zones = state.zones
    key = jax.random.fold_in(state.key, state.ncycle)
    if axis_name is not None:
        # independent stream per device (deterministic in device count)
        key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
    k_src, k_trk, k_rr = jax.random.split(key, 3)

    def psum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    # ---- zone-axis device sharding (run.zone_shard) -----------------
    # The zone-batched phases (volume_em, FP solve, pair tensors) are
    # independent per zone; each device computes Z/n_devices zones and
    # the small per-zone outputs are all-gathered — the device-mesh
    # analogue of the reference's dynamic zone farm (update2d.f:190-214,
    # imcvol2d_para.f:26-78). Per-zone results are computed identically
    # regardless of placement, so outputs are bitwise equal to the
    # replicated path.
    Z = nz * nr
    zshard = (
        axis_name is not None and n_devices > 1 and run.zone_shard
        and Z >= n_devices
    )
    Zs = -(-Z // n_devices)
    Zp = Zs * n_devices

    def _zflat(x):
        return x.reshape((Z,) + x.shape[2:])

    def _zpad(x):
        if Zp == Z:
            return x
        # edge-replicate; scalar-contaminating leaves are masked by the
        # caller (fp pads zero n_e/tna so padded zones are inert)
        return jnp.concatenate(
            [x, jnp.repeat(x[-1:], Zp - Z, axis=0)], axis=0
        )

    def zslice(x, keep2d=True):
        """(nz, nr, ...) -> this device's (Zs, 1, ...) zone slice."""
        s = jax.lax.dynamic_slice_in_dim(
            _zpad(_zflat(x)), jax.lax.axis_index(axis_name) * Zs, Zs,
            axis=0,
        )
        return s.reshape((Zs, 1) + s.shape[1:]) if keep2d else s

    def zslice_flat(x):
        """(Z, ...) -> this device's (Zs, ...) zone slice."""
        return jax.lax.dynamic_slice_in_dim(
            _zpad(x), jax.lax.axis_index(axis_name) * Zs, Zs, axis=0
        )

    def zgather(x):
        """(Zs, 1, ...) or (Zs, ...) device slice -> full (nz, nr, ...)."""
        if x.ndim >= 2 and x.shape[1] == 1:
            x = x.reshape((x.shape[0],) + x.shape[2:])
        g = jax.lax.all_gather(x, axis_name, axis=0, tiled=True)
        return g[:Z].reshape((nz, nr) + x.shape[1:])

    zmask = None   # (Zs, 1) validity of this device's slice (padding)
    if zshard and Zp != Z:
        zmask = jax.lax.dynamic_slice_in_dim(
            jnp.arange(Zp) < Z,
            jax.lax.axis_index(axis_name) * Zs, Zs, axis=0,
        ).reshape(Zs, 1)

    # ---- 0. census replay: reset flight clocks (imcfield2d.f:117) ---
    photons = state.photons._replace(
        dcen=jnp.where(
            state.photons.alive,
            jnp.float32(scales.c) * state.dt.astype(jnp.float32),
            0.0,
        )
    )
    # previous-step census energy per zone, for the budget
    from compton2d_tpu.transport.tracking import zone_accum

    zid = (
        jnp.clip(photons.jz, 0, nz - 1) * nr
        + jnp.clip(photons.kr, 0, nr - 1)
    )
    ecens_prev = psum(
        zone_accum(
            jnp.where(photons.alive, photons.w, 0.0), zid, nz * nr
        ).reshape(nz, nr)
    )

    # ---- 1. zone pass (imcgen2d): B, emissivities, budget -----------
    B = equipartition_b(
        zones.ep_switch, zones.tea, zones.tna, zones.n_e, zones.f_pair,
        zones.B_field, tables.gamma_bar.forward,
    )
    zones = zones._replace(B_field=B)

    l_min = jnp.minimum(grid.dz, grid.dr) * jnp.ones_like(grid.vol)
    if zshard:
        # each device runs its zone slice as an (Zs, 1) grid, results
        # all-gathered (bitwise equal to the replicated pass: per-zone
        # computation is placement-independent)
        ve_s = volume_em(
            tables.e_ph, tables.gnt, zslice(zones.f_nt),
            zslice(zones.tea), zslice(zones.n_e), zslice(B),
            zslice(zones.amxwl), zslice(grid.vol),
            zslice(grid.zone_surf), zslice(l_min), state.dt,
            tables.sync, scales, f_pair=zslice(zones.f_pair),
        )
        ve = jax.tree_util.tree_map(zgather, ve_s)
    else:
        ve = volume_em(
            tables.e_ph, tables.gnt, zones.f_nt, zones.tea, zones.n_e,
            B, zones.amxwl, grid.vol, grid.zone_surf, l_min, state.dt,
            tables.sync, scales, f_pair=zones.f_pair,
        )

    nst_eff = cfg.source.nst * max(cfg.source.split, 1)
    budget = sourcing.compute_budget(
        src, ve.eloss_tot, ecens_prev, state.ed_abs,
        grid.area_lower, grid.area_upper, grid.area_inner,
        grid.area_outer,
        state.dt, state.dt_prev, max(nst_eff // n_devices, 1),
        cfg.source.bias_cap, scales.sigma_sb,
        dh_sentinel=bool(phys.dh_sentinel),
        replicas=n_devices,
    )

    # census population control (weight-window RR, replaces the
    # reference's hard stop at ucens overflow, imctrk2d.f:573-577);
    # sized by this step's actual emission count so fresh photons always
    # find slots. bingo used the pre-roulette census energy, so the
    # realized roulette delta e_rr enters the audit balance.
    if run.census_rr:
        from compton2d_tpu.transport.population import census_roulette

        photons, e_rr, n_rr = census_roulette(
            photons, k_rr, run.census_rr_hi, run.census_rr_lo,
            n_reserve=budget.n_new,
        )
    else:
        e_rr = jnp.zeros((), jnp.float32)
        n_rr = jnp.zeros((), jnp.int32)

    # ---- 1b. pair physics from the previous census field ------------
    # (imcgen2d.f:354-396: normalize n_ph, smooth, kgg_calc, pairprod)
    if phys.pair_switch and pair_tables is not None:
        from compton2d_tpu.physics import pairs as pair_mod

        from compton2d_tpu.transport.tracking import loggrid_bin

        ngg = g.n_gg
        egg32 = tables.e_gg.astype(jnp.float32)
        gbin, in_gg = loggrid_bin(
            photons.e, jnp.log(tables.e_gg[0]),
            jnp.log(tables.e_gg[1] / tables.e_gg[0]), ngg,
        )
        cnts = jnp.where(
            photons.alive & in_gg,
            photons.w / jnp.maximum(photons.e, 1e-30),
            0.0,
        )
        from compton2d_tpu.transport.tracking import hist2d_accum

        nph_scaled = psum(hist2d_accum(cnts, zid, nz * nr, gbin, ngg))
        de_gg = jnp.concatenate(
            [jnp.diff(egg32), jnp.ones((1,), jnp.float32)]
        )
        k_nph = jnp.float32(scales.nfield_to_dgic)
        nph_phys = (
            nph_scaled * k_nph
            / grid.vol.reshape(-1, 1).astype(jnp.float32)
            / de_gg[None, :]
        )
        nph_raw = nph_phys.reshape(nz, nr, ngg)   # n_ph1.dat dump
        tea_flat = zones.tea.reshape(-1).astype(jnp.float32)
        f_flat = zones.f_nt.reshape(nz * nr, -1).astype(jnp.float32)
        npos_flat = zones.n_pos.reshape(nz * nr, -1).astype(jnp.float32)
        ne_flat = zones.n_e.reshape(-1).astype(jnp.float32)
        if zshard:
            # per-zone pair tensors on this device's zone slice
            # (sharded pairprod/pa_calc farm, imcvol2d-style P2)
            nph_phys = zslice_flat(nph_phys)
            tea_flat = zslice_flat(tea_flat)
            f_flat = zslice_flat(f_flat)
            npos_flat = zslice_flat(npos_flat)
            ne_flat = zslice_flat(ne_flat)
        with jax.named_scope("pairs"):
            nph_sm = pair_mod.nph_smooth(nph_phys, egg32, tea_flat)
            k_gg_new = jnp.matmul(
                nph_sm, pair_tables.kgg_mat.T,
                precision=jax.lax.Precision.HIGHEST,
            )
            dn_pp_new = pair_mod.dn_pp_from_field(
                nph_sm, pair_tables.pp_tensor
            )
            dne_pa_new, dnp_pa_new = pair_mod.pa_rates(
                f_flat, npos_flat, ne_flat,
                pair_tables.vsigma, tables.gnt.astype(jnp.float32),
            )
        if zshard:
            nph_fit = zgather(nph_sm)
            k_gg_new = zgather(k_gg_new)
            dn_pp_new = zgather(dn_pp_new)
            dne_pa_new = zgather(dne_pa_new)
            dnp_pa_new = zgather(dnp_pa_new)
        else:
            nph_fit = nph_sm.reshape(nz, nr, ngg)
            k_gg_new = k_gg_new.reshape(nz, nr, ngg)
            dn_pp_new = dn_pp_new.reshape(nz, nr, -1)
            dne_pa_new = dne_pa_new.reshape(nz, nr, -1)
            dnp_pa_new = dnp_pa_new.reshape(nz, nr, -1)
        state = state._replace(
            k_gg=k_gg_new,
            dn_pp=dn_pp_new,
            dne_pa=dne_pa_new,
            dnp_pa=dnp_pa_new,
        )
    else:
        nph_raw = jnp.zeros((nz, nr, g.n_gg))
        nph_fit = nph_raw

    # ---- 2. emit new photons ----------------------------------------
    # named scopes label the phases' device ops in a profiler trace
    # (tools/profile_phases.py)
    with jax.named_scope("sourcing"):
        photons, e_src_lost = sourcing.emit(
            photons, k_src, budget, src,
            grid.r_edges, grid.z_edges, grid.zone_surf,
            ve.eps_tot, ve.eps_th, ve.eloss_th, ve.eloss_tot,
            tables.e_ph, state.dt, nz, nr, c_scaled=scales.c,
        )

    # ---- 3. tracking ------------------------------------------------
    sigma_zone = zone_sigma_table(
        tables.sigma_e, zones.f_nt, tables.gnt, zones.n_e,
        zones.f_pair if phys.pair_switch else None,
    ).reshape(nz * nr, -1).astype(jnp.float32)
    kappa_zone = ve.kappa_tot.reshape(nz * nr, -1).astype(jnp.float32)
    kgg_zone = state.k_gg.reshape(nz * nr, -1).astype(jnp.float32)
    cdf_rows = zones.cdf_nt.reshape(nz * nr, -1).astype(jnp.float32)

    ctx = TrackContext(
        r_edges=grid.r_edges.astype(jnp.float32),
        z_edges=grid.z_edges.astype(jnp.float32),
        opac_zone=jnp.stack([sigma_zone, kappa_zone], axis=-1),
        kgg_zone=kgg_zone,
        cdf_nt=cdf_rows,
        gnt=tables.gnt,
        e_ph_log0=jnp.log(tables.e_ph[0]),
        e_ph_dlog=jnp.log(tables.e_ph[1] / tables.e_ph[0]),
        e_gg_log0=jnp.log(tables.e_gg[0]),
        e_gg_dlog=jnp.log(tables.e_gg[1] / tables.e_gg[0]),
        e_field_log0=jnp.log(tables.e_field[0]),
        e_field_dlog=jnp.log(tables.e_field[1] / tables.e_field[0]),
        hu=tables.hu,
        mu_edges=tables.mu_edges,
        lc_lo=tables.lc_lo,
        lc_hi=tables.lc_hi,
        e_ref=tables.e_ref,
        p_ref_t=tables.p_ref.T,
        w_abs_t=tables.w_abs.T,
        tbbl_pos=src.tbb_lower > 0.0,
        # 1/(n_eff sigma_T L F_tot): the stratified-scatter normalizer
        # (Z = <sigma_KN ratio> under the sampled f/F_tot measure =
        # sig_s * inv_nsigt; same quadrature as zone_sigma_table)
        inv_nsigt=(
            1.0
            / jnp.maximum(
                (
                    zones.n_e * (1.0 + 2.0 * zones.f_pair)
                    if phys.pair_switch
                    else zones.n_e
                ).reshape(-1).astype(jnp.float32)
                * jnp.float32(compton_sigma_t * scales.L)
                * jnp.sum(
                    zones.f_nt[..., :-1] * jnp.diff(tables.gnt), axis=-1
                ).reshape(-1).astype(jnp.float32),
                1e-38,
            )
        ),
        time=state.time,
        dt=state.dt,
        inv_c=jnp.float32(scales.inv_c),
    )
    if cfg.source.strat_split:
        from compton2d_tpu.physics.electron_dist import gnt_grid

        # gnt holds gamma-1; the grid is static given num_nt, so the
        # cut index is computed host-side (tables.gnt is traced here)
        strat_icut = int(
            np.searchsorted(
                gnt_grid(g.num_nt), cfg.source.strat_gamma_c - 1.0
            )
        )
        strat_icut = min(max(strat_icut, 1), g.num_nt - 1)
    else:
        strat_icut = 0
    st = TrackStatics(
        nz=nz, nr=nr,
        cr_sent=phys.cr_sent,
        pair_switch=phys.pair_switch,
        rmin_positive=g.r_min > 1e-10,
        max_iters=run.max_flight_iters,
        max_scatter_tries=run.max_scatter_tries,
        weight_floor=cfg.source.weight_floor,
        spec_switch=phys.spec_switch,
        strat_split=cfg.source.strat_split,
        strat_icut=strat_icut,
        strat_p_max=cfg.source.strat_p_max,
        strat_copies=cfg.source.strat_copies,
    )

    tallies = Tallies.zeros(
        nz, nr, g.num_nt, g.nphfield, g.n_gg, g.nmu, g.nphtotal, g.nph_lc
    )
    events = EventBuffer.empty(run.event_capacity)

    tallies = tallies._replace(
        e_src_lost=tallies.e_src_lost + e_src_lost,
        e_rr=tallies.e_rr + e_rr,
        n_rr=tallies.n_rr + n_rr,
    )
    n_tracked = psum(
        jnp.sum(photons.alive.astype(jnp.int32)).astype(jnp.int32)
    )
    with jax.named_scope("tracking"):
        photons, tallies, events = transport_step(
            photons, tallies, events, k_trk, ctx, st
        )
    with jax.named_scope("census_tally"):
        tallies = census_tally(photons, tallies, ctx, st)
        # deterministic tally reduction over the photon-sharded mesh
        # (the reference's MPI_REDUCE trees, xec2d.f:325-399)
        tallies = psum(tallies)

    # ---- 4. FP electron update (update2d) ---------------------------
    do_fp = (not phys.t_const)
    if do_fp:
        n_field_real = tallies.n_field  # photon counts (already scaled)
        zones_fp = zones
        fl = phys.flare
        if fl.enabled:
            # coronal-flare Gaussian turbulence enhancement
            # (update2d.f:543-558); flare coordinates are cm -> scaled
            r_mid = 0.5 * (grid.r_edges[1:] + grid.r_edges[:-1])
            z_mid = 0.5 * (grid.z_edges[1:] + grid.z_edges[:-1])
            y = 0.5 * (
                ((r_mid[None, :] - fl.r_flare / scales.L)
                 / (fl.sigma_r / scales.L)) ** 2
                + ((z_mid[:, None] - fl.z_flare / scales.L)
                   / (fl.sigma_z / scales.L)) ** 2
                + ((state.time - fl.t_flare) / fl.sigma_t) ** 2
            )
            tl_flare = jnp.where(
                y < 100.0, fl.amplitude / jnp.exp(jnp.minimum(y, 100.0)),
                0.0,
            ).astype(jnp.float32)
            zones_fp = zones._replace(
                turb_lev=zones.turb_lev + tl_flare,
                tna=zones.tna * (1.0 + tl_flare),
            )
        if zshard:
            # the reference's FP zone farm (update2d.f:190-214): each
            # device solves its zone slice, the updated ZoneState
            # (small: ~Z*num_nt f32) is all-gathered
            zones_fp_s = jax.tree_util.tree_map(zslice, zones_fp)
            zvalid = None
            if zmask is not None:
                # padded zones are made inert (no protons -> skipped by
                # the tna>1 guard, zero leptons -> zero energy); the
                # explicit validity mask additionally gates injection
                # (which is independent of n_e/tna) and the e_el audit
                # sums inside fp_step
                zvalid = zmask
                zones_fp_s = zones_fp_s._replace(
                    n_e=jnp.where(zmask, zones_fp_s.n_e, 0.0),
                    tna=jnp.where(zmask, zones_fp_s.tna, 0.0),
                )
            j_row_full = jnp.broadcast_to(
                jnp.arange(nz, dtype=jnp.float32)[:, None], (nz, nr)
            )
            with jax.named_scope("fp"):
                fpr = fp_step(
                    zones_fp_s, zslice(n_field_real), tables,
                    zslice(grid.vol), float(cfg.grid.z_max), grid.dz,
                    state.dt, state.time, zslice(ve.eloss_sy), phys,
                    scales,
                    dn_pp=zslice(state.dn_pp),
                    dne_pa=zslice(state.dne_pa),
                    dnp_pa=zslice(state.dnp_pa), coulomb=coulomb_tables,
                    j_row=zslice(j_row_full),
                    slab_vol=jnp.sum(grid.vol) / nz,
                    zone_valid=zvalid,
                    eloss_br=zslice(ve.eloss_br),
                )
            fpr = fpr._replace(
                zones=jax.tree_util.tree_map(zgather, fpr.zones),
                dT_max=jax.lax.pmax(fpr.dT_max, axis_name),
                # dt ladder (update2d.f:232-243) is monotone
                # non-increasing in dT_max, so the global ladder value
                # ladder(pmax(dT_max)) == pmin(local dt_new); without
                # this, adaptive_dt would apply a per-device dt and
                # replicated state.dt/time would silently diverge
                dt_new=jax.lax.pmin(fpr.dt_new, axis_name),
                e_el_old=psum(fpr.e_el_old),
                e_el_new=psum(fpr.e_el_new),
                substeps=jax.lax.pmax(fpr.substeps, axis_name),
                incomplete=psum(fpr.incomplete),
            )
        else:
            with jax.named_scope("fp"):
                fpr = fp_step(
                    zones_fp, n_field_real, tables, grid.vol,
                    float(cfg.grid.z_max), grid.dz,
                    state.dt, state.time,
                    ve.eloss_sy, phys, scales,
                    dn_pp=state.dn_pp, dne_pa=state.dne_pa,
                    dnp_pa=state.dnp_pa,
                    coulomb=coulomb_tables,
                    eloss_br=ve.eloss_br,
                )
        # the flare modifications to tna/turb_lev are ephemeral
        # (Tp_flare, update2d.f:558)
        fpr_zones = fpr.zones._replace(
            tna=zones.tna, turb_lev=zones.turb_lev
        )
        # only apply after the field is established (xec2d: update only
        # for ncycle > 0)
        apply = state.ncycle > 0
        zones_new = jax.tree_util.tree_map(
            lambda new, old: jnp.where(
                jnp.reshape(apply, (1,) * new.ndim), new, old
            ),
            fpr_zones, zones,
        )
        dT_max = jnp.where(apply, fpr.dT_max, 0.0)
        e_el_old, e_el_new = fpr.e_el_old, fpr.e_el_new
        fp_sub = fpr.substeps
        fp_inc = jnp.where(apply, fpr.incomplete, 0)
    else:
        zones_new = zones
        dT_max = jnp.zeros(())
        e_el_old = jnp.zeros(())
        e_el_new = jnp.zeros(())
        fp_sub = jnp.zeros((), jnp.int32)
        fp_inc = jnp.zeros((), jnp.int32)

    # ---- 5. advance time (xec2d.f:100-106: constant dt) -------------
    # opt-in adaptive dt (run.adaptive_dt): apply the FP ladder's
    # dt_new (update2d.f:232-243) with the dt_min = dr_min/c guard
    # (update2d.f:257). The reference computes this ladder but its
    # apply site is dead code, so constant dt remains the faithful
    # default; this is the completion of what the authors wired up.
    dt_next = state.dt
    if run.adaptive_dt and do_fp:
        dt_min = (
            jnp.minimum(jnp.min(jnp.diff(grid.r_edges)), grid.dz)
            * jnp.float32(scales.L / cn.C_LIGHT)
        )
        dt_next = jnp.where(
            state.ncycle > 0,
            jnp.maximum(
                fpr.dt_new.astype(state.dt.dtype),
                dt_min.astype(state.dt.dtype),
            ),
            state.dt,
        )
    new_state = state._replace(
        zones=zones_new,
        photons=photons,
        time=state.time + state.dt,
        dt=dt_next,
        dt_prev=state.dt,
        ncycle=state.ncycle + 1,
        ed_abs=tallies.ed_in - tallies.ed_ref,
        ed_ref=tallies.ed_ref,
    )
    out = StepOutputs(
        tallies=tallies,
        events=events,
        bingo=budget.bingo,
        e_el_old=e_el_old,
        e_el_new=e_el_new,
        dT_max=dT_max,
        fp_substeps=fp_sub,
        fp_incomplete=fp_inc,
        n_tracked=n_tracked,
        nph_raw=nph_raw,
        nph_fit=nph_fit,
    )
    return new_state, out


def write_diagnostics(sim: "Simulation", out_dir: str,
                      extras: bool = False):
    """The reference's diagnostic dumps (SURVEY.md §4): icloss.dat,
    seb.dat, fnt snapshots, nfield.dat, eic.dat.

    ``extras=True`` additionally dumps the reference-DEACTIVATED
    emissivity channels (thermal cyclotron + pair-annihilation vdsigma
    spectrum + the Eloss_cy tally, volume2d.f:253-339) — excluded from
    the active budget in both codes (volume2d.f:347-353,
    imcgen2d.f:328-331), recorded here for completeness."""
    import os

    from compton2d_tpu.io import outputs as outs

    os.makedirs(out_dir, exist_ok=True)
    if extras:
        from compton2d_tpu.physics import emissivity_extras as ex

        e_ph = np.asarray(sim.tables.e_ph)
        tea = np.asarray(sim.state.zones.tea)
        n_e = np.asarray(sim.state.zones.n_e)
        B = np.asarray(sim.state.zones.B_field)
        j_cy, kap_cy = ex.cyclotron(e_ph, tea, n_e, B)
        el_cy = ex.eloss_cy(e_ph, j_cy)
        np.savetxt(
            os.path.join(out_dir, "eloss_cy.dat"),
            el_cy.reshape(tea.shape[0], -1), fmt="%14.6e",
        )
        np.savetxt(
            os.path.join(out_dir, "j_cy.dat"),
            j_cy.reshape(-1, e_ph.shape[0]), fmt="%14.6e",
        )
        if sim.cfg.physics.pair_switch:
            j_pa = ex.annihilation_spectrum(
                e_ph, np.asarray(sim.tables.gnt),
                np.asarray(sim.state.zones.f_nt),
                np.asarray(sim.state.zones.n_pos), n_e,
            )
            np.savetxt(
                os.path.join(out_dir, "j_pa.dat"),
                j_pa.reshape(-1, e_ph.shape[0]), fmt="%14.6e",
            )
    t = sim.tables
    s = sim.state
    outs.write_icloss(
        os.path.join(out_dir, "icloss.dat"), t.gnt, t.e_field, t.f_ic
    )
    outs.write_seb(
        os.path.join(out_dir, "seb.dat"), t.gnt, s.zones.f_nt,
        s.zones.n_pos,
    )
    outs.write_electron_snapshots(
        out_dir, t.gnt, np.asarray(s.zones.f_nt),
        np.asarray(s.zones.n_pos), int(s.ncycle),
    )
    if sim.last_outputs is not None:
        outs.write_nfield(
            os.path.join(out_dir, "nfield.dat"), t.e_field,
            sim.last_outputs.tallies.n_field, sim.scales.E,
        )
        outs.write_eic(
            os.path.join(out_dir, "eic.dat"), t.gnt,
            sim.last_outputs.tallies.e_ic, sim.scales.E,
        )
        outs.write_esp(
            os.path.join(out_dir, "esp.dat"), t.gnt,
            sim.last_outputs.tallies.n_esp,
        )
        if sim.cfg.physics.pair_switch:
            outs.write_nph(
                os.path.join(out_dir, "n_ph1.dat"), t.e_gg,
                sim.last_outputs.nph_raw,
            )
            outs.write_nph(
                os.path.join(out_dir, "n_ph2.dat"), t.e_gg,
                sim.last_outputs.nph_fit,
            )
