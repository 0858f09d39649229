"""Benchmark: photon histories per second on one GPU.

    python bench.py        # BENCH_SIZE=full|large|small, BENCH_STEPS=16

Prints ONE JSON line:
  {"metric": "photon_histories_per_sec_per_chip", "value": N,
   "unit": "histories/s", "step_s": ..., "compile_s": ...,
   "tracking_rounds_per_step": ..., "mrk421_histories_per_s": ...,
   "device": {"platform", "kind", "count", "nvidia_smi"}}

``value`` is the thermal corona at 8x4 zones with reference-size tables
(200 gamma bins, 400 emissivity and field bins, general.pa) and 131072
photon slots; ``mrk421_histories_per_s`` is the Mrk 421 SSC flare
workload (postprocessing/mrk421_lc.input). A "history" is one photon
tracked through a full time step (census replays + fresh emissions),
the unit the reference's task farm processes per rank per cycle.

Runs only on a GPU: any other backend is an error, not a fallback.
"""
from __future__ import annotations

import json
import os
import sys
import time


def _measure(sim, steps):
    """Time ``steps`` simulation steps. The step() loop's async dispatch
    overlaps host work with device execution; the per-step scalars are
    fetched only after the window."""
    import jax

    outs = []
    jax.block_until_ready(sim.state.photons.alive)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = sim.step()
        outs.append((out.n_tracked, out.tallies.trk_rounds))
    jax.block_until_ready(outs[-1][0])
    dt = time.perf_counter() - t0
    histories = sum(int(a) for a, _ in outs)
    rounds = sum(int(b) for _, b in outs)
    return dt, histories, rounds


def main():
    import jax

    from compton2d_tpu import runtime

    runtime.require_gpu()
    runtime.enable_compile_cache()
    from compton2d_tpu.examples import small_corona

    size = os.environ.get("BENCH_SIZE", "full")
    steps = int(os.environ.get("BENCH_STEPS", 16))
    t_const = bool(int(os.environ.get("BENCH_TCONST", 0)))
    if size == "small":
        sim = small_corona(
            nz=4, nr=3, nst=5000, n_slots=1 << 14, num_nt=100,
            n_vol=128, nphfield=128, t_const=True,
        )
        steps = 3
    elif size == "large":
        # 32x32 = 1024 zones: the one-hot zone tallies at scale
        sim = small_corona(
            nz=32, nr=32, nst=60000, n_slots=1 << 17, num_nt=200,
            n_vol=400, nphfield=128, t_const=t_const,
        )
    else:
        sim = small_corona(
            nz=8, nr=4, nst=60000, n_slots=1 << 17, num_nt=200,
            n_vol=400, nphfield=400, t_const=t_const,
            max_flight_iters=int(os.environ.get("BENCH_MAX_ITERS", 256)),
        )

    # warmup: compile + populate the census
    t0 = time.perf_counter()
    jax.block_until_ready(sim.step())
    compile_s = time.perf_counter() - t0
    sim.step()
    dt_s, histories, rounds = _measure(sim, steps)

    # Mrk 421 flagship workload (BENCH_MRK421=0 to skip)
    mrk_value = None
    if int(os.environ.get("BENCH_MRK421", 1)) and size != "small":
        from compton2d_tpu.examples import mrk421

        sim2 = mrk421(nst=20000, n_slots=1 << 16)
        sim2.step()
        sim2.step()
        mdt, mhist, _ = _measure(sim2, steps)
        mrk_value = mhist / mdt

    d = jax.devices()
    rec = {
        "metric": "photon_histories_per_sec_per_chip",
        "value": histories / dt_s,
        "unit": "histories/s",
        "step_s": dt_s / steps,
        "compile_s": compile_s,
        "tracking_rounds_per_step": rounds / steps,
        "size": size,
        "device": {
            "platform": d[0].platform,
            "kind": d[0].device_kind,
            "count": len(d),
            "nvidia_smi": runtime.gpu_name_and_power_limit(),
        },
    }
    if mrk_value is not None:
        rec["mrk421_histories_per_s"] = mrk_value
    print(json.dumps(rec))
    print(f"# histories={histories} steps={steps}", file=sys.stderr)


if __name__ == "__main__":
    main()
