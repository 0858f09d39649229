"""Per-phase device time of the simulation step, from a profiler trace.

    python tools/profile_phases.py [--nz 8 --nr 4 --n-slots 131072
        --nst 60000 --pairs 1 --steps 3 --out profile_out]
    python tools/profile_phases.py --nz 99 --nr 99 --no-trace --steps 1

Builds the thermal corona at reference-size tables, times a cold step
(compile included) and a warm step, then traces ``--steps`` steps with
``jax.profiler`` (one ``block_until_ready`` per step) and reduces the
trace:

- device busy time per named phase of the step (``jax.named_scope`` in
  driver._step_impl: sourcing, tracking, census_tally, pairs, fp; the
  rest is "other"), each device op classified by the ``op_name``
  metadata of its HLO instruction in the compiled step;
- the device's idle share, in the traced window and against the
  untraced step time (tracing slows the host);
- the longest device ops, and the step's ``while`` loops by host time;
- the flight loop: device busy time and traced wall time per iteration.

Prints one JSON summary and writes it, with the raw trace and the
compiled step's HLO text, under ``--out``. Runs only on a GPU.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

PHASES = ("sourcing", "tracking", "census_tally", "pairs", "fp")
STEP_SPAN = "profiled_step"

_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\""
)


def hlo_op_phases(hlo_text: str) -> dict:
    """HLO instruction name -> phase, from the op_name metadata of the
    compiled (post-optimization) module text."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        parts = m.group(2).split("/")
        out[m.group(1)] = next((p for p in PHASES if p in parts), "other")
    return out


def _hlo_name(ev_name: str, stats: dict, op_phase: dict):
    """The HLO instruction a trace event ran. Kernels replayed from a
    CUDA graph carry ``hlo_op=command_buffer``; their kernel name is the
    fusion's name with '.' written as '_'."""
    for cand in (str(stats.get("hlo_op", "")), ev_name):
        if cand in op_phase:
            return cand
    head, _, tail = ev_name.rpartition("_")
    if tail.isdigit() and f"{head}.{tail}" in op_phase:
        return f"{head}.{tail}"
    return None


def _union(intervals) -> int:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _clip(intervals, w0, w1):
    return [(max(a, w0), min(b, w1)) for a, b in intervals
            if b > w0 and a < w1]


def reduce_trace(xplane_path: str, op_phase: dict, n_iters: int,
                 step_s: float = 0.0,
                 device_plane: str = "/device:GPU:0") -> dict:
    """Per-phase device busy time, idle share, the while loops by host
    time, and flight-loop figures of the traced steps.

    Device events (kernels and copies on ``device_plane``) are named
    after their HLO instruction and classified by its named scope;
    events of no instruction of the step count as busy, phase
    "unattributed". Host events of the step's ``while`` instructions
    give each loop's wall time. The flight loop is the tracking-scope
    while with the most host time; ``n_iters`` is the number of its
    iterations over the traced steps (the trk_rounds tallies).
    ``step_s`` is the untraced warm step time: tracing slows the
    host, so the idle share is also given against it."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    spans, dev, loops = [], [], []
    for plane in pd.planes:
        on_dev = plane.name.startswith(device_plane)
        for line in plane.lines:
            for ev in line.events:
                if ev.name == STEP_SPAN:
                    spans.append((ev.start_ns, ev.end_ns))
                    continue
                st = dict(ev.stats)
                name = _hlo_name(ev.name, st, op_phase)
                if on_dev:
                    dev.append((ev.start_ns, ev.end_ns, ev.name,
                                op_phase.get(name, "unattributed")))
                elif name and name.startswith("while") \
                        and not line.name.startswith("pjrt"):
                    loops.append((ev.start_ns, ev.end_ns, name))
    if not spans or not dev:
        raise RuntimeError(
            f"trace has {len(spans)} step spans and {len(dev)} events "
            f"on {device_plane}"
        )
    spans.sort()
    n_steps = len(spans)
    phases = PHASES + ("other", "unattributed")
    per_phase = dict.fromkeys(phases, 0)
    busy = window = 0
    kernels, loop_time, loop_count = {}, {}, {}
    for s0, s1 in spans:
        in_step = [d for d in dev if s0 <= d[0] < s1]
        for p in phases:
            per_phase[p] += _union([(a, b) for a, b, _, q in in_step
                                    if q == p])
        busy += _union([(a, b) for a, b, _, _ in in_step])
        if in_step:
            window += max(d[1] for d in in_step) - min(d[0] for d in in_step)
        for a, b, n, p in in_step:
            k = kernels.setdefault(n, [0, 0, p])
            k[0] += 1
            k[1] += b - a
        for a, b, n in loops:
            if s0 <= a < s1:
                loop_time[n] = loop_time.get(n, 0) + (b - a)
                loop_count[n] = loop_count.get(n, 0) + 1
    trk_loops = [n for n in loop_time if op_phase.get(n) == "tracking"]
    flight = max(trk_loops, key=loop_time.get) if trk_loops else None
    f_busy = f_wall = 0
    if flight:
        for a, b, n in loops:
            if n == flight and any(s0 <= a < s1 for s0, s1 in spans):
                f_wall += b - a
                f_busy += _union(_clip([(x, y) for x, y, _, _ in dev],
                                       a, b))
    iters = max(n_iters, 1)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    ms = 1e-6 / n_steps
    return {
        "steps": n_steps,
        "device_ms_per_step": {k: v * ms for k, v in per_phase.items()},
        "busy_ms_per_step": busy * ms,
        "idle_share_traced": 1.0 - busy / window if window else 0.0,
        "idle_share_vs_untraced_step": (
            1.0 - busy * 1e-9 / n_steps / step_s if step_s else None
        ),
        "top_device_ops": [
            {"name": n, "calls_per_step": c / n_steps,
             "ms_per_step": t * ms, "phase": p}
            for n, (c, t, p) in top
        ],
        "while_loops_host_ms_per_step": {
            n: {"runs_per_step": loop_count[n] / n_steps,
                "ms": loop_time[n] * ms, "phase": op_phase.get(n)}
            for n in sorted(loop_time, key=loop_time.get, reverse=True)[:8]
        },
        "flight_loop": flight,
        "flight_iterations_per_step": n_iters / n_steps,
        "flight_device_busy_us_per_iteration": f_busy * 1e-3 / iters,
        "flight_wall_us_per_iteration_traced": f_wall * 1e-3 / iters,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nz", type=int, default=8)
    ap.add_argument("--nr", type=int, default=4)
    ap.add_argument("--n-slots", type=int, default=1 << 17)
    ap.add_argument("--nst", type=int, default=60000)
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--no-trace", dest="trace", action="store_false")
    args = ap.parse_args(argv)

    import jax

    from compton2d_tpu import runtime
    from compton2d_tpu.examples import small_corona

    runtime.require_gpu()
    runtime.enable_compile_cache()
    os.makedirs(args.out, exist_ok=True)
    sim = small_corona(
        nz=args.nz, nr=args.nr, nst=args.nst, n_slots=args.n_slots,
        num_nt=200, n_vol=400, nphfield=400, pair_switch=args.pairs,
    )
    rec = {"config": vars(args),
           "nvidia_smi": runtime.gpu_name_and_power_limit(),
           "device_kind": jax.devices()[0].device_kind}
    t0 = time.perf_counter()
    jax.block_until_ready(sim.step())
    rec["cold_step_s"] = time.perf_counter() - t0
    warm = []
    for _ in range(max(args.steps, 1)):
        t0 = time.perf_counter()
        out = sim.step()
        jax.block_until_ready(out)
        warm.append(time.perf_counter() - t0)
    rec["warm_step_s"] = warm
    rec["balance"] = sim.energy_audit()["balance"]
    rec["histories_per_step"] = int(out.n_tracked)
    rec["peak_gib"] = (
        jax.devices()[0].memory_stats()["peak_bytes_in_use"] / 2**30
    )

    if args.trace:
        trace_dir = os.path.join(args.out, "trace")
        n_iters = 0
        with jax.profiler.trace(trace_dir):
            for i in range(args.steps):
                with jax.profiler.TraceAnnotation(STEP_SPAN):
                    out = sim.step()
                    jax.block_until_ready(out)
                n_iters += int(out.tallies.trk_rounds)
        hlo = sim._step_jit.lower(
            sim.state, sim.src_static, sim.grid, sim.tables
        ).compile().as_text()
        path = sorted(glob.glob(
            os.path.join(trace_dir, "plugins", "profile", "*",
                         "*.xplane.pb")
        ))[-1]
        with open(os.path.join(args.out, "step_hlo.txt"), "w") as fh:
            fh.write(hlo)
        rec["trace"] = reduce_trace(path, hlo_op_phases(hlo), n_iters,
                                    step_s=float(np.median(warm)))
    print(json.dumps(rec, indent=1))
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(rec, fh, indent=1)


if __name__ == "__main__":
    main()
