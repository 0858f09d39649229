"""Weak-scaling harness: fixed photon work per device, 1 -> N processes.

Without multi-chip hardware this exercises the full multi-process path
(jax.distributed + global photon mesh + cross-process psum reductions
+ per-process event spooling) on virtual CPU devices — the analogue of
testing an MPI code on a laptop (SURVEY.md §4). The reference's
scaling story was MPI ranks + imcredist rebalancing; here equal
per-device budgets make rebalancing unnecessary by construction.

Parent mode:   python tools/weak_scaling.py            (runs 1 and 2 procs)
Child mode:    spawned internally with _WS_CHILD env vars.

Prints a JSON line per configuration and a final efficiency line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEV_PER_PROC = 4
SLOTS_PER_DEV = 1 << 13
NST_PER_DEV = 2000
STEPS = 4


def child():
    nproc = int(os.environ["_WS_NPROC"])
    pid = int(os.environ["_WS_PID"])
    port = os.environ["_WS_PORT"]
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEV_PER_PROC}"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from compton2d_tpu.parallel import distributed as dist

    if nproc > 1:
        dist.initialize(f"localhost:{port}", nproc, pid)
    mesh = dist.global_photon_mesh()
    ndev = mesh.devices.size

    from compton2d_tpu.examples import small_corona

    sim = small_corona(
        nz=4, nr=3, nst=NST_PER_DEV * ndev,
        n_slots=SLOTS_PER_DEV * ndev,
        num_nt=60, n_vol=64, nphfield=64, t_const=True, mesh=mesh,
    )
    for _ in range(2):
        sim.step()
    jax.block_until_ready(sim.state.photons.alive)
    t0 = time.time()
    hist = 0
    for _ in range(STEPS):
        out = sim.step()
        hist += int(out.n_tracked)
    jax.block_until_ready(sim.state.photons.alive)
    dt = (time.time() - t0) / STEPS

    # ---- checkpoint/resume cycle (per-process shard files, the
    # analogue of the reference's pNNN_misc/census dumps) -------------
    ckpt_ok = True
    ckpt_path = os.environ.get("_WS_CKPT")
    if ckpt_path:
        from jax.experimental import multihost_utils

        from compton2d_tpu.io.checkpoint import (
            load_checkpoint, save_checkpoint,
        )

        def fingerprint(sim, steps=2):
            fps = []
            for _ in range(steps):
                out = sim.step()
                fps.append((
                    float(jnp.sum(out.tallies.ecens)),
                    float(jnp.sum(out.tallies.fout)),
                    int(out.n_tracked),
                ))
            return fps

        import jax.numpy as jnp

        save_checkpoint(ckpt_path, sim.state)
        if nproc > 1:
            multihost_utils.sync_global_devices("ckpt_written")
        saved_state = sim.state
        fp_ref = fingerprint(sim)
        sim.state = load_checkpoint(ckpt_path, saved_state)
        fp_res = fingerprint(sim)
        ckpt_ok = fp_ref == fp_res
        if not ckpt_ok:
            print(
                f"# pid {pid}: resume mismatch {fp_ref} vs {fp_res}",
                file=sys.stderr, flush=True,
            )
        assert ckpt_ok, "checkpoint/resume not bit-identical"

    if pid == 0:
        print(json.dumps({
            "processes": nproc, "devices": ndev,
            "step_s": dt, "histories_per_s": hist / (dt * STEPS),
            "ckpt_resume_bitwise": bool(ckpt_ok),
        }), flush=True)


def run_config(nproc: int, port: int) -> dict:
    import tempfile

    ckpt_dir = tempfile.mkdtemp(prefix="ws_ckpt_")
    procs = []
    for pid in range(nproc):
        env = dict(os.environ)
        env.update(
            _WS_CHILD="1", _WS_NPROC=str(nproc), _WS_PID=str(pid),
            _WS_PORT=str(port),
            _WS_CKPT=os.path.join(ckpt_dir, "state.npz"),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)],
                env=env, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL if pid else None,
                text=True, cwd=REPO,
            )
        )
    out0, _ = procs[0].communicate(timeout=900)
    for p in procs[1:]:
        p.wait(timeout=900)
    line = [ln for ln in out0.splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


def main():
    if os.environ.get("_WS_CHILD"):
        child()
        return
    r1 = run_config(1, 59777)
    print(json.dumps(r1))
    r2 = run_config(2, 59779)
    print(json.dumps(r2))
    eff = r1["step_s"] / r2["step_s"]
    print(json.dumps({
        "metric": "weak_scaling_efficiency_1to2proc",
        "value": eff, "unit": "x",
    }))


if __name__ == "__main__":
    main()
