"""The GPU entry points on the CPU: ``chip_smoke.py`` and ``bench.py``
refuse a non-GPU backend, the compile-cache helper, the distributed
bring-up's device mapping, chip_smoke's device-comparison helpers on
two CPU devices, and the profile tool's trace reduction."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from compton2d_tpu import runtime  # noqa: E402
from compton2d_tpu.validation import max_rel_err, ztest  # noqa: E402


@pytest.mark.parametrize("main", [chip_smoke.main, bench.main],
                         ids=["chip_smoke", "bench"])
def test_entry_point_refuses_cpu(main, capsys):
    with pytest.raises(SystemExit) as exc:
        main([]) if main is chip_smoke.main else main()
    assert "no GPU" in str(exc.value)
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the package it exits non-zero
    and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("env_dir", [True, False],
                         ids=["env_set", "env_unset"])
def test_compile_cache_dir(env_dir, tmp_path, monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(ROOT, ".jax_cache")
    try:
        assert runtime.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    # the default directory is fixed and ignored by git
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize("count,ids", [(None, None), (2, [0, 1])])
def test_distributed_initialize_maps_local_devices(count, ids,
                                                   monkeypatch):
    from compton2d_tpu.parallel import distributed

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    distributed.initialize("localhost:1234", 2, 1,
                           local_device_count=count)
    assert seen.pop("coordinator_address") == "localhost:1234"
    assert seen.pop("num_processes") == 2
    assert seen.pop("process_id") == 1
    assert seen == ({} if ids is None else {"local_device_ids": ids})


def test_max_rel_err_floor_and_nonfinite():
    ref = np.array([1.0, 1e-9, 0.0])
    assert max_rel_err(ref, ref) == 0.0
    got = ref + np.array([1e-4, 1e-9, 0.0])
    assert max_rel_err(got, ref) == pytest.approx(1.0)  # 1e-9 doubled
    # floor 1e-3 x max: the 1e-9 entry's error drops to 1e-6
    assert max_rel_err(got, ref, atol_frac=1e-3) == pytest.approx(
        1e-4, rel=1e-2)
    assert max_rel_err(got * np.nan, ref) == float("inf")
    with pytest.raises(ValueError):
        max_rel_err(ref[:2], ref)


def test_compare_on_devices_two_cpus():
    d0, d1 = jax.devices()[:2]
    x = np.linspace(0.1, 2.0, 64, dtype=np.float32)
    err = chip_smoke.compare_on_devices(
        "exp", jnp.exp, (x,), d0, d1, rtol=0.0, atol_frac=0.0, why="test")
    assert err == 0.0
    with pytest.raises(AssertionError):
        # a different function on one side cannot pass
        chip_smoke.check(
            max_rel_err(chip_smoke.run_on(d0, jnp.exp, (x,)),
                        chip_smoke.run_on(d1, jnp.sin, (x,))) <= 1e-3,
            "differs")


def _tiny_pairs():
    from compton2d_tpu.examples import small_corona

    return small_corona(nz=3, nr=2, nst=512, n_slots=1024, num_nt=40,
                        n_vol=32, nphfield=32, pair_switch=1)


def test_deterministic_phases_identical_on_two_cpus():
    """Every deterministic-phase comparison of phase 3, fed from a real
    state, gives identical results on two devices of one backend."""
    sim = _tiny_pairs()
    sim.step()
    sim.step()
    d0, d1 = jax.devices()[:2]
    names = []
    for name, fn, args, rtol, atol_frac, why in (
        chip_smoke.deterministic_phases(sim)
    ):
        assert 0.0 < rtol < 1e-2 and why
        assert chip_smoke.compare_on_devices(
            name, fn, args, d0, d1, rtol, atol_frac, why) == 0.0
        names.append(name)
    assert names == ["zone_sigma_table", "volume_em", "fp_step",
                     "pairs.kgg_mat", "pairs.dn_pp_from_field",
                     "pairs.pa_rates"]


def test_ztest_on_devices_two_cpus():
    d0, d1 = jax.devices()[2:4]
    seeds = [3, 5, 9]
    zs, a, b = chip_smoke.ztest_on_devices(
        _tiny_pairs, d0, d1, seeds=seeds, ref_seeds=seeds, steps=2)
    assert set(zs) == {"census", "escaped", "edep"}
    for k in zs:
        # same seeds on the same backend: identical replicates
        np.testing.assert_array_equal(a[k], b[k])
        assert zs[k] == 0.0
        assert a[k].std() > 0.0
    assert ztest(a, {k: v * 3.0 for k, v in b.items()})["census"] > 4.0


def test_profile_trace_reduction(tmp_path):
    """hlo_op_phases + reduce_trace on a CPU trace of a jitted function
    with a named while loop and a named matmul."""
    import glob

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import profile_phases as pp

    def f(x):
        with jax.named_scope("tracking"):
            def body(c):
                i, y = c
                return i + 1, jnp.sin(y) * 1.01
            _, y = jax.lax.while_loop(lambda c: c[0] < 10, body, (0, x))
        with jax.named_scope("fp"):
            return y @ y.T

    jf = jax.jit(f)
    x = jnp.ones((128, 128))
    jf(x).block_until_ready()
    phases = pp.hlo_op_phases(jf.lower(x).compile().as_text())
    assert "tracking" in phases.values() and "fp" in phases.values()
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(2):
            with jax.profiler.TraceAnnotation(pp.STEP_SPAN):
                jf(x).block_until_ready()
    path = glob.glob(str(tmp_path / "plugins/profile/*/*.xplane.pb"))[0]
    r = pp.reduce_trace(path, phases, n_iters=20, step_s=1.0,
                        device_plane="/host:CPU")
    assert r["steps"] == 2
    ms = r["device_ms_per_step"]
    assert ms["tracking"] > 0.0 and ms["fp"] > 0.0
    assert 0.0 <= r["idle_share_traced"] < 1.0
    assert 0.0 < r["idle_share_vs_untraced_step"] < 1.0
    assert r["busy_ms_per_step"] >= max(ms.values())
    assert r["top_device_ops"][0]["ms_per_step"] > 0.0
    # a kernel replayed from a CUDA graph is found by its kernel name
    assert pp._hlo_name("loop_add_fusion_12", {"hlo_op": "command_buffer"},
                        {"loop_add_fusion.12": "fp"}) == "loop_add_fusion.12"
