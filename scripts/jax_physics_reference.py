"""Write the JAX package's full-physics plant on solo12_trot_n50 and the
artifact manifests of its `run-motion` CLI to
tests/data/jax_physics_solo12_trot_n50.npz:

    refs_q_des, refs_qd_des, refs_tau_ff, refs_h_des, refs_K_lqr,
    refs_logic, refs_kp, refs_kd      sim/physics.build_references of the
                                      pipeline's nominal plan (float64),
                                      as its stage 4b builds them
    x0                                the episodes' initial state
    push_force, push_start, push_len  four fixed pushes: two unpushed (a
                                      zero force; a force that starts
                                      after the episode) and two drawn
                                      from numpy's default_rng(0)
    h, feet, rpy                      simulate_episode of each push
    slippage, cum_cost, fell          foot_slippage, tracking_cost[:, -1]
                                      and fell of those episodes
    manifest_solo12_trot              JSON: every file `run-motion --preset
                                      solo12_trot --sims 16 --physics-sims
                                      64 --terrain debris` wrote, with npz
                                      keys and shapes (.dat: rows and
                                      columns; figures and the preview:
                                      the name)
    manifest_mini_flat, manifest_mini_debris
                                      the same for `run-motion --preset
                                      solo12_trot_mini --sims 2
                                      --physics-sims 2` on flat ground
                                      and with `--terrain debris`

The nominal plan is the JAX package's float64 pipeline solution of
tests/data/jax_pipeline_solo12_trot_n50.npz (nom_X, nom_U).  The CLI runs
are float32 on the CPU, as `cmpc-run-motion --cpu` runs them.  The port's
tests/test_torch_physics.py, tests/test_torch_cli.py and chip_smoke.py's
`# physics/solo12_trot_n50` and `# run_motion/solo12_trot` phases hold
the port to this file.  It imports only the JAX package:

    python scripts/jax_physics_reference.py

It took 300 s on an 8-core x86 CPU (115 s of it the full-size CLI run).
"""
import json
import os
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from centroidal_mpc_tpu import cli  # noqa: E402
from centroidal_mpc_tpu.config import presets  # noqa: E402
from centroidal_mpc_tpu.contact.swing import (  # noqa: E402
    compute_swing_trajectories)
from centroidal_mpc_tpu.models import rigid_body as rb  # noqa: E402
from centroidal_mpc_tpu.models import whole_body  # noqa: E402
from centroidal_mpc_tpu.models import whole_body_ddp as wbd  # noqa: E402
from centroidal_mpc_tpu.models.centroidal import (  # noqa: E402
    compute_trajectory_data)
from centroidal_mpc_tpu.sim import physics as phys  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "jax_physics_solo12_trot_n50.npz")
PIPELINE = os.path.join(ROOT, "tests", "data",
                        "jax_pipeline_solo12_trot_n50.npz")
PRESET = presets.SOLO12_TROT_N50
RUNS = {
    "manifest_solo12_trot": ["--preset", "solo12_trot", "--sims", "16",
                             "--physics-sims", "64", "--terrain", "debris"],
    "manifest_mini_flat": ["--preset", "solo12_trot_mini", "--sims", "2",
                           "--physics-sims", "2"],
    "manifest_mini_debris": ["--preset", "solo12_trot_mini", "--sims", "2",
                             "--physics-sims", "2", "--terrain", "debris"],
}


def store_manifest(root):
    """Every file of a run-motion output directory: npz keys and shapes,
    .dat rows and columns, other files (figures, the preview) by name."""
    out = {}
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if name.endswith(".npz"):
            with np.load(path) as f:
                out[name] = {k: list(f[k].shape) for k in f.files}
        elif name.endswith(".dat"):
            out[name] = {"rows_cols": list(np.loadtxt(path).shape)}
        else:
            out[name] = {}
    return out


def physics_reference():
    """The pipeline's stage 4b on the float64 nominal plan, then four
    episodes with fixed pushes."""
    ref = np.load(PIPELINE)
    prob = presets.build_problem(PRESET, dtype=jnp.float64)
    spec = rb.robot_spec(PRESET.robot.name)
    X, U = jnp.asarray(ref["nom_X"]), jnp.asarray(ref["nom_U"])
    swing = compute_swing_trajectories(prob.plan, PRESET.dt_ctrl)
    wb = whole_body.track_centroidal_solution(
        prob.plan, swing, X, U, PRESET.dt_ctrl,
        geom=wbd.leg_geometry_from_spec(spec))
    data = compute_trajectory_data(prob.model, prob.plan.schedule, X, U)
    refs = phys.build_references(wb, X, data.K, prob.plan.schedule)
    q0 = jnp.concatenate([refs.h_des[0, :3], jnp.zeros((3,), jnp.float64),
                          refs.q_des[0]])
    x0 = jnp.concatenate([q0, jnp.zeros((spec.nv,), jnp.float64)])
    t_total = refs.q_des.shape[0]
    push_len = 200
    rng = np.random.default_rng(0)
    forces = np.zeros((4, 3))
    forces[1] = (0.0, 6.0, 0.0)
    forces[2:] = np.sqrt(15.0) * rng.standard_normal((2, 3))
    starts = np.zeros(4, np.int64)
    starts[1] = t_total
    starts[2:] = rng.integers(0, t_total - push_len, 2)
    h, feet, rpy = jax.jit(jax.vmap(
        lambda f, s: phys.simulate_episode(spec, refs, x0, f, s, push_len)))(
            jnp.asarray(forces), jnp.asarray(starts))
    # fell as run_physics_monte_carlo computes it
    res = phys.PhysicsSimResult(
        h=h, feet=feet, base_rpy=rpy,
        fell=h[:, :, 2].min(axis=1) < 0.5 * x0[2],
        push_force=jnp.asarray(forces), push_start=jnp.asarray(starts))
    out = {f"refs_{k}": np.asarray(getattr(refs, k))
           for k in ("q_des", "qd_des", "tau_ff", "h_des", "K_lqr", "logic",
                     "kp", "kd")}
    out.update(
        x0=np.asarray(x0), push_force=forces, push_start=starts,
        push_len=np.asarray(push_len), h=np.asarray(h),
        feet=np.asarray(feet), rpy=np.asarray(rpy),
        slippage=np.asarray(phys.foot_slippage(res, refs)),
        cum_cost=np.asarray(phys.tracking_cost(res, refs)[:, -1]),
        fell=np.asarray(res.fell))
    return out


def main():
    t0 = time.perf_counter()
    out = {}
    # the CLI as a user runs it: float32, jax_enable_x64 off
    for key, argv in RUNS.items():
        with tempfile.TemporaryDirectory() as tmp:
            t1 = time.perf_counter()
            cli.run_motion_main(["--cpu", "--out", tmp] + argv)
            out[key] = np.asarray(json.dumps(store_manifest(tmp),
                                             sort_keys=True))
            print(f"{key}: {time.perf_counter() - t1:.0f} s")
    jax.config.update("jax_enable_x64", True)
    out.update(physics_reference())
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes) in "
          f"{time.perf_counter() - t0:.0f} s: {out['h'].shape[1]} steps; "
          f"slippage {out['slippage']}, cum_cost {out['cum_cost']}, fell "
          f"{out['fell']}")
    for key in RUNS:
        print(key, json.dumps(json.loads(str(out[key])), indent=1))


if __name__ == "__main__":
    main()
