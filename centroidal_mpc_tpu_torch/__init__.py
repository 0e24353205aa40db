"""centroidal_mpc_tpu_torch: the PyTorch + CUDA port of centroidal_mpc_tpu.

Batch-first PyTorch counterparts of the JAX package's modules (same
layout and names: config/, contact/, models/, ops/, solver/, parallel/),
with hand-written CUDA kernels for Hopper (csrc/) in place of the JAX
package's Pallas TPU kernels.  The package never imports jax.

Quick start (a batch of B scenarios; chip_smoke.py drives the same path
at the bench operating point)::

    import dataclasses, torch
    from centroidal_mpc_tpu_torch.config import presets
    from centroidal_mpc_tpu_torch.ops.admm import QPSettings
    from centroidal_mpc_tpu_torch.parallel.batch import (batched_solve,
                                                         tile_ocp_config)

    prob = presets.build_problem(
        presets.SOLO12_TROT_N50, dtype=torch.float32, device="cuda",
        qp=QPSettings(eps_abs=5e-4, eps_rel=5e-4, adaptive_rho=False,
                      polish=True, max_iter=4000))
    X0 = prob.X0.expand(8, -1, -1)
    U0 = prob.U0.expand(8, -1, -1)
    cfg = tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1], X0)
    scp = dataclasses.replace(prob.scp, qp_backend="block",
                              norm_method="power")
    sol = batched_solve(prob.model, prob.plan.schedule, cfg, X0, U0, scp)
"""

__version__ = "0.1.0"
