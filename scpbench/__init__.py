"""A data-driven benchmark of centroidal_mpc_tpu_torch on NVIDIA GPUs."""
