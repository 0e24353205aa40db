#!/usr/bin/env python
"""End-to-end motion demo on the PyTorch + CUDA port (thin shim over
centroidal_mpc_tpu_torch.cli).

The script form of the demo notebooks (demos/trot_demo_torch.ipynb):
pick a preset, run the full pipeline on the card, drop npz artifacts,
analysis figures, and an HTML 3D motion preview in --out.

Usage:
    python demos/run_motion_torch.py --preset solo12_trot --sims 32 --out artifacts/trot
    python demos/run_motion_torch.py --preset solo12_bound --cpu --f64

Installed form (pip install -e .):  cmpc-torch-run-motion --preset solo12_trot
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from centroidal_mpc_tpu_torch.cli import run_motion_main

if __name__ == "__main__":
    run_motion_main()
