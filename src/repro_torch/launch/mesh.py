"""The host the port runs on: one NVIDIA H100 or four of one host, and the
d-GLMNET mesh over their processes.

The JAX package's ``repro.launch.mesh`` builds the TPU pod's production
mesh (``make_production_mesh``: (16, 16) or (2, 16, 16) chips) and holds
the TPU v5e's constants.  Neither carries over.  The port's host is one
card or four cards of one machine joined by NVLink, so there is no pod
mesh to build; the dry-run's size and memory check of a configuration on
1 or 4 cards comes with ``launch/dryrun.py``'s slice (ROADMAP Queue 1 item
6).  ``mesh_from_devices`` has no counterpart either: a mesh of the port
is one process a rank, laid out by ``repro_torch.dist.bootstrap``.

The constants are per card, from NVIDIA's H100 data sheet (the SXM part,
dense rates without sparsity, at its full power limit of 700 W).  A card
set below 700 W runs slower under load: read ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` beside any time.
"""
from __future__ import annotations

DEVICE_NAME = "NVIDIA H100 80GB HBM3 (SXM), 700 W"

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12      # FLOP/s, dense TF32 on the tensor cores
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12              # B/s
HBM_BYTES = 80e9              # B of device memory
# NVLink 4 (the same data sheet): 18 links of 50 GB/s, 900 GB/s in all,
# both directions counted
NVLINK_LINKS = 18
NVLINK_BW_PER_LINK = 50e9     # B/s per link
NVLINK_BW = NVLINK_LINKS * NVLINK_BW_PER_LINK


def make_glm_mesh(n_data: int, n_model: int):
    """Mesh for the d-GLMNET workload: rows x feature blocks, over the
    ranks of the ``torch.distributed`` job this process belongs to.
    (1, M) reproduces the paper's layout exactly."""
    from repro_torch.dist.bootstrap import make_dist_mesh
    return make_dist_mesh(n_data, n_model)
