"""The host the port runs on: one NVIDIA H100 or four of one host, the
abstract meshes of the dry-run, and the d-GLMNET mesh over their
processes.

The JAX package's ``repro.launch.mesh`` builds the TPU pod's production
mesh (``make_production_mesh``: (16, 16) or (2, 16, 16) chips) and holds
the TPU v5e's constants.  Neither carries over.  The port's host is one
card or four cards of one machine joined by NVLink: ``abstract_mesh(1)``
and ``abstract_mesh(4)`` are its (data, model) meshes (1, 1) and (1, 4),
axis names and sizes with no process group, which ``launch/dryrun.py`` and
the tests place abstract state on where the reference takes the
production mesh.  A live mesh of the port is one process a rank,
``repro_torch.dist.bootstrap.make_dist_mesh`` (``mesh_from_devices`` has
no counterpart).

The constants are per card, from NVIDIA's H100 data sheet (the SXM part,
dense rates without sparsity, at its full power limit of 700 W).  A card
set below 700 W runs slower under load: read ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` beside any time.
"""
from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, with no process group: what the
    dry-run's placement reads (``axis_names``, ``shape`` {axis: size})."""
    sizes: tuple
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def tag(self) -> str:
        return "x".join(map(str, self.sizes))


def abstract_mesh(n_cards: int) -> AbstractMesh:
    """The (data, model) mesh of ``n_cards`` cards of one host, the model
    axis across them: (1, 1) for one card, (1, 4) for four."""
    return AbstractMesh((1, n_cards))
