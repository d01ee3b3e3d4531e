"""The port's configurations (``repro_torch.configs``) against the JAX
package's (``repro.configs``): every architecture's full and smoke config
field for field, the shape grid, the skip rule, the GLM dry-run shapes,
head and vocab padding for tensor parallelism; and ``launch/mesh.py``,
which holds the H100 host's constants where the reference holds the TPU
v5e's.  Exact equality throughout: these are plain dataclasses."""
import dataclasses
import importlib

import pytest

from repro.configs import base as j_base
from repro.configs import glm_webscale as j_glm
from repro.configs import registry as j_reg
from repro.launch import mesh as j_mesh
from repro_torch import configs as t_configs
from repro_torch.configs import base as t_base
from repro_torch.configs import glm_webscale as t_glm
from repro_torch.configs import registry as t_reg
from repro_torch.launch import mesh as t_mesh

NAMES = sorted(j_reg.ARCHS)


def test_registry_holds_every_architecture():
    assert sorted(t_reg.ARCHS) == NAMES and len(NAMES) == 10
    assert t_configs.ARCHS is t_reg.ARCHS
    assert t_configs.get_arch is t_reg.get_arch
    assert t_configs.smoke_variant is t_reg.smoke_variant


@pytest.mark.parametrize("name", NAMES)
def test_full_config_equals_the_reference(name):
    assert dataclasses.asdict(t_reg.get_arch(name)) == \
        dataclasses.asdict(j_reg.get_arch(name))


@pytest.mark.parametrize("name", NAMES)
def test_smoke_config_equals_the_reference(name):
    t, j = t_reg.smoke_variant(name), j_reg.smoke_variant(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.resolved_head_dim == j.resolved_head_dim


@pytest.mark.parametrize("name", NAMES)
def test_config_module_keeps_its_source(name):
    """Each config file keeps the reference's docstring (its source)."""
    mod = name.replace("-", "_").replace(".", "_")
    t = importlib.import_module(f"repro_torch.configs.{mod}")
    j = importlib.import_module(f"repro.configs.{mod}")
    assert t.__doc__ == j.__doc__ and t.__doc__


def test_arch_defaults_equal_the_reference():
    t = [(f.name, f.default) for f in dataclasses.fields(t_base.ArchConfig)]
    j = [(f.name, f.default) for f in dataclasses.fields(j_base.ArchConfig)]
    assert t == j
    cfg = t_reg.get_arch("gemma3-12b").replace(n_layers=2)
    assert cfg.n_layers == 2 and isinstance(cfg, t_base.ArchConfig)


def test_get_arch_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown arch"):
        t_reg.get_arch("gpt-5")


def test_shapes_and_the_skip_rule():
    assert {k: dataclasses.asdict(v) for k, v in t_base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_base.SHAPES.items()}
    for name in NAMES:
        for shape in j_base.SHAPES:
            assert t_base.cell_is_runnable(
                t_reg.get_arch(name), t_base.SHAPES[shape]) == \
                j_base.cell_is_runnable(j_reg.get_arch(name),
                                        j_base.SHAPES[shape])


def test_glm_shapes():
    assert t_configs.GLM_SHAPES is t_glm.GLM_SHAPES
    assert {k: dataclasses.asdict(v) for k, v in t_glm.GLM_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in j_glm.GLM_SHAPES.items()}


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
def test_tp_pad_config(tp):
    for name in NAMES:
        t_cfg, t_pads = t_base.tp_pad_config(t_reg.get_arch(name), tp)
        j_cfg, j_pads = j_base.tp_pad_config(j_reg.get_arch(name), tp)
        assert t_pads == j_pads, (name, tp)
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)


def test_mesh_holds_the_h100_constants():
    """The card's per-device peaks (NVIDIA's H100 SXM data sheet, dense
    rates, 700 W), not the TPU v5e's."""
    assert t_mesh.PEAK_FLOPS_BF16 == 989e12
    assert t_mesh.PEAK_FLOPS_TF32 == 495e12
    assert t_mesh.PEAK_FLOPS_FP32 == 67e12
    assert t_mesh.HBM_BW == 3.35e12 and t_mesh.HBM_BYTES == 80e9
    assert t_mesh.NVLINK_BW == 900e9
    assert "H100" in t_mesh.DEVICE_NAME and "700 W" in t_mesh.DEVICE_NAME
    assert t_mesh.PEAK_FLOPS_BF16 != j_mesh.PEAK_FLOPS_BF16
    assert t_mesh.HBM_BW != j_mesh.HBM_BW
    assert not hasattr(t_mesh, "make_production_mesh")
    assert not hasattr(t_mesh, "ICI_BW_PER_LINK")


def test_glm_mesh_is_the_dist_mesh():
    """make_glm_mesh(1, 1) in a world of one (gloo on the CPU) is the
    port's (data, model) DeviceMesh."""
    from repro_torch.dist import bootstrap
    bootstrap.initialize(device="cpu", backend="gloo")
    try:
        mesh = t_mesh.make_glm_mesh(1, 1)
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.mesh.shape) == (1, 1)
    finally:
        bootstrap.shutdown()
