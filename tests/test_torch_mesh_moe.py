"""The port's sharded MoE LMs (granite-moe-1b-a400m, deepseek-v2-236b:
expert-parallel routed experts, tensor-parallel shared experts and MLA)
against the port and the JAX package on one device, on the (2, 2) and
(1, 4) meshes: the cases of ``tests/test_torch_mesh_models.py``, whose
docstring gives what is compared and at which tolerances."""
import pytest

from test_torch_mesh_models import MESHES, check_arch_on_mesh


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "granite-moe-1b-a400m"])
def test_sharded_moe_lm_matches_one_device_and_jax(arch, mesh):
    check_arch_on_mesh(arch, mesh)
