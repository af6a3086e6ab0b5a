"""Port parity of the MoE and MLA families on a (2, 2) ("data", "model")
mesh of four gloo ranks on the CPU (``test_torch_sharding_families.py``'s
checks; JAX runs their ``loss_fn`` op by op, ``lm_parity.jax_mode``): each
without the sharding options and again with ``moe_cap_shard`` (the
dispatch buffer and the experts' hidden with their capacity over "data")
and ``attn_kv_hoist`` (JAX's config field; the port lays K and V out
once before it attends either way, so it changes nothing here). The
routers are the port's without a mesh, bit for bit, on every rank.
"""
import pytest

from test_torch_sharding_families import FLAGS, check_case, run_cases

CASES = ([(a, a, a, {}) for a in ("deepseek-moe-16b", "deepseek-v2-236b")]
         + [(f"{a}+hoist+cap", a, a, FLAGS) for a in ("deepseek-moe-16b", "deepseek-v2-236b")])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("moe"), CASES)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_family_on_a_2x2_mesh_matches_jax(case, runs):
    check_case(case, CASES, runs)
