"""``test_torch_remat.py``'s JAX parity with ``remat="full"`` on both
sides, for the MoE ids (deepseek-moe-16b, deepseek-v2-236b) at SMOKE, in
a file of their own: JAX runs their MoE op by op (``lm_parity.jax_mode``),
its layer bodies under ``jax.checkpoint``, the port's under
``torch.utils.checkpoint``. Tolerances as ``test_torch_loss_moe.py``'s
(``lm_parity.assert_loss_and_grads_close``, unchanged)."""
import pytest

import lm_parity as lp
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-236b"])
def test_remat_loss_and_gradients_match_jax_moe(arch):
    worst = lp.assert_loss_and_grads_close(arch, remat="full")
    print(f"{arch} (remat full): worst gradient normwise {worst:.4g}")
