"""Port parity of training's loss (``models.*.loss_fn``,
``layers.cross_entropy``): loss and every parameter gradient of each
registry id at SMOKE (B 2, L 32, the data pipeline's tokens) against
``jax.value_and_grad`` of JAX's ``loss_fn``, weights carried across by
``interop``; the MoE families run JAX op by op (``lm_parity.jax_mode``).
Tolerances in ``lm_parity.assert_loss_and_grads_close`` (stated there).
The two MoE ids, whose op-by-op JAX gradients take ~20-30 s each, are in
``test_torch_loss_moe.py``; the cross-entropy alone is here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as lp
from repro.models import layers as jlayers
from repro.models import registry as jreg
from repro_torch.models import layers as tlayers
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

ARCHS = [a for a in jreg.ARCH_IDS if a not in ("deepseek-v2-236b", "deepseek-moe-16b")]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    worst = lp.assert_loss_and_grads_close(arch)
    print(f"{arch}: worst gradient normwise {worst:.4g}")


@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_cross_entropy_matches_jax(z_loss):
    """fp32 logsumexp, the label's logit gathered (JAX sums an iota
    compare: zeros and one term, the same value), z-loss, mean; and its
    gradient, softmax minus one-hot, against ``jax.grad``."""
    rng = np.random.default_rng(0)
    lg = (rng.normal(size=(2, 31, 97)) * 3).astype(np.float32)
    labels = rng.integers(0, 97, (2, 31)).astype(np.int32)
    lj, gj = jax.value_and_grad(lambda x: jlayers.cross_entropy(x, jnp.asarray(labels),
                                                                z_loss))(jnp.asarray(lg))
    x = torch.tensor(lg, requires_grad=True)
    lt = tlayers.cross_entropy(x, torch.as_tensor(labels), z_loss)
    lt.backward()
    assert lt.dtype == torch.float32 and lt.shape == ()
    assert abs(float(lt) - float(lj)) <= 64 * 2.0**-24 * abs(float(lj))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj), rtol=0,
                               atol=64 * 2.0**-24 / lg[..., 0].size)
    # bf16 logits are upcast first, as JAX's astype(f32)
    lb = tlayers.cross_entropy(torch.tensor(lg).to(torch.bfloat16), torch.as_tensor(labels))
    assert lb.dtype == torch.float32
