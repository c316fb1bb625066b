"""Parity of the port's training loss and gradients with JAX's for the MoE
families: DeepSeekMoE (a dense head layer, then MoE layers), Kimi-K2 (the
same pattern at top-4 of 16) and Jamba's hybrid super-block (Mamba, MoE
on odd layers, attention at offset 4).  Split from ``test_torch_loss.py``
because their JAX gradients take the longest; the tolerances are the same
(loss 1e-5 relative, each gradient leaf 1e-4 of its largest |g|).  The
routing runs in f32 on both sides at the reduced capacity factor 4.0,
which drops nothing; the load-balance term enters the loss through
``aux_coef`` and is held with it.
"""
import pytest

from _torch_lm import MOE_ARCHS, check_loss_and_grads


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


def test_moe_loss_without_mask_in_one_chunk_matches_jax():
    check_loss_and_grads("deepseek-moe-16b", mask=False, seed=4,
                         loss_chunks=1)
