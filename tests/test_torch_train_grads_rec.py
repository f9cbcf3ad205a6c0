"""The training objective and its gradients against JAX's
jax.value_and_grad(transformer.loss_fn) for the recurrent families
(RWKV-6, RecurrentGemma: the chunked wkv loop and the associative scan's
in-place interleave under autograd), the enc-dec Whisper (frames through
the encoder) and the VLM InternVL (the image prefix cut before the loss),
on their reduced configs in f32, with the tolerances of
test_torch_train_grads.py, which holds the helpers."""

import pytest

from test_torch_train_grads import (REC_ARCHS, check_decay_mask, check_loss_and_grads,
                                    one_thread)  # noqa: F401  (autouse)


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_decay_mask_matches_jax(arch):
    check_decay_mask(arch)
