"""DenseNet, AlexNet, SqueezeNet and ShuffleNetV2 of the port's vision zoo
against the JAX package's (tests/torch_zoo_parity.py says how weights are
carried and what each tolerance is): logits in eval and training mode at
the reference's own test sizes (tests/test_zoo_audio_text.py:
densenet121, squeezenet1_1 and shufflenet_v2_x0_25 at 32 x 32, alexnet at
224 x 224; squeezenet1_0 and the swish ShuffleNet beside them), and the
loss and every gradient of DenseNet-121 (a concatenation at every layer)
and ShuffleNetV2 (the channel shuffle, the split of a stride-1 unit)
against jax.grad at b4 64 x 64."""

import pytest
import torch

import torch_zoo_parity as Z


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: with a worker's default threads under xdist,
    every worker's CPU kernels contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

FAMILIES = [("densenet121", 32), ("alexnet", 224), ("squeezenet1_0", 64),
            ("squeezenet1_1", 32), ("shufflenet_v2_x0_25", 32),
            ("shufflenet_v2_swish", 32)]


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,hw", FAMILIES, ids=[n for n, _ in FAMILIES])
def test_logits_match_reference(name, hw, training):
    x, _ = Z.images(hw=hw, b=2 if hw == 224 else 4)
    Z.check_logits(name, x, training, num_classes=10)


@pytest.mark.parametrize("name", ["densenet121", "shufflenet_v2_x0_25"])
def test_loss_and_gradients_match_jax_grad(name):
    x, y = Z.images(hw=64)
    Z.check_grads(name, x, y, num_classes=10)
