"""GoogLeNet and InceptionV3 of the port's vision zoo against the JAX
package's (tests/torch_zoo_parity.py says how weights are carried and
what each tolerance is): all three of GoogLeNet's outputs (the main head
and the aux heads, whose AdaptiveAvgPool2D(4) bins a 4 x 4 or 2 x 2 map
into 4 x 4, unevenly at 64 x 64 and 96 x 96 inputs) and InceptionV3's
logits in eval and training mode at the reference's own test sizes
(tests/test_zoo_audio_text.py: googlenet at 64 x 64, inception_v3 at
75 x 75); the loss of GoogLeNet's main head and every gradient against
jax.grad; and the adaptive pools against the reference's start/end rule
at the aux heads' 14 x 14 -> 4 x 4 of a 224 x 224 image."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_zoo_parity as Z
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as PF


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: with a worker's default threads under xdist,
    every worker's CPU kernels contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,hw", [("googlenet", 64), ("googlenet", 96),
                                     ("inception_v3", 75)],
                         ids=["googlenet_64", "googlenet_96",
                              "inception_v3_75"])
def test_logits_match_reference(name, hw, training):
    x, _ = Z.images(hw=hw)
    Z.check_logits(name, x, training, num_classes=10)


def test_googlenet_main_head_loss_and_gradients_match_jax_grad():
    """The aux heads are off the loss's path: no gradient on either
    side."""
    x, y = Z.images(hw=64)
    Z.check_grads("googlenet", x, y, num_classes=10)


@pytest.mark.parametrize("size,out", [(14, 4), (7, 4), (13, 5), (5, 3)])
@pytest.mark.parametrize("kind", ["avg", "max"])
def test_adaptive_pools_uneven_bins_match_reference(kind, size, out):
    """Bins floor(i * in / out) to ceil((i + 1) * in / out): overlapping
    and of unequal sizes where out does not divide in."""
    x = np.random.RandomState(size).randn(2, 3, size, size).astype(
        np.float32)
    name = f"adaptive_{kind}_pool2d"
    want = np.asarray(getattr(JF, name)(paddle.Tensor(x), out)._data)
    got = getattr(PF, name)(torch.as_tensor(x), out).numpy()
    np.testing.assert_allclose(got, want, rtol=Z.F32_TOL, atol=1e-6)
