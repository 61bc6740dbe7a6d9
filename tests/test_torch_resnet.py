"""PyTorch port vs the JAX package: the four ResNets of models/resnet.py at
width 8 and depth 2, with the flax parameters carried across by
`state_dict_from_flax`, on the same channels-last input from a numpy seed.
The port runs on the CPU in float32; tolerance 1e-5 relative max-abs (float32
convolutions, sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mech_nn_discovery_pde_torch.models import resnet as tres
from mech_nn_discovery_pde_tpu.models import resnet as jres

torch.set_num_threads(1)

SHAPES = {  # channels-last input shapes (bs, *spatial, channels)
    "ResNet": (2, 8, 12, 1),
    "ResNet1D": (2, 16, 1),
    "ResNet2D": (2, 8, 12, 2),
    "ResNet3D": (2, 4, 6, 8, 1),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_resnet_matches_flax(name):
    shape = SHAPES[name]
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jm = getattr(jres, name)(width=8, depth=2)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tm = getattr(tres, name)(in_channels=shape[-1], width=8, depth=2, device="cpu")
    tm.load_state_dict(tres.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    assert got.shape == want.shape == shape[:-1] + (1,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if name == "ResNet1D":
        # circular padding: rolling the input along L rolls the output
        with torch.no_grad():
            rolled = tm(torch.tensor(np.roll(x, 3, axis=1))).numpy()
        np.testing.assert_allclose(rolled, np.roll(got, 3, axis=1), rtol=1e-5, atol=1e-6)
