from mech_nn_discovery_pde_torch.data import generate
from mech_nn_discovery_pde_torch.data.datasets import (
    BurgersDataset,
    KamaniDataset,
    PatchLoader,
    ReactDiffDataset,
)
