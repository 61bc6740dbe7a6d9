"""mech_nn_discovery_pde_torch: the PyTorch / NVIDIA H100 port of
mech_nn_discovery_pde_tpu (Mechanistic PDE Networks for Discovery of
Governing Equations).

A linear(ized) PDE on a grid is an equality-constrained least-squares system
over per-grid-point unknowns (function value + all partial derivatives up to
order 2), solved inside the training loop as a differentiable layer: dense
batched Cholesky (layers/dense.py) for small grids, FGMRES preconditioned by
geometric multigrid (layers/multigrid.py) for large ones, whose stencil
apply and smoothing run hand-written CUDA kernels (csrc/).  The backward
passes use the implicit function theorem and reuse the forward's solver
data.  Entry points run on "cuda" unless given device="cpu".
"""

from mech_nn_discovery_pde_torch.config import PDEConfig

__version__ = "0.1.0"
