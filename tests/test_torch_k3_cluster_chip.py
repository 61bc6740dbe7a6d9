"""K3 on a thread-block cluster (csrc/line_block.cu
`k3_factored_line_block_apply_cluster`), which reads W as its packed upper
triangle, on the card (marker `chip`; each test skips without a CUDA
device):

    python3 -m pytest tests/test_torch_k3_cluster_chip.py -q     (on the chip)

The kernel against its plain version at the cluster widths, at block
pointers of every 2-byte alignment, with and without the Chebyshev epilogue
(d in place); and the long window's hierarchy in 'bf16_factored' storage,
which stores W packed at both smoothed levels.  Imports nothing of JAX."""

import pytest
import torch

from mech_nn_discovery_pde_torch.ops import fused_smoother as fs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the chip")
    return torch.device("cuda")


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.chip
@pytest.mark.parametrize("nt,m", [(13, 13), (25, 7), (50, 7), (229, 4)],
                         ids=["bw169", "bw175", "bw350", "bw916"])
def test_packed_cluster_k3_matches_plain(cuda, nt, m):
    """At bw 169, 175, 350 and 916 the launch takes the cluster kernel on the
    packed W, and at every 2-byte alignment of the blocks' pointer (the
    packed blocks start 0 to 14 bytes past a 16-byte boundary) it equals
    the plain version within 1e-5, alone and with d = c1 d + c2 t in
    place."""
    from mech_nn_discovery_pde_torch.ops import _cuda

    bs, S, bw = 2, 6, nt * m
    g = torch.Generator(device=cuda).manual_seed(bw)
    w = (torch.randn((bs, S, bw, bw), generator=g, device=cuda) / bw).triu()
    wp = fs.pack_upper(w.to(torch.bfloat16)).contiguous()
    r = torch.randn((bs, nt * S * m), generator=g, device=cuda)
    d0 = torch.randn((bs, nt * S * m), generator=g, device=cuda)
    c1 = torch.rand((bs,), generator=g, device=cuda)
    c2 = torch.rand((bs,), generator=g, device=cuda)
    assert fs.block_apply_route(wp, nt, True) == "cluster"
    want = fs.factored_block_apply_plain(wp, r, nt)
    want_d = fs.factored_block_apply_plain(wp, r, nt, d=d0.clone(), c1=c1, c2=c2)
    flat = torch.empty(wp.numel() + 16, dtype=torch.bfloat16, device=cuda)
    base = flat.data_ptr() % 16 // 2
    for shift in range(8):
        off = (shift - base) % 8
        wa = flat[off:off + wp.numel()].view(wp.shape)
        wa.copy_(wp)
        assert wa.data_ptr() % 16 == 2 * shift
        _cuda.LAUNCHES.clear()
        got = fs.factored_block_apply(wa, r, nt)
        d = d0.clone()
        fs.factored_block_apply(wa, r, nt, d=d, c1=c1, c2=c2)
        torch.cuda.synchronize()
        assert dict(_cuda.LAUNCHES) == {"k3_factored_line_block_apply_cluster": 2}
        assert _rel(got, want) <= 1e-5, shift
        assert _rel(d, want_d) <= 1e-5, shift


@pytest.mark.chip
def test_long_window_hierarchy_stores_packed_w(cuda):
    """The long window's layer ((50, 32, 32) patches, time-coarsened, bs 2)
    in 'bf16_factored' storage stores W packed at its smoothed levels 0 and
    1 (bw 350 and 175: bs x S x packed_off(bw, bw) bf16, no dense factor
    there), whose block applies take the cluster kernel."""
    from mech_nn_discovery_pde_torch.config import PDEConfig
    from mech_nn_discovery_pde_torch.discovery.ginzburg_landau import GLDiscovery
    from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer

    bs, dims = 2, (50, 32, 32)
    cfg = PDEConfig(precision="f32_ir", mg_solve_dtype="f32", mg_precond_dtype="bf16_factored",
                    mg_smoother_steps_pre=4, mg_smoother_steps_post=4,
                    mg_smoother_residual=True, mg_fused_matvec=True)
    layer = MultigridLayer(bs=bs, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
                           init_index_mi_list=GLDiscovery.IV_LIST, solver_dbl=True, n_grid=3,
                           downsample_first=True, config=cfg, device=cuda)
    g = torch.Generator().manual_seed(0)
    coeffs = torch.zeros((bs, layer.grid_size, layer.n_orders), dtype=torch.float64)
    coeffs[..., 0], coeffs[..., 1], coeffs[..., 5], coeffs[..., 6] = -1.0, 1.0, -1.0, -1.0
    rhs = 0.01 * torch.randn((bs, layer.grid_size), generator=g, dtype=torch.float64)
    iv = 0.1 * torch.randn((bs, layer.system.n_init_rows), generator=g, dtype=torch.float64)
    steps = [torch.full((bs, n - 1), 0.1, dtype=torch.float64).to(cuda) for n in dims]
    with torch.no_grad():
        _, _, hier = layer._prepare(coeffs.to(cuda), rhs.to(cuda), iv.to(cuda), steps)
    mg = layer.mg_solver
    m = layer.system.var_set.n_mi
    for k, bw in ((0, 350), (1, 175)):
        nt, S = mg.dim_list[k][0], int(torch.tensor(mg.dim_list[k][1:]).prod())
        assert nt * m == bw
        w = hier["levels"][k]["binv"]
        assert w.dtype == torch.bfloat16 and tuple(w.shape) == (bs, S, fs.packed_off(bw, bw))
        assert mg._block_attrs(k, hier["levels"][k])["layout"] == "packed"
        assert fs.block_apply_route(w, nt, True) == "cluster"
