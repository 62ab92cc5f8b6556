"""The port's kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: each test skips on a host without a CUDA device, where the
kernels cannot run (they have no CPU mode; the CPU tests hold the plain
versions against the JAX package instead). This file imports neither jax
nor the reference package, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: bf16 outputs within 5e-2 (tests/test_kernels.py's bf16
tolerance; kernel and plain version round the f32 accumulators at the same
points but sum in another order), router indices exactly equal and weights
within 1e-5.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ragged_moe_ffn as t_ragged  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

pytestmark = pytest.mark.gpu

BF16_TOL = 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ragged_inputs(dev, sizes, D, F, bm, seed=0):
    g = torch.Generator().manual_seed(seed)
    E = len(sizes)
    sizes_t = torch.tensor(sizes, dtype=torch.int32)
    n_tiles = t_ragged.ragged_n_tiles(int(sizes_t.sum()), E, bm)
    ro, tg = t_ragged.ragged_tile_metadata(sizes_t, bm, n_tiles)
    toks = torch.zeros((n_tiles * bm, D))
    for e in range(E):
        toks[ro[e]:ro[e] + sizes[e]] = torch.randn((sizes[e], D), generator=g)
    w = [torch.randn(s, generator=g) / math.sqrt(s[1])
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    bf = [t.to(dev, torch.bfloat16) for t in (*w, toks)]
    return bf, tg.to(dev)


@pytest.mark.parametrize("sizes,D,F,bm", [
    ([70, 0, 130, 3], 128, 192, 64),      # aligned, one empty expert
    ([5, 300, 0, 0, 9], 160, 130, 128),   # F edge inside a column block
    ([33, 1, 64], 200, 100, 64),          # D, F not multiples of 8: scalar
])
def test_ragged_moe_ffn_kernel_matches_plain(cuda, sizes, D, F, bm):
    (w1, w3, w2, toks), tg = _ragged_inputs(cuda, sizes, D, F, bm)
    ops.reset_launch_counts()
    y = ops.ragged_moe_ffn(w1, w3, w2, toks, tg)
    y_ref = ref.ragged_moe_ffn_ref(w1, w3, w2, toks, tg)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ragged_moe_ffn"] == 1
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    sentinel = (tg >= len(sizes)).repeat_interleave(bm)
    assert sentinel.any() and bool((y[sentinel] == 0).all())


def test_ragged_moe_ffn_kernel_refuses_what_it_does_not_take(cuda):
    (w1, w3, w2, toks), tg = _ragged_inputs(cuda, [40, 3], 64, 64, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.ragged_moe_ffn(w1.float(), w3, w2, toks, tg)
    with pytest.raises(ValueError, match="multiple of 64"):
        ops.ragged_moe_ffn(w1, w3, w2, toks, tg.repeat_interleave(2))
    with pytest.raises(ValueError, match="contiguous"):
        ops.ragged_moe_ffn(w1.transpose(1, 2).contiguous().transpose(1, 2),
                           w3, w2, toks, tg)


@pytest.mark.parametrize("T,E,K,ties", [(4096, 40, 8, False),
                                        (513, 128, 8, False),
                                        (7, 4, 1, False), (300, 40, 8, True)])
def test_router_kernel_matches_plain(cuda, T, E, K, ties):
    g = torch.Generator().manual_seed(T)
    logits = (torch.randint(0, 3, (T, E), generator=g).float() if ties
              else torch.randn((T, E), generator=g)).to(cuda)
    w, i = ops.router_topk(logits, K)
    w_ref, i_ref = ref.router_topk_ref(logits, K)
    torch.cuda.synchronize()
    assert torch.equal(i, i_ref)                                 # exact
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)


def test_moe_layer_on_card_matches_cpu(cuda):
    """The whole ragged layer — plan, kernels, gather-combine — on the card
    against the same layer's plain path on the CPU."""
    g = torch.Generator().manual_seed(3)
    E, D, F, K = 8, 256, 192, 2
    p = tmoe.moe_init(g, d=D, f=F, n_experts=E, n_slots=E)
    x = torch.randn((3, 50, D), generator=g).to(torch.bfloat16)
    y_c, t_c, _ = tmoe.moe_layer(p, x, top_k=K, n_experts=E, route_seed=5)
    y_g, t_g, _ = tmoe.moe_layer({k: v.to(cuda) for k, v in p.items()},
                                 x.to(cuda), top_k=K, n_experts=E,
                                 route_seed=5)
    torch.testing.assert_close(t_g.cpu(), t_c, rtol=0, atol=0)
    torch.testing.assert_close(y_g.float().cpu(), y_c.float(),
                               rtol=BF16_TOL, atol=BF16_TOL)
