"""The MoE layer on the card against the CPU (no JAX: this file runs on
the card as it is; the CPU tests against the reference are in
``test_torch_moe.py``).

``moe_block`` in float32 (full float32 products, no TF32) at a small
width on the card and on the CPU from the same parameters and tokens:
the same experts, positions and drops, outputs within 1e-5 of the
largest, the load-balance loss within 1e-6; the same bits from call to
call and under torch's deterministic mode; a bf16 layer finite and
deterministic too.  The inputs have no near tie in the router (each
row's first k + 1 probabilities at least 1e-5 apart, asserted), so a
choice that differs is a fault, not a rounding.
"""
import pytest
import torch

from repro_torch.models.lm import moe


def _layer(dtype, device, seed=0):
    cfg = moe.MoEConfig(n_experts=16, top_k=4, d_expert=96)
    gen = torch.Generator().manual_seed(seed)
    p = {k: v[0].to(device) for k, v in moe.init_moe(
        gen, 1, 128, cfg, dtype, "cpu").items()}
    x = torch.randn((4, 33, 128), generator=gen).to(device, dtype)
    return cfg, p, x


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_small_layer_has_no_near_tie():
    """The CPU half of the card test: the data it uses routes with every
    margin clear, and drops tokens (capacity 42 of 132 x 4 choices over
    16 experts is tight)."""
    cfg, p, x = _layer(torch.float32, "cpu")
    x2d = x.reshape(-1, 128)
    probs = torch.softmax(x2d @ p["router"], dim=-1)
    top = torch.sort(probs, dim=-1, descending=True).values[:, :cfg.top_k + 1]
    assert float((top[:, :-1] - top[:, 1:]).min()) > 1e-5
    _, idx, _ = moe._route(p["router"], x2d, cfg)
    _, keep = moe._positions(idx, cfg.n_experts, moe.capacity(132, cfg))
    assert not bool(keep.all())


@pytest.mark.gpu
def test_moe_block_card_matches_cpu(cuda):
    cfg, p, x = _layer(torch.float32, "cpu")
    want, aux_h = moe.moe_block(p, x, cfg)
    pc = {k: v.to(cuda) for k, v in p.items()}
    xc = x.to(cuda)
    got, aux_c = moe.moe_block(pc, xc, cfg)
    x2d = x.reshape(-1, 128)
    _, idx_h, _ = moe._route(p["router"], x2d, cfg)
    _, idx_c, _ = moe._route(pc["router"], xc.reshape(-1, 128), cfg)
    assert torch.equal(idx_c.cpu(), idx_h)
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    assert abs(float(aux_c) - float(aux_h)) <= 1e-6 * float(aux_h)
    again, _ = moe.moe_block(pc, xc, cfg)
    torch.use_deterministic_algorithms(True)
    try:
        det, _ = moe.moe_block(pc, xc, cfg)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(again, got) and torch.equal(det, got)


@pytest.mark.gpu
def test_bf16_moe_block_on_the_card(cuda):
    cfg, p, x = _layer(torch.bfloat16, cuda, seed=1)
    assert p["router"].dtype == torch.float32
    y, aux = moe.moe_block(p, x, cfg)
    assert y.dtype == torch.bfloat16 and bool(y.isfinite().all())
    assert torch.equal(moe.moe_block(p, x, cfg)[0], y)
    assert float(aux) > 0
