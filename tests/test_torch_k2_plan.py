"""K2's launch plan (``gather_prefill.plan``) at every main-path shape, and
B16 (``kernels.gather_wraps``) against aqlm_tpu, on the CPU.

The plan is a pure function of the shapes, so a launch that would need more
shared memory than a block may use, leave a split empty, or miss part of the
output fails here and not first on the card. The kernel itself runs only on
the card (tests/test_torch_cuda.py)."""

import pytest
import torch

from aqlm_tpu.ops import kernels as jk
from aqlm_tpu_torch.ops import gather_prefill as gp
from aqlm_tpu_torch.ops import kernels as k

# (name, OUT, IN, experts): Llama-2-7B's fused qkv, o, fused gate/up and down,
# Falcon-7B's fc1, Mixtral-8x7B's gate/up and down (all experts in one
# launch), and the card tests' shapes
SHAPES = [("qkv", 12288, 4096, 1), ("o", 4096, 4096, 1), ("gate_up", 22016, 4096, 1),
          ("down", 4096, 11008, 1), ("falcon_fc1", 18176, 4544, 1),
          ("mixtral_gate_up", 14336, 4096, 8), ("mixtral_down", 4096, 14336, 8),
          ("card_512x4096", 512, 4096, 1), ("card_512x1024", 512, 1024, 1),
          ("card_128x11008", 128, 11008, 1), ("card_512x256", 512, 256, 1),
          ("card_moe_split", 128, 4096, 2)]
ROWS = [9, 64, 77, 200, 256, 300, 1024, 2048]


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s[0])
def test_plan_fits_and_covers(shape, rows):
    _, out_f, in_f, experts = shape
    for K, out_dtype in ((2, torch.bfloat16), (2, torch.float32), (1, torch.bfloat16),
                         (8, torch.bfloat16)):
        p = gp.plan(rows, out_f, in_f, K, 256, experts, out_dtype)
        n_slabs = in_f // 64
        assert p.smem == gp.smem_bytes(p.bm, K, 256, p.stages) <= gp.SMEM_LIMIT
        assert p.stages >= 3
        assert p.bm == (256 if rows > 128 else 128)
        assert p.grid[0] * 128 == out_f
        assert (p.grid[1] - 1) * p.bm < rows <= p.grid[1] * p.bm
        assert p.grid[2] == experts * p.splits
        assert (p.splits - 1) * p.per_split < n_slabs <= p.splits * p.per_split  # none empty
        if rows <= 1024:  # each weight dequantised at most 4 times up to 1024 rows
            assert p.grid[1] <= 4
        if p.splits > 1:
            assert p.partials_shape == (experts * p.splits, p.grid[1] * p.bm, out_f)
            assert p.grid[0] * p.grid[1] * experts < 132  # only where the tiles leave SMs idle


def test_plan_splits_short_narrow_and_not_long():
    """The split path is kept for short prompts on narrow projections
    (Llama's down at 64 rows) and not taken where the tiles fill the card."""
    assert gp.plan(64, 4096, 11008, 2, 256).splits > 1
    assert gp.plan(1024, 12288, 4096, 2, 256).splits == 1
    assert gp.plan(1024, 14336, 4096, 2, 256, experts=8, out_dtype=torch.float32).splits == 1


@pytest.mark.parametrize("bad", [dict(K=9), dict(S=257), dict(out_features=200),
                                 dict(in_features=100), dict(out_dtype=torch.float16)])
def test_plan_refuses_what_the_kernel_cannot_run(bad):
    args = dict(T=64, out_features=512, in_features=1024, K=2, S=256, experts=1,
                out_dtype=torch.bfloat16) | bad
    with pytest.raises(ValueError):
        gp.plan(**args)


@pytest.fixture
def fresh_probe(monkeypatch):
    """Both probes' cached answers cleared (and restored after)."""
    monkeypatch.setattr(jk, "_GATHER_WRAPS", None)
    monkeypatch.setattr(k, "_GATHER_WRAPS", {})
    return monkeypatch


def test_gather_wraps_on_the_cpu_matches_jax(fresh_probe):
    """On the CPU both answer False (JAX's interpret mode clamps)."""
    fresh_probe.delenv("AQLM_GATHER_WRAP", raising=False)
    assert k.gather_wraps("cpu") is False
    assert jk.gather_wraps() is False


@pytest.mark.parametrize("env,want", [("0", False), ("1", True), ("false", False)])
def test_gather_wraps_override_matches_jax(fresh_probe, env, want):
    fresh_probe.setenv("AQLM_GATHER_WRAP", env)
    assert k.gather_wraps("cpu") is want
    assert jk.gather_wraps() is want


def test_gather_wraps_plain_is_the_wrapping_gather():
    """B16's plain version reads tab[idx % 128]: at the probe's indices
    128..255 it returns the table itself, the answer of a wrapping gather."""
    tab, idx = k.wrap_probe_inputs("cpu")
    assert tab.shape == idx.shape == (8, 128) and int(idx.min()) == 128 and int(idx.max()) == 255
    assert torch.equal(k.gather_wraps_plain(tab, idx), tab)
    rand = torch.randn((8, 128))
    shifted = torch.randint(0, 128, (8, 128), dtype=torch.int32)
    assert torch.equal(k.gather_wraps_plain(rand, shifted + 128),
                       torch.take_along_dim(rand, shifted.long(), dim=1))
