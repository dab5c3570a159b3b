"""Port parity for the DMA engine and the controller's bulk path:
``repro_torch.core.dma_engine`` and ``MemoryController.bulk_read`` /
``bulk_write`` (``device="cpu"``, kernels on and off, the DMA engine on and
off) against the JAX package's, with its Pallas kernel in interpret mode
and without.

Tolerance: none. The planner's numbers are integers or sums of the same
float terms in the same order, and a bulk transfer moves bytes (the one
cast, ``src`` to ``dst``'s dtype, rounds the same way in both packages),
so every comparison is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import config as jcfg
from repro.core import controller as jctl
from repro.core import dma_engine as jdma
from repro.core.timing import HBM_V5E as JHBM_V5E
from repro_torch import convert
from repro_torch.core import HBM_V5E, controller as tctl
from repro_torch.core import dma_engine as tdma
from repro_torch.core.config import DMAConfig


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).reshape(-1)


def _pair(dma=True, use_pallas=True, use_kernels=True, **dma_cfg):
    """The JAX controller and the port's, with the DMA engine toggled and
    its config changed, the port's carried over by ``convert``."""
    base = jcfg.PAPER_EVAL_CONFIG
    j = dataclasses.replace(base, dma=dataclasses.replace(
        base.dma, enabled=dma, **dma_cfg))
    t = convert.config_from_dict(dataclasses.asdict(j))
    return (jctl.MemoryController(j, use_pallas=use_pallas),
            tctl.MemoryController(t, use_kernels=use_kernels, device="cpu"))


PATHS = [(True, True, True), (True, False, False), (False, True, True),
         (False, False, False)]
"""(DMA engine, use_pallas, use_kernels)."""


@settings(max_examples=30, deadline=None, derandomize=True)
@given(st.integers(1, 10_000_000), st.integers(1, 8),
       st.sampled_from([256, 4096, 16384, 65536, 262144]))
def test_plan_and_modeled_cycles_match_reference(total, channels, txn):
    cfg = dict(num_parallel_dma=channels, max_transaction_bytes=txn)
    jplan = jdma.plan_transfer(total, jcfg.DMAConfig(**cfg))
    tplan = tdma.plan_transfer(total, DMAConfig(**cfg))
    for f in ("channel", "offset", "size"):
        got, want = getattr(tplan, f), getattr(jplan, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tplan.total_bytes == jplan.total_bytes
    assert tplan.num_transactions == jplan.num_transactions
    assert tdma.modeled_transfer_cycles(tplan, DMAConfig(**cfg)) == \
        jdma.modeled_transfer_cycles(jplan, jcfg.DMAConfig(**cfg))


def test_modeled_cycles_on_hbm_match_reference():
    cfg = dict(num_parallel_dma=3, max_transaction_bytes=4096)
    assert tdma.modeled_transfer_cycles(
        tdma.plan_transfer(1 << 20, DMAConfig(**cfg)), DMAConfig(**cfg),
        HBM_V5E) == jdma.modeled_transfer_cycles(
        jdma.plan_transfer(1 << 20, jcfg.DMAConfig(**cfg)),
        jcfg.DMAConfig(**cfg), JHBM_V5E)


@pytest.mark.parametrize("channels,buf", [(1, 256), (4, 16384), (8, 1 << 20)])
def test_channel_vmem_bytes_matches_reference(channels, buf):
    cfg = dict(num_parallel_dma=channels, buffer_bytes=buf)
    assert tdma.channel_vmem_bytes(DMAConfig(**cfg)) == \
        jdma.channel_vmem_bytes(jcfg.DMAConfig(**cfg))


def test_plan_rejects_empty():
    with pytest.raises(ValueError):
        tdma.plan_transfer(0, DMAConfig())


@pytest.mark.parametrize("dma,use_pallas,use_kernels", PATHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "uint8"])
@pytest.mark.parametrize("shape", [(1000,), (17, 33), (3, 128, 9)])
def test_bulk_read_matches_reference(dma, use_pallas, use_kernels, dtype,
                                     shape, rng):
    jmc, tmc = _pair(dma, use_pallas, use_kernels, max_transaction_bytes=512)
    src = jnp.asarray(rng.standard_normal(shape) * 40, jnp.float32).astype(
        dtype)
    t_src = convert.to_tensor(np.asarray(src), "cpu")
    got = tmc.bulk_read(t_src)
    want = jmc.bulk_read(src)
    assert got.shape == t_src.shape and got.dtype == t_src.dtype
    assert got.data_ptr() != t_src.data_ptr()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dma,use_pallas,use_kernels", PATHS)
@pytest.mark.parametrize("offset", [0, 1, 7, 333])
@pytest.mark.parametrize("dst_dtype,src_dtype", [
    ("bfloat16", "bfloat16"), ("bfloat16", "float32"), ("float32", "int32"),
    ("int32", "int32"), ("int32", "float32")])
def test_bulk_write_matches_reference(dma, use_pallas, use_kernels, offset,
                                      dst_dtype, src_dtype, rng):
    """At odd element offsets (a bf16 region then starts 2-byte aligned)
    and with ``src`` cast to ``dst``'s dtype; ``dst`` is not changed."""
    jmc, tmc = _pair(dma, use_pallas, use_kernels, max_transaction_bytes=256,
                     num_parallel_dma=3)
    dst = jnp.asarray(rng.standard_normal((4, 25, 8)) * 30,
                      jnp.float32).astype(dst_dtype)
    src = jnp.asarray(rng.standard_normal((5, 90)) * 30,
                      jnp.float32).astype(src_dtype)
    t_dst, t_src = (convert.to_tensor(np.asarray(a), "cpu")
                    for a in (dst, src))
    before = t_dst.clone()
    got = tmc.bulk_write(t_dst, t_src, offset_elems=offset)
    want = jmc.bulk_write(dst, src, offset_elems=offset)
    assert got.shape == t_dst.shape and got.dtype == t_dst.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert torch.equal(t_dst, before)
    flat = before.reshape(-1).clone()
    flat[offset:offset + t_src.numel()] = t_src.reshape(-1).to(t_dst.dtype)
    assert torch.equal(got.reshape(-1), flat)


@pytest.mark.parametrize("dma,use_pallas,use_kernels", PATHS)
@pytest.mark.parametrize("offset", [-1, 711, 10_000])
def test_bulk_write_out_of_bounds_raises_on_every_path(dma, use_pallas,
                                                       use_kernels, offset):
    jmc, tmc = _pair(dma, use_pallas, use_kernels)
    dst, src = np.zeros((8, 100), np.float32), np.ones(90, np.float32)
    with pytest.raises(ValueError, match="out of destination bounds"):
        jmc.bulk_write(jnp.asarray(dst), jnp.asarray(src),
                       offset_elems=offset)
    with pytest.raises(ValueError, match="out of destination bounds"):
        tmc.bulk_write(torch.from_numpy(dst), torch.from_numpy(src),
                       offset_elems=offset)
    with pytest.raises(ValueError, match="out of destination bounds"):
        tdma.bulk_write(torch.from_numpy(dst), torch.from_numpy(src),
                        config=DMAConfig(), offset_elems=offset,
                        use_kernels=use_kernels)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_engine_functions_match_reference(use_kernels, rng):
    """``bulk_copy`` and ``bulk_write`` themselves, at the Table I maximum
    transaction with more channels than transactions."""
    cfg = dict(num_parallel_dma=8, max_transaction_bytes=262144)
    src = jnp.asarray(rng.standard_normal((40, 30)), jnp.bfloat16)
    dst = jnp.zeros((50, 30), jnp.bfloat16)
    t_src, t_dst = (convert.to_tensor(np.asarray(a), "cpu")
                    for a in (src, dst))
    got = tdma.bulk_copy(t_src, config=DMAConfig(**cfg),
                         use_kernels=use_kernels)
    np.testing.assert_array_equal(
        _bits(got), _bits(jdma.bulk_copy(src, config=jcfg.DMAConfig(**cfg),
                                         use_pallas=True)))
    got = tdma.bulk_write(t_dst, t_src, config=DMAConfig(**cfg),
                          offset_elems=299, use_kernels=use_kernels)
    np.testing.assert_array_equal(
        _bits(got), _bits(jdma.bulk_write(dst, src,
                                          config=jcfg.DMAConfig(**cfg),
                                          offset_elems=299)))

