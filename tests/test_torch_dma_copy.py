"""Port parity for B4, the DMA copy: ``repro_torch`` (the kernel's plain
version, as it runs for CPU tensors) against the JAX op with its Pallas
kernel in interpret mode, on the grid of ``tests/kernels/test_dma_copy.py``.

Tolerance: none. A copy moves bytes, so every case is bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import DMAConfig as JDMAConfig
from repro.kernels.dma_copy import kernel as jkernel
from repro.kernels.dma_copy.ops import dma_copy as jdma_copy
from repro_torch import convert
from repro_torch.core import dma_engine as tdma
from repro_torch.core.config import DMAConfig
from repro_torch.kernels.dma_copy import kernel as tkernel
from repro_torch.kernels.dma_copy import ops as tops


def _bits(x) -> np.ndarray:
    """The bytes of a JAX array or a tensor, for a bit-equal compare."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).reshape(-1)


def _both(x, **cfg):
    want = jdma_copy(x, config=JDMAConfig(**cfg))
    t = convert.to_tensor(np.asarray(x), "cpu")
    got = tops.dma_copy(t, config=DMAConfig(**cfg))
    assert got.shape == t.shape and got.dtype == t.dtype
    assert got.data_ptr() != t.data_ptr()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert torch.equal(got, t.clone())


@pytest.mark.parametrize("shape", [(128,), (1000,), (17, 33), (4, 128, 9)])
@pytest.mark.parametrize("channels", [1, 2, 8])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32])
def test_identity_matches_pallas_op(shape, channels, dtype, rng):
    x = jnp.asarray(rng.standard_normal(shape) * 5, dtype)
    _both(x, num_parallel_dma=channels, max_transaction_bytes=512)


@pytest.mark.parametrize("txn", [256, 1024, 65536])
def test_transaction_sizes(txn, rng):
    _both(jnp.asarray(rng.standard_normal(5000), jnp.float32),
          max_transaction_bytes=txn)


def test_more_channels_than_chunks(rng):
    """One chunk, eight channels: the prologue must not stage past it."""
    _both(jnp.asarray(rng.standard_normal(100), jnp.float32),
          num_parallel_dma=8, max_transaction_bytes=65536)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16, torch.int32])
def test_copy_into_a_region_at_any_offset(dtype):
    """``out=`` writes one region of a larger buffer and nothing else, at
    an odd element offset too (2- or 1-byte aligned on the card)."""
    src = torch.arange(1, 301, dtype=torch.int32).to(dtype)
    for offset in (0, 1, 7):
        buf = torch.zeros(400, dtype=dtype)
        out = tops.dma_copy(src, config=DMAConfig(max_transaction_bytes=256),
                            out=buf[offset:offset + 300])
        assert out.data_ptr() == buf[offset:].data_ptr()
        assert torch.equal(buf[offset:offset + 300], src)
        assert not buf[:offset].any() and not buf[offset + 300:].any()


@pytest.mark.parametrize("itemsize,txn,want", [(4, 512, 128), (2, 512, 256),
                                               (4, 256, 128),
                                               (2, 262144, 131072),
                                               (1, 16384, 16384)])
def test_chunk_elems_follows_the_reference_plan(itemsize, txn, want):
    assert tops.chunk_elems(DMAConfig(max_transaction_bytes=txn),
                            itemsize) == want


def test_kernel_and_torch_backends_agree(rng):
    """The staged copy and its plain version (``dst.copy_(src)``) agree,
    and so do the DMA engine's two paths."""
    x = torch.from_numpy(rng.standard_normal((33, 65)).astype(np.float32))
    cfg = DMAConfig(max_transaction_bytes=1000, num_parallel_dma=3)
    flat = x.reshape(-1)
    assert torch.equal(
        tkernel.staged_copy(torch.empty_like(flat), flat, chunk_elems=250,
                            channels=3),
        tkernel.staged_copy_plain(torch.empty_like(flat), flat))
    assert torch.equal(tdma.bulk_copy(x, config=cfg, use_kernels=True),
                       tdma.bulk_copy(x, config=cfg, use_kernels=False))


def _bad(case):
    dst, src, kw = torch.zeros(64), torch.ones(64), dict(chunk_elems=16,
                                                         channels=4)
    if case == "dtype":
        src = src.double()
    elif case == "size":
        src = torch.ones(65)
    elif case == "strided":
        src = torch.ones(128)[::2]
    elif case == "two_d":
        dst, src = dst.view(8, 8), src.view(8, 8)
    elif case == "channels_0":
        kw["channels"] = 0
    elif case == "channels_9":
        kw["channels"] = 9
    elif case == "chunk_0":
        kw["chunk_elems"] = 0
    elif case == "overlap":
        buf = torch.zeros(100)
        dst, src = buf[:64], buf[10:74]
    return dst, src, kw


@pytest.mark.parametrize("case", ["dtype", "size", "strided", "two_d",
                                  "channels_0", "channels_9", "chunk_0",
                                  "overlap"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    dst, src, kw = _bad(case)
    with pytest.raises(ValueError):
        tkernel.staged_copy(dst, src, **kw)


@pytest.mark.parametrize("chunk_elems,channels", [(1, 1), (3, 4), (7, 8),
                                                  (131072, 4)])
@pytest.mark.parametrize("n", [1000, 1003])
def test_staged_copy_of_any_chunk_and_total(chunk_elems, channels, n, rng):
    """Chunks under 16 bytes (on the card the cp.async route), a chunk of
    256 KB (the Table I maximum), totals that are and are not a multiple
    of the chunk and of 16 bytes, one to eight channels: the copy is the
    source, bit for bit, and agrees with the JAX Pallas kernel on the
    chunked layout where the chunk divides the total."""
    src = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        torch.bfloat16)
    got = tkernel.staged_copy(torch.empty_like(src), src,
                              chunk_elems=chunk_elems, channels=channels)
    np.testing.assert_array_equal(_bits(got), _bits(src))
    if n % chunk_elems == 0:
        x = jnp.asarray(src.float().numpy()).astype(jnp.bfloat16)
        want = jkernel.dma_copy_chunked(x.reshape(-1, chunk_elems),
                                        channels=channels)
        np.testing.assert_array_equal(_bits(got), _bits(want.reshape(-1)))


@pytest.mark.parametrize("src_off,dst_off", [(1, 0), (0, 1), (1, 3), (8, 8)])
def test_staged_copy_between_misaligned_views(src_off, dst_off, rng):
    """Source and destination views at element offsets that leave them
    2-byte aligned (a bulk write at an odd bf16 offset) or 16-byte
    aligned: the destination region is the source, and nothing around it
    changes."""
    n = 777
    sbuf = torch.from_numpy(rng.standard_normal(n + 8).astype(
        np.float32)).to(torch.bfloat16)
    dbuf = torch.zeros(n + 8, dtype=torch.bfloat16)
    src, dst = sbuf[src_off:src_off + n], dbuf[dst_off:dst_off + n]
    tkernel.staged_copy(dst, src, chunk_elems=128, channels=4)
    assert torch.equal(dbuf[dst_off:dst_off + n], src)
    assert not dbuf[:dst_off].any() and not dbuf[dst_off + n:].any()


def test_staged_copy_of_nothing():
    """An empty payload copies nothing and returns ``dst`` (the kernel is
    never launched for it on the card)."""
    dst, src = torch.zeros(0, dtype=torch.bfloat16), torch.zeros(
        0, dtype=torch.bfloat16)
    out = tkernel.staged_copy(dst, src, chunk_elems=128, channels=4)
    assert out is dst and out.shape == (0,)
    assert tkernel.LIB.launches == 0


@pytest.mark.parametrize("dtype", [np.float32, np.int32, "bfloat16"])
def test_oracle_matches_the_reference_oracle(dtype, rng):
    """``dma_copy_ref`` (a clone) against the reference's seven-line
    oracle (``jnp.array(src, copy=True)``), and the op against both."""
    from repro.kernels.dma_copy.ref import dma_copy_ref as jref
    from repro_torch.kernels.dma_copy.ref import dma_copy_ref
    x = rng.standard_normal((7, 33)).astype(np.float32)
    x = jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bfloat16" \
        else jnp.asarray(x.astype(dtype))
    t = convert.to_tensor(np.asarray(x), "cpu")
    got = dma_copy_ref(t)
    assert got.data_ptr() != t.data_ptr() and got.dtype == t.dtype
    np.testing.assert_array_equal(_bits(got), _bits(jref(x)))
    np.testing.assert_array_equal(_bits(tops.dma_copy(t)), _bits(got))
